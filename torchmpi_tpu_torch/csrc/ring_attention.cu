// Ring attention over virtual ranks on one card: the forward (K8), the
// bidirectional forward (K9) and the analytic backward (K10).
//
// Replaces, in torchmpi_tpu/ops/ring_attention_kernel.py:
// - _ring_attn_kernel (K8): rank r keeps its queries and merges the K/V
//   block of rank (r - s) mod p at ring step s into f32 running max,
//   normalizer and accumulator (the alpha/beta merge of _flash_merge_cells);
// - _ring_attn_bidir_kernel (K9): the same merge, blocks visited in the
//   bidirectional order: the local block, then for t = 1..nR the R chain's
//   (r - t) mod p and, while t <= nL, the L chain's (r + t) mod p, with
//   nR = ceil((p-1)/2), nL = floor((p-1)/2);
// - _ring_attn_bwd_kernel (K10): dQ, dK, dV from the saved (o, lse), with
//   P = exp(S - lse), D = rowsum(dO * O), dS = P * (dP - D), in two
//   launches: bwd_dq_mma_kernel (dQ, and D for the second launch) and
//   bwd_dkv_mma_kernel (dK, dV).
//
// On one card every rank's shard already lies in device memory, so the
// K/V ring is an index: at step s rank r reads block (r - s) mod p in
// place. The VMEM residency, the remote copies, the two-slot buffers, the
// neighbour barrier, cap_sem and the batch/head chunking that fitted the
// VMEM envelope have no counterpart here. What stays is the arithmetic, in
// f32 whatever the input dtype: scale 1/sqrt(d), causal masking by global
// positions, l = max(l, 1e-30), o = acc / l cast to q's dtype,
// lse = m + log(l).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [p, B, n, H, D] contiguous (each
// rank keeps the JAX layout [B, n, H, D]); lse and delta are [p, B, H, n]
// f32. A (b, h) pair is a "cell".
//
// Causal skips. A block from rank src > r is masked for every query of
// rank r. In the JAX merge its beta = exp(-1e30 - m) is exactly 0, since the
// local block (merged first) gives every row a finite m; its alpha is 1. So
// skipping it gives the same result, and the kernels skip it (in the
// backward its P is exactly 0). In the diagonal block (src == r), a key
// tile after every query of the tile is skipped for the same reason. The
// first key tile of the local block holds key r*n, which every query of
// rank r sees, so no row is ever empty when it is merged.
//
// Forward (K8, K9). A block of 256 threads owns one 64-row query tile of
// one cell of one rank and walks the visiting blocks in 64-key tiles,
// staged through shared memory as f32. Each thread holds a 4 x 4 tile of
// the 64 x 64 score block and a 4 x D/16 tile of the output rows; the
// products are plain f32 FMAs on the CUDA cores. A key tile is merged with
// the online softmax; the JAX kernel merges a whole block at once, so
// results agree to rounding, not bit for bit. Bound: operations, 4 d flops
// per (query, key) pair the mask keeps (69 GFLOP at the LM path's
// [4, 4, 1024, 8, 64] f32 causal).
//
// Backward (K10), on the tensor cores. Each 64 x 64 (query, key) tile
// takes five products: S = Q K^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q,
// dQ += dS K. Each runs as mma.sync m16n8k8 with TF32 operands and f32
// accumulators. A block of 8 warps owns 64 rows (queries in the dQ launch,
// keys in the dK/dV launch): warp w holds the 16 rows 16 (w % 4) .. and,
// of every visited 64-column tile, the half w / 4; the two warps of a row
// group add their sums once, at the end, through shared memory. S and dP
// stay in registers as accumulator fragments, with lse and D for the
// fragment's rows or columns. The accumulator fragment of m16n8k8 holds
// columns 2t, 2t+1 of
// row g where the A fragment wants columns t, t+4; the sum over k does not
// care in which order the 8 k of a step come, so P and dS are fed as A
// straight from their registers with k permuted (k 2t, 2t+1 in the slots
// of t, t+4), and the B fragment reads rows 2t and 2t+1 to match. So no
// score tile goes through shared memory. Every tile sits in shared memory
// in its natural [row][D] layout with 16 bytes of padding a row, which
// makes both fragment reads of it (row g col t for A and for B as K^T,
// row 2t col g for B as K) free of bank conflicts for D >= 16; the first
// kind comes, for f32 tiles, by ldmatrix (an 8 x 4 f32 sub-tile is an
// 8 x 8 b16 one, and ldmatrix hands it out in the TF32 fragment's layout).
// The next K/V tile (dQ launch) or Q/dO tile (dK/dV launch) is staged with
// 16-byte cp.async copies into a second buffer while the current one
// computes. The tensor cores truncate as they accumulate: carried through
// them over a 4096-key ring, dV drifted from its plain version by 2.5e-4 at
// the LM shape on an H100. So each tile's P B products are summed in a
// fresh accumulator and added to the running sum by an f32 add (1.2e-5).
//
// Why 3xTF32 and not TF32. TF32 keeps 10 mantissa bits; a gradient summed
// over a 4096-token causal row from such products misses the f32 limits
// (atol and rtol 2e-4) that hold K10 to its plain version. So each f32
// operand x is split when its fragment is loaded into big = tf32_rna(x) and
// small = tf32_rna(x - big), and a product takes three MMAs,
// a_big b_small + a_small b_big first, then a_big b_big: the arithmetic of
// CUTLASS's OpMultiplyAddFastF32, about f32 accuracy. bf16 inputs are exact
// in TF32, so S and dP (both operands bf16) take one MMA, and the three
// products with P or dS (f32) two: P_big b + P_small b. One template
// serves both dtypes; the number of terms is fixed at compile time.
//
// Why two launches. dK/dV of block j sum over every visiting rank's
// queries and dQ of rank r over every visited block's keys; one launch
// would have to add one of them across blocks with atomics, in an order
// that changes from run to run, and the LM's losses would too. So the dQ
// launch (grid over rank, cell, query tile) first writes D for its rows and
// accumulates dS K over the visiting blocks src = (r - s) mod p; the dK/dV
// launch (grid over block j, cell, key tile) accumulates P^T dO and
// dS^T Q over the visiting ranks in ring order (j + s) mod p, s = 0..p-1,
// the order in which the JAX accumulators ride the ring home. Each launch
// computes S and dP for its own tiles: 7 products where one launch would
// do 5, 14 d flops per kept pair instead of 10 d.
//
// Bound: operations at the 3xTF32 rate. At [4, 4, 1024, 8, 64] f32 causal
// the backward needs 10 d flops per kept pair, 171.8 GFLOP: 1.04 ms at
// 495 / 3 = 165 TFLOP/s (three TF32 MMAs per f32 product), against 2.56 ms
// at the 67 TFLOP/s of f32 FMAs. Up to D = 64 two blocks of 256 threads
// share an SM (16 warps), which caps the registers at 128 a thread. At
// D = 64, the LM's head dim, ptxas (nvcc -Xptxas -v, sm_90a; chip_smoke.py
// prints its report) finds no spill in the dQ launch and 380 bytes of
// spill stores in the f32 dK/dV launch (252 for bf16), whose dK and dV
// accumulators take 64 of the 128 registers. The same launch at one block
// of 8 warps an SM, which spills nothing, was slower at the LM shape on an
// H100 (4.0 ms against 3.7). At D = 128 one block holds an SM.
//
// Every entry point returns cudaGetLastError() so the wrapper can raise on
// a refused launch.
#include "common.cuh"

#include <type_traits>

namespace tmpi {
namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // the forward's block
constexpr int kTile = 64;  // queries per query tile, keys per key tile
constexpr int kPad = 4;    // keeps the forward's f32 rows 16-byte aligned
constexpr int kLdT = kTile + kPad;  // row length of a transposed tile [D][kTile]

struct Geometry {
  int p, B, n, H;
  float scale;
  int causal;
  // element offset of row i of cell `cell` on rank r, for head dim D
  __device__ __forceinline__ size_t row(int r, int cell, int i, int D) const {
    const int b = cell / H, h = cell - b * H;
    return ((((size_t)r * B + b) * n + i) * H + h) * (size_t)D;
  }
  // offset into a [p, B, H, n] statistic (lse, delta)
  __device__ __forceinline__ size_t stat(int r, int cell, int i) const {
    return ((size_t)r * B * H + cell) * n + i;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
template <typename S> __device__ __forceinline__ S from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ unsigned short from_f32<unsigned short>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Output columns each thread holds: 16 threads span D (for D = 8, half of
// them hold none).
template <int D> struct Cols {
  static constexpr int kOC = D >= 16 ? D / 16 : 1;
  static constexpr int kLdN = D + kPad;  // row length of a natural tile [kTile][D]
};

// Rows [row0, row0 + kTile) of (r, cell) as f32 into shared memory: the
// transposed tile t[d * kLdT + i] and/or the natural tile nat[i * kLdN + d].
// Rows past n read as 0.
template <int D, typename S>
__device__ void load_tile(float* t, float* nat, const S* src, const Geometry& g,
                          int r, int cell, int row0) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int i = e / D, d = e % D;
    const int row = row0 + i;
    const float x = row < g.n ? to_f32(src[g.row(r, cell, row, D) + d]) : 0.f;
    if (t) t[d * kLdT + i] = x;
    if (nat) nat[i * Cols<D>::kLdN + d] = x;
  }
}

// c[ii][jj] += sum_k at[k][ty*4 + ii] * bt[k][tx*4 + jj]: both operands
// transposed ([L][kLdT]).
template <int L>
__device__ __forceinline__ void mma_tt(float (&c)[4][4], const float* at, const float* bt,
                                       int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < L; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(at + k * kLdT + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + k * kLdT + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) c[ii][jj] = fmaf(av[ii], bv[jj], c[ii][jj]);
  }
}

// c[ii][cc] += sum_k at[k][ty*4 + ii] * bn[k][tx*OC + cc] over k < kTile:
// at transposed ([kTile][kLdT]), bn natural ([kTile][kLdN]).
template <int D>
__device__ __forceinline__ void mma_tn(float (&c)[4][Cols<D>::kOC], const float* at,
                                       const float* bn, int ty, int tx) {
  constexpr int OC = Cols<D>::kOC, LDN = Cols<D>::kLdN;
  if (tx * OC >= D) return;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(at + k * kLdT + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float* brow = bn + k * LDN + tx * OC;
    float bv[OC];
    if constexpr (OC % 4 == 0) {
#pragma unroll
      for (int q = 0; q < OC / 4; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(brow + 4 * q);
        bv[4 * q] = t.x; bv[4 * q + 1] = t.y; bv[4 * q + 2] = t.z; bv[4 * q + 3] = t.w;
      }
    } else if constexpr (OC == 2) {
      const float2 t = *reinterpret_cast<const float2*>(brow);
      bv[0] = t.x; bv[1] = t.y;
    } else {
      bv[0] = brow[0];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int cc = 0; cc < OC; ++cc) c[ii][cc] = fmaf(av[ii], bv[cc], c[ii][cc]);
  }
}

// max and sum over the 16 threads of a half-warp (one row group)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The rank whose K/V block rank r merges at visit i (0 <= i < p).
__device__ __forceinline__ int visit_src(int r, int i, int p, bool bidir) {
  if (!bidir || i == 0) return (r - i + p) % p;
  const int t = (i + 1) / 2;  // odd i: the R chain's step t; even i: the L chain's
  return (i & 1) ? (r - t + p) % p : (r + t) % p;
}

// Key tiles of block src that queries tile `qtile` of rank r needs: all of
// them, none (causal, src > r), or those up to the diagonal (src == r).
__device__ __forceinline__ int key_tiles(const Geometry& g, int r, int src, int qtile) {
  const int all = (g.n + kTile - 1) / kTile;
  if (!g.causal || src < r) return all;
  if (src > r) return 0;
  return qtile + 1 < all ? qtile + 1 : all;
}

// ---------------------------------------------------------------- forward

template <int D, typename S, bool kBidir>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
               S* __restrict__ o, float* __restrict__ lse, Geometry g) {
  constexpr int OC = Cols<D>::kOC, LDN = Cols<D>::kLdN;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLdT]
  float* kt = qt + D * kLdT;                     // [D][kLdT]
  float* vn = kt + D * kLdT;                     // [kTile][LDN]
  float* pt = vn + kTile * LDN;                  // [kTile keys][kLdT queries]

  const int qtile = blockIdx.x, cell = blockIdx.y, r = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qtile * kTile;
  load_tile<D>(qt, nullptr, q, g, r, cell, q0);

  float acc[4][OC], m[4], l[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int cc = 0; cc < OC; ++cc) acc[ii][cc] = 0.f;
  }

  for (int i = 0; i < g.p; ++i) {
    const int src = visit_src(r, i, g.p, kBidir);
    const int ntiles = key_tiles(g, r, src, qtile);
    const bool diag = g.causal && src == r;
    for (int ktile = 0; ktile < ntiles; ++ktile) {
      const int k0 = ktile * kTile;
      __syncthreads();  // the previous tile's kt, vn and pt are consumed
      load_tile<D>(kt, nullptr, k, g, src, cell, k0);
      load_tile<D>(nullptr, vn, v, g, src, cell, k0);
      __syncthreads();
      float s[4][4] = {};
      mma_tt<D>(s, qt, kt, ty, tx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int qi = q0 + ty * 4 + ii;
        bool ok[4];
        float mt = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kj = k0 + tx * 4 + jj;
          ok[jj] = kj < g.n && (!diag || kj <= qi);
          s[ii][jj] = ok[jj] ? s[ii][jj] * g.scale : kNegInf;
          mt = fmaxf(mt, s[ii][jj]);
        }
        const float m_new = fmaxf(m[ii], row_max(mt));
        const float alpha = expf(m[ii] - m_new);
        float lt = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float pv = ok[jj] ? expf(s[ii][jj] - m_new) : 0.f;
          lt += pv;
          pt[(tx * 4 + jj) * kLdT + ty * 4 + ii] = pv;
        }
        l[ii] = l[ii] * alpha + row_sum(lt);
        m[ii] = m_new;
#pragma unroll
        for (int cc = 0; cc < OC; ++cc) acc[ii][cc] *= alpha;
      }
      __syncthreads();
      mma_tn<D>(acc, pt, vn, ty, tx);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qi = q0 + ty * 4 + ii;
    if (qi >= g.n) continue;
    const float li = fmaxf(l[ii], 1e-30f);
    if (tx * OC < D) {
      S* orow = o + g.row(r, cell, qi, D) + tx * OC;
#pragma unroll
      for (int cc = 0; cc < OC; ++cc) orow[cc] = from_f32<S>(acc[ii][cc] / li);
    }
    if (tx == 0) lse[g.stat(r, cell, qi)] = m[ii] + logf(li);
  }
}

// ------------------------------------------- backward: tensor-core pieces

// A block of the backward: 8 warps over kTile rows; warp w owns the 16 rows
// 16 (w % 4) .. of the tile and the half w / 4 of each visited tile's
// kTile columns (kCols of them), so two warps hold partial sums of the same
// rows, added once at the end (sum_halves).
constexpr int kColSplit = 2;
constexpr int kCols = kTile / kColSplit;
constexpr int kBwdWarps = 4 * kColSplit;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr float kLog2e = 1.4426950408889634f;

// A backward tile in shared memory: kTile rows of D elements of S in their
// natural layout, each row padded by 16 bytes (which keeps the rows 16-byte
// aligned for cp.async and the fragment reads free of bank conflicts).
template <int D, typename S> struct BwdTile {
  static constexpr int kLd = D + 16 / (int)sizeof(S);
  static constexpr int kElems = kTile * kLd;
  static constexpr int kChunks = D * (int)sizeof(S) / 16;  // 16-byte copies a row
  static constexpr bool kF32 = std::is_same<S, float>::value;
  // blocks an SM should hold: two up to D = 64 (16 warps; the registers are
  // then capped at 128 a thread), one at D = 128, whose dK and dV
  // accumulators alone take 128
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// An element of a tile as f32: a bf16 value is its bits shifted up, and is
// exact in TF32.
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const unsigned short* p) {
  return __uint_as_float((uint32_t)*p << 16);
}

// The TF32 terms of N fragment registers: with kSplit, big = tf32_rna(x)
// and small = tf32_rna(x - big); without, big holds x, exact in TF32.
template <int N> struct Frag {
  uint32_t big[N], small[N];
};
template <bool kSplit, int N>
__device__ __forceinline__ void set_terms(Frag<N>& f, int i, float x) {
  if constexpr (kSplit) {
    f.big[i] = tf32_rna(x);
    f.small[i] = tf32_rna(x - __uint_as_float(f.big[i]));
  } else {
    f.big[i] = __float_as_uint(x);
  }
}

// Four 8 x 4 f32 sub-tiles of shared memory, one 16-byte row address from
// each lane (lanes 8m .. 8m + 7 give sub-tile m's rows); lane l receives
// word l % 4 of row l / 4 of each, which is the m16n8k8 TF32 fragment layout.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// P = exp(s * scale - lse), by the hardware's 2^x
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((s * scale - lse) * kLog2e));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on the tensor cores, the small terms first: 3xTF32 when both
// operands are split, a_small b + a_big b when only a is, one MMA when
// neither is.
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_terms(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  if constexpr (kSplitA && kSplitB) {
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.small, b.big);
  } else if constexpr (kSplitA) {
    mma_tf32(c, a.small, b.big);
  }
  mma_tf32(c, a.big, b.big);
}

// c[j] += (A B^T)[rows, 8j .. 8j + 7] over k < D, for a warp's 16 rows and
// kCols columns: a is the warp's 16 rows and b the kCols column rows, both
// natural tiles. Lane (g, t) = (lane / 4, lane % 4) holds A's rows g and
// g + 8, columns t and t + 4 of each k step, and B's row (= product
// column) g, columns t and t + 4; c[j] holds rows g, g + 8, columns 2t,
// 2t + 1 of step j. f32 tiles are read by ldmatrix, four sub-tiles at a
// time; bf16 ones element by element (ldmatrix would hand out pairs).
template <int D, typename S>
__device__ __forceinline__ void mma_abt(float (&c)[kCols / 8][4], const S* a, const S* b,
                                        int lane) {
  constexpr int LD = BwdTile<D, S>::kLd;
  if constexpr (BwdTile<D, S>::kF32) {
    // sub-tiles: A rows 0-7 / 8-15 x words 0-3 / 4-7 of the step; B rows
    // of two column steps x words 0-3 / 4-7
    const int m = lane >> 3, i = lane & 7;
    const float* pa = a + (i + 8 * (m & 1)) * LD + 4 * (m >> 1);
    const float* pb = b + (i + 8 * (m >> 1)) * LD + 4 * (m & 1);
#pragma unroll
    for (int k = 0; k < D; k += 8) {
      uint32_t ra[4];
      ldsm4(ra, pa + k);
      Frag<4> fa;
#pragma unroll
      for (int e = 0; e < 4; ++e) set_terms<true>(fa, e, __uint_as_float(ra[e]));
#pragma unroll
      for (int j = 0; j < kCols / 8; j += 2) {
        uint32_t rb[4];
        ldsm4(rb, pb + j * 8 * LD + k);
        Frag<2> f0, f1;
        set_terms<true>(f0, 0, __uint_as_float(rb[0]));
        set_terms<true>(f0, 1, __uint_as_float(rb[1]));
        set_terms<true>(f1, 0, __uint_as_float(rb[2]));
        set_terms<true>(f1, 1, __uint_as_float(rb[3]));
        mma_terms<true, true>(c[j], fa, f0);
        mma_terms<true, true>(c[j + 1], fa, f1);
      }
    }
  } else {
    const S* arow = a + (lane >> 2) * LD + (lane & 3);
    const S* brow = b + (lane >> 2) * LD + (lane & 3);
#pragma unroll
    for (int k = 0; k < D; k += 8) {
      Frag<4> fa;
      set_terms<false>(fa, 0, load_f32(arow + k));
      set_terms<false>(fa, 1, load_f32(arow + 8 * LD + k));
      set_terms<false>(fa, 2, load_f32(arow + k + 4));
      set_terms<false>(fa, 3, load_f32(arow + 8 * LD + k + 4));
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        Frag<2> fb;
        set_terms<false>(fb, 0, load_f32(brow + j * 8 * LD + k));
        set_terms<false>(fb, 1, load_f32(brow + j * 8 * LD + k + 4));
        mma_terms<false, false>(c[j], fa, fb);
      }
    }
  }
}

// c[j] += (P B)[rows, 8j .. 8j + 7] over the kCols columns of P, for a
// warp's 16 rows and D output columns. p holds P (or dS) as mma_abt left
// it: rows g, g + 8, columns 2t, 2t + 1 of each 8-column step. It is fed as
// A with the step's k permuted, slot t taking column 2t and slot t + 4
// column 2t + 1 (A's registers are then p's, reordered), so B's fragment
// reads rows 2t and 2t + 1 of the step, column g. b: kCols natural rows of
// B. P is f32 and always split; B is split when it is f32. The tile's sum
// is taken in a fresh accumulator and added to c with an f32 add: the
// tensor cores truncate as they accumulate, and a sum carried through them
// over a whole ring drifts (the note at the top).
template <int D, typename S>
__device__ __forceinline__ void mma_pb(float (&c)[D / 8][4], const float (&p)[kCols / 8][4],
                                       const S* b, int lane) {
  constexpr int LD = BwdTile<D, S>::kLd;
  constexpr bool kSplitB = BwdTile<D, S>::kF32;
  const S* bcol = b + 2 * (lane & 3) * LD + (lane >> 2);
  float tile[D / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kCols / 8; ++kk) {
    Frag<4> fa;
    set_terms<true>(fa, 0, p[kk][0]);
    set_terms<true>(fa, 1, p[kk][2]);
    set_terms<true>(fa, 2, p[kk][1]);
    set_terms<true>(fa, 3, p[kk][3]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      Frag<2> fb;
      set_terms<kSplitB>(fb, 0, load_f32(bcol + kk * 8 * LD + j * 8));
      set_terms<kSplitB>(fb, 1, load_f32(bcol + (kk * 8 + 1) * LD + j * 8));
      mma_terms<true, kSplitB>(tile[j], fa, fb);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += tile[j][e];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Rows [row0, row0 + kTile) of (r, cell) into the natural tile t by 16-byte
// cp.async copies; rows past n are zero-filled.
template <int D, typename S>
__device__ __forceinline__ void stage_tile(S* t, const S* src, const Geometry& g, int r,
                                           int cell, int row0) {
  using T = BwdTile<D, S>;
  constexpr int kPer = 16 / (int)sizeof(S);
  const S* base = src + g.row(r, cell, 0, D);
  const size_t stride = (size_t)g.H * D;
  for (int e = threadIdx.x; e < kTile * T::kChunks; e += kBwdThreads) {
    const int i = e / T::kChunks, c = e % T::kChunks;
    const bool valid = row0 + i < g.n;
    cp_async16(t + i * T::kLd + c * kPer, valid ? base + (row0 + i) * stride + c * kPer : src,
               valid);
  }
}

// lse and D of rows [row0, row0 + kTile) of (r, cell) into stats[0..kTile)
// and stats[kTile..2 kTile) by 4-byte cp.async copies; 0 past n.
__device__ __forceinline__ void stage_stats(float* stats, const float* lse, const float* delta,
                                            const Geometry& g, int r, int cell, int row0) {
  const int i = threadIdx.x % kTile, row = row0 + i;
  const bool valid = row < g.n;
  const size_t off = valid ? g.stat(r, cell, row) : 0;
  if (threadIdx.x < kTile) cp_async4(stats + i, lse + off, valid);
  else if (threadIdx.x < 2 * kTile) cp_async4(stats + kTile + i, delta + off, valid);
}

// A launch's (visit, tile) pairs in order: visit s covers tiles [lo, hi)
// by range(s, lo, hi); visits without a tile are passed over. s == p once
// there is none left.
template <typename Range>
__device__ __forceinline__ void first_tile(int& s, int& t, int p, const Range& range) {
  int lo, hi;
  for (s = 0; s < p; ++s) {
    range(s, lo, hi);
    if (lo < hi) {
      t = lo;
      return;
    }
  }
}
template <typename Range>
__device__ __forceinline__ void next_tile(int& s, int& t, int p, const Range& range) {
  int lo, hi;
  range(s, lo, hi);
  if (++t < hi) return;
  for (++s; s < p; ++s) {
    range(s, lo, hi);
    if (lo < hi) {
      t = lo;
      return;
    }
  }
}

// Warps w and w + 4 hold sums over the two column halves of every tile for
// the same rows: the second puts its accumulators in red ([kTile][D] f32),
// the first adds them to its own. The caller has synchronised after its
// last use of red's space.
template <int D>
__device__ __forceinline__ void sum_halves(float (&a)[D / 8][4], float* red, int half, int row0,
                                           int lane) {
  float* base = red + row0 * D + 2 * (lane & 3);
  if (half == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(base + 8 * h * D + 8 * j) =
            make_float2(a[j][2 * h], a[j][2 * h + 1]);
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(base + 8 * h * D + 8 * j);
        a[j][2 * h] += x.x;
        a[j][2 * h + 1] += x.y;
      }
  }
}

// Two f32 values into adjacent elements of an output row.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(unsigned short* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = (uint32_t)from_f32<unsigned short>(a) |
                                    ((uint32_t)from_f32<unsigned short>(b) << 16);
}

// --------------------------------------------------------- backward: dQ

template <int D, typename S> constexpr size_t dq_mma_smem() {
  return 6 * BwdTile<D, S>::kElems * sizeof(S);  // q, dO, two k and two v tiles
}
template <int D, typename S> constexpr size_t dkv_mma_smem() {
  return dq_mma_smem<D, S>() + 4 * kTile * sizeof(float);  // and two lse/D stages
}

template <int D, typename S>
__global__ void __launch_bounds__(kBwdThreads, BwdTile<D, S>::kMinBlocks)
    bwd_dq_mma_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                      const S* __restrict__ o, const S* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      S* __restrict__ dq, Geometry g) {
  using T = BwdTile<D, S>;
  constexpr int LD = T::kLd;
  extern __shared__ float4 smem4[];
  S* qs = reinterpret_cast<S*>(smem4);  // [kTile][LD]
  S* dos = qs + T::kElems;               // [kTile][LD]
  S* ks = dos + T::kElems;               // [2][kTile][LD]
  S* vs = ks + 2 * T::kElems;            // [2][kTile][LD]

  // the heaviest blocks first: a later rank's later query tile sees more keys
  const int qtile = gridDim.x - 1 - blockIdx.x, cell = blockIdx.y;
  const int r = gridDim.z - 1 - blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qtile * kTile;
  const int half = warp / 4, c0 = half * kCols;  // the warp's columns of a key tile
  const int row0 = (warp % 4) * 16 + (lane >> 2);  // the lane's rows: row0, row0 + 8
  const S* qw = qs + (warp % 4) * 16 * LD;
  const S* dow = dos + (warp % 4) * 16 * LD;
  const auto range = [&](int s, int& lo, int& hi) {
    lo = 0;
    hi = key_tiles(g, r, (r - s + g.p) % g.p, qtile);
  };
  int s, t = 0;
  first_tile(s, t, g.p, range);
  stage_tile<D>(qs, q, g, r, cell, q0);
  stage_tile<D>(dos, dout, g, r, cell, q0);
  if (s < g.p) {
    const int src = (r - s + g.p) % g.p;
    stage_tile<D>(ks, k, g, src, cell, t * kTile);
    stage_tile<D>(vs, v, g, src, cell, t * kTile);
  }
  cp_async_commit();

  // D = rowsum(dO * O) of the lane's rows, written for the dK/dV launch by
  // the first half; the four lanes of a row each sum every fourth column
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    float sum = 0.f;
    if (row < g.n) {
      const size_t off = g.row(r, cell, row, D);
      for (int d = lane & 3; d < D; d += 4) sum += to_f32(dout[off + d]) * to_f32(o[off + d]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    del_r[h] = sum;
    lse_r[h] = row < g.n ? lse[g.stat(r, cell, row)] : 0.f;
    if (half == 0 && (lane & 3) == 0 && row < g.n) delta[g.stat(r, cell, row)] = sum;
  }

  float acc[D / 8][4] = {};
  for (int it = 0; s < g.p; ++it) {
    const int buf = it & 1;
    int s2 = s, t2 = t;
    next_tile(s2, t2, g.p, range);
    if (s2 < g.p) {  // stage the next tile while this one computes
      const int src2 = (r - s2 + g.p) % g.p;
      stage_tile<D>(ks + (buf ^ 1) * T::kElems, k, g, src2, cell, t2 * kTile);
      stage_tile<D>(vs + (buf ^ 1) * T::kElems, v, g, src2, cell, t2 * kTile);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int src = (r - s + g.p) % g.p;
    const bool diag = g.causal && src == r;
    const int k0 = t * kTile;
    // a tile inside the causal and ragged edges keeps every pair
    const bool inner = !diag && k0 + kTile <= g.n && q0 + kTile <= g.n;
    const S* kb = ks + buf * T::kElems + c0 * LD;
    float sc[kCols / 8][4] = {}, dp[kCols / 8][4] = {};
    mma_abt<D>(sc, qw, kb, lane);
    mma_abt<D>(dp, dow, vs + buf * T::kElems + c0 * LD, lane);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + row0 + (e >> 1) * 8;
        const int kj = k0 + c0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = inner || (qi < g.n && kj < g.n && (!diag || kj <= qi));
        const float pv = ok ? prob(sc[j][e], g.scale, lse_r[e >> 1]) : 0.f;
        sc[j][e] = pv * (dp[j][e] - del_r[e >> 1]);  // dS
      }
    }
    mma_pb<D>(acc, sc, kb, lane);
    __syncthreads();  // buf is read before the next iteration but one refills it
    s = s2;
    t = t2;
  }

  // the tiles' space takes the halves' sum (no copy is in flight: the last
  // iteration staged none and waited for the others)
  sum_halves<D>(acc, reinterpret_cast<float*>(smem4), half, row0, lane);
  if (half == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + row0 + 8 * h;
    if (qi >= g.n) continue;
    S* out = dq + g.row(r, cell, qi, D) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j, acc[j][2 * h] * g.scale, acc[j][2 * h + 1] * g.scale);
  }
}

// ------------------------------------------------------ backward: dK, dV

template <int D, typename S>
__global__ void __launch_bounds__(kBwdThreads, BwdTile<D, S>::kMinBlocks)
    bwd_dkv_mma_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                       const S* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, S* __restrict__ dk, S* __restrict__ dv,
                       Geometry g) {
  using T = BwdTile<D, S>;
  constexpr int LD = T::kLd;
  extern __shared__ float4 smem4[];
  S* ks = reinterpret_cast<S*>(smem4);  // [kTile][LD]: this block's keys
  S* vs = ks + T::kElems;                // [kTile][LD]
  S* qs = vs + T::kElems;                // [2][kTile][LD]
  S* dos = qs + 2 * T::kElems;           // [2][kTile][LD]
  float* stats = reinterpret_cast<float*>(dos + 2 * T::kElems);  // [2][lse, D][kTile]

  const int ktile = blockIdx.x, cell = blockIdx.y, j = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = ktile * kTile;
  const int half = warp / 4, c0 = half * kCols;  // the warp's queries of a query tile
  const int row0 = (warp % 4) * 16 + (lane >> 2);  // the lane's keys: row0, row0 + 8
  const S* kw = ks + (warp % 4) * 16 * LD;
  const S* vw = vs + (warp % 4) * 16 * LD;
  const int nqt = (g.n + kTile - 1) / kTile;
  // visit s: the rank rr = (j + s) mod p; under causal none of its queries
  // sees block j when j > rr, and on the diagonal only tiles from ktile on
  const auto range = [&](int s, int& lo, int& hi) {
    const int rr = (j + s) % g.p;
    lo = g.causal && rr == j ? ktile : 0;
    hi = g.causal && j > rr ? 0 : nqt;
  };
  int s, t = 0;
  first_tile(s, t, g.p, range);
  stage_tile<D>(ks, k, g, j, cell, k0);
  stage_tile<D>(vs, v, g, j, cell, k0);
  if (s < g.p) {
    const int rr = (j + s) % g.p;
    stage_tile<D>(qs, q, g, rr, cell, t * kTile);
    stage_tile<D>(dos, dout, g, rr, cell, t * kTile);
    stage_stats(stats, lse, delta, g, rr, cell, t * kTile);
  }
  cp_async_commit();

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int it = 0; s < g.p; ++it) {
    const int buf = it & 1;
    int s2 = s, t2 = t;
    next_tile(s2, t2, g.p, range);
    if (s2 < g.p) {  // stage the next tile while this one computes
      const int rr2 = (j + s2) % g.p;
      stage_tile<D>(qs + (buf ^ 1) * T::kElems, q, g, rr2, cell, t2 * kTile);
      stage_tile<D>(dos + (buf ^ 1) * T::kElems, dout, g, rr2, cell, t2 * kTile);
      stage_stats(stats + (buf ^ 1) * 2 * kTile, lse, delta, g, rr2, cell, t2 * kTile);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int rr = (j + s) % g.p;
    const bool diag = g.causal && rr == j;
    const int q0 = t * kTile;
    // a tile inside the causal and ragged edges keeps every pair
    const bool inner = !diag && k0 + kTile <= g.n && q0 + kTile <= g.n;
    const S* qb = qs + buf * T::kElems + c0 * LD;
    const S* dob = dos + buf * T::kElems + c0 * LD;
    const float* lse_s = stats + buf * 2 * kTile + c0;
    const float* del_s = lse_s + kTile;
    // transposed scores: st[jj][e] is key row0 + 8 (e / 2) against query
    // c0 + 8 jj + 2 (lane % 4) + e % 2 of the tile
    float st[kCols / 8][4] = {}, dpt[kCols / 8][4] = {};
    mma_abt<D>(st, kw, qb, lane);
    mma_abt<D>(dpt, vw, dob, lane);
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jj * 8 + 2 * (lane & 3) + (e & 1);
        const int qi = q0 + c0 + col, kj = k0 + row0 + (e >> 1) * 8;
        const bool ok = inner || (qi < g.n && kj < g.n && (!diag || kj <= qi));
        const float pv = ok ? prob(st[jj][e], g.scale, lse_s[col]) : 0.f;
        dpt[jj][e] = pv * (dpt[jj][e] - del_s[col]);  // dS^T
        st[jj][e] = pv;                                // P^T
      }
    }
    mma_pb<D>(dva, st, dob, lane);
    mma_pb<D>(dka, dpt, qb, lane);
    __syncthreads();  // buf is read before the next iteration but one refills it
    s = s2;
    t = t2;
  }

  // the tiles' space takes the halves' sums (no copy is in flight)
  float* red = reinterpret_cast<float*>(smem4);
  sum_halves<D>(dka, red, half, row0, lane);
  sum_halves<D>(dva, red + kTile * D, half, row0, lane);
  if (half == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + row0 + 8 * h;
    if (kj >= g.n) continue;
    const size_t off = g.row(j, cell, kj, D) + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      store2(dk + off + 8 * c, dka[c][2 * h] * g.scale, dka[c][2 * h + 1] * g.scale);
      store2(dv + off + 8 * c, dva[c][2 * h], dva[c][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLdT + kTile * Cols<D>::kLdN + kTile * kLdT);
}

inline dim3 grid_of(const Geometry& g) {
  return dim3((unsigned)((g.n + kTile - 1) / kTile), (unsigned)(g.B * g.H), (unsigned)g.p);
}

template <int D, typename S>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Geometry& g, bool bidir, cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem<D>();
  auto kernel = bidir ? fwd_kernel<D, S, true> : fwd_kernel<D, S, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g), kThreads, bytes, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
      static_cast<S*>(o), lse, g);
  return cudaGetLastError();
}

template <int D, typename S>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const Geometry& g, cudaStream_t stream) {
  constexpr size_t dq_bytes = dq_mma_smem<D, S>(), dkv_bytes = dkv_mma_smem<D, S>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_mma_kernel<D, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv_mma_kernel<D, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const S* qs = static_cast<const S*>(q);
  const S* ks = static_cast<const S*>(k);
  const S* vs = static_cast<const S*>(v);
  const S* dos = static_cast<const S*>(dout);
  bwd_dq_mma_kernel<D, S><<<grid_of(g), kBwdThreads, dq_bytes, stream>>>(
      qs, ks, vs, static_cast<const S*>(o), dos, lse, delta, static_cast<S*>(dq), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_mma_kernel<D, S><<<grid_of(g), kBwdThreads, dkv_bytes, stream>>>(
      qs, ks, vs, dos, lse, delta, static_cast<S*>(dk), static_cast<S*>(dv), g);
  return cudaGetLastError();
}

inline bool geometry(int p, int B, int n, int H, int D, int causal, Geometry* g) {
  if (p < 1 || B < 1 || n < 1 || H < 1 || (long long)B * H > 65535 || p > 65535) return false;
  *g = Geometry{p, B, n, H, 1.0f / sqrtf((float)D), causal ? 1 : 0};
  return true;
}

}  // namespace attn
}  // namespace tmpi

#define TMPI_ATTN_DISPATCH(D_, FN, ...)                                           \
  switch (D_) {                                                                   \
    case 8: return (int)(dtype == tmpi::kF32 ? FN<8, float>(__VA_ARGS__)          \
                                             : FN<8, unsigned short>(__VA_ARGS__)); \
    case 16: return (int)(dtype == tmpi::kF32 ? FN<16, float>(__VA_ARGS__)        \
                                              : FN<16, unsigned short>(__VA_ARGS__)); \
    case 32: return (int)(dtype == tmpi::kF32 ? FN<32, float>(__VA_ARGS__)        \
                                              : FN<32, unsigned short>(__VA_ARGS__)); \
    case 64: return (int)(dtype == tmpi::kF32 ? FN<64, float>(__VA_ARGS__)        \
                                              : FN<64, unsigned short>(__VA_ARGS__)); \
    case 128: return (int)(dtype == tmpi::kF32 ? FN<128, float>(__VA_ARGS__)      \
                                               : FN<128, unsigned short>(__VA_ARGS__)); \
    default: return (int)cudaErrorInvalidValue;                                   \
  }

// q, k, v, o: [p, B, n, H, D] contiguous of `dtype` (tmpi::kF32 or kBF16);
// lse: [p, B, H, n] f32. bidir selects K9's visiting order.
extern "C" int tm_ring_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int dtype, int p, int B, int n, int H, int D,
                                     int causal, int bidir, void* stream) {
  using namespace tmpi::attn;
  Geometry g;
  if ((dtype != tmpi::kF32 && dtype != tmpi::kBF16) || !geometry(p, B, n, H, D, causal, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  TMPI_ATTN_DISPATCH(D, launch_fwd, q, k, v, o, l, g, bidir != 0, s)
}

// Inputs as the forward's, with o and dout of q's shape and dtype and lse
// the forward's; delta: [p, B, H, n] f32 scratch; dq, dk, dv: outputs of
// q's shape and dtype. Two launches: dQ (which writes delta), then dK/dV.
extern "C" int tm_ring_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, int dtype,
                                     int p, int B, int n, int H, int D, int causal,
                                     void* stream) {
  using namespace tmpi::attn;
  Geometry g;
  if ((dtype != tmpi::kF32 && dtype != tmpi::kBF16) || !geometry(p, B, n, H, D, causal, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* del = static_cast<float*>(delta);
  TMPI_ATTN_DISPATCH(D, launch_bwd, q, k, v, o, dout, l, del, dq, dk, dv, g, s)
}
