// Ring attention over virtual ranks on one card, f32 inputs: the forward
// (K8), the bidirectional forward (K9) and the analytic backward (K10).
// bf16 inputs take ring_attention_bf16.cu's kernels, on the bf16 tensor
// cores.
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
// f32: scale 1/sqrt(d), causal masking by global positions,
// l = max(l, 1e-30), o = acc / l, lse = m + log(l).
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
// Forward (K8, K9), on the tensor cores: fwd_mma_kernel. A block of 8
// warps owns 128 query rows of one cell of one rank (layout A, 4 warps
// over 64 rows, was 12% slower at the LM shape on an H100), and walks the
// visiting blocks in 64-key tiles. Each warp holds 16 query rows against
// all 64 columns of a key tile, so the online softmax's row max and row
// sum stay in the lane quad that holds a row: two shuffles for the max,
// and each lane keeps its own share of the sum until the end. S = Q K^T (mma_abt,
// Q's fragments read again from shared memory each tile) and O += P V
// (mma_pb, P fed from S's accumulator registers) run as mma.sync m16n8k8
// with TF32 operands by the precision rule below; each tile's P V is
// summed fresh and added in f32. The softmax runs in the log2 domain
// (x = s scale log2 e, P = 2^(x - m) by ex2.approx) with a mask-free path
// for tiles inside the causal and ragged edges; on the diagonal a warp
// skips a key tile past its last query. K and V are staged by 16-byte
// cp.async copies into a second buffer while the current tile computes,
// and the heaviest query tiles (later ranks, later rows) launch first. A
// key tile is merged with the online softmax; the JAX kernel merges a
// whole block at once, so results agree to rounding, not bit for bit.
// Bound: operations, 4 d flops per (query, key) pair the mask keeps (68.7
// GFLOP at the LM path's [4, 4, 1024, 8, 64] f32 causal): 0.42 ms at
// 495 / 3 = 165 TFLOP/s under 3xTF32, against 1.03 ms at the 67 TFLOP/s of
// f32 FMAs. The design spends its instructions on the MMAs and on
// splitting operands, and keeps two blocks (16 warps) an SM up to D = 64,
// which caps the registers at 128 a thread: at D = 64 ptxas (chip_smoke.py
// prints its report) finds 136 bytes of spill stores. Capping at one
// block an SM (no spill) or halving mma_pb's fresh accumulator (more
// spill) was slower on an H100.
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
// (atol and rtol 2e-4) that hold K10 to its plain version, and the
// forward's o and lse miss theirs (atol 2e-5 and 1e-4) as well
// (tests/test_torch_tf32.py). So each f32 operand x is split when its
// fragment is loaded into big = tf32_rna(x) and small = tf32_rna(x - big),
// and a product takes three MMAs, a_big b_small + a_small b_big first, then
// a_big b_big: the arithmetic of CUTLASS's OpMultiplyAddFastF32, about f32
// accuracy.
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
// spill stores in the dK/dV launch, whose dK and dV accumulators take 64
// of the 128 registers. The same launch at one block
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
constexpr int kTile = 64;  // keys per key tile; queries per query tile of the backward

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

// The rank whose K/V block rank r merges at visit i (0 <= i < p).
__device__ __forceinline__ int visit_src(int r, int i, int p, bool bidir) {
  if (!bidir || i == 0) return (r - i + p) % p;
  const int t = (i + 1) / 2;  // odd i: the R chain's step t; even i: the L chain's
  return (i & 1) ? (r - t + p) % p : (r + t) % p;
}

// Key tiles of block src that the queries of rank r before q_end (a query
// tile's end) need: all of them, none (causal, src > r), or those up to the
// diagonal (src == r).
__device__ __forceinline__ int key_tiles(const Geometry& g, int r, int src, int q_end) {
  const int all = (g.n + kTile - 1) / kTile;
  if (!g.causal || src < r) return all;
  if (src > r) return 0;
  const int need = (q_end + kTile - 1) / kTile;
  return need < all ? need : all;
}

// ------------------------------------------------------ tensor-core pieces

// A block of the backward: 8 warps over kTile rows; warp w owns the 16 rows
// 16 (w % 4) .. of the tile and the half w / 4 of each visited tile's
// kTile columns (kCols of them), so two warps hold partial sums of the same
// rows, added once at the end (sum_halves).
constexpr int kColSplit = 2;
constexpr int kCols = kTile / kColSplit;
constexpr int kBwdWarps = 4 * kColSplit;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile in shared memory: kTile rows of D elements of S in their natural
// layout, each row padded by 16 bytes (which keeps the rows 16-byte
// aligned for cp.async and the fragment reads free of bank conflicts).
template <int D, typename S> struct SmemTile {
  static constexpr int kLd = D + 16 / (int)sizeof(S);
  static constexpr int kElems = kTile * kLd;
  static constexpr int kChunks = D * (int)sizeof(S) / 16;  // 16-byte copies a row
  // backward blocks an SM should hold: two up to D = 64 (16 warps; the
  // registers are then capped at 128 a thread), one at D = 128, whose dK
  // and dV accumulators alone take 128
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The TF32 terms of N fragment registers: big = tf32_rna(x) and
// small = tf32_rna(x - big).
template <int N> struct Frag {
  uint32_t big[N], small[N];
};
template <int N>
__device__ __forceinline__ void set_terms(Frag<N>& f, int i, float x) {
  f.big[i] = tf32_rna(x);
  f.small[i] = tf32_rna(x - __uint_as_float(f.big[i]));
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

// 2^x by the hardware's approximation (2^-1e29 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(s * scale - lse)
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return ex2((s * scale - lse) * kLog2e);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on the tensor cores as 3xTF32, the small terms first.
__device__ __forceinline__ void mma_terms(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// c[j] += (A B^T)[rows, 8j .. 8j + 7] over k < D, for a warp's 16 rows and
// 8 kSteps columns: a is the warp's 16 rows and b the 8 kSteps column rows,
// both natural tiles. Lane (g, t) = (lane / 4, lane % 4) holds A's rows g and
// g + 8, columns t and t + 4 of each k step, and B's row (= product
// column) g, columns t and t + 4; c[j] holds rows g, g + 8, columns 2t,
// 2t + 1 of step j. The tiles are read by ldmatrix, four sub-tiles at a
// time.
template <int D, typename S, int kSteps>
__device__ __forceinline__ void mma_abt(float (&c)[kSteps][4], const S* a, const S* b,
                                        int lane) {
  static_assert(kSteps % 2 == 0, "ldmatrix reads two column steps of B at a time");
  constexpr int LD = SmemTile<D, S>::kLd;
  static_assert(std::is_same<S, float>::value,
                "f32 tiles; bf16 inputs take ring_attention_bf16.cu");
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
    for (int e = 0; e < 4; ++e) set_terms(fa, e, __uint_as_float(ra[e]));
#pragma unroll
    for (int j = 0; j < kSteps; j += 2) {
      uint32_t rb[4];
      ldsm4(rb, pb + j * 8 * LD + k);
      Frag<2> f0, f1;
      set_terms(f0, 0, __uint_as_float(rb[0]));
      set_terms(f0, 1, __uint_as_float(rb[1]));
      set_terms(f1, 0, __uint_as_float(rb[2]));
      set_terms(f1, 1, __uint_as_float(rb[3]));
      mma_terms(c[j], fa, f0);
      mma_terms(c[j + 1], fa, f1);
    }
  }
}

// c[j] += (P B)[rows, 8j .. 8j + 7] over the 8 kSteps columns of P, for a
// warp's 16 rows and D output columns. p holds P (or dS) as mma_abt left
// it: rows g, g + 8, columns 2t, 2t + 1 of each 8-column step. It is fed as
// A with the step's k permuted, slot t taking column 2t and slot t + 4
// column 2t + 1 (A's registers are then p's, reordered), so B's fragment
// reads rows 2t and 2t + 1 of the step, column g. b: 8 kSteps natural rows of
// B. P and B are both split (3xTF32). The tile's sum is taken in a fresh
// accumulator and added to c with an f32 add: the
// tensor cores truncate as they accumulate, and a sum carried through them
// over a whole ring drifts (the note at the top).
template <int D, typename S, int kSteps>
__device__ __forceinline__ void mma_pb(float (&c)[D / 8][4], const float (&p)[kSteps][4],
                                       const S* b, int lane) {
  constexpr int LD = SmemTile<D, S>::kLd;
  const S* bcol = b + 2 * (lane & 3) * LD + (lane >> 2);
  float tile[D / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    Frag<4> fa;
    set_terms(fa, 0, p[kk][0]);
    set_terms(fa, 1, p[kk][2]);
    set_terms(fa, 2, p[kk][1]);
    set_terms(fa, 3, p[kk][3]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      Frag<2> fb;
      set_terms(fb, 0, bcol[kk * 8 * LD + j * 8]);
      set_terms(fb, 1, bcol[(kk * 8 + 1) * LD + j * 8]);
      mma_terms(tile[j], fa, fb);
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

// Rows [row0, row0 + kRows) of (r, cell) into the natural tile t by 16-byte
// cp.async copies from the block's kThreads threads; rows past n are
// zero-filled.
template <int D, typename S, int kThreads = kBwdThreads, int kRows = kTile>
__device__ __forceinline__ void stage_tile(S* t, const S* src, const Geometry& g, int r,
                                           int cell, int row0) {
  using T = SmemTile<D, S>;
  constexpr int kPer = 16 / (int)sizeof(S);
  const S* base = src + g.row(r, cell, 0, D);
  const size_t stride = (size_t)g.H * D;
  for (int e = threadIdx.x; e < kRows * T::kChunks; e += kThreads) {
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

// ------------------------------------------------------------- forward

// The forward's block: 8 warps over 128 query rows; each warp owns 16 rows
// against all kTile columns of every key tile, so a row's running max and
// sum stay in the four lanes that hold it.
template <int D, typename S> struct FwdBlock {
  static constexpr int kWarps = 8, kRows = 16 * kWarps, kThreads = 32 * kWarps;
  // q, two k and two v tiles
  static constexpr size_t kSmem = (kRows + 4 * kTile) * SmemTile<D, S>::kLd * sizeof(S);
  // up to D = 64 two blocks fit an SM's shared memory; at 8 warps that caps
  // the registers at 128 a thread
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

template <int D, typename S, bool kBidir>
__global__ void __launch_bounds__(FwdBlock<D, S>::kThreads, FwdBlock<D, S>::kMinBlocks)
    fwd_mma_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                   S* __restrict__ o, float* __restrict__ lse, Geometry g) {
  using T = SmemTile<D, S>;
  using F = FwdBlock<D, S>;
  constexpr int LD = T::kLd;
  extern __shared__ float4 smem4[];
  S* qs = reinterpret_cast<S*>(smem4);  // [kRows][LD]
  S* ks = qs + F::kRows * LD;            // [2][kTile][LD]
  S* vs = ks + 2 * T::kElems;            // [2][kTile][LD]

  // the heaviest blocks first: a later rank's later query tile sees more keys
  const int qtile = gridDim.x - 1 - blockIdx.x, cell = blockIdx.y;
  const int r = gridDim.z - 1 - blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qtile * F::kRows;
  const int w0 = q0 + 16 * warp;  // the warp's first query; the lane's are
  const int row = w0 + (lane >> 2);  // row and row + 8
  const S* qw = qs + 16 * warp * LD;
  const auto range = [&](int s, int& lo, int& hi) {
    lo = 0;
    hi = key_tiles(g, r, visit_src(r, s, g.p, kBidir), q0 + F::kRows);
  };
  int s, t = 0;
  first_tile(s, t, g.p, range);
  stage_tile<D, S, F::kThreads, F::kRows>(qs, q, g, r, cell, q0);
  if (s < g.p) {
    const int src = visit_src(r, s, g.p, kBidir);
    stage_tile<D, S, F::kThreads>(ks, k, g, src, cell, t * kTile);
    stage_tile<D, S, F::kThreads>(vs, v, g, src, cell, t * kTile);
  }
  cp_async_commit();

  // The online softmax in the log2 domain: x = s scale log2(e), m the
  // running max of x, P = 2^(x - m). Each lane keeps its own share of a
  // row's sum l (the quad's four are added at the end) and of its output
  // columns in acc.
  const float c = g.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4] = {};
  for (int it = 0; s < g.p; ++it) {
    const int buf = it & 1;
    int s2 = s, t2 = t;
    next_tile(s2, t2, g.p, range);
    if (s2 < g.p) {  // stage the next tile while this one computes
      const int src2 = visit_src(r, s2, g.p, kBidir);
      stage_tile<D, S, F::kThreads>(ks + (buf ^ 1) * T::kElems, k, g, src2, cell, t2 * kTile);
      stage_tile<D, S, F::kThreads>(vs + (buf ^ 1) * T::kElems, v, g, src2, cell, t2 * kTile);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const bool diag = g.causal && visit_src(r, s, g.p, kBidir) == r;
    const int k0 = t * kTile;
    // on the diagonal a key tile past the warp's last query is all masked:
    // merging it would change nothing (alpha 1, P 0)
    if (!diag || k0 <= w0 + 15) {
      float sc[kTile / 8][4] = {};
      mma_abt<D>(sc, qw, ks + buf * T::kElems, lane);
      // a tile inside the causal and ragged edges keeps every pair; a
      // masked score is kNegInf, whose P is 0
      const bool inner = k0 + kTile <= g.n && (!diag || k0 + kTile - 1 <= w0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!inner) {
            const int kj = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
            if (kj >= g.n || (diag && kj > row + 8 * (e >> 1))) sc[j][e] = kNegInf;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * c);  // c > 0: max(s) c = max(s c)
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(fmaf(sc[j][e], c, -m[e >> 1]));  // P
          l[e >> 1] += sc[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      mma_pb<D>(acc, sc, vs + buf * T::kElems, lane);
    }
    __syncthreads();  // buf is read before the next iteration but one refills it
    s = s2;
    t = t2;
  }

  // the epilogue: l = max(l, 1e-30), o = acc / l, lse = m + log(l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row + 8 * h;
    if (qi >= g.n) continue;
    const float li = fmaxf(l[h], 1e-30f);
    S* out = o + g.row(r, cell, qi, D) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(out + 8 * j, acc[j][2 * h] / li, acc[j][2 * h + 1] / li);
    if ((lane & 3) == 0) lse[g.stat(r, cell, qi)] = m[h] * kLn2 + logf(li);
  }
}

// --------------------------------------------------------- backward: dQ

template <int D, typename S> constexpr size_t dq_mma_smem() {
  return 6 * SmemTile<D, S>::kElems * sizeof(S);  // q, dO, two k and two v tiles
}
template <int D, typename S> constexpr size_t dkv_mma_smem() {
  return dq_mma_smem<D, S>() + 4 * kTile * sizeof(float);  // and two lse/D stages
}

template <int D, typename S>
__global__ void __launch_bounds__(kBwdThreads, SmemTile<D, S>::kMinBlocks)
    bwd_dq_mma_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                      const S* __restrict__ o, const S* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      S* __restrict__ dq, Geometry g) {
  using T = SmemTile<D, S>;
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
    hi = key_tiles(g, r, (r - s + g.p) % g.p, q0 + kTile);
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
      for (int d = lane & 3; d < D; d += 4) sum += dout[off + d] * o[off + d];
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
__global__ void __launch_bounds__(kBwdThreads, SmemTile<D, S>::kMinBlocks)
    bwd_dkv_mma_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                       const S* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, S* __restrict__ dk, S* __restrict__ dv,
                       Geometry g) {
  using T = SmemTile<D, S>;
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

// (query tile, cell, rank) blocks of `rows` queries each
inline dim3 grid_of(const Geometry& g, int rows) {
  return dim3((unsigned)((g.n + rows - 1) / rows), (unsigned)(g.B * g.H), (unsigned)g.p);
}

template <int D, typename S>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Geometry& g, bool bidir, cudaStream_t stream) {
  using F = FwdBlock<D, S>;
  auto kernel = bidir ? fwd_mma_kernel<D, S, true> : fwd_mma_kernel<D, S, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g, F::kRows), F::kThreads, F::kSmem, stream>>>(
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
  bwd_dq_mma_kernel<D, S><<<grid_of(g, kTile), kBwdThreads, dq_bytes, stream>>>(
      qs, ks, vs, static_cast<const S*>(o), dos, lse, delta, static_cast<S*>(dq), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_mma_kernel<D, S><<<grid_of(g, kTile), kBwdThreads, dkv_bytes, stream>>>(
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

#define TMPI_ATTN_DISPATCH(D_, FN, ...)                 \
  switch (D_) {                                         \
    case 8: return (int)FN<8, float>(__VA_ARGS__);      \
    case 16: return (int)FN<16, float>(__VA_ARGS__);    \
    case 32: return (int)FN<32, float>(__VA_ARGS__);    \
    case 64: return (int)FN<64, float>(__VA_ARGS__);    \
    case 128: return (int)FN<128, float>(__VA_ARGS__);  \
    default: return (int)cudaErrorInvalidValue;         \
  }

// q, k, v, o: [p, B, n, H, D] contiguous of `dtype` (tmpi::kF32; bf16
// inputs take tm_ring_attention_bf16_fwd); lse: [p, B, H, n] f32. bidir
// selects K9's visiting order.
extern "C" int tm_ring_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int dtype, int p, int B, int n, int H, int D,
                                     int causal, int bidir, void* stream) {
  using namespace tmpi::attn;
  Geometry g;
  if (dtype != tmpi::kF32 || !geometry(p, B, n, H, D, causal, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  TMPI_ATTN_DISPATCH(D, launch_fwd, q, k, v, o, l, g, bidir != 0, s)
}

// Inputs as the forward's (f32; bf16 inputs take
// tm_ring_attention_bf16_bwd), with o and dout of q's shape and dtype and
// lse the forward's; delta: [p, B, H, n] f32 scratch; dq, dk, dv: outputs of
// q's shape and dtype. Two launches: dQ (which writes delta), then dK/dV.
extern "C" int tm_ring_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, int dtype,
                                     int p, int B, int n, int H, int D, int causal,
                                     void* stream) {
  using namespace tmpi::attn;
  Geometry g;
  if (dtype != tmpi::kF32 || !geometry(p, B, n, H, D, causal, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* del = static_cast<float*>(delta);
  TMPI_ATTN_DISPATCH(D, launch_bwd, q, k, v, o, dout, l, del, dq, dk, dv, g, s)
}
