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
//   P = exp(S - lse), D = rowsum(dO * O), dS = P * (dP - D).
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
// Design. A block of 256 threads owns one 64-row tile of queries (forward,
// dQ) or keys (dK/dV) of one cell of one rank, and walks the visiting
// blocks in ring order in 64-row tiles, staged through shared memory as
// f32. Each thread holds a 4 x 4 tile of the 64 x 64 score block and a
// 4 x D/16 tile of the output rows in registers; the 16 threads of a
// half-warp share rows, so row maxima and sums are shuffles. The products
// are plain f32 FMAs (no tensor cores: the JAX kernel's f32 dot products).
// A key tile is merged with the online softmax; the JAX kernel merges a
// whole block at once, so results agree to rounding, not bit for bit.
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
// Backward. Two launches and no atomics: the dQ launch (grid over rank,
// cell, query tile) first writes D for its rows, then accumulates
// dS K over the visiting blocks src = (r - s) mod p; the dK/dV launch
// (grid over block j, cell, key tile) accumulates P^T dO and dS^T Q over
// the visiting ranks in ring order (j + s) mod p, s = 0..p-1, the order in
// which the JAX accumulators ride the ring home. Each launch recomputes S
// and dP for its own tiles.
//
// Bound: operations. At the LM path's shape ([4, 4, 1024, 8, 64] f32,
// causal) the forward needs 4 d flops per (query, key) pair the mask
// keeps, 69 GFLOP (1.03 ms at 67 TFLOP/s f32), against 134 MB of q/k/v/o
// (0.04 ms at 3.35 TB/s); the backward needs 10 d per pair. The design
// keeps every score in registers and shared memory, so device memory sees
// only the tiles; the 4 x 4 register tiles read two shared-memory float4s
// per 16 FMAs. Tensor cores (tf32 or bf16 wgmma) are the lever of a later
// change.
//
// Every entry point returns cudaGetLastError() so the wrapper can raise on
// a refused launch.
#include "common.cuh"

namespace tmpi {
namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTile = 64;  // queries per query tile, keys per key tile
constexpr int kPad = 4;    // keeps rows 16-byte aligned
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

// --------------------------------------------------------- backward: dQ

template <int D, typename S>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                  const S* __restrict__ o, const S* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  S* __restrict__ dq, Geometry g) {
  constexpr int OC = Cols<D>::kOC, LDN = Cols<D>::kLdN;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLdT]
  float* dot = qt + D * kLdT;                    // [D][kLdT]
  float* kt = dot + D * kLdT;                    // [D][kLdT]
  float* vt = kt + D * kLdT;                     // [D][kLdT]
  float* kn = vt + D * kLdT;                     // [kTile][LDN]
  float* dst = kn + kTile * LDN;                 // [kTile keys][kLdT queries]
  float* lse_s = dst + kTile * kLdT;             // [kTile]
  float* del_s = lse_s + kTile;                  // [kTile]

  const int qtile = blockIdx.x, cell = blockIdx.y, r = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qtile * kTile;
  load_tile<D>(qt, nullptr, q, g, r, cell, q0);
  load_tile<D>(dot, nullptr, dout, g, r, cell, q0);
  // D = rowsum(dO * O) for this tile's rows, kept for the dK/dV launch
  for (int i = warp; i < kTile; i += kThreads / 32) {
    const int row = q0 + i;
    float sum = 0.f;
    if (row < g.n) {
      const size_t off = g.row(r, cell, row, D);
      for (int d = lane; d < D; d += 32) sum += to_f32(dout[off + d]) * to_f32(o[off + d]);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) {
      del_s[i] = sum;
      lse_s[i] = row < g.n ? lse[g.stat(r, cell, row)] : 0.f;
      if (row < g.n) delta[g.stat(r, cell, row)] = sum;
    }
  }
  __syncthreads();
  float lse_r[4], del_r[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    lse_r[ii] = lse_s[ty * 4 + ii];
    del_r[ii] = del_s[ty * 4 + ii];
  }

  float acc[4][OC] = {};
  for (int s = 0; s < g.p; ++s) {
    const int src = (r - s + g.p) % g.p;
    const int ntiles = key_tiles(g, r, src, qtile);
    const bool diag = g.causal && src == r;
    for (int ktile = 0; ktile < ntiles; ++ktile) {
      const int k0 = ktile * kTile;
      __syncthreads();
      load_tile<D>(kt, kn, k, g, src, cell, k0);
      load_tile<D>(vt, nullptr, v, g, src, cell, k0);
      __syncthreads();
      float sc[4][4] = {}, dp[4][4] = {};
      mma_tt<D>(sc, qt, kt, ty, tx);
      mma_tt<D>(dp, dot, vt, ty, tx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int qi = q0 + ty * 4 + ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kj = k0 + tx * 4 + jj;
          const bool ok = qi < g.n && kj < g.n && (!diag || kj <= qi);
          const float pv = ok ? expf(sc[ii][jj] * g.scale - lse_r[ii]) : 0.f;
          dst[(tx * 4 + jj) * kLdT + ty * 4 + ii] = pv * (dp[ii][jj] - del_r[ii]);
        }
      }
      __syncthreads();
      mma_tn<D>(acc, dst, kn, ty, tx);
    }
  }

  if (tx * OC < D) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int qi = q0 + ty * 4 + ii;
      if (qi >= g.n) continue;
      S* row = dq + g.row(r, cell, qi, D) + tx * OC;
#pragma unroll
      for (int cc = 0; cc < OC; ++cc) row[cc] = from_f32<S>(acc[ii][cc] * g.scale);
    }
  }
}

// ------------------------------------------------------ backward: dK, dV

template <int D> struct DkvSmem {
  // the transposed q and dO tiles are reused for P and dS once S and dP
  // are in registers, so each region holds the larger of the two
  static constexpr int kRegion = (D > kTile ? D : kTile) * kLdT;
  static constexpr int kFloats =
      2 * D * kLdT + 2 * kRegion + 2 * kTile * Cols<D>::kLdN + 2 * kTile;
};

template <int D, typename S>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
                   const S* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, S* __restrict__ dk, S* __restrict__ dv,
                   Geometry g) {
  constexpr int OC = Cols<D>::kOC, LDN = Cols<D>::kLdN;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][kLdT]: this block's keys
  float* vt = kt + D * kLdT;                     // [D][kLdT]
  float* qt = vt + D * kLdT;                     // [D][kLdT], then P as [kTile q][kLdT k]
  float* dot = qt + DkvSmem<D>::kRegion;         // [D][kLdT], then dS as [kTile q][kLdT k]
  float* qn = dot + DkvSmem<D>::kRegion;         // [kTile][LDN]
  float* don = qn + kTile * LDN;                 // [kTile][LDN]
  float* lse_s = don + kTile * LDN;              // [kTile]
  float* del_s = lse_s + kTile;                  // [kTile]
  float* ps = qt;
  float* dss = dot;

  const int ktile = blockIdx.x, cell = blockIdx.y, j = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = ktile * kTile;
  load_tile<D>(kt, nullptr, k, g, j, cell, k0);
  load_tile<D>(vt, nullptr, v, g, j, cell, k0);

  float dka[4][OC] = {}, dva[4][OC] = {};
  const int nqt = (g.n + kTile - 1) / kTile;
  for (int s = 0; s < g.p; ++s) {
    const int rr = (j + s) % g.p;  // the rank visiting block j at step s
    if (g.causal && j > rr) continue;  // every query of rr is before block j
    const bool diag = g.causal && rr == j;
    for (int qtile = diag ? ktile : 0; qtile < nqt; ++qtile) {
      const int q0 = qtile * kTile;
      __syncthreads();  // the previous tile's P, dS, qn and don are consumed
      load_tile<D>(qt, qn, q, g, rr, cell, q0);
      load_tile<D>(dot, don, dout, g, rr, cell, q0);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < g.n ? lse[g.stat(rr, cell, row)] : 0.f;
        del_s[threadIdx.x] = row < g.n ? delta[g.stat(rr, cell, row)] : 0.f;
      }
      __syncthreads();
      // transposed scores: st[ii][jj] is key ty*4+ii against query tx*4+jj
      float st[4][4] = {}, dpt[4][4] = {};
      mma_tt<D>(st, kt, qt, ty, tx);
      mma_tt<D>(dpt, vt, dot, ty, tx);
      float pv[4][4], dsv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qi = q0 + tx * 4 + jj;
        const float lse_q = lse_s[tx * 4 + jj], del_q = del_s[tx * 4 + jj];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int kj = k0 + ty * 4 + ii;
          const bool ok = qi < g.n && kj < g.n && (!diag || kj <= qi);
          pv[ii][jj] = ok ? expf(st[ii][jj] * g.scale - lse_q) : 0.f;
          dsv[ii][jj] = pv[ii][jj] * (dpt[ii][jj] - del_q);
        }
      }
      __syncthreads();  // qt and dot are read: their space takes P and dS
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qrow = (tx * 4 + jj) * kLdT + ty * 4;
        *reinterpret_cast<float4*>(ps + qrow) =
            make_float4(pv[0][jj], pv[1][jj], pv[2][jj], pv[3][jj]);
        *reinterpret_cast<float4*>(dss + qrow) =
            make_float4(dsv[0][jj], dsv[1][jj], dsv[2][jj], dsv[3][jj]);
      }
      __syncthreads();
      mma_tn<D>(dva, ps, don, ty, tx);
      mma_tn<D>(dka, dss, qn, ty, tx);
    }
  }

  if (tx * OC < D) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int kj = k0 + ty * 4 + ii;
      if (kj >= g.n) continue;
      const size_t off = g.row(j, cell, kj, D) + tx * OC;
#pragma unroll
      for (int cc = 0; cc < OC; ++cc) {
        dk[off + cc] = from_f32<S>(dka[ii][cc] * g.scale);
        dv[off + cc] = from_f32<S>(dva[ii][cc]);
      }
    }
  }
}

// ------------------------------------------------------------ launchers

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLdT + kTile * Cols<D>::kLdN + kTile * kLdT);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLdT + kTile * Cols<D>::kLdN + kTile * kLdT + 2 * kTile);
}
template <int D> constexpr size_t dkv_smem() { return sizeof(float) * DkvSmem<D>::kFloats; }

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
  constexpr size_t dq_bytes = dq_smem<D>(), dkv_bytes = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<D, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv_kernel<D, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const S* qs = static_cast<const S*>(q);
  const S* ks = static_cast<const S*>(k);
  const S* vs = static_cast<const S*>(v);
  const S* dos = static_cast<const S*>(dout);
  bwd_dq_kernel<D, S><<<grid_of(g), kThreads, dq_bytes, stream>>>(
      qs, ks, vs, static_cast<const S*>(o), dos, lse, delta, static_cast<S*>(dq), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<D, S><<<grid_of(g), kThreads, dkv_bytes, stream>>>(
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
