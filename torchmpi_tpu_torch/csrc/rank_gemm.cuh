// The mainloop of the per-rank kernels (csrc/conv_wgrad.cu, csrc/rank_bmm.cu):
// a block computes a BM x BN tile of one rank's product C = A B over one
// slice of K, on the tensor cores as 3xTF32, its operands brought into a
// ring of shared-memory stages by cp.async.
//
// Precision. A rank's result must be f32-accurate (the per-rank kernels
// exist so that a rank's gradient is the same bits whatever the stack, and
// the f32 plain versions sum in f32), so each operand x enters as two TF32
// terms, big = rna(x) and small = rna(x - big), and each 8-deep step adds
// the three products big*small, small*big and big*big, the small ones
// first (the product small*small, below 2^-22 of |x y|, is dropped). One
// TF32 term keeps about 11 bits, 1e-3 of a product: tests/
// test_torch_rank_gemm_3xtf32.py shows it missing a 1e-5 limit where
// three terms hold 1e-6. The tensor cores' f32 accumulation is not
// documented to round to nearest, so a stage's products (32 deep) go
// into a zeroed register tile and each stage's tile is added to the
// block's sums by an FADD: the tensor cores never carry a long sum.
//
// Order. Every output element sums its K products in an order fixed by the
// shape alone: the slices of K (ops/rank_gemm.py:plan, from M, N and K,
// never from R), 32-deep stages in increasing k within a slice, the three
// terms of each 8-deep step. The tensor cores compute an element from its
// row of A and its column of B alone, so the position of a tile, the rank,
// the number of ranks a launch holds and the way an operand was copied
// (16 or 4 bytes, which layout in shared memory) change no bit. Slices are
// added in slice order 0..S-1 by the last block of a tile to finish (an
// atomic ticket picks which block adds, never the order), which then sets
// the ticket back to 0: the ticket buffer is zeroed once when it is made
// and never again.
//
// Shared memory. An operand's tile is kept "k-major" ([rows][40]: 32 k a
// row, 8 floats of padding) when it is read along k in device memory, and
// "mn-major" ([32 k][rows + 4]) when it is read along its rows. The k of an
// 8-deep step are permuted (fragment slot t takes k = 2t, slot t + 4 takes
// 2t + 1, the same for A and B), so a k-major fragment pair is one 8-byte
// load; both strides keep the fragment loads free of bank conflicts. A
// stage is one barrier: wait for the oldest copies, sync, issue the copies
// of the stage kStages - 1 ahead, compute.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rank_gemm {

constexpr int kBK = 32;         // depth of a stage
constexpr int kLdK = kBK + 8;   // a k-major row: 40 floats (8-byte pairs conflict-free)

// The block tiles (BM x BN) the plan chooses from: BM in {16, 32, 48, 64}
// (mma's 16-row step), BN in {32, 64, 128}; a warp computes 16 MT x 8 NT.
template <int BM, int BN> struct Tile {
  static constexpr int kMT = BM == 64 ? 2 : 1;
  static constexpr int kNT = (BM == 16 || BN == 32) ? 2 : 4;
  static constexpr int kWM = BM / (16 * kMT);
  static constexpr int kWN = BN / (8 * kNT);
  static constexpr int kWarps = kWM * kWN;
  static constexpr int kThreads = 32 * kWarps;
  // blocks an SM should hold (each warp's sums and fragments fit in 128
  // registers), and stages: two 64 x 128 blocks take 3 stages each
  static constexpr int kMinBlocks = 2;
  static constexpr int kStages = BM * BN >= 64 * 128 ? 3 : 4;
  static_assert(kWM * 16 * kMT == BM && kWN * 8 * kNT == BN, "tile");
};

// Floats of an operand's stage tile of `rows` rows in either layout.
template <int ROWS, bool KMAJOR> struct Layout {
  static constexpr int kFloats = KMAJOR ? ROWS * kLdK : kBK * (ROWS + 4);
  // element (i, k) of the tile
  __device__ __forceinline__ static int at(int i, int k) {
    return KMAJOR ? i * kLdK + k : k * (ROWS + 4) + i;
  }
};

template <int BM, int BN, bool AK, bool BKM> struct Smem {
  static constexpr int kA = Layout<BM, AK>::kFloats;
  static constexpr int kB = Layout<BN, BKM>::kFloats;
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = kStage * Tile<BM, BN>::kStages * (int)sizeof(float);
};

// ---- 3xTF32 on the tensor cores (csrc/ring_attention.cu's scheme, the split
// done in integer operations)

// big = x rounded to TF32, to nearest with ties away from zero (half a
// TF32 ulp added to the bits, the 13 low bits cleared: cvt.rna.tf32.f32's
// rounding in two integer operations, where the instruction costs five),
// small = x - big, exact in f32. small enters the tensor cores as it is:
// they read a TF32 operand's top 19 bits, so it is truncated to TF32 there
// (within 2^-21 of |x|). A value within half a TF32 ulp of the largest f32
// rounds to inf, which no gradient of the paths comes near.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- asynchronous copies

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// one float, or a zero where !valid (src is then not read)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N> __device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- a strided operand: element (i, k) at p[i * si + k * sk], i < extent

// Copies the stage's tile (rows i0 .. i0 + ROWS - 1, k0 .. k0 + 31) into
// `tile`, zeros outside i < extent and k < k_end. With `vec` the unit axis
// (k for a k-major tile, i for an mn-major one) moves 16 bytes a copy
// (the caller checked that the unit stride is 1 and every other stride and
// the base are 16-byte aligned); a chunk across the ragged edge, and every
// element without `vec`, moves 4 bytes. Neighbouring threads take
// neighbouring addresses along the unit axis, and a thread's copies of a
// stage lie a fixed number of lines apart, so it keeps one address and
// one stride (kept per copy they took more registers than the block has).
template <int ROWS, int THREADS, bool KMAJOR> struct Strided {
  // copies of W floats: a line holds kPer of them along the unit axis
  template <int W> struct Grain {
    static constexpr int kPer = (KMAJOR ? kBK : ROWS) / W;
    static constexpr int kCount = ROWS * kBK / W;
    static constexpr int kQ = (kCount + THREADS - 1) / THREADS;  // copies a thread
    static constexpr int kLines = THREADS / kPer;  // lines between a thread's copies
    static constexpr int kDst = KMAJOR ? kLines * kLdK : kLines * (ROWS + 4);
    static_assert(THREADS % kPer == 0, "a thread's copies share their unit-axis offset");
  };
  const float* p;
  long long si, sk;
  int extent, i0;
  bool vec;
  // the thread's first copy: its address at k = 0, its tile offset, its k
  // within the stage and its room along i; copy q lies q * kLines further
  const float* at0;
  long long line_step;
  int dst0, kk0, room0;

  template <int W> __device__ __forceinline__ void prepare_for() {
    using G = Grain<W>;
    const int line = threadIdx.x / G::kPer, c = W * (threadIdx.x % G::kPer);
    const int i = KMAJOR ? line : c;
    kk0 = KMAJOR ? c : line;
    dst0 = Layout<ROWS, KMAJOR>::at(i, kk0);
    at0 = p + (long long)(i0 + i) * si + (long long)kk0 * sk;
    line_step = (long long)G::kLines * (KMAJOR ? si : sk);
    room0 = extent - (i0 + i);
  }

  __device__ __forceinline__ void prepare() {
    if (vec) {
      prepare_for<4>();
    } else {
      prepare_for<1>();
    }
  }

  // room along the unit axis of copy q: k for a k-major tile (its row in
  // range), i for an mn-major one (its k in range)
  template <int W> __device__ __forceinline__ int room(int q, int k0, int k_end) const {
    constexpr int kLines = Grain<W>::kLines;
    return KMAJOR ? (room0 - q * kLines > 0 ? k_end - (k0 + kk0) : 0)
                  : (k0 + kk0 + q * kLines < k_end ? room0 : 0);
  }

  __device__ __forceinline__ void load(float* tile, int k0, int k_end) const {
    const float* src = at0 + (long long)k0 * sk;
    if (vec) {
      using G = Grain<4>;
#pragma unroll
      for (int q = 0; q < G::kQ; ++q, src += line_step) {
        if (G::kCount % THREADS != 0 && (int)threadIdx.x + q * THREADS >= G::kCount) break;
        float* dst = tile + dst0 + q * G::kDst;
        const int n = room<4>(q, k0, k_end);
        if (n >= 4 || n <= 0) {
          cp16(dst, n > 0 ? src : p, n > 0);
        } else {  // the ragged edge: the unit axis is contiguous in the tile too
#pragma unroll
          for (int u = 0; u < 4; ++u) cp4(dst + u, u < n ? src + u : p, u < n);
        }
      }
    } else {
      using G = Grain<1>;
#pragma unroll
      for (int q = 0; q < G::kQ; ++q, src += line_step) {
        if (G::kCount % THREADS != 0 && (int)threadIdx.x + q * THREADS >= G::kCount) break;
        const bool ok = room<1>(q, k0, k_end) > 0;
        cp4(tile + dst0 + q * G::kDst, ok ? src : p, ok);
      }
    }
  }
};

// ---- the block's product and its split-K epilogue

// A block's sums of one rank's tile (m0, n0) over k_begin .. k_end - 1
// from the loaders la (A: BM rows of M) and lb (B: BN rows of N), then the
// tile written to out (row-major M x N) directly when splits == 1, else
// through the workspace and the ticket of tile_id (see the note above).
template <int BM, int BN, bool AK, bool BKM, class LA, class LB>
__device__ __forceinline__ void run(LA la, LB lb, float* smem, float* out, int M,
                                   int N, int m0, int n0, int k_begin, int k_end, float* work,
                                   unsigned int* tickets, long long tile_id, int splits,
                                   int split_id) {
  using T = Tile<BM, BN>;
  using S = Smem<BM, BN, AK, BKM>;
  using LayA = Layout<BM, AK>;
  using LayB = Layout<BN, BKM>;
  constexpr int MT = T::kMT, NT = T::kNT, ST = T::kStages;
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const int nk = (k_end - k_begin + kBK - 1) / kBK;
  la.prepare();
  lb.prepare();

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) {
      la.load(smem + s * S::kStage, k_begin + s * kBK, k_end);
      lb.load(smem + s * S::kStage + S::kA, k_begin + s * kBK, k_end);
    }
    commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    wait_copies<ST - 2>();
    __syncthreads();
    {
      const int next = kt + ST - 1;  // its slot was read in step kt - 1, before the barrier
      if (next < nk) {
        float* slot = smem + (next % ST) * S::kStage;
        la.load(slot, k_begin + next * kBK, k_end);
        lb.load(slot + S::kA, k_begin + next * kBK, k_end);
      }
      commit();
    }
    const float* As = smem + (kt % ST) * S::kStage;
    const float* Bs = As + S::kA;

    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int k = kk + 2 * t;  // slot t takes k, slot t + 4 takes k + 1
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 16 * MT + mt * 16 + g;
        float v[4];  // (r, k), (r + 8, k), (r, k + 1), (r + 8, k + 1)
        if (AK) {
          const float2 lo = *reinterpret_cast<const float2*>(As + LayA::at(r, k));
          const float2 hi = *reinterpret_cast<const float2*>(As + LayA::at(r + 8, k));
          v[0] = lo.x; v[1] = hi.x; v[2] = lo.y; v[3] = hi.y;
        } else {
          v[0] = As[LayA::at(r, k)];
          v[1] = As[LayA::at(r + 8, k)];
          v[2] = As[LayA::at(r, k + 1)];
          v[3] = As[LayA::at(r + 8, k + 1)];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], ab[mt][e], as[mt][e]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn * 8 * NT + nt * 8 + g;
        float v[2];  // (c, k), (c, k + 1)
        if (BKM) {
          const float2 w = *reinterpret_cast<const float2*>(Bs + LayB::at(c, k));
          v[0] = w.x; v[1] = w.y;
        } else {
          v[0] = Bs[LayB::at(c, k)];
          v[1] = Bs[LayB::at(c, k + 1)];
        }
        uint32_t bb[2], bs[2];
        split(v[0], bb[0], bs[0]);
        split(v[1], bb[1], bs[1]);
        // the small terms first, then the big product
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], ab[mt], bs);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], as[mt], bb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], ab[mt], bb);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  wait_copies<0>();

  // element e of fragment (mt, nt): row g (+ 8 for e >= 2), column 2t (+ 1
  // for odd e) of the warp's 16 x 8 step
  auto store = [&](float (&v)[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * 16 * MT + mt * 16 + g + 8 * (e >> 1);
          const int n = n0 + wn * 8 * NT + nt * 8 + 2 * t + (e & 1);
          if (m < M && n < N) out[(long long)m * N + n] = v[mt][nt][e];
        }
  };
  if (splits == 1) {
    store(acc);
    return;
  }

  // the partial tile to the workspace, each thread's values at
  // lane-consecutive addresses (it reads back the same positions)
  constexpr int kTile = BM * BN;
  auto slot = [&](int mt, int nt, int e) {
    return ((warp * MT * NT + mt * NT + nt) * 4 + e) * 32 + lane;
  };
  float* parts = work + tile_id * splits * kTile;
  float* mine = parts + (long long)split_id * kTile;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) __stcg(mine + slot(mt, nt, e), acc[mt][nt][e]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&tickets[tile_id], 1u) == (unsigned int)(splits - 1);
    if (last) atomicExch(&tickets[tile_id], 0u);  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the S partials added in slice order, its own read
  // back too (the same bits as its sums), so they hold no registers here
  float sum[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.0f;
#pragma unroll 1
  for (int p = 0; p < splits; ++p) {  // a partial's loads are in flight together
    const float* src = parts + (long long)p * kTile;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[mt][nt][e] += __ldcg(src + slot(mt, nt, e));
  }
  store(sum);
}

// Opts a kernel into `bytes` of dynamic shared memory (above 48 KB) once
// per device; `done` is the kernel's own record of the devices.
template <class K> inline int allow_smem(K kernel, int bytes, bool (&done)[64]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64) done[dev] = true;
  return 0;
}

}  // namespace rank_gemm
