// Elementwise accumulate, result = out + in, and scaled accumulate,
// result = out + alpha * in, in the payload type, over a list of leaves in
// one launch.
//
// tm_accumulate_many replaces torchmpi_tpu/ops/reduce_kernel.py:
// _accumulate_kernel and tm_scale_accumulate_many replaces
// _scale_add_kernel beside it, which on the TPU walk one flat buffer in
// zero-padded (1024, 128) blocks staged through VMEM (the scale as a scalar
// in SMEM), one call per tensor; the JAX engine issues a step's calls inside
// one compiled program. Here one launch takes a whole list of leaves (a
// step's parameters, or one tensor as a list of one), as the reference's
// reduce_kernel.cu took one buffer (out[i] += in[i], float4 loads). The
// result goes to `out`, which may be the first input itself (an update
// rule applied in place), so `a` and `out` carry no __restrict__. The ring
// allreduce (ring_kernels.cu) fuses the plain add into its own loop.
//
// Rounding of the scaled form, as the interpret-mode Pallas kernel rounds:
// f32 and f64 take one rounding, fma(alpha, in, out); bf16 rounds the
// product to bf16 and then the sum (each computed in f32); f16 computes
// product and sum in f32 (the product is exact there) and rounds once to
// f16. The intrinsics keep nvcc from contracting or reordering any of it.
//
// Bound: both inputs read once and the result written once, 3 * n *
// itemsize bytes at 3.35 TB/s; one add or FMA per element is far below the
// card's rate. ResNet-50's 161 leaves at p=8 are 25,557,032 * 8 floats:
// 2.4535 GB, 0.7324 ms a step for each kernel. Two things stood between the
// one-launch-per-tensor kernel and that bound: a launch per leaf (about
// 2 us each, and 106 of the 161 leaves are batch-norm vectors of 64-2,048
// floats a rank), and a grid-stride loop that kept one 16-byte vector per
// operand in flight per thread. So:
//
// - One launch over a list. The host passes a table of leaf descriptors
//   (three pointers, the element count, the leaf's first tile and its
//   vector width) by value in the kernel's parameter space, read through
//   __grid_constant__: no host-to-device copy and no sync. The classic
//   parameter limit of 4,096 bytes holds kLeavesClassic = 102 leaves; CUDA
//   12.1 and later on Volta or newer take 32,764 bytes, kLeavesLarge = 818
//   leaves. A launch of at most 102 leaves takes the classic table, a
//   longer one the large table where the build has it
//   (tm_leaves_per_launch says how many leaves one launch takes). Blocks
//   find their leaf by a binary search over the leaves' first tiles.
//   Leaves of different dtypes go in separate launches (the caller groups
//   them).
// - A register-staged tile: each thread issues kUnroll = 4 independent
//   loads of each operand (16 bytes each where all three pointers allow)
//   before it computes, both operands with evict-first loads and the
//   results with streaming stores (each byte is touched once); one tile per
//   block, and blocks of 256 threads, or fewer when a list is too small to
//   give the 132 SMs two tiles each. Misaligned leaves (a parameter-server
//   shard at any element offset) take narrower vectors, the width
//   vector_bytes gives, as before.
//
// A TMA bulk ring (persistent blocks, cp.async.bulk into a 4-stage ring of
// shared memory, completion on an mbarrier) was built and timed against
// the register tile: 3-15% slower over ResNet-50's list on an H100 80GB
// HBM3 at 700 W (PERF.md), as it adds a shared-memory round trip and caps
// the bytes in flight at the ring's. It is not kept.
//
// The entry points return cudaGetLastError() so the wrapper can raise on a
// refused launch.
#include "common.cuh"

namespace tmpi {

// The scaled form of each floating payload type: its storage type S, the
// type A the scale is passed in, and out + alpha * in.
struct ScaleF32 {
  using S = float;
  using A = float;
  __device__ __forceinline__ static S apply(S a, S b, A alpha) {
    return fmaf(alpha, b, a);
  }
};
struct ScaleF64 {
  using S = double;
  using A = double;
  __device__ __forceinline__ static S apply(S a, S b, A alpha) {
    return fma(alpha, b, a);
  }
};
struct ScaleBF16 {
  using S = unsigned short;
  using A = float;  // the bf16 scale, widened exactly
  __device__ __forceinline__ static S apply(S a, S b, A alpha) {
    const float p = __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(alpha, __bfloat162float(__ushort_as_bfloat16(b)))));
    const float s = __fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)), p);
    return __bfloat16_as_ushort(__float2bfloat16_rn(s));
  }
};
struct ScaleF16 {
  using S = unsigned short;
  using A = float;  // the f16 scale, widened exactly
  __device__ __forceinline__ static S apply(S a, S b, A alpha) {
    const float p = __fmul_rn(alpha, __half2float(__ushort_as_half(b)));
    return __half_as_ushort(
        __float2half_rn(__fadd_rn(__half2float(__ushort_as_half(a)), p)));
  }
};

// Adapts an Add* type of common.cuh to the same shape (the scale unused).
template <typename Add>
struct Plain {
  using S = typename Add::S;
  using A = int;
  __device__ __forceinline__ static S apply(S a, S b, A) { return Add::add(a, b); }
};

// One leaf as the host hands it over: out[i] = a[i] (+ alpha *) b[i] for
// i < n. out may be a.
struct LeafIn {
  const void* a;
  const void* b;
  void* out;
  long long n;
};

// One leaf in a launch's table: 40 bytes.
struct Leaf {
  const void* a;
  const void* b;
  void* out;
  long long n;
  int tile0;  // the leaf's first tile in the launch
  int vw;     // bytes per vector access (16, 8, 4, 2, 1)
};

template <int CAP>
struct Table {
  Leaf leaf[CAP];
  int count;  // leaves in this launch
  int tiles;  // tiles over all of them
};

constexpr int kLeavesClassic = 102;  // 4,096 bytes of parameters
constexpr int kLeavesLarge = 818;    // 32,764 bytes
static_assert(sizeof(Table<kLeavesClassic>) + sizeof(double) <= 4096, "classic table");
static_assert(sizeof(Table<kLeavesLarge>) + sizeof(double) <= 32764, "large table");
#if CUDART_VERSION >= 12010
constexpr int kLeavesPerLaunch = kLeavesLarge;
#else
constexpr int kLeavesPerLaunch = kLeavesClassic;
#endif

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors of each operand in flight per thread

// The leaf that holds `tile`: the last whose first tile is at or below it.
template <int CAP>
__device__ __forceinline__ const Leaf& leaf_of(const Table<CAP>& t, int tile) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].tile0 <= tile) lo = mid;
    else hi = mid - 1;
  }
  return t.leaf[lo];
}

// Tile `local` of leaf L in vectors of BYTES: blockDim.x * kUnroll vectors,
// all loads issued before any compute; the leaf's last tile also takes the
// tail of fewer than one vector.
template <typename Op, int BYTES>
__device__ __forceinline__ void register_tile(const Leaf& L, long long local,
                                              typename Op::A alpha) {
  using S = typename Op::S;
  if constexpr (BYTES < (int)sizeof(S)) {
    return;
  } else {
    using R = typename RawOf<BYTES>::T;
    constexpr int kVW = BYTES / (int)sizeof(S);
    const R* ar = static_cast<const R*>(L.a);
    const R* br = static_cast<const R*>(L.b);
    R* outr = static_cast<R*>(L.out);
    const long long nvec = L.n / kVW;
    const long long per_tile = (long long)blockDim.x * kUnroll;
    const long long first = local * per_tile + threadIdx.x;
    Pack<S, BYTES> pa[kUnroll], pb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = first + (long long)u * blockDim.x;
      if (v < nvec) {
        pa[u].raw = __ldcs(ar + v);
        pb[u].raw = __ldcs(br + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = first + (long long)u * blockDim.x;
      if (v < nvec) {
#pragma unroll
        for (int j = 0; j < kVW; ++j) pa[u].v[j] = Op::apply(pa[u].v[j], pb[u].v[j], alpha);
        __stcs(outr + v, pa[u].raw);
      }
    }
    const long long last = nvec > 0 ? (nvec - 1) / per_tile : 0;
    const long long t = nvec * kVW + threadIdx.x;  // the tail: fewer than kVW elements
    if (local == last && t < L.n) {
      const S* a = static_cast<const S*>(L.a);
      const S* b = static_cast<const S*>(L.b);
      static_cast<S*>(L.out)[t] = Op::apply(a[t], b[t], alpha);
    }
  }
}

template <typename Op>
__device__ __forceinline__ void register_tile_any(const Leaf& L, long long local,
                                                  typename Op::A alpha) {
  switch (L.vw) {
    case 16: register_tile<Op, 16>(L, local, alpha); break;
    case 8: register_tile<Op, 8>(L, local, alpha); break;
    case 4: register_tile<Op, 4>(L, local, alpha); break;
    case 2: register_tile<Op, 2>(L, local, alpha); break;
    default: register_tile<Op, 1>(L, local, alpha); break;
  }
}

// One register-staged tile per block.
template <typename Op, int CAP>
__global__ void __launch_bounds__(kThreads)
    many_kernel(const __grid_constant__ Table<CAP> t, typename Op::A alpha) {
  const Leaf& L = leaf_of(t, blockIdx.x);
  register_tile_any<Op>(L, blockIdx.x - L.tile0, alpha);
}

// ---- the host side ----------------------------------------------------------

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Fill t from the host's leaves: vector widths, tiles, first tiles. Returns
// false on a bad count or a vector width the payload type cannot take.
template <typename S, int CAP>
bool fill_table(Table<CAP>& t, const LeafIn* in, int count, int threads) {
  if (count < 1 || count > CAP) return false;
  const int itemsize = (int)sizeof(S);
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    Leaf& L = t.leaf[i];
    L.a = in[i].a;
    L.b = in[i].b;
    L.out = in[i].out;
    L.n = in[i].n;
    if (L.n < 0) return false;
    const int wa = vector_bytes(itemsize, 0, L.a, L.b);
    const int wo = vector_bytes(itemsize, 0, L.out, L.out);
    L.vw = wa < wo ? wa : wo;
    const long long nvec = L.n / (L.vw / itemsize);
    const long long per_tile = (long long)threads * kUnroll;
    long long n_tiles = nvec > 0 ? (nvec + per_tile - 1) / per_tile : 1;
    if (L.n == 0) n_tiles = 0;
    L.tile0 = (int)tiles;
    tiles += n_tiles;
    if (tiles > (1LL << 30)) return false;
  }
  t.count = count;
  t.tiles = (int)tiles;
  return true;
}

// Threads per block: 256, or fewer (down to 32) while
// the list gives fewer than two tiles per SM.
template <typename S>
int register_threads(const LeafIn* in, int count) {
  const int itemsize = (int)sizeof(S);
  int threads = kThreads;
  while (threads > 32) {
    long long tiles = 0;
    for (int i = 0; i < count; ++i) {
      const int wa = vector_bytes(itemsize, 0, in[i].a, in[i].b);
      const int wo = vector_bytes(itemsize, 0, in[i].out, in[i].out);
      const long long nvec = in[i].n / ((wa < wo ? wa : wo) / itemsize);
      tiles += (nvec + (long long)threads * kUnroll - 1) / ((long long)threads * kUnroll);
    }
    if (tiles >= 2LL * sm_count()) break;
    threads >>= 1;
  }
  return threads;
}

template <typename Op, int CAP>
int launch_table(const LeafIn* in, int count, typename Op::A alpha, cudaStream_t stream) {
  using S = typename Op::S;
  Table<CAP> t;
  const int threads = register_threads<S>(in, count);
  if (!fill_table<S, CAP>(t, in, count, threads)) return (int)cudaErrorInvalidValue;
  if (t.tiles == 0) return (int)cudaSuccess;
  many_kernel<Op, CAP><<<t.tiles, threads, 0, stream>>>(t, alpha);
  return (int)cudaGetLastError();
}

// The classic table for at most kLeavesClassic leaves, else the largest
// this build takes (fill_table refuses more than it holds).
template <typename Op>
int launch_many(const LeafIn* in, int count, typename Op::A alpha, cudaStream_t stream) {
  if (count <= kLeavesClassic) return launch_table<Op, kLeavesClassic>(in, count, alpha, stream);
  return launch_table<Op, kLeavesPerLaunch>(in, count, alpha, stream);
}

}  // namespace tmpi

// The most leaves one launch takes: kLeavesLarge where the build takes a
// parameter table above the classic 4,096 bytes (CUDA 12.1 or later), else
// kLeavesClassic; and the bytes of kernel parameters of that table.
extern "C" int tm_leaves_per_launch() { return tmpi::kLeavesPerLaunch; }
extern "C" int tm_table_bytes() {
  return (int)(sizeof(tmpi::Table<tmpi::kLeavesPerLaunch>) + sizeof(double));
}

// leaves: `count` leaves of the payload type `dtype` (tmpi::Dtype), each n
// contiguous elements; out[i] = a[i] + b[i]. One launch; count at most
// tm_leaves_per_launch().
extern "C" int tm_accumulate_many(const void* leaves, int count, int dtype, void* stream) {
  using namespace tmpi;
  const LeafIn* in = static_cast<const LeafIn*>(leaves);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_many<Plain<AddF32>>(in, count, 0, s);
    case kBF16: return launch_many<Plain<AddBF16>>(in, count, 0, s);
    case kF16: return launch_many<Plain<AddF16>>(in, count, 0, s);
    case kI32: return launch_many<Plain<AddI32>>(in, count, 0, s);
    case kI8: return launch_many<Plain<AddI8>>(in, count, 0, s);
    case kU8: return launch_many<Plain<AddU8>>(in, count, 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As tm_accumulate_many for the floating payload types (kF32, kBF16, kF16,
// kF64): out[i] = a[i] + alpha * b[i], alpha already rounded to the
// payload type by the caller.
extern "C" int tm_scale_accumulate_many(const void* leaves, int count, double alpha, int dtype,
                                        void* stream) {
  using namespace tmpi;
  const LeafIn* in = static_cast<const LeafIn*>(leaves);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_many<ScaleF32>(in, count, (float)alpha, s);
    case kF64: return launch_many<ScaleF64>(in, count, alpha, s);
    case kBF16: return launch_many<ScaleBF16>(in, count, (float)alpha, s);
    case kF16: return launch_many<ScaleF16>(in, count, (float)alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
