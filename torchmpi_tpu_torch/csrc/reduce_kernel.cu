// Elementwise accumulate, result = out + in, and scaled accumulate,
// result = out + alpha * in, in the payload type.
//
// tm_accumulate replaces torchmpi_tpu/ops/reduce_kernel.py:_accumulate_kernel
// and tm_scale_accumulate replaces _scale_add_kernel beside it, which on the
// TPU walk the flat buffer in zero-padded (1024, 128) blocks staged through
// VMEM (the scale as a scalar in SMEM). Here there is no padding: each
// thread handles one vector of up to 16 bytes (float4 for f32, where all
// three buffers are 16-byte aligned; narrower accesses where they are not,
// as for a parameter-server shard, a view at any element offset), in a
// grid-stride loop, and the first threads take the ragged tail of fewer
// than one vector. This is the reference's reduce_kernel.cu (out[i] +=
// in[i], float4 loads). The result goes to `out`, which may be the first
// input itself (an update rule applied in place), so `a` and `out` carry no
// __restrict__. The ring allreduce (ring_kernels.cu) fuses the plain add
// into its own loop.
//
// Rounding of the scaled form, as the interpret-mode Pallas kernel rounds:
// f32 and f64 take one rounding, fma(alpha, in, out); bf16 rounds the
// product to bf16 and then the sum (each computed in f32); f16 computes
// product and sum in f32 (the product is exact there) and rounds once to
// f16. The intrinsics keep nvcc from contracting or reordering any of it.
//
// Bound: both inputs read once and the result written once,
// 3*n*itemsize bytes at 3.35 TB/s (for LeNet's largest parameter at p=8,
// [8, 256, 3136] f32: 77.1 MB, 23.0 us; for one 100,352-element shard of
// it, 0.36 us, below a launch's own cost). One add or FMA per element is far
// below the card's rate, so bytes bound it; the design moves only those
// bytes.
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

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    elementwise_kernel(const typename Op::S* a, const typename Op::S* __restrict__ b,
                       typename Op::S* out, long long n, typename Op::A alpha) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  constexpr int kVW = BYTES / (int)sizeof(S);
  const R* ar = reinterpret_cast<const R*>(a);
  const R* br = reinterpret_cast<const R*>(b);
  R* outr = reinterpret_cast<R*>(out);
  const long long nvec = n / kVW;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = tid; v < nvec; v += stride) {
    Pack<S, BYTES> pa, pb;
    pa.raw = ar[v];
    pb.raw = br[v];
#pragma unroll
    for (int j = 0; j < kVW; ++j) pa.v[j] = Op::apply(pa.v[j], pb.v[j], alpha);
    outr[v] = pa.raw;
  }
  const long long t = nvec * kVW + tid;  // the tail: fewer than kVW elements
  if (t < n) out[t] = Op::apply(a[t], b[t], alpha);
}

template <typename Op, int BYTES>
bool launch_elementwise(const void* a, const void* b, void* out, long long n,
                        typename Op::A alpha, cudaStream_t stream) {
  using S = typename Op::S;
  if constexpr (BYTES < (int)sizeof(S)) {
    return false;
  } else {
    constexpr int kVW = BYTES / (int)sizeof(S);
    elementwise_kernel<Op, BYTES><<<grid_for(n / kVW + 1, 256), 256, 0, stream>>>(
        static_cast<const S*>(a), static_cast<const S*>(b), static_cast<S*>(out), n,
        alpha);
    return true;
  }
}

template <typename Op>
bool dispatch_elementwise(const void* a, const void* b, void* out, long long n,
                          typename Op::A alpha, cudaStream_t stream) {
  const int itemsize = (int)sizeof(typename Op::S);
  const int wa = vector_bytes(itemsize, 0, a, b);
  const int wo = vector_bytes(itemsize, 0, out, out);
  switch (wa < wo ? wa : wo) {
    case 16: return launch_elementwise<Op, 16>(a, b, out, n, alpha, stream);
    case 8: return launch_elementwise<Op, 8>(a, b, out, n, alpha, stream);
    case 4: return launch_elementwise<Op, 4>(a, b, out, n, alpha, stream);
    case 2: return launch_elementwise<Op, 2>(a, b, out, n, alpha, stream);
    case 1: return launch_elementwise<Op, 1>(a, b, out, n, alpha, stream);
    default: return false;
  }
}

}  // namespace tmpi

// a, b and out: n contiguous elements of the payload type `dtype`
// (tmpi::Dtype); out[i] = a[i] + b[i]. out may be a.
extern "C" int tm_accumulate(const void* a, const void* b, void* out, int dtype,
                             long long n, void* stream) {
  using namespace tmpi;
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  switch (dtype) {
    case kF32: launched = dispatch_elementwise<Plain<AddF32>>(a, b, out, n, 0, s); break;
    case kBF16: launched = dispatch_elementwise<Plain<AddBF16>>(a, b, out, n, 0, s); break;
    case kF16: launched = dispatch_elementwise<Plain<AddF16>>(a, b, out, n, 0, s); break;
    case kI32: launched = dispatch_elementwise<Plain<AddI32>>(a, b, out, n, 0, s); break;
    case kI8: launched = dispatch_elementwise<Plain<AddI8>>(a, b, out, n, 0, s); break;
    case kU8: launched = dispatch_elementwise<Plain<AddU8>>(a, b, out, n, 0, s); break;
    default: break;
  }
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a, b and out: n contiguous elements of the floating payload type `dtype`
// (kF32, kBF16, kF16 or kF64); out[i] = a[i] + alpha * b[i], with alpha
// already rounded to the payload type by the caller. out may be a.
extern "C" int tm_scale_accumulate(const void* a, const void* b, void* out,
                                   double alpha, int dtype, long long n,
                                   void* stream) {
  using namespace tmpi;
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  switch (dtype) {
    case kF32: launched = dispatch_elementwise<ScaleF32>(a, b, out, n, (float)alpha, s); break;
    case kF64: launched = dispatch_elementwise<ScaleF64>(a, b, out, n, alpha, s); break;
    case kBF16: launched = dispatch_elementwise<ScaleBF16>(a, b, out, n, (float)alpha, s); break;
    case kF16: launched = dispatch_elementwise<ScaleF16>(a, b, out, n, (float)alpha, s); break;
    default: break;
  }
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
