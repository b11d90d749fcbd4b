// Elementwise accumulate: result = out + in, in the payload type.
//
// Replaces torchmpi_tpu/ops/reduce_kernel.py:_accumulate_kernel, which on
// the TPU walks the flat buffer in zero-padded (1024, 128) blocks staged
// through VMEM. Here there is no padding: each thread adds one vector of
// up to 16 bytes (float4 for f32, where all three buffers are 16-byte
// aligned; narrower accesses where they are not), in a grid-stride loop,
// and the first threads add the ragged tail of fewer than one vector. This
// is the reference's reduce_kernel.cu (out[i] += in[i], float4 loads) with
// the sum written to a fresh output, as the JAX kernel returns one.
// The ring allreduce (ring_kernels.cu) fuses this add into its own loop.
//
// Bound: both inputs read once and the result written once,
// 3*n*itemsize bytes at 3.35 TB/s (for LeNet's largest parameter at p=8,
// [8, 256, 3136] f32: 77.1 MB, 23.0 us). One add per element is far below
// the card's rate, so bytes bound it; the design moves only those bytes.
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.
#include "common.cuh"

namespace tmpi {

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    accumulate_kernel(const typename Op::S* __restrict__ a,
                      const typename Op::S* __restrict__ b,
                      typename Op::S* __restrict__ out, long long n) {
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
    for (int j = 0; j < kVW; ++j) pa.v[j] = Op::add(pa.v[j], pb.v[j]);
    outr[v] = pa.raw;
  }
  const long long t = nvec * kVW + tid;  // the tail: fewer than kVW elements
  if (t < n) out[t] = Op::add(a[t], b[t]);
}

template <typename Op, int BYTES>
bool launch_accumulate(const void* a, const void* b, void* out, long long n,
                       cudaStream_t stream) {
  using S = typename Op::S;
  if constexpr (BYTES < (int)sizeof(S)) {
    return false;
  } else {
    constexpr int kVW = BYTES / (int)sizeof(S);
    accumulate_kernel<Op, BYTES><<<grid_for(n / kVW + 1, 256), 256, 0, stream>>>(
        static_cast<const S*>(a), static_cast<const S*>(b), static_cast<S*>(out), n);
    return true;
  }
}

template <typename Op>
bool dispatch_accumulate(int bytes, const void* a, const void* b, void* out,
                         long long n, cudaStream_t stream) {
  switch (bytes) {
    case 16: return launch_accumulate<Op, 16>(a, b, out, n, stream);
    case 8: return launch_accumulate<Op, 8>(a, b, out, n, stream);
    case 4: return launch_accumulate<Op, 4>(a, b, out, n, stream);
    case 2: return launch_accumulate<Op, 2>(a, b, out, n, stream);
    case 1: return launch_accumulate<Op, 1>(a, b, out, n, stream);
    default: return false;
  }
}

}  // namespace tmpi

// a, b and out: n contiguous elements of the payload type `dtype`
// (tmpi::Dtype); out[i] = a[i] + b[i].
extern "C" int tm_accumulate(const void* a, const void* b, void* out, int dtype,
                             long long n, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int wa = vector_bytes(itemsize, 0, a, b);
  const int wo = vector_bytes(itemsize, 0, out, out);
  const int bytes = wa < wo ? wa : wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  switch (dtype) {
    case kF32: launched = dispatch_accumulate<AddF32>(bytes, a, b, out, n, s); break;
    case kBF16: launched = dispatch_accumulate<AddBF16>(bytes, a, b, out, n, s); break;
    case kF16: launched = dispatch_accumulate<AddF16>(bytes, a, b, out, n, s); break;
    case kI32: launched = dispatch_accumulate<AddI32>(bytes, a, b, out, n, s); break;
    case kI8: launched = dispatch_accumulate<AddI8>(bytes, a, b, out, n, s); break;
    case kU8: launched = dispatch_accumulate<AddU8>(bytes, a, b, out, n, s); break;
    default: break;
  }
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
