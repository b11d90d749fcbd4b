// Ring allreduce and ring broadcast over p virtual ranks held on one card.
//
// Replaces two Pallas TPU kernels of the JAX package:
//
// - torchmpi_tpu/ops/ring_kernels.py:_ring_phases_kernel, allreduce mode.
//   On the TPU each device sends one chunk to its right neighbour per step:
//   p-1 reduce-scatter steps, then p-1 all-gather steps. The chunk that
//   holds an element fixes the rank its sum starts at: chunk j is summed
//   ((x_j + x_{j+1}) + x_{j+2}) + ... + x_{j+p-1}, ranks taken mod p, and
//   every rank ends with that sum. Here every rank's buffer lies in the
//   same device memory, so the remote copies, the two-slot staging buffer
//   and the capacity semaphores (which exist only for remote DMA) go away.
//   One launch does it all: each thread takes a vector of the row, finds
//   its chunk j, reads the p rank rows in the ring's order, adds in the
//   payload type (common.cuh) and writes the sum to all p rows. The chunk
//   layout comes from the Python wrapper (ops/ring_kernels.py:chunk_elems),
//   which keeps the JAX wrapper's integer arithmetic, so f32 results match
//   the JAX ring bit for bit.
//   Bound: the p rows are read once and written once, 2*p*n*itemsize bytes
//   at 3.35 TB/s (for MNIST LeNet at p=8, n=857738 f32: 54.9 MB, 16.4 us).
//   The adds, (p-1)*n, are far below the card's rate, so bytes bound it;
//   the design moves exactly those bytes and nothing more, with the widest
//   vector access (up to 16 bytes) that the row stride and addresses allow.
//
// - torchmpi_tpu/ops/ring_kernels.py:_ring_broadcast_kernel. On the TPU the
//   root's buffer flows down the ring in k pipelined chunks. On one card
//   the root row is read once and its bytes are written to every rank's
//   row; non-root inputs are ignored. Any payload type rides as bytes, so
//   bool and -0.0 survive.
//   Bound: the root row read once and p rows written, (1+p)*row_bytes at
//   3.35 TB/s (for LeNet at p=8: 30.9 MB, 9.2 us). Pure data movement.
//
// Both entry points take the stream, launch, and return cudaGetLastError()
// so the wrapper can raise on a refused launch.
#include "common.cuh"

namespace tmpi {

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_allreduce_kernel(const typename Op::S* __restrict__ x,
                          typename Op::S* __restrict__ out, int p,
                          long long row_vecs, long long chunk_vecs) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  constexpr int kVW = BYTES / (int)sizeof(S);
  const R* xr = reinterpret_cast<const R*>(x);
  R* outr = reinterpret_cast<R*>(out);
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    // the chunk holding v is the rank its sum starts at
    int r = (int)((v % seg_vecs) / chunk_vecs);
    Pack<S, BYTES> acc;
    acc.raw = xr[(long long)r * row_vecs + v];
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      r = (r + 1 == p) ? 0 : r + 1;
      Pack<S, BYTES> in;
      in.raw = xr[(long long)r * row_vecs + v];
#pragma unroll
      for (int j = 0; j < kVW; ++j) acc.v[j] = Op::add(acc.v[j], in.v[j]);
    }
    for (int q = 0; q < p; ++q) outr[(long long)q * row_vecs + v] = acc.raw;
  }
}

template <typename Op, int BYTES>
bool launch_allreduce(const void* x, void* out, int p, long long n,
                      long long chunk_elems, cudaStream_t stream) {
  using S = typename Op::S;
  if constexpr (BYTES < (int)sizeof(S)) {
    return false;
  } else {
    constexpr int kVW = BYTES / (int)sizeof(S);
    const long long row_vecs = n / kVW;
    ring_allreduce_kernel<Op, BYTES><<<grid_for(row_vecs, 256), 256, 0, stream>>>(
        static_cast<const S*>(x), static_cast<S*>(out), p, row_vecs,
        chunk_elems / kVW);
    return true;
  }
}

template <typename Op>
bool dispatch_allreduce(int bytes, const void* x, void* out, int p, long long n,
                        long long chunk_elems, cudaStream_t stream) {
  switch (bytes) {
    case 16: return launch_allreduce<Op, 16>(x, out, p, n, chunk_elems, stream);
    case 8: return launch_allreduce<Op, 8>(x, out, p, n, chunk_elems, stream);
    case 4: return launch_allreduce<Op, 4>(x, out, p, n, chunk_elems, stream);
    case 2: return launch_allreduce<Op, 2>(x, out, p, n, chunk_elems, stream);
    case 1: return launch_allreduce<Op, 1>(x, out, p, n, chunk_elems, stream);
    default: return false;
  }
}

template <int BYTES>
__global__ void __launch_bounds__(256)
    ring_broadcast_kernel(const unsigned char* __restrict__ src,
                          unsigned char* __restrict__ out, int p,
                          long long row_vecs) {
  using R = typename RawOf<BYTES>::T;
  const R* s = reinterpret_cast<const R*>(src);
  R* o = reinterpret_cast<R*>(out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    const R val = s[v];
    for (int q = 0; q < p; ++q) o[(long long)q * row_vecs + v] = val;
  }
}

template <int BYTES>
void launch_broadcast(const unsigned char* src, unsigned char* out, int p,
                      long long row_bytes, cudaStream_t stream) {
  const long long row_vecs = row_bytes / BYTES;
  ring_broadcast_kernel<BYTES><<<grid_for(row_vecs, 256), 256, 0, stream>>>(
      src, out, p, row_vecs);
}

}  // namespace tmpi

// x and out: [p, n] contiguous rows of the payload type `dtype` (tmpi::Dtype).
// chunk_elems: elements per ring chunk, a multiple of 128.
extern "C" int tm_ring_allreduce(const void* x, void* out, int dtype, int p,
                                 long long n, long long chunk_elems,
                                 void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || n < 0 || chunk_elems <= 0 || chunk_elems % 128) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes =
      vector_bytes(itemsize, (unsigned long long)n * itemsize, x, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  switch (dtype) {
    case kF32: launched = dispatch_allreduce<AddF32>(bytes, x, out, p, n, chunk_elems, s); break;
    case kBF16: launched = dispatch_allreduce<AddBF16>(bytes, x, out, p, n, chunk_elems, s); break;
    case kF16: launched = dispatch_allreduce<AddF16>(bytes, x, out, p, n, chunk_elems, s); break;
    case kI32: launched = dispatch_allreduce<AddI32>(bytes, x, out, p, n, chunk_elems, s); break;
    case kI8: launched = dispatch_allreduce<AddI8>(bytes, x, out, p, n, chunk_elems, s); break;
    case kU8: launched = dispatch_allreduce<AddU8>(bytes, x, out, p, n, chunk_elems, s); break;
    default: break;
  }
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x and out: [p, row_bytes] contiguous byte rows; out[q] = x[root] for all q.
extern "C" int tm_ring_broadcast(const void* x, void* out, int p,
                                 long long row_bytes, int root, void* stream) {
  using namespace tmpi;
  if (p < 1 || row_bytes < 0 || root < 0 || root >= p) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned char* src = static_cast<const unsigned char*>(x) + (long long)root * row_bytes;
  unsigned char* dst = static_cast<unsigned char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(1, (unsigned long long)row_bytes, src, dst)) {
    case 16: launch_broadcast<16>(src, dst, p, row_bytes, s); break;
    case 8: launch_broadcast<8>(src, dst, p, row_bytes, s); break;
    case 4: launch_broadcast<4>(src, dst, p, row_bytes, s); break;
    case 2: launch_broadcast<2>(src, dst, p, row_bytes, s); break;
    default: launch_broadcast<1>(src, dst, p, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}
