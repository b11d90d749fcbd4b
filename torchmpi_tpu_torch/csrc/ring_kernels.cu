// The ring kernels over p virtual ranks held on one card.
//
// Replaces these Pallas TPU kernels of the JAX package
// (torchmpi_tpu/ops/ring_kernels.py):
//
// - _ring_phases_kernel, allreduce mode. On the TPU each device sends one
//   chunk to its right neighbour per step: p-1 reduce-scatter steps, then
//   p-1 all-gather steps. The chunk that holds an element fixes the rank
//   its sum starts at: chunk j is summed ((x_j + x_{j+1}) + x_{j+2}) + ...
//   + x_{j+p-1}, ranks taken mod p, and every rank ends with that sum. Here
//   every rank's buffer lies in the same device memory, so the remote
//   copies, the two-slot staging buffer and the capacity semaphores (which
//   exist only for remote DMA) go away. One launch does it all: each thread
//   takes a vector of the row, finds its chunk j, reads the p rank rows in
//   the ring's order, adds in the payload type (common.cuh) and writes the
//   sum to all p rows. The chunk layout comes from the Python wrapper
//   (ops/ring_kernels.py:chunk_elems), which keeps the JAX wrapper's integer
//   arithmetic, so f32 results match the JAX ring bit for bit.
//   Bound: the p rows are read once and written once, 2*p*n*itemsize bytes
//   at 3.35 TB/s (for MNIST LeNet at p=8, n=857738 f32: 54.9 MB, 16.4 us).
//   The adds, (p-1)*n, are far below the card's rate, so bytes bound it;
//   the design moves exactly those bytes and nothing more, with the widest
//   vector access (up to 16 bytes) that the row stride and addresses allow.
//
// - _ring_phases_kernel, 'rs' mode (ring_reduce_scatter_pallas): every rank
//   holds p segments, and rank s ends with the sum of every rank's segment
//   s. The JAX wrapper rolls the segments by one before the standard
//   schedule, so segment s's sum starts at rank s+1 and walks rightward to
//   its owner, rank s. One thread per output vector reads the p ranks'
//   values of its segment position in that order and writes the sum once.
//   The VMEM row slicing changes no sum (elements reduce independently)
//   and is dropped. Bound: p*p*seg_n elements read, p*seg_n written.
//
// - _ring_phases_kernel, 'ag' mode (ring_allgather_pallas): every rank
//   ends with every rank's block, stacked in rank order. On one card that
//   is the whole rank-stacked input copied to each of the p output rows:
//   the broadcast kernel below with the input as its one source row.
//   Bytes, so any payload type, bool and -0.0 included. Bound: p*row bytes
//   read, p*p*row written.
//
// - _ring_phases_kernel 'rs' then _ring_gather_root_kernel
//   (ring_reduce_pallas): the reduce-scatter in the allreduce's chunk layout,
//   then the owned sums carried round the ring to the root. On one card the
//   gather moves nothing: each thread sums its vector as the allreduce does
//   and writes the sum to the root's row only, and copies each other rank's
//   value (read once for the sum) to that rank's row, whose reduce result is
//   its input. Bound: 2*p*n*itemsize bytes, as the allreduce.
//
// - _ring_bidir_kernel (ring_allreduce_bidir_pallas): the flat buffer is cut
//   at half = ceil(n/2); half A is summed rightward from its chunk's rank
//   and half B leftward (acc = x_c; acc = x_{c-1} + acc; ...), each half in
//   its own chunk layout (ops/ring_kernels.py:bidir_chunk_elems). On the TPU
//   the two directions load both ways of every link; on one card it is the
//   allreduce with the chunk and direction taken from the half. Bound:
//   2*p*n*itemsize bytes.
//
// - _ring_broadcast_kernel. On the TPU the root's buffer flows down the
//   ring in k pipelined chunks. On one card the root row is read once and
//   its bytes are written to every rank's row; non-root inputs are ignored.
//   Any payload type rides as bytes, so bool and -0.0 survive.
//   Bound: the root row read once and p rows written, (1+p)*row_bytes at
//   3.35 TB/s (for LeNet at p=8: 30.9 MB, 9.2 us). Pure data movement.
//
// Every entry point takes the stream, launches once, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <numeric>
#include <type_traits>

#include "common.cuh"

namespace tmpi {

template <int B>
using Width = std::integral_constant<int, B>;

// Calls launch(Op{}, Width<BYTES>{}) when a vector of BYTES holds whole
// payload elements; false (nothing launched) otherwise.
template <typename Op, int BYTES, typename F>
bool launch_if(F& launch) {
  if constexpr (BYTES < (int)sizeof(typename Op::S)) {
    return false;
  } else {
    launch(Op{}, Width<BYTES>{});
    return true;
  }
}

template <typename Op, typename F>
bool at_width(int bytes, F& launch) {
  switch (bytes) {
    case 16: return launch_if<Op, 16>(launch);
    case 8: return launch_if<Op, 8>(launch);
    case 4: return launch_if<Op, 4>(launch);
    case 2: return launch_if<Op, 2>(launch);
    case 1: return launch_if<Op, 1>(launch);
    default: return false;
  }
}

// Calls launch(Op{}, Width<bytes>{}) with the add of the payload type
// `dtype`; false when the type or the width is not one the kernels take.
template <typename F>
bool with_reduce_type(int dtype, int bytes, F&& launch) {
  switch (dtype) {
    case kF32: return at_width<AddF32>(bytes, launch);
    case kBF16: return at_width<AddBF16>(bytes, launch);
    case kF16: return at_width<AddF16>(bytes, launch);
    case kI32: return at_width<AddI32>(bytes, launch);
    case kI8: return at_width<AddI8>(bytes, launch);
    case kU8: return at_width<AddU8>(bytes, launch);
    default: return false;
  }
}

template <typename Op, int BYTES>
__device__ __forceinline__ void add_into(Pack<typename Op::S, BYTES>& acc,
                                         const Pack<typename Op::S, BYTES>& in) {
#pragma unroll
  for (int j = 0; j < BYTES / (int)sizeof(typename Op::S); ++j) {
    acc.v[j] = Op::add(acc.v[j], in.v[j]);
  }
}

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_allreduce_kernel(const typename Op::S* __restrict__ x,
                          typename Op::S* __restrict__ out, int p,
                          long long row_vecs, long long chunk_vecs) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
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
      add_into<Op, BYTES>(acc, in);
    }
    for (int q = 0; q < p; ++q) outr[(long long)q * row_vecs + v] = acc.raw;
  }
}

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_reduce_scatter_kernel(const typename Op::S* __restrict__ x,
                               typename Op::S* __restrict__ out, int p,
                               long long seg_vecs) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  const R* xr = reinterpret_cast<const R*>(x);
  R* outr = reinterpret_cast<R*>(out);
  // a rank's row holds its p segments; the output holds one per rank
  const long long row_vecs = seg_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    // segment s's sum starts at rank s+1 and ends at its owner, rank s
    const int s = (int)(v / seg_vecs);
    int r = (s + 1 == p) ? 0 : s + 1;
    Pack<S, BYTES> acc;
    acc.raw = xr[(long long)r * row_vecs + v];
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      r = (r + 1 == p) ? 0 : r + 1;
      Pack<S, BYTES> in;
      in.raw = xr[(long long)r * row_vecs + v];
      add_into<Op, BYTES>(acc, in);
    }
    outr[v] = acc.raw;
  }
}

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_reduce_kernel(const typename Op::S* __restrict__ x,
                       typename Op::S* __restrict__ out, int p,
                       long long row_vecs, long long chunk_vecs, int root) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  const R* xr = reinterpret_cast<const R*>(x);
  R* outr = reinterpret_cast<R*>(out);
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    int r = (int)((v % seg_vecs) / chunk_vecs);
    Pack<S, BYTES> acc;
    acc.raw = xr[(long long)r * row_vecs + v];
    // a non-root rank's result is its input: copy each value as it is read
    if (r != root) outr[(long long)r * row_vecs + v] = acc.raw;
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      r = (r + 1 == p) ? 0 : r + 1;
      Pack<S, BYTES> in;
      in.raw = xr[(long long)r * row_vecs + v];
      if (r != root) outr[(long long)r * row_vecs + v] = in.raw;
      add_into<Op, BYTES>(acc, in);
    }
    outr[(long long)root * row_vecs + v] = acc.raw;
  }
}

template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_allreduce_bidir_kernel(const typename Op::S* __restrict__ x,
                                typename Op::S* __restrict__ out, int p,
                                long long row_vecs, long long half_vecs,
                                long long chunk_vecs) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  const R* xr = reinterpret_cast<const R*>(x);
  R* outr = reinterpret_cast<R*>(out);
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    // half B (from half_vecs on) walks the ring leftward, with its own
    // chunk layout counted from the start of the half
    const bool leftward = v >= half_vecs;
    const long long i = leftward ? v - half_vecs : v;
    int r = (int)((i % seg_vecs) / chunk_vecs);
    Pack<S, BYTES> acc;
    acc.raw = xr[(long long)r * row_vecs + v];
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      if (leftward) {
        r = (r == 0) ? p - 1 : r - 1;
      } else {
        r = (r + 1 == p) ? 0 : r + 1;
      }
      Pack<S, BYTES> in;
      in.raw = xr[(long long)r * row_vecs + v];
      add_into<Op, BYTES>(acc, in);
    }
    for (int q = 0; q < p; ++q) outr[(long long)q * row_vecs + v] = acc.raw;
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

// Writes the row_bytes at src to each of the p rows of out.
inline int replicate(const void* src, void* out, int p, long long row_bytes,
                     void* stream) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(1, (unsigned long long)row_bytes, s, d)) {
    case 16: launch_broadcast<16>(s, d, p, row_bytes, st); break;
    case 8: launch_broadcast<8>(s, d, p, row_bytes, st); break;
    case 4: launch_broadcast<4>(s, d, p, row_bytes, st); break;
    case 2: launch_broadcast<2>(s, d, p, row_bytes, st); break;
    default: launch_broadcast<1>(s, d, p, row_bytes, st); break;
  }
  return (int)cudaGetLastError();
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
  const int bytes = vector_bytes(itemsize, (unsigned long long)n * itemsize, x, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kVW = decltype(width)::value / (int)sizeof(S);
    ring_allreduce_kernel<Op, decltype(width)::value>
        <<<grid_for(n / kVW, 256), 256, 0, s>>>(static_cast<const S*>(x),
                                                static_cast<S*>(out), p, n / kVW,
                                                chunk_elems / kVW);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: [p, p * seg_n] contiguous rows of the payload type `dtype` (rank r's p
// segments); out: [p, seg_n], out[s] = the sum of every rank's segment s.
extern "C" int tm_ring_reduce_scatter(const void* x, void* out, int dtype, int p,
                                      long long seg_n, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || seg_n < 0) return (int)cudaErrorInvalidValue;
  const int bytes =
      vector_bytes(itemsize, (unsigned long long)seg_n * itemsize, x, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kVW = decltype(width)::value / (int)sizeof(S);
    ring_reduce_scatter_kernel<Op, decltype(width)::value>
        <<<grid_for(p * (seg_n / kVW), 256), 256, 0, s>>>(
            static_cast<const S*>(x), static_cast<S*>(out), p, seg_n / kVW);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: [p, row_bytes] contiguous byte rows; out: [p, p, row_bytes], every
// out[q] a copy of all of x.
extern "C" int tm_ring_allgather(const void* x, void* out, int p,
                                 long long row_bytes, void* stream) {
  if (p < 1 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  return tmpi::replicate(x, out, p, (long long)p * row_bytes, stream);
}

// x and out: [p, n] contiguous rows of the payload type `dtype`; out[root] is
// the ring allreduce's row, every other out[q] = x[q].
extern "C" int tm_ring_reduce(const void* x, void* out, int dtype, int p,
                              long long n, long long chunk_elems, int root,
                              void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || n < 0 || chunk_elems <= 0 || chunk_elems % 128 ||
      root < 0 || root >= p) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = vector_bytes(itemsize, (unsigned long long)n * itemsize, x, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kVW = decltype(width)::value / (int)sizeof(S);
    ring_reduce_kernel<Op, decltype(width)::value>
        <<<grid_for(n / kVW, 256), 256, 0, s>>>(static_cast<const S*>(x),
                                                static_cast<S*>(out), p, n / kVW,
                                                chunk_elems / kVW, root);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x and out: [p, n] contiguous rows of the payload type `dtype`; elements
// [0, half) are summed rightward and [half, n) leftward, each half cut into
// chunks of chunk_elems (a multiple of 128) from its own start.
extern "C" int tm_ring_allreduce_bidir(const void* x, void* out, int dtype, int p,
                                       long long n, long long half,
                                       long long chunk_elems, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || n < 0 || half < 0 || half > n ||
      chunk_elems <= 0 || chunk_elems % 128) {
    return (int)cudaErrorInvalidValue;
  }
  // a vector must not straddle the two halves: its width divides both
  const int bytes = vector_bytes(
      itemsize, (unsigned long long)std::gcd(n, half) * itemsize, x, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kVW = decltype(width)::value / (int)sizeof(S);
    ring_allreduce_bidir_kernel<Op, decltype(width)::value>
        <<<grid_for(n / kVW, 256), 256, 0, s>>>(static_cast<const S*>(x),
                                                static_cast<S*>(out), p, n / kVW,
                                                half / kVW, chunk_elems / kVW);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x and out: [p, row_bytes] contiguous byte rows; out[q] = x[root] for all q.
extern "C" int tm_ring_broadcast(const void* x, void* out, int p,
                                 long long row_bytes, int root, void* stream) {
  if (p < 1 || row_bytes < 0 || root < 0 || root >= p) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned char* src =
      static_cast<const unsigned char*>(x) + (long long)root * row_bytes;
  return tmpi::replicate(src, out, p, row_bytes, stream);
}
