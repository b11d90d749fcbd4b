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
//   Groups: the rows may hold G rings of p ranks each, in group-major order
//   (the intra phase of a two-level communicator, which the JAX package runs
//   as one program over its (inter, intra) mesh). Group g's ring is rows
//   g*p .. g*p+p-1, with the chunk layout of one p-rank ring, and blockIdx.y
//   picks the group: one launch sums every group straight into the one
//   output. G = 1 is the flat ring.
//   Bound: the rows are read once and written once, 2*G*p*n*itemsize bytes
//   at 3.35 TB/s (for MNIST LeNet at p=8, n=857738 f32: 54.9 MB, 16.4 us;
//   for config 5's largest bucket, 2 groups of 4 at n=100480: 6.4 MB,
//   1.92 us). The adds, (p-1)*n a group, are far below the card's rate, so
//   bytes bound it; the design moves exactly those bytes and nothing more,
//   with the widest vector access (up to 16 bytes) that the row stride and
//   addresses allow.
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
//   the broadcast kernel below with the input as its one source row; with
//   G groups, group g's [p, d] block copied to each of its p rows.
//   Bytes, so any payload type, bool and -0.0 included. Bound: G*p*row
//   bytes read, G*p*p*row written.
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
//   With G groups, group g's root row g*p + root goes to the group's p
//   rows, all groups in one launch. Any payload type rides as bytes, so
//   bool and -0.0 survive. Bound: each root row read once and every row
//   written, G*(1+p)*row_bytes at 3.35 TB/s (for LeNet at p=8: 30.9 MB,
//   9.2 us). Pure data movement.
//
// - The cross-process forms of K3 and K7 (ranks spread over several
//   processes on one card, runtime/peers.py). Each process holds only its
//   own ranks' rows and copies them into its slab, a cudaMalloc that every
//   other process has mapped (csrc/peer.cpp). The kernel gets a table of p
//   row pointers, one a rank, into those slabs, passed by value (p <= 32),
//   and writes the process's own rows only. K3: the same chunk layout and
//   order of adds as ring_sum above, so the sum is the one-process ring's
//   on the same [p, n], bit for bit; every process reads all p rows, so p
//   processes read P_proc times the rows (the ring's ownership of chunks,
//   each process reducing its own and gathering the rest, is later work).
//   Bound: p rows read and L rows written by each of the P_proc processes.
//   K7: the broadcast kernel above with the root's row, in whichever slab
//   it lies, as its source row and the process's L rows as its output.
//   K3 'rs': each process sums only the segments its own ranks keep (the
//   `owned` global ranks, passed by value beside the table, in any order),
//   each in the one-process 'rs' order (segment s starts at rank s+1 and
//   walks rightward to s). So the job's launches together read the [p, p*m]
//   rows once, as the one-process 'rs' does, with no duplicated work. Bound:
//   L*p*m elements read and L*m written by each process. K3 'ag': each
//   process copies the p blocks, wherever they lie, into each of its L
//   rows, in rank order; bytes, so any payload type, bool and -0.0
//   included. Bound: p blocks read and L*p written by each process.
//   K5: the bidirectional allreduce above over the table, each process
//   writing its L rows. Bound: p rows read and L written by each process.
//   K6: launched by the root's process only (the others' result is their
//   input, and they read no peer's slab): the reduce above over the table,
//   the sum written to the root's row and each other rank the process
//   holds given its value as the sum reads it. Bound: p rows read, L
//   written.
//   Grouped K3 and K7 across processes (the intra phase of a two-level
//   communicator whose groups span processes): the table holds, group-major,
//   the rows of every group that holds one of the process's ranks, wherever
//   each lies; blockIdx.y is the group. K3 sums each group in the chunk
//   layout and order of a ring of its I ranks, as the one-process grouped
//   launch does, and writes the sum to the process's own rows of that group
//   only (a slot a table row). K7 reads each group's root row from its
//   owner's slab and writes it to the process's own rows of that group.
//   Bound: every row of those groups read once (K7: each root row) and the
//   process's rows written once.
//   No kernel waits on another process: the host protocol of
//   runtime/peers.py orders the copies with interprocess events.
//
// The launch shape (common.cuh shape_for). Every kernel here streams: it
// is bound by bytes, and at the paths' small payloads by the launch and by
// how many loads are in flight. So (1) the groups share one launch, which
// doubles the work a launch at config 5's two hosts and halves the
// launches; (2) below two blocks an SM the blocks shrink (256 threads down
// to 64) so that every SM gets one, where 256-thread blocks left a quarter
// of the card without a block at [4, 100480] f32; (3) the rank loop of the
// allreduce and the reduce-scatter is instantiated for p = 2, 4 and 8 (the
// flat ring's 8 and the intra groups' 4 and 2), so that all p loads of a
// vector are issued before the first add; other p take the same kernel
// with the loop over a runtime p. Large work keeps 256 threads, at most 16
// blocks an SM, a grid-stride loop and 16-byte accesses. (A TMA bulk ring
// was 3-15% slower than plain loads for K1/K2's streaming passes, and is
// not tried here.)
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

// Calls launch(Ranks<P>{}) with P = p for the ring sizes on the paths (2,
// 4, 8), else P = 0: the kernel's loop over a runtime p.
template <int P>
using Ranks = std::integral_constant<int, P>;

template <typename F>
void with_ranks(int p, F&& launch) {
  switch (p) {
    case 2: launch(Ranks<2>{}); break;
    case 4: launch(Ranks<4>{}); break;
    case 8: launch(Ranks<8>{}); break;
    default: launch(Ranks<0>{}); break;
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

// The ring's sum of vector v over the p rank rows at xr (row stride
// row_vecs), started at rank r and taken rightward: ((x_r + x_{r+1}) +
// ...) + x_{r+p-1}, ranks mod p. With P > 0 (P == p) the p loads are all
// issued before the first add.
template <typename Op, int BYTES, int P>
__device__ __forceinline__ Pack<typename Op::S, BYTES> ring_sum(
    const typename RawOf<BYTES>::T* __restrict__ xr, int p, long long row_vecs,
    long long v, int r) {
  using S = typename Op::S;
  Pack<S, BYTES> acc;
  if constexpr (P > 0) {
    Pack<S, BYTES> in[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = (r + k < P) ? r + k : r + k - P;
      in[k].raw = xr[(long long)q * row_vecs + v];
    }
    acc = in[0];
#pragma unroll
    for (int k = 1; k < P; ++k) add_into<Op, BYTES>(acc, in[k]);
  } else {
    acc.raw = xr[(long long)r * row_vecs + v];
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      r = (r + 1 == p) ? 0 : r + 1;
      Pack<S, BYTES> in;
      in.raw = xr[(long long)r * row_vecs + v];
      add_into<Op, BYTES>(acc, in);
    }
  }
  return acc;
}

// blockIdx.y is the group: its p rows start at row blockIdx.y * p.
template <typename Op, int BYTES, int P>
__global__ void __launch_bounds__(256)
    ring_allreduce_kernel(const typename Op::S* __restrict__ x,
                          typename Op::S* __restrict__ out, int p,
                          long long row_vecs, long long chunk_vecs) {
  using R = typename RawOf<BYTES>::T;
  if constexpr (P > 0) p = P;
  const long long group = (long long)blockIdx.y * p * row_vecs;
  const R* xr = reinterpret_cast<const R*>(x) + group;
  R* outr = reinterpret_cast<R*>(out) + group;
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    // the chunk holding v is the rank its sum starts at
    const int r = (int)((v % seg_vecs) / chunk_vecs);
    const auto acc = ring_sum<Op, BYTES, P>(xr, p, row_vecs, v, r);
    for (int q = 0; q < p; ++q) outr[(long long)q * row_vecs + v] = acc.raw;
  }
}

template <typename Op, int BYTES, int P>
__global__ void __launch_bounds__(256)
    ring_reduce_scatter_kernel(const typename Op::S* __restrict__ x,
                               typename Op::S* __restrict__ out, int p,
                               long long seg_vecs) {
  using R = typename RawOf<BYTES>::T;
  if constexpr (P > 0) p = P;
  const R* xr = reinterpret_cast<const R*>(x);
  R* outr = reinterpret_cast<R*>(out);
  // a rank's row holds its p segments; the output holds one per rank
  const long long row_vecs = seg_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    // segment s's sum starts at rank s+1 and ends at its owner, rank s
    const int s = (int)(v / seg_vecs);
    outr[v] = ring_sum<Op, BYTES, P>(xr, p, row_vecs, v, (s + 1 == p) ? 0 : s + 1).raw;
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

// Group g (blockIdx.y) copies its source row, src_group_vecs after group
// g-1's, to its p rows of out.
template <int BYTES>
__global__ void __launch_bounds__(256)
    ring_broadcast_kernel(const unsigned char* __restrict__ src,
                          unsigned char* __restrict__ out, int p,
                          long long row_vecs, long long src_group_vecs) {
  using R = typename RawOf<BYTES>::T;
  const R* s = reinterpret_cast<const R*>(src) + (long long)blockIdx.y * src_group_vecs;
  R* o = reinterpret_cast<R*>(out) + (long long)blockIdx.y * p * row_vecs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    const R val = s[v];
    for (int q = 0; q < p; ++q) o[(long long)q * row_vecs + v] = val;
  }
}

template <int BYTES>
void launch_broadcast(const unsigned char* src, unsigned char* out, int p,
                      long long row_bytes, long long src_group_bytes, int groups,
                      cudaStream_t stream) {
  const long long row_vecs = row_bytes / BYTES;
  const LaunchShape sh = shape_for(row_vecs, groups);
  ring_broadcast_kernel<BYTES><<<sh.grid, sh.threads, 0, stream>>>(
      src, out, p, row_vecs, src_group_bytes / BYTES);
}

// For each of `groups` groups g: writes the row_bytes at src + g *
// src_group_bytes to each of the group's p rows of out (rows g*p ..
// g*p+p-1).
inline int replicate(const void* src, long long src_group_bytes, void* out, int p,
                     long long row_bytes, int groups, void* stream) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long stride = std::gcd(row_bytes, src_group_bytes);
  switch (vector_bytes(1, (unsigned long long)stride, s, d)) {
    case 16: launch_broadcast<16>(s, d, p, row_bytes, src_group_bytes, groups, st); break;
    case 8: launch_broadcast<8>(s, d, p, row_bytes, src_group_bytes, groups, st); break;
    case 4: launch_broadcast<4>(s, d, p, row_bytes, src_group_bytes, groups, st); break;
    case 2: launch_broadcast<2>(s, d, p, row_bytes, src_group_bytes, groups, st); break;
    default: launch_broadcast<1>(s, d, p, row_bytes, src_group_bytes, groups, st); break;
  }
  return (int)cudaGetLastError();
}

// The p rank rows of the cross-process K3, one pointer a rank, each into
// the slab of the process that owns it.
constexpr int kMaxTableRows = 32;
struct RowTable {
  const void* row[kMaxTableRows];
};

// ring_sum over the rows of a table: vector v of rank rows started at rank
// r, ((x_r + x_{r+1}) + ...) + x_{r+p-1}, ranks mod p.
// (The rows of a ring of p start at table row `base`: a group of the
// grouped form.)
template <typename Op, int BYTES, int P>
__device__ __forceinline__ Pack<typename Op::S, BYTES> table_sum(const RowTable& rows, int p,
                                                               long long v, int r,
                                                               int base = 0) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  Pack<S, BYTES> acc;
  if constexpr (P > 0) {
    Pack<S, BYTES> in[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = (r + k < P) ? r + k : r + k - P;
      in[k].raw = static_cast<const R*>(rows.row[base + q])[v];
    }
    acc = in[0];
#pragma unroll
    for (int k = 1; k < P; ++k) add_into<Op, BYTES>(acc, in[k]);
  } else {
    acc.raw = static_cast<const R*>(rows.row[base + r])[v];
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      r = (r + 1 == p) ? 0 : r + 1;
      Pack<S, BYTES> in;
      in.raw = static_cast<const R*>(rows.row[base + r])[v];
      add_into<Op, BYTES>(acc, in);
    }
  }
  return acc;
}

// The process's row of each rank of a table, or -1 for a rank it does not
// hold.
struct RankSlots {
  int slot[kMaxTableRows];
};

// The cross-process K3: group g (blockIdx.y) is the table's rows g*p ..
// g*p+p-1, a ring of p; every vector's ring sum of the group is written to
// the rows of out that the group's table rows name in `slots` (the
// process's own ranks of the group). One group with slots 0..local-1 is
// the flat ring.
template <typename Op, int BYTES, int P>
__global__ void __launch_bounds__(256)
    ring_allreduce_xproc_kernel(const __grid_constant__ RowTable rows,
                                const __grid_constant__ RankSlots slots,
                                typename Op::S* __restrict__ out, int p,
                                long long row_vecs, long long chunk_vecs) {
  using R = typename RawOf<BYTES>::T;
  if constexpr (P > 0) p = P;
  R* outr = reinterpret_cast<R*>(out);
  const int base = blockIdx.y * p;
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    const int r = (int)((v % seg_vecs) / chunk_vecs);
    const auto acc = table_sum<Op, BYTES, P>(rows, p, v, r, base);
    for (int q = 0; q < p; ++q) {
      const int slot = slots.slot[base + q];
      if (slot >= 0) outr[(long long)slot * row_vecs + v] = acc.raw;
    }
  }
}

// The cross-process K7: each row i of out gets the bytes of the source
// row groups[i] (each group's root row, where it lies); blockIdx.y is the
// source row.
template <int BYTES>
__global__ void __launch_bounds__(256)
    ring_broadcast_xproc_kernel(const __grid_constant__ RowTable srcs,
                                const __grid_constant__ RankSlots groups,
                                unsigned char* __restrict__ out, int local,
                                long long row_vecs) {
  using R = typename RawOf<BYTES>::T;
  const int g = blockIdx.y;
  const R* s = static_cast<const R*>(srcs.row[g]);
  R* o = reinterpret_cast<R*>(out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    const R val = s[v];
    for (int i = 0; i < local; ++i) {
      if (groups.slot[i] == g) o[(long long)i * row_vecs + v] = val;
    }
  }
}

template <int BYTES>
void launch_broadcast_xproc(const RowTable& srcs, const RankSlots& groups, int ngroups,
                            unsigned char* out, int local, long long row_bytes,
                            cudaStream_t stream) {
  const long long row_vecs = row_bytes / BYTES;
  const LaunchShape sh = shape_for(row_vecs, ngroups);
  ring_broadcast_xproc_kernel<BYTES><<<sh.grid, sh.threads, 0, stream>>>(
      srcs, groups, out, local, row_vecs);
}

// The global rank of each of a process's rows in the cross-process 'rs':
// row i of the output is that rank's segment.
struct OwnedTable {
  int rank[kMaxTableRows];
};

// The cross-process K3 'rs': vector j of local row i is vector j of
// segment s = owned[i] of the sum over the table's p rows (each p
// segments of seg_vecs), started at rank s+1 and walked rightward to s.
template <typename Op, int BYTES, int P>
__global__ void __launch_bounds__(256)
    ring_reduce_scatter_xproc_kernel(const __grid_constant__ RowTable rows,
                                     const __grid_constant__ OwnedTable owned,
                                     typename Op::S* __restrict__ out, int p, int local,
                                     long long seg_vecs) {
  using R = typename RawOf<BYTES>::T;
  if constexpr (P > 0) p = P;
  R* outr = reinterpret_cast<R*>(out);
  const long long total = (long long)local * seg_vecs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += stride) {
    const int i = (int)(v / seg_vecs);
    const int s = owned.rank[i];
    const long long at = (long long)s * seg_vecs + (v - (long long)i * seg_vecs);
    outr[v] = table_sum<Op, BYTES, P>(rows, p, at, (s + 1 == p) ? 0 : s + 1).raw;
  }
}

// The cross-process K3 'ag': the table's p blocks of row_vecs, each read
// once, written in rank order to each of the `local` rows of out (a row
// is p blocks).
template <int BYTES>
__global__ void __launch_bounds__(256)
    ring_allgather_xproc_kernel(const __grid_constant__ RowTable rows,
                                unsigned char* __restrict__ out, int p, int local,
                                long long row_vecs) {
  using R = typename RawOf<BYTES>::T;
  R* o = reinterpret_cast<R*>(out);
  const long long block = (long long)p * row_vecs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < block;
       v += stride) {
    const int q = (int)(v / row_vecs);
    const R val = static_cast<const R*>(rows.row[q])[v - (long long)q * row_vecs];
    for (int i = 0; i < local; ++i) o[(long long)i * block + v] = val;
  }
}

template <int BYTES>
void launch_allgather_xproc(const RowTable& rows, unsigned char* out, int p, int local,
                            long long row_bytes, cudaStream_t stream) {
  const long long row_vecs = row_bytes / BYTES;
  const LaunchShape sh = shape_for(p * row_vecs, 1);
  ring_allgather_xproc_kernel<BYTES><<<sh.grid, sh.threads, 0, stream>>>(
      rows, out, p, local, row_vecs);
}

// The cross-process K5: tm_ring_allreduce_bidir's sums (half A rightward,
// half B leftward, each half in its own chunk layout) over the table's p
// rows, written to the `local` rows of out.
template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_allreduce_bidir_xproc_kernel(const __grid_constant__ RowTable rows,
                                      typename Op::S* __restrict__ out, int p, int local,
                                      long long row_vecs, long long half_vecs,
                                      long long chunk_vecs) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  R* outr = reinterpret_cast<R*>(out);
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    const bool leftward = v >= half_vecs;
    const long long i = leftward ? v - half_vecs : v;
    int r = (int)((i % seg_vecs) / chunk_vecs);
    Pack<S, BYTES> acc;
    acc.raw = static_cast<const R*>(rows.row[r])[v];
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      if (leftward) {
        r = (r == 0) ? p - 1 : r - 1;
      } else {
        r = (r + 1 == p) ? 0 : r + 1;
      }
      Pack<S, BYTES> in;
      in.raw = static_cast<const R*>(rows.row[r])[v];
      add_into<Op, BYTES>(acc, in);
    }
    for (int q = 0; q < local; ++q) outr[(long long)q * row_vecs + v] = acc.raw;
  }
}

// The cross-process K6, launched by the root's process only: vector v of
// the ring's sum over the table's p rows (tm_ring_reduce's chunk layout and
// order of adds) written to the root's slot of out, and each other rank the
// process holds given its own value, copied as the sum reads it.
template <typename Op, int BYTES>
__global__ void __launch_bounds__(256)
    ring_reduce_xproc_kernel(const __grid_constant__ RowTable rows,
                             const __grid_constant__ RankSlots slots,
                             typename Op::S* __restrict__ out, int p, long long row_vecs,
                             long long chunk_vecs, int root) {
  using S = typename Op::S;
  using R = typename RawOf<BYTES>::T;
  R* outr = reinterpret_cast<R*>(out);
  const long long seg_vecs = chunk_vecs * p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < row_vecs; v += stride) {
    int r = (int)((v % seg_vecs) / chunk_vecs);
    Pack<S, BYTES> acc;
    acc.raw = static_cast<const R*>(rows.row[r])[v];
    if (r != root && slots.slot[r] >= 0) outr[(long long)slots.slot[r] * row_vecs + v] = acc.raw;
#pragma unroll 4
    for (int k = 1; k < p; ++k) {
      r = (r + 1 == p) ? 0 : r + 1;
      Pack<S, BYTES> in;
      in.raw = static_cast<const R*>(rows.row[r])[v];
      if (r != root && slots.slot[r] >= 0) outr[(long long)slots.slot[r] * row_vecs + v] = in.raw;
      add_into<Op, BYTES>(acc, in);
    }
    outr[(long long)slots.slot[root] * row_vecs + v] = acc.raw;
  }
}

// Ranks per group of `rows` rows in `groups` groups, or 0 when they do not
// split evenly (or more groups than a grid's y dimension takes).
inline int group_size(int rows, int groups) {
  if (rows < 1 || groups < 1 || groups > 65535 || rows % groups) return 0;
  return rows / groups;
}

}  // namespace tmpi

// x and out: [rows, n] contiguous rows of the payload type `dtype`
// (tmpi::Dtype), `groups` rings of rows / groups ranks in group-major
// order; every group's rows get its own ring's sum. chunk_elems: elements
// per ring chunk of one group's ring, a multiple of 128.
extern "C" int tm_ring_allreduce(const void* x, void* out, int dtype, int rows,
                                 int groups, long long n, long long chunk_elems,
                                 void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  const int p = group_size(rows, groups);
  if (itemsize == 0 || p < 1 || n < 0 || chunk_elems <= 0 || chunk_elems % 128) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = vector_bytes(itemsize, (unsigned long long)n * itemsize, x, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kBytes = decltype(width)::value;
    constexpr int kVW = kBytes / (int)sizeof(S);
    const LaunchShape sh = shape_for(n / kVW, groups);
    with_ranks(p, [&](auto ranks) {
      ring_allreduce_kernel<Op, kBytes, decltype(ranks)::value>
          <<<sh.grid, sh.threads, 0, s>>>(static_cast<const S*>(x), static_cast<S*>(out),
                                          p, n / kVW, chunk_elems / kVW);
    });
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
    constexpr int kBytes = decltype(width)::value;
    constexpr int kVW = kBytes / (int)sizeof(S);
    const LaunchShape sh = shape_for(p * (seg_n / kVW), 1);
    with_ranks(p, [&](auto ranks) {
      ring_reduce_scatter_kernel<Op, kBytes, decltype(ranks)::value>
          <<<sh.grid, sh.threads, 0, s>>>(static_cast<const S*>(x), static_cast<S*>(out),
                                          p, seg_n / kVW);
    });
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: [rows, row_bytes] contiguous byte rows, `groups` groups of p = rows /
// groups ranks in group-major order; out: [rows, p, row_bytes], every row
// of group g a copy of the group's p rows of x.
extern "C" int tm_ring_allgather(const void* x, void* out, int rows, int groups,
                                 long long row_bytes, void* stream) {
  const int p = tmpi::group_size(rows, groups);
  if (p < 1 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  const long long block = (long long)p * row_bytes;
  return tmpi::replicate(x, block, out, p, block, groups, stream);
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
    const LaunchShape sh = shape_for(n / kVW, 1);
    ring_reduce_kernel<Op, decltype(width)::value>
        <<<sh.grid, sh.threads, 0, s>>>(static_cast<const S*>(x), static_cast<S*>(out), p,
                                        n / kVW, chunk_elems / kVW, root);
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
    const LaunchShape sh = shape_for(n / kVW, 1);
    ring_allreduce_bidir_kernel<Op, decltype(width)::value>
        <<<sh.grid, sh.threads, 0, s>>>(static_cast<const S*>(x), static_cast<S*>(out), p,
                                        n / kVW, half / kVW, chunk_elems / kVW);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x and out: [rows, row_bytes] contiguous byte rows, `groups` groups of p =
// rows / groups ranks in group-major order; every row of group g gets the
// group's row g*p + root.
extern "C" int tm_ring_broadcast(const void* x, void* out, int rows, int groups,
                                 long long row_bytes, int root, void* stream) {
  const int p = tmpi::group_size(rows, groups);
  if (p < 1 || row_bytes < 0 || root < 0 || root >= p) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned char* src =
      static_cast<const unsigned char*>(x) + (long long)root * row_bytes;
  return tmpi::replicate(src, (long long)p * row_bytes, out, p, row_bytes, groups, stream);
}

// The cross-process K3. rows: `count` device addresses in `groups` groups
// of p = count / groups ranks, group-major, rank row t of n elements of
// `dtype` (each in the slab of the process that owns it); slots: for each
// table row, the row of out ([local, n] contiguous) that gets its group's
// sum (this process's own ranks), or -1. Each group's sum is
// tm_ring_allreduce's for a ring of p (chunk_elems, a multiple of 128), so
// the result is the one-process grouped launch's rows. One group with
// slots 0..local-1 is the flat ring.
extern "C" int tm_ring_allreduce_xproc(const unsigned long long* rows, int count, int groups,
                                       const int* slots, void* out, int local, int dtype,
                                       long long n, long long chunk_elems, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  const int p = group_size(count, groups);
  if (itemsize == 0 || p < 1 || count > kMaxTableRows || local < 1 || n < 0 ||
      chunk_elems <= 0 || chunk_elems % 128) {
    return (int)cudaErrorInvalidValue;
  }
  RankSlots slot;
  for (int t = 0; t < kMaxTableRows; ++t) slot.slot[t] = -1;
  for (int t = 0; t < count; ++t) {
    if (slots[t] < -1 || slots[t] >= local) return (int)cudaErrorInvalidValue;
    slot.slot[t] = slots[t];
  }
  RowTable table = {};
  int bytes = 16;
  for (int r = 0; r < count; ++r) {
    table.row[r] = reinterpret_cast<const void*>(rows[r]);
    const int w = vector_bytes(itemsize, (unsigned long long)n * itemsize, table.row[r], out);
    if (w < bytes) bytes = w;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kBytes = decltype(width)::value;
    constexpr int kVW = kBytes / (int)sizeof(S);
    const LaunchShape sh = shape_for(n / kVW, groups);
    with_ranks(p, [&](auto ranks) {
      ring_allreduce_xproc_kernel<Op, kBytes, decltype(ranks)::value>
          <<<sh.grid, sh.threads, 0, s>>>(table, slot, static_cast<S*>(out), p, n / kVW,
                                          chunk_elems / kVW);
    });
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The cross-process K7. srcs: `groups` device addresses, each group's root
// row of row_bytes (in the slab of the process that owns it); of_group:
// for each of the `local` rows of out ([local, row_bytes] contiguous), the
// group whose root row it gets. One group is the flat broadcast.
extern "C" int tm_ring_broadcast_xproc(const unsigned long long* srcs, int groups,
                                       const int* of_group, void* out, int local,
                                       long long row_bytes, void* stream) {
  using namespace tmpi;
  if (groups < 1 || groups > kMaxTableRows || local < 1 || local > kMaxTableRows ||
      row_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  RankSlots of;
  for (int i = 0; i < kMaxTableRows; ++i) of.slot[i] = -1;
  for (int i = 0; i < local; ++i) {
    if (of_group[i] < 0 || of_group[i] >= groups) return (int)cudaErrorInvalidValue;
    of.slot[i] = of_group[i];
  }
  RowTable table = {};
  int bytes = 16;
  for (int g = 0; g < groups; ++g) {
    table.row[g] = reinterpret_cast<const void*>(srcs[g]);
    const int w = vector_bytes(1, (unsigned long long)row_bytes, table.row[g], out);
    if (w < bytes) bytes = w;
  }
  unsigned char* o = static_cast<unsigned char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bytes) {
    case 16: launch_broadcast_xproc<16>(table, of, groups, o, local, row_bytes, s); break;
    case 8: launch_broadcast_xproc<8>(table, of, groups, o, local, row_bytes, s); break;
    case 4: launch_broadcast_xproc<4>(table, of, groups, o, local, row_bytes, s); break;
    case 2: launch_broadcast_xproc<2>(table, of, groups, o, local, row_bytes, s); break;
    default: launch_broadcast_xproc<1>(table, of, groups, o, local, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

// The cross-process K3 'rs'. rows: p device addresses, rank r's row of p
// segments of seg_n elements of `dtype` (each in the slab of the process
// that owns r); owned: the global rank of each of the `local` rows of out
// ([local, seg_n] contiguous), whose row i is the sum of every rank's
// segment owned[i], in tm_ring_reduce_scatter's order of adds.
extern "C" int tm_ring_reduce_scatter_xproc(const unsigned long long* rows, int p,
                                            const int* owned, int local, void* out,
                                            int dtype, long long seg_n, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || p > kMaxTableRows || local < 1 || local > kMaxTableRows ||
      seg_n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  OwnedTable own = {};
  for (int i = 0; i < local; ++i) {
    if (owned[i] < 0 || owned[i] >= p) return (int)cudaErrorInvalidValue;
    own.rank[i] = owned[i];
  }
  RowTable table = {};
  // a vector never straddles two segments: its width divides seg_n's bytes
  int bytes = 16;
  for (int r = 0; r < p; ++r) {
    table.row[r] = reinterpret_cast<const void*>(rows[r]);
    const int w = vector_bytes(itemsize, (unsigned long long)seg_n * itemsize, table.row[r], out);
    if (w < bytes) bytes = w;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kBytes = decltype(width)::value;
    constexpr int kVW = kBytes / (int)sizeof(S);
    const LaunchShape sh = shape_for(local * (seg_n / kVW), 1);
    with_ranks(p, [&](auto ranks) {
      ring_reduce_scatter_xproc_kernel<Op, kBytes, decltype(ranks)::value>
          <<<sh.grid, sh.threads, 0, s>>>(table, own, static_cast<S*>(out), p, local,
                                          seg_n / kVW);
    });
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The cross-process K3 'ag'. rows: p device addresses, rank r's block of
// row_bytes (each in the slab of the process that owns r); out: [local, p,
// row_bytes] contiguous, every row the p blocks in rank order.
extern "C" int tm_ring_allgather_xproc(const unsigned long long* rows, int p, void* out,
                                       int local, long long row_bytes, void* stream) {
  using namespace tmpi;
  if (p < 1 || p > kMaxTableRows || local < 1 || row_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  RowTable table = {};
  int bytes = 16;
  for (int r = 0; r < p; ++r) {
    table.row[r] = reinterpret_cast<const void*>(rows[r]);
    const int w = vector_bytes(1, (unsigned long long)row_bytes, table.row[r], out);
    if (w < bytes) bytes = w;
  }
  unsigned char* o = static_cast<unsigned char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bytes) {
    case 16: launch_allgather_xproc<16>(table, o, p, local, row_bytes, s); break;
    case 8: launch_allgather_xproc<8>(table, o, p, local, row_bytes, s); break;
    case 4: launch_allgather_xproc<4>(table, o, p, local, row_bytes, s); break;
    case 2: launch_allgather_xproc<2>(table, o, p, local, row_bytes, s); break;
    default: launch_allgather_xproc<1>(table, o, p, local, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

// The cross-process K5. rows: p device addresses, rank r's row of n
// elements of `dtype` (each in the slab of the process that owns r); out:
// [local, n] contiguous, every row tm_ring_allreduce_bidir's sum for a ring
// of p: elements [0, half) summed rightward, [half, n) leftward, each half
// in chunks of chunk_elems (a multiple of 128) from its own start.
extern "C" int tm_ring_allreduce_bidir_xproc(const unsigned long long* rows, int p, void* out,
                                             int local, int dtype, long long n, long long half,
                                             long long chunk_elems, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || p > kMaxTableRows || local < 1 || n < 0 || half < 0 ||
      half > n || chunk_elems <= 0 || chunk_elems % 128) {
    return (int)cudaErrorInvalidValue;
  }
  RowTable table = {};
  // a vector must not straddle the two halves: its width divides both
  int bytes = 16;
  for (int r = 0; r < p; ++r) {
    table.row[r] = reinterpret_cast<const void*>(rows[r]);
    const int w = vector_bytes(itemsize, (unsigned long long)std::gcd(n, half) * itemsize,
                               table.row[r], out);
    if (w < bytes) bytes = w;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kVW = decltype(width)::value / (int)sizeof(S);
    const LaunchShape sh = shape_for(n / kVW, 1);
    ring_allreduce_bidir_xproc_kernel<Op, decltype(width)::value>
        <<<sh.grid, sh.threads, 0, s>>>(table, static_cast<S*>(out), p, local, n / kVW,
                                        half / kVW, chunk_elems / kVW);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The cross-process K6, launched by the process that owns `root`. rows: p
// device addresses, rank r's row of n elements of `dtype` (each in the slab
// of the process that owns r); owned: the global rank of each of the
// `local` rows of out ([local, n] contiguous), root among them. The root's
// row is tm_ring_reduce's sum for a ring of p (chunk_elems, a multiple of
// 128), every other row its rank's input.
extern "C" int tm_ring_reduce_xproc(const unsigned long long* rows, int p, const int* owned,
                                    int local, void* out, int dtype, long long n,
                                    long long chunk_elems, int root, void* stream) {
  using namespace tmpi;
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || p < 1 || p > kMaxTableRows || local < 1 || local > p || n < 0 ||
      chunk_elems <= 0 || chunk_elems % 128 || root < 0 || root >= p) {
    return (int)cudaErrorInvalidValue;
  }
  RankSlots slots;
  for (int r = 0; r < kMaxTableRows; ++r) slots.slot[r] = -1;
  for (int i = 0; i < local; ++i) {
    if (owned[i] < 0 || owned[i] >= p || slots.slot[owned[i]] >= 0) {
      return (int)cudaErrorInvalidValue;
    }
    slots.slot[owned[i]] = i;
  }
  if (slots.slot[root] < 0) return (int)cudaErrorInvalidValue;
  RowTable table = {};
  int bytes = 16;
  for (int r = 0; r < p; ++r) {
    table.row[r] = reinterpret_cast<const void*>(rows[r]);
    const int w = vector_bytes(itemsize, (unsigned long long)n * itemsize, table.row[r], out);
    if (w < bytes) bytes = w;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_reduce_type(dtype, bytes, [&](auto op, auto width) {
    using Op = decltype(op);
    using S = typename Op::S;
    constexpr int kVW = decltype(width)::value / (int)sizeof(S);
    const LaunchShape sh = shape_for(n / kVW, 1);
    ring_reduce_xproc_kernel<Op, decltype(width)::value>
        <<<sh.grid, sh.threads, 0, s>>>(table, slots, static_cast<S*>(out), p, n / kVW,
                                        chunk_elems / kVW, root);
  });
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
