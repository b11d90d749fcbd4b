// Ring allreduce and reduce-scatter with a compressed wire, over p virtual
// ranks held on one card.
//
// Replaces torchmpi_tpu/ops/ring_kernels.py:_ring_quant_kernel (allreduce
// and 'rs' modes). On the TPU every hop ships the outgoing chunk in a wire
// encoding instead of f32, and the receiver decodes it and adds in f32:
//
// - int8: one f32 scale per 128-lane row, scale = max(rowmax|v|, 1e-30)/127,
//   code = round-half-even(v / scale);
// - bf16: a round-to-nearest-even cast.
//
// The chunk that holds a row fixes the rank c its sum starts at. In the
// reduce-scatter phase acc = x[c], then acc = x[c+k] + decode(encode(acc))
// for k = 1..p-1 (ranks mod p); the last rank, c-1, owns the sum and keeps
// it in f32. In the all-gather phase every other rank installs the decoding
// of the wire form of its left neighbour's value: out[c] =
// decode(encode(acc)), out[c+k] = decode(encode(out[c+k-1])). So the ranks'
// rows differ by the wire's rounding, as in the JAX package.
//
// On one card the remote copies, the two-slot staging buffers, the scale
// stream and the semaphores go away. One launch does it all, a warp per
// 128-lane row position: each lane holds 4 of the row's elements. The row
// layout (which chunk, so which start rank) comes from the Python wrapper
// (ops/ring_kernels.py:quant_chunk_elems), which keeps the JAX wrapper's
// 128-row-aligned segmentation.
//
// Bound: each rank's row is read once and written once, 2*p*n*4 bytes at
// 3.35 TB/s (LeNet's first gradient bucket at p=8, n=805386: 51.5 MB,
// 15.4 us). What stands between the kernel and that bound is the hop
// chain: 2(p-1) dependent encodes (a warp-wide max, then a division per
// element) that the warp must walk before it stores and loads again, so the
// card needs many rows in flight and a short chain. The design:
//
// - Many warps: the grid holds as many blocks as the card keeps resident,
//   at least 3 an SM (every rank's values of a row in registers, at most 85
//   a thread); each warp walks rows with a stride, its p loads issued
//   together. (A second register set that loads the next row during the
//   chain, or a cp.async stage in shared memory, cost more in warps than it
//   gained: slower, in trial builds on an H100.)
// - Vector accesses: 16 bytes a lane where every rank's row is 16-byte
//   aligned, else 8, else 4 (the main path's n = 805386 is even, not a
//   multiple of 4: 8 bytes). A ragged last row takes masked scalar ones.
//   Loads and stores are evict-first (__ldcs, __stcs): faster, in trial
//   builds on an H100.
// - A short encode: the row max is one warp reduction (REDUX on the bits
//   of |v|, which order as the floats do); the code comes from a
//   reciprocal and two FMA corrections, exact but within 2^-15 of a
//   half-integer, where the lane takes the IEEE division instead; its round
//   half to even is an add and a subtract of 1.5 * 2^23 (exact for
//   |v / scale| < 2^22, here at most 127), with no -0.0 code.
// - The decode-and-add is one FMA, as XLA fuses the JAX kernel's (so the
//   sum is rounded once, C4).
// - The all-gather encodes once. Re-encoding a decoded row gives the same
//   codes: its max is the largest code times the scale, that code is 127
//   (or the row is under the floor and the scale stays), so each new code
//   is the old one times 1 +- 2^-21. Only the scale moves, s' = RN(max(RN(
//   qmax * s), 1e-30) * RN(1/127)), and each later hop installs q * s'.
//   A bf16 hop re-installs the same values.
//
// The cross-process form (tm_ring_quant_xproc) is the same hop chain over
// ranks held by several processes on the card (runtime/peers.py): it reads
// every rank's row through a table of pointers into the processes' slabs,
// as the cross-process K3 does, and writes only this process's ranks'
// rows. The allreduce walks every row position's whole chain and stores the
// local ranks' values; the reduce-scatter walks only the segments this
// process's ranks own. So each process's rows are the one-card kernel's
// rows bit for bit. No launch waits on another process: the lane's events
// and host sequence numbers order the slab copies around it.
//
// Rounding is spelled out so that the plain PyTorch version, which walks
// every hop in full, repeats it bit for bit: the scale is a product with
// 1/127 rounded to f32 (XLA's rewrite of the JAX kernel's division), the
// code the IEEE quotient rounded half to even, the decode-and-add one FMA,
// the all-gather's decode one product. The intrinsics keep nvcc from
// contracting or reassociating any of it. Do not build with fast math.
#include "common.cuh"

namespace tmpi {
namespace {

constexpr float kInv127 = 0x1.020408p-7f;        // 1/127 rounded to f32
constexpr float kScaleFloor = 0x1.4484cp-100f;   // 1e-30 rounded to f32
constexpr float kRoundMagic = 0x1.8p+23f;        // 1.5 * 2^23
constexpr int kLanes = 128;
constexpr int kPerLane = kLanes / 32;
constexpr int kThreads = 256;
// blocks an SM keeps resident (so at most 85 registers a thread)
constexpr int kMinBlocks = 3;
// a quotient this far from every half-integer rounds as the IEEE one does
constexpr float kSafeFrac = 0.5f - 0x1p-15f;

enum Wire { kWireInt8 = 0, kWireBF16 = 1 };
enum Mode { kAllreduce = 0, kReduceScatter = 1 };

__device__ __forceinline__ float round_half_even(float x) {
  return __fadd_rn(__fadd_rn(x, kRoundMagic), -kRoundMagic);
}

// The warp's max of non-negative floats (NaN above all), one REDUX.
__device__ __forceinline__ float warp_max(float m) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
}

// The int8 scale of a row whose max |v| is m (a NaN max stays NaN).
__device__ __forceinline__ float int8_scale(float m) {
  return __fmul_rn(m < kScaleFloor ? kScaleFloor : m, kInv127);
}

// The wire form of one row held by a warp: codes as f32, and the int8 scale.
// The code is RN(v / s) rounded half to even. q1, from a reciprocal y of s
// within an ulp and two FMA corrections, is within 0.51 ulp of v / s, and
// so within 1.01 ulp of RN(v / s): where it lies more than 2^-15 from every
// half-integer (the ulp of a quotient under 128 is at most 2^-17), both
// round to the same integer; elsewhere, and for a NaN or infinite q1, the
// lane divides.
template <int WIRE>
__device__ __forceinline__ void encode(const float (&v)[kPerLane],
                                       float (&q)[kPerLane], float& s) {
  if constexpr (WIRE == kWireInt8) {
    float m = fabsf(v[0]);
#pragma unroll
    for (int j = 1; j < kPerLane; ++j) m = fmaxf(m, fabsf(v[j]));
    s = int8_scale(warp_max(m));
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(s));
    bool safe = true;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float q0 = __fmul_rn(v[j], y);
      const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v[j]), y, q0);
      q[j] = round_half_even(q1);
      safe &= fabsf(__fsub_rn(q1, q[j])) < kSafeFrac;
    }
    if (!safe) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) q[j] = round_half_even(__fdiv_rn(v[j], s));
    }
  } else {
    s = 1.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      q[j] = __bfloat162float(__float2bfloat16_rn(v[j]));
    }
  }
}

// The scale with which the all-gather's next hop re-encodes a row decoded
// from codes whose largest magnitude is qmax at scale s (the codes stay).
template <int WIRE>
__device__ __forceinline__ float next_scale(float qmax, float s) {
  if constexpr (WIRE == kWireInt8) return int8_scale(__fmul_rn(qmax, s));
  return s;
}

// An all-gather hop's install.
template <int WIRE>
__device__ __forceinline__ float decode(float q, float s) {
  if constexpr (WIRE == kWireInt8) return __fmul_rn(q, s);
  return q;
}

// A reduce-scatter hop's receive: local + decode(q), rounded once.
template <int WIRE>
__device__ __forceinline__ float decode_add(float q, float s, float local) {
  if constexpr (WIRE == kWireInt8) return __fmaf_rn(q, s, local);
  return __fadd_rn(local, q);
}

// The row element that a lane's j-th value is, for accesses of V floats:
// lane l holds [lV, lV + V) of each 32V-element stretch.
template <int V>
__device__ __forceinline__ int elem(int lane, int j) {
  return (j / V) * 32 * V + lane * V + j % V;
}

// Loads and stores stream past the L2 (evict-first): every rank's row is
// read once, and written once and read by the caller only after the launch.
template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int valid,
                                         int lane, float (&v)[kPerLane]) {
  if (valid == kLanes) {
    if constexpr (V == 4) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(src) + lane);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if constexpr (V == 2) {
      const float2 a = __ldcs(reinterpret_cast<const float2*>(src) + lane);
      const float2 b = __ldcs(reinterpret_cast<const float2*>(src + 64) + lane);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = __ldcs(src + 32 * j + lane);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = elem<V>(lane, j);
      v[j] = e < valid ? __ldcs(src + e) : 0.0f;  // the JAX wrapper pads with zeros
    }
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int valid, int lane,
                                          const float (&v)[kPerLane]) {
  if (valid == kLanes) {
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(dst) + lane, make_float4(v[0], v[1], v[2], v[3]));
    } else if constexpr (V == 2) {
      __stcs(reinterpret_cast<float2*>(dst) + lane, make_float2(v[0], v[1]));
      __stcs(reinterpret_cast<float2*>(dst + 64) + lane, make_float2(v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) __stcs(dst + 32 * j + lane, v[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = elem<V>(lane, j);
      if (e < valid) __stcs(dst + e, v[j]);
    }
  }
}

// Where the rank rows lie: one [p, stride] tensor on this card, or (the
// cross-process form) a table of p rows, each in the slab of the process
// that owns its rank.
struct Stacked {
  const float* x;
  long long stride;
  __device__ __forceinline__ const float* rank(int r) const { return x + r * stride; }
};

constexpr int kMaxTableRows = 32;
struct Table {
  const float* row[kMaxTableRows];
  __device__ __forceinline__ const float* rank(int r) const { return row[r]; }
};

// Where rank r's output row lies: row r of one [p, n] tensor, or row
// slot[r] of this process's [local, n] (nullptr for another process's rank).
// kEveryRank: every rank has a row, so no store tests for nullptr.
struct StackedOut {
  static constexpr bool kEveryRank = true;
  float* out;
  long long n;
  __device__ __forceinline__ float* rank(int r) const { return out + r * n; }
};

struct LocalOut {
  static constexpr bool kEveryRank = false;
  float* out;
  long long n;
  int slot[kMaxTableRows];
  __device__ __forceinline__ float* rank(int r) const {
    return slot[r] < 0 ? nullptr : out + slot[r] * n;
  }
};

// The segments a reduce-scatter walks: every rank's (one card), or those
// of this process's ranks, in the order of its output rows.
struct AllSegments {
  __device__ __forceinline__ int at(long long i) const { return (int)i; }
};

struct OwnedSegments {
  int rank[kMaxTableRows];
  __device__ __forceinline__ int at(long long i) const { return rank[i]; }
};

// Where row w lies and where its sum starts.
// allreduce: every rank's row is n elements; row w is elements [128w, 128w
//   + 128) of each, in the chunk (128w % (p*chunk)) / chunk.
// reduce-scatter: every rank's row is p segments of n; row w is row w % rps
//   of segment s = segs.at(w / rps), whose sum starts at rank s + 1 (the
//   JAX wrapper's pre-roll) and ends at its owner, rank s.
// Either way the sum's owner is rank c - 1.
struct Row {
  long long off;  // the row's first element in every rank's input row
  long long dst;  // and in an output row
  int valid;      // its elements, 128 but in a ragged last row
  int c;          // the rank its sum starts at
};

template <int MODE, typename Segs>
__device__ __forceinline__ Row row_at(long long w, int p, long long n, long long rps,
                                      long long chunk_elems, const Segs& segs) {
  Row r;
  if constexpr (MODE == kAllreduce) {
    r.off = w * kLanes;
    r.dst = r.off;
    r.valid = (int)min((long long)kLanes, n - r.off);
    r.c = (int)((r.off % (chunk_elems * p)) / chunk_elems);
  } else {
    const long long i = w / rps, wr = w - i * rps;
    const int s = segs.at(i);
    r.off = s * n + wr * kLanes;
    r.dst = wr * kLanes;
    r.valid = (int)min((long long)kLanes, n - wr * kLanes);
    r.c = (s + 1) % p;
  }
  return r;
}

// Every rank's values of a row, in ring order from its start rank.
template <int MAXP, int V, typename Src>
__device__ __forceinline__ void load_ranks(const Src& src, const Row& row, int p, int lane,
                                           float (&held)[MAXP][kPerLane]) {
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    if (k < p) {
      const int r = row.c + k < p ? row.c + k : row.c + k - p;
      load_row<V>(src.rank(r) + row.off, row.valid, lane, held[k]);
    }
  }
}

// The hop chain of one row, then its stores. MAXP > 0: ``held`` has every
// rank's values (p <= MAXP); MAXP == 0: each rank's are loaded when the
// walk reaches them. Only the ranks whose output row ``dst`` holds are
// stored.
template <int WIRE, int MODE, int MAXP, int V, typename Src, typename Dst>
__device__ __forceinline__ void walk_row(const float (&held)[MAXP > 0 ? MAXP : 1][kPerLane],
                                         const Src& src, const Dst& dst, const Row& row,
                                         int p, int lane) {
  // reduce-scatter: round the ring from rank c
  float acc[kPerLane];
  if constexpr (MAXP > 0) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = held[0][j];
#pragma unroll
    for (int k = 1; k < MAXP; ++k) {
      if (k >= p) break;
      float q[kPerLane], s;
      encode<WIRE>(acc, q, s);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[j] = decode_add<WIRE>(q[j], s, held[k][j]);
    }
  } else {
    load_row<V>(src.rank(row.c) + row.off, row.valid, lane, acc);
    for (int k = 1; k < p; ++k) {
      const int r = row.c + k < p ? row.c + k : row.c + k - p;
      float local[kPerLane], q[kPerLane], s;
      load_row<V>(src.rank(r) + row.off, row.valid, lane, local);
      encode<WIRE>(acc, q, s);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[j] = decode_add<WIRE>(q[j], s, local[j]);
    }
  }

  float* owner = dst.rank(row.c == 0 ? p - 1 : row.c - 1);
  if (Dst::kEveryRank || owner != nullptr) store_row<V>(owner + row.dst, row.valid, lane, acc);
  if constexpr (MODE == kAllreduce) {
    // all-gather: the owner keeps its f32 sum; each later rank installs
    // the decoding of the wire form of its left neighbour's value, the
    // owner's codes at a scale that moves from hop to hop (see the top)
    float q[kPerLane], s;
    encode<WIRE>(acc, q, s);
    float qmax = fabsf(q[0]);
#pragma unroll
    for (int j = 1; j < kPerLane; ++j) qmax = fmaxf(qmax, fabsf(q[j]));
    if constexpr (WIRE == kWireInt8) qmax = warp_max(qmax);
    for (int k = 0; k < p - 1; ++k) {
      const int r = row.c + k < p ? row.c + k : row.c + k - p;
      if (k > 0) s = next_scale<WIRE>(qmax, s);
      float* o = dst.rank(r);
      if (!Dst::kEveryRank && o == nullptr) continue;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[j] = decode<WIRE>(q[j], s);
      store_row<V>(o + row.dst, row.valid, lane, acc);
    }
  }
}

template <int WIRE, int MODE, int MAXP, int V, typename Src, typename Dst, typename Segs>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ring_quant_kernel(const __grid_constant__ Src src, const __grid_constant__ Dst dst,
                      const __grid_constant__ Segs segs, int p, long long n, long long nrows,
                      long long chunk_elems) {
  const int lane = threadIdx.x & 31;
  const long long rps = (n + kLanes - 1) / kLanes;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  for (; w < nrows; w += warps) {
    const Row row = row_at<MODE>(w, p, n, rps, chunk_elems, segs);
    float held[MAXP > 0 ? MAXP : 1][kPerLane];
    if constexpr (MAXP > 0) load_ranks<MAXP, V>(src, row, p, lane, held);
    walk_row<WIRE, MODE, MAXP, V>(held, src, dst, row, p, lane);
  }
}

// One launch over `nrows` row positions of `n`-element rows (segments).
template <int WIRE, int MODE, int MAXP, int V, typename Src, typename Dst, typename Segs>
void launch(const Src& src, const Dst& dst, const Segs& segs, int p, long long n,
            long long nrows, long long chunk_elems, cudaStream_t stream) {
  // as many blocks as the card keeps resident, found once per instantiation
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_quant_kernel<WIRE, MODE, MAXP, V, Src, Dst, Segs>, kThreads, 0);
    resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (nrows * 32 + kThreads - 1) / kThreads;
  const unsigned int blocks = (unsigned int)(need < resident ? need : resident);
  ring_quant_kernel<WIRE, MODE, MAXP, V, Src, Dst, Segs><<<blocks, kThreads, 0, stream>>>(
      src, dst, segs, p, n, nrows, chunk_elems);
}

// The launch at the vector width `v` (4 bytes times 4, 2 or 1) and p.
template <int WIRE, int MODE, typename Src, typename Dst, typename Segs>
void launch_vp(int v, const Src& src, const Dst& dst, const Segs& segs, int p, long long n,
               long long nrows, long long chunk_elems, cudaStream_t stream) {
#define TM_QUANT_LAUNCH(V)                                                                  \
  do {                                                                                      \
    if (p <= 8) {                                                                           \
      launch<WIRE, MODE, 8, V>(src, dst, segs, p, n, nrows, chunk_elems, stream);           \
    } else {                                                                                \
      launch<WIRE, MODE, 0, V>(src, dst, segs, p, n, nrows, chunk_elems, stream);           \
    }                                                                                       \
  } while (0)
  if (v == 4) {
    TM_QUANT_LAUNCH(4);
  } else if (v == 2) {
    TM_QUANT_LAUNCH(2);
  } else {
    TM_QUANT_LAUNCH(1);
  }
#undef TM_QUANT_LAUNCH
}

template <typename Src, typename Dst, typename Segs>
void launch_all(int wire, int mode, int v, const Src& src, const Dst& dst, const Segs& segs,
                int p, long long n, long long nrows, long long chunk_elems,
                cudaStream_t stream) {
  if (wire == kWireInt8) {
    if (mode == kAllreduce) {
      launch_vp<kWireInt8, kAllreduce>(v, src, dst, segs, p, n, nrows, chunk_elems, stream);
    } else {
      launch_vp<kWireInt8, kReduceScatter>(v, src, dst, segs, p, n, nrows, chunk_elems, stream);
    }
  } else if (mode == kAllreduce) {
    launch_vp<kWireBF16, kAllreduce>(v, src, dst, segs, p, n, nrows, chunk_elems, stream);
  } else {
    launch_vp<kWireBF16, kReduceScatter>(v, src, dst, segs, p, n, nrows, chunk_elems, stream);
  }
}

inline bool bad_args(int wire, int mode, long long n, long long chunk_elems) {
  return n < 0 || (wire != kWireInt8 && wire != kWireBF16) ||
         (mode != kAllreduce && mode != kReduceScatter) ||
         (mode == kAllreduce && (chunk_elems <= 0 || chunk_elems % kLanes));
}

}  // namespace
}  // namespace tmpi

// wire: 0 int8, 1 bf16. mode 0 (allreduce): x and out are [p, n] f32 rows,
// chunk_elems the ring chunk, a multiple of 128. mode 1 (reduce-scatter):
// x is [p, p*n] and out [p, n]; chunk_elems is unused.
extern "C" int tm_ring_quant(const void* x, void* out, int wire, int mode, int p,
                             long long n, long long chunk_elems, void* stream) {
  using namespace tmpi;
  if (p < 2 || bad_args(wire, mode, n, chunk_elems)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Stacked src{static_cast<const float*>(x), mode == kAllreduce ? n : n * p};
  const StackedOut dst{static_cast<float*>(out), n};
  const long long rps = (n + kLanes - 1) / kLanes;
  // every rank's row (and every segment) starts n elements apart
  const int v = vector_bytes(4, (unsigned long long)n * 4, x, out) / 4;
  launch_all(wire, mode, v, src, dst, AllSegments{}, p, n, mode == kAllreduce ? rps : rps * p,
             chunk_elems, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The cross-process K4. rows: p device addresses, rank r's f32 row (each in
// the slab of the process that owns r): n elements (mode 0) or p segments
// of n (mode 1). owned: the global rank of each of the `local` rows of out
// ([local, n] contiguous). Mode 0: row i is rank owned[i]'s row of
// tm_ring_quant's allreduce over the stacked rows (every row position's
// whole chain walked, this process's ranks stored). Mode 1: row i is the
// sum of segment owned[i], as tm_ring_quant's 'rs' row of that rank (only
// the owned segments walked).
extern "C" int tm_ring_quant_xproc(const unsigned long long* rows, int p, const int* owned,
                                   int local, void* out, int wire, int mode, long long n,
                                   long long chunk_elems, void* stream) {
  using namespace tmpi;
  if (p < 2 || p > kMaxTableRows || local < 1 || local > p ||
      bad_args(wire, mode, n, chunk_elems)) {
    return (int)cudaErrorInvalidValue;
  }
  Table src = {};
  LocalOut dst = {static_cast<float*>(out), n, {}};
  OwnedSegments segs = {};
  for (int r = 0; r < p; ++r) dst.slot[r] = -1;
  for (int i = 0; i < local; ++i) {
    if (owned[i] < 0 || owned[i] >= p || dst.slot[owned[i]] >= 0) {
      return (int)cudaErrorInvalidValue;
    }
    dst.slot[owned[i]] = i;
    segs.rank[i] = owned[i];
  }
  if (n == 0) return 0;
  int bytes = 16;
  for (int r = 0; r < p; ++r) {
    src.row[r] = reinterpret_cast<const float*>(rows[r]);
    const int w = vector_bytes(4, (unsigned long long)n * 4, src.row[r], out);
    if (w < bytes) bytes = w;
  }
  const long long rps = (n + kLanes - 1) / kLanes;
  launch_all(wire, mode, bytes / 4, src, dst, segs, p, n,
             mode == kAllreduce ? rps : rps * local, chunk_elems,
             static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
