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
// stream and the semaphores go away. One launch does it all: one warp per
// 128-lane row position, lane l holding elements l, l+32, l+64 and l+96.
// For p <= 8 the warp loads the row of every rank first, in ring order,
// so the p loads are in flight together; then it walks the ring in
// registers (a warp shuffle gives the int8 row max) and writes each rank's
// row once. The row layout (which chunk, so which start rank) comes from
// the Python wrapper (ops/ring_kernels.py:quant_chunk_elems), which keeps
// the JAX wrapper's 128-row-aligned segmentation.
//
// Rounding is spelled out so that the plain PyTorch version repeats it bit
// for bit: the scale is a product with 1/127 rounded to f32 (XLA's rewrite
// of the JAX kernel's division), the code an IEEE division rounded half to
// even and passed through an int (no -0.0 code, as on the int8 wire), and
// the reduce-scatter's decode-and-add is the exact f64 product plus the
// local value, rounded in f64 and then to f32. The intrinsics keep nvcc
// from contracting any of it into an FMA. Do not build with fast math.
//
// Bound: each rank's row is read once and written once, 2*p*n*4 bytes at
// 3.35 TB/s (LeNet's first gradient bucket at p=8, n=805386: 51.5 MB,
// 15.4 us). The hops cost 2(p-1) encodes and decodes per element, a few
// microseconds of issue, so bytes bound it.
#include "common.cuh"

namespace tmpi {
namespace {

constexpr float kInv127 = 0x1.020408p-7f;        // 1/127 rounded to f32
constexpr float kScaleFloor = 0x1.4484cp-100f;   // 1e-30 rounded to f32
constexpr int kLanes = 128;
constexpr int kPerLane = kLanes / 32;

enum Wire { kWireInt8 = 0, kWireBF16 = 1 };
enum Mode { kAllreduce = 0, kReduceScatter = 1 };

// The wire form of one row held by a warp: codes as f32, and the int8 scale.
template <int WIRE>
__device__ __forceinline__ void encode(const float (&v)[kPerLane],
                                       float (&q)[kPerLane], float& s) {
  if constexpr (WIRE == kWireInt8) {
    float m = fabsf(v[0]);
#pragma unroll
    for (int j = 1; j < kPerLane; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = __fmul_rn(fmaxf(m, kScaleFloor), kInv127);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      q[j] = __int2float_rn(__float2int_rn(__fdiv_rn(v[j], s)));
    }
  } else {
    s = 1.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      q[j] = __bfloat162float(__float2bfloat16_rn(v[j]));
    }
  }
}

// An all-gather hop's install.
template <int WIRE>
__device__ __forceinline__ float decode(float q, float s) {
  if constexpr (WIRE == kWireInt8) return __fmul_rn(q, s);
  return q;
}

// A reduce-scatter hop's receive: local + decode(q).
template <int WIRE>
__device__ __forceinline__ float decode_add(float q, float s, float local) {
  if constexpr (WIRE == kWireInt8) {
    return __double2float_rn(__dadd_rn(__dmul_rn((double)q, (double)s), (double)local));
  }
  return __fadd_rn(local, q);
}

__device__ __forceinline__ void load_row(const float* __restrict__ src, long long valid,
                                         int lane, float (&v)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < valid ? src[e] : 0.0f;  // the JAX wrapper pads with zeros
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ dst, long long valid,
                                          int lane, const float (&v)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    if (e < valid) dst[e] = v[j];
  }
}

// allreduce: x and out are [p, n]; row w is elements [128w, 128w + 128) of
//   every rank's row, in the chunk (128w % (p*chunk)) / chunk.
// reduce-scatter: x is [p, p*n] (p segments of n per rank) and out [p, n];
//   row w is row w % rps of segment s = w / rps, whose sum starts at rank
//   s + 1 (the JAX wrapper's pre-roll) and ends at its owner, rank s.
// MAXP > 0: p <= MAXP, every rank's row is loaded before the walk; 0: each
// row is loaded when the walk reaches it.
template <int WIRE, int MODE, int MAXP>
__global__ void __launch_bounds__(256)
    ring_quant_kernel(const float* __restrict__ x, float* __restrict__ out, int p,
                      long long n, long long chunk_elems) {
  const int lane = threadIdx.x & 31;
  const long long rps = (n + kLanes - 1) / kLanes;
  const long long nrows = MODE == kAllreduce ? rps : rps * p;
  const long long x_stride = MODE == kAllreduce ? n : n * p;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < nrows;
       w += warps) {
    long long off, valid;
    int c;
    if constexpr (MODE == kAllreduce) {
      off = w * kLanes;
      valid = min((long long)kLanes, n - off);
      c = (int)((off % (chunk_elems * p)) / chunk_elems);
    } else {
      const long long s = w / rps, wr = w - s * rps;
      off = s * n + wr * kLanes;  // the same in x's rank rows and in out
      valid = min((long long)kLanes, n - wr * kLanes);
      c = (int)((s + 1) % p);
    }
    const float* src = x + off;

    float held[MAXP > 0 ? MAXP : 1][kPerLane];
    if constexpr (MAXP > 0) {
#pragma unroll
      for (int k = 0; k < MAXP; ++k) {
        if (k < p) {
          const int r = c + k < p ? c + k : c + k - p;
          load_row(src + r * x_stride, valid, lane, held[k]);
        }
      }
    }

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
      load_row(src + c * x_stride, valid, lane, acc);
      for (int k = 1; k < p; ++k) {
        const int r = c + k < p ? c + k : c + k - p;
        float local[kPerLane], q[kPerLane], s;
        load_row(src + r * x_stride, valid, lane, local);
        encode<WIRE>(acc, q, s);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) acc[j] = decode_add<WIRE>(q[j], s, local[j]);
      }
    }

    if constexpr (MODE == kReduceScatter) {
      store_row(out + off, valid, lane, acc);
    } else {
      // all-gather: the owner keeps its f32 sum; each later rank installs
      // the decoding of the wire form of its left neighbour's value
      store_row(out + (c == 0 ? p - 1 : c - 1) * n + off, valid, lane, acc);
      for (int k = 0; k < p - 1; ++k) {
        const int r = c + k < p ? c + k : c + k - p;
        float q[kPerLane], s;
        encode<WIRE>(acc, q, s);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) acc[j] = decode<WIRE>(q[j], s);
        store_row(out + r * n + off, valid, lane, acc);
      }
    }
  }
}

template <int WIRE, int MODE>
void launch(const float* x, float* out, int p, long long n, long long chunk_elems,
            cudaStream_t stream) {
  const long long rows = ((n + kLanes - 1) / kLanes) * (MODE == kAllreduce ? 1 : p);
  const unsigned int blocks = grid_for(rows * 32, 256);
  if (p <= 8) {
    ring_quant_kernel<WIRE, MODE, 8><<<blocks, 256, 0, stream>>>(x, out, p, n, chunk_elems);
  } else {
    ring_quant_kernel<WIRE, MODE, 0><<<blocks, 256, 0, stream>>>(x, out, p, n, chunk_elems);
  }
}

template <int WIRE>
void launch_mode(int mode, const float* x, float* out, int p, long long n,
                 long long chunk_elems, cudaStream_t stream) {
  if (mode == kAllreduce) {
    launch<WIRE, kAllreduce>(x, out, p, n, chunk_elems, stream);
  } else {
    launch<WIRE, kReduceScatter>(x, out, p, n, chunk_elems, stream);
  }
}

}  // namespace
}  // namespace tmpi

// wire: 0 int8, 1 bf16. mode 0 (allreduce): x and out are [p, n] f32 rows,
// chunk_elems the ring chunk, a multiple of 128. mode 1 (reduce-scatter):
// x is [p, p*n] and out [p, n]; chunk_elems is unused.
extern "C" int tm_ring_quant(const void* x, void* out, int wire, int mode, int p,
                             long long n, long long chunk_elems, void* stream) {
  using namespace tmpi;
  if (p < 2 || n < 0 || (wire != kWireInt8 && wire != kWireBF16) ||
      (mode != kAllreduce && mode != kReduceScatter) ||
      (mode == kAllreduce && (chunk_elems <= 0 || chunk_elems % kLanes))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wire == kWireInt8) {
    launch_mode<kWireInt8>(mode, xf, of, p, n, chunk_elems, s);
  } else {
    launch_mode<kWireBF16>(mode, xf, of, p, n, chunk_elems, s);
  }
  return (int)cudaGetLastError();
}
