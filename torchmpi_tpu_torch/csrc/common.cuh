// Shared by the port's kernels: the payload types, the add each payload
// type uses, and the widest vector a launch may move at once.
//
// Every add happens in the payload type itself, as the JAX ring does it:
// a bf16 or f16 sum is rounded to bf16 or f16 after every add, and the
// integer types wrap. For bf16 and f16 the add is taken in f32 and rounded
// once to nearest even; f32 keeps 24 bits, at least 2*11+2, so that double
// rounding gives the correctly rounded sum of the two operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmpi {

// Codes the Python wrappers pass for the native payload types.
// kF64 is taken by the scaled accumulate only (the parameter server's f64
// shards); the ring kernels refuse it.
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2, kI32 = 3, kI8 = 4, kU8 = 5, kF64 = 6 };

inline int itemsize_of(int dtype) {
  switch (dtype) {
    case kF64:
      return 8;
    case kF32:
    case kI32:
      return 4;
    case kBF16:
    case kF16:
      return 2;
    case kI8:
    case kU8:
      return 1;
    default:
      return 0;
  }
}

// Each payload type: its storage type S and its add.
struct AddF32 {
  using S = float;
  __device__ __forceinline__ static S add(S a, S b) { return a + b; }
};
struct AddBF16 {
  using S = unsigned short;
  __device__ __forceinline__ static S add(S a, S b) {
    float s = __bfloat162float(__ushort_as_bfloat16(a)) +
              __bfloat162float(__ushort_as_bfloat16(b));
    return __bfloat16_as_ushort(__float2bfloat16_rn(s));
  }
};
struct AddF16 {
  using S = unsigned short;
  __device__ __forceinline__ static S add(S a, S b) {
    float s = __half2float(__ushort_as_half(a)) + __half2float(__ushort_as_half(b));
    return __half_as_ushort(__float2half_rn(s));
  }
};
struct AddI32 {
  using S = int;
  __device__ __forceinline__ static S add(S a, S b) {
    return (int)((unsigned int)a + (unsigned int)b);
  }
};
struct AddI8 {
  using S = signed char;
  __device__ __forceinline__ static S add(S a, S b) {
    return (signed char)(unsigned char)((unsigned int)a + (unsigned int)b);
  }
};
struct AddU8 {
  using S = unsigned char;
  __device__ __forceinline__ static S add(S a, S b) { return (unsigned char)(a + b); }
};

// The raw word of a vector access of BYTES bytes.
template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using T = uint4; };
template <> struct RawOf<8> { using T = uint2; };
template <> struct RawOf<4> { using T = unsigned int; };
template <> struct RawOf<2> { using T = unsigned short; };
template <> struct RawOf<1> { using T = unsigned char; };

// One vector access seen as BYTES / sizeof(S) payload elements.
template <typename S, int BYTES>
union Pack {
  typename RawOf<BYTES>::T raw;
  S v[BYTES / sizeof(S)];
};

// The widest access of at most 16 bytes, and at least `itemsize`, that
// divides `stride` and the addresses `a` and `b`.
inline int vector_bytes(int itemsize, unsigned long long stride, const void* a,
                        const void* b) {
  int w = 16;
  while (w > itemsize &&
         (stride % w || (uintptr_t)a % w || (uintptr_t)b % w)) {
    w >>= 1;
  }
  return w;
}

// The card's streaming multiprocessors (H100 SXM).
constexpr int kSMs = 132;

// The launch of a grid-stride loop over `work` items in each of `groups`
// groups, the group on blockIdx.y. 256 threads a block while the blocks
// cover every SM at least twice; when the work is smaller, smaller blocks
// (down to 64 threads), so that the blocks still reach every SM instead
// of leaving a quarter of the card idle at a few hundred KB. At most 16
// blocks an SM over all groups: above that each thread loops.
struct LaunchShape {
  dim3 grid;
  unsigned int threads;
};

inline LaunchShape shape_for(long long work, int groups) {
  const long long total = work * groups;
  unsigned int threads = 256;
  while (threads > 64 && (total + threads - 1) / threads < 2 * kSMs) threads >>= 1;
  long long blocks = (work + threads - 1) / threads;
  long long cap = (long long)kSMs * 16 / groups;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return {dim3((unsigned int)blocks, (unsigned int)groups), threads};
}

}  // namespace tmpi
