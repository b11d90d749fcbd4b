// Each rank's matrix product, for R ranks at once: out[r] = a[r] @ b[r].
//
// Replaces no TPU kernel: the JAX package takes these products from XLA.
// It repairs a fault of the port (ROADMAP C6). Under the engine's
// rank_map='vmap' a dense layer of rank-stacked weights becomes one batched
// product (aten::bmm) for its forward and for each of its gradients, and
// cuBLAS picks a batched product's algorithm by its batch count, so a
// rank's result depended on how many ranks its process stacked: config 5
// run by 4 processes x 2 ranks parted from one process of 8 in its first
// epoch. Here every output element is summed in an order fixed by the shape
// alone, so a rank's result is the same bits whether the launch holds 8, 4
// or 2 ranks, and whatever the operands' strides.
//
// What it computes: a [R, M, K] and b [R, K, N], f32, at any element
// strides (a transposed view, or a rank stride of 0 for an operand vmap
// expanded); out [R, M, N] contiguous f32, out[r, m, n] = sum over k of
// a[r, m, k] * b[r, k, n].
//
// Design: conv_wgrad.cu's tiling with plain strided loads. A block computes
// a 64 x 64 tile of one rank's output over one slice of K; each step it
// reads a 16-deep slice of a and of b into shared memory. Each operand is
// read along whichever of its axes has unit stride (k or the row for a, k
// or the column for b), so the common layouts read whole lines. 256 threads
// each keep 4 x 4 sums and add k in increasing order. K is split into S
// slices of kc (a multiple of 16) chosen from the shape alone
// (ops/conv_wgrad.py:splits); the last of a tile's S blocks to finish adds
// the S partials in slice order 0..S-1. The ticket picks which block adds,
// never the order of the adds, and the way an operand is read changes which
// thread loads an element, never the sums: the result is deterministic and
// independent of R and of the strides.
//
// Bound: 2*M*N*K operations a rank at 67 TFLOP/s (f32 outside the tensor
// cores: the callers run with TF32 off), against reading a and b once and
// writing out once at 3.35 TB/s. The engine's products are small (config
// 5's MLP6 at 8 rows a rank, LeNet's head at 42), so a launch is near its
// floor. A first kernel: right and simple, made faster later.
//
// The entry point launches once on the given stream and returns
// cudaGetLastError(); the caller allocates the workspace and the tickets
// (zeroed) and the output.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;

struct Shape {
  long long as_r, as_m, as_k;  // a's strides (elements)
  long long bs_r, bs_k, bs_n;  // b's
  int M, N, K;
  int tiles_n, tiles;
  int splits, kc;
  bool a_k_unit, b_k_unit;     // read along k (else along the row / column)
};

__global__ void __launch_bounds__(kThreads)
    rank_bmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, float* __restrict__ work,
                    unsigned int* __restrict__ tickets, const Shape s) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ bool last;

  const int t = threadIdx.x;
  const int r = blockIdx.y;
  const int split = blockIdx.x % s.splits;
  const int tile = blockIdx.x / s.splits;
  const int m0 = (tile / s.tiles_n) * kBM;
  const int n0 = (tile % s.tiles_n) * kBN;
  const int k_begin = split * s.kc;
  const int k_end = min(s.K, k_begin + s.kc);

  const float* ar = a + (long long)r * s.as_r;
  const float* br = b + (long long)r * s.bs_r;

  // this thread's 4 loads of each operand a step: (depth, row) of the
  // 16 x 64 slice, along k when that stride is 1, else along the row
  int a_kk[4], a_i[4], b_kk[4], b_i[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a_kk[q] = s.a_k_unit ? (t % kBK) : (t / kBM + 4 * q);
    a_i[q] = s.a_k_unit ? (t / kBK + 16 * q) : (t % kBM);
    b_kk[q] = s.b_k_unit ? (t % kBK) : (t / kBN + 4 * q);
    b_i[q] = s.b_k_unit ? (t / kBK + 16 * q) : (t % kBN);
  }

  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ka = k0 + a_kk[q];
      const int m = m0 + a_i[q];
      a_reg[q] = (ka < k_end && m < s.M)
                     ? __ldg(ar + (long long)m * s.as_m + (long long)ka * s.as_k) : 0.0f;
      const int kb = k0 + b_kk[q];
      const int n = n0 + b_i[q];
      b_reg[q] = (kb < k_end && n < s.N)
                     ? __ldg(br + (long long)kb * s.bs_k + (long long)n * s.bs_n) : 0.0f;
    }
  };

  const int tx = t % 16;
  const int ty = t / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      As[a_kk[q]][a_i[q]] = a_reg[q];
      Bs[b_kk[q]][b_i[q]] = b_reg[q];
    }
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);
#pragma unroll
    for (int d = 0; d < kBK; ++d) {
      const float4 av4 = *reinterpret_cast<const float4*>(&As[d][ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[d][tx * 4]);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out_rank = out + (long long)r * s.M * s.N;
  auto store = [&](float (&v)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= s.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < s.N) out_rank[(long long)m * s.N + n] = v[i][j];
      }
    }
  };
  if (s.splits == 1) {
    store(acc);
    return;
  }

  const long long tile_id = (long long)r * s.tiles + tile;
  float* part = work + (tile_id * s.splits + split) * (kBM * kBN);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(&part[(ty * 4 + i) * kBN + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[tile_id], 1u) == (unsigned int)(s.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the S partials added in slice order
  const float* parts = work + tile_id * s.splits * (kBM * kBN);
  float sum[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0.0f;
  for (int p = 0; p < s.splits; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v;
      if (p == split) {
        v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        v = __ldcg(reinterpret_cast<const float4*>(
            &parts[(long long)p * kBM * kBN + (ty * 4 + i) * kBN + tx * 4]));
      }
      sum[i][0] += v.x;
      sum[i][1] += v.y;
      sum[i][2] += v.z;
      sum[i][3] += v.w;
    }
  }
  store(sum);
}

}  // namespace

// a: [R, M, K] and b: [R, K, N] f32 at the element strides given (any,
// 0 included); out: [R, M, N] contiguous f32. work: R * tiles * splits *
// 64 * 64 floats and tickets: R * tiles zeroed unsigned ints when splits > 1
// (unused otherwise), tiles = ceil(M / 64) * ceil(N / 64). kc: the length
// of a slice of K, a multiple of 16, splits = ceil(K / kc).
extern "C" int tm_rank_bmm(const float* a, const float* b, float* out, float* work,
                           unsigned int* tickets, int R, int M, int N, int K, int kc,
                           long long a_rank_stride, long long a_row_stride,
                           long long a_k_stride, long long b_rank_stride,
                           long long b_k_stride, long long b_col_stride, void* stream) {
  if (R < 1 || R > 65535 || M < 1 || N < 1 || K < 1 || kc < kBK || kc % kBK ||
      a_rank_stride < 0 || a_row_stride < 0 || a_k_stride < 0 || b_rank_stride < 0 ||
      b_k_stride < 0 || b_col_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Shape s;
  s.as_r = a_rank_stride; s.as_m = a_row_stride; s.as_k = a_k_stride;
  s.bs_r = b_rank_stride; s.bs_k = b_k_stride; s.bs_n = b_col_stride;
  s.M = M; s.N = N; s.K = K;
  s.tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * s.tiles_n;
  s.kc = kc;
  s.splits = (K + kc - 1) / kc;
  if (tiles * s.splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.tiles = (int)tiles;
  s.a_k_unit = a_k_stride == 1;
  s.b_k_unit = !(b_col_stride == 1);
  if (s.splits > 1 && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(s.tiles * s.splits), (unsigned int)R);
  rank_bmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, work,
                                                                             tickets, s);
  return (int)cudaGetLastError();
}
