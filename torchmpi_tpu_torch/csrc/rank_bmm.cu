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
// Design: csrc/rank_gemm.cuh's mainloop (3xTF32 on the tensor cores, a ring
// of cp.async stages, slices of K added in slice order; its note says why
// one TF32 term is not enough and why the order is fixed) with a strided
// loader for each operand. An operand whose k stride is 1 is kept k-major
// in shared memory, one whose row (a) or column (b) stride is 1 and k
// stride is not mn-major, and either moves 16 bytes a copy along its unit
// axis when the base and its other strides (the rank's included, 0 too)
// are 16-byte aligned, else 4 bytes an element; the four layouts are four
// instantiations. The tile (BM x BN from {16, 32, 48, 64} x {32, 64, 128})
// and the slices of K come from the shape alone (ops/rank_gemm.py:plan):
// LeNet's 42 rows a rank take a 48-row tile and config 5's 8 a 16-row one,
// where a 64-row tile padded both.
//
// Bound: 2*M*N*K operations a rank at 3xTF32's 165 TFLOP/s, against
// reading a and b once and writing out once at 3.35 TB/s. The engine's
// products are thin (42 rows at LeNet's dense0, 8 at config 5's MLP6), so
// they are bound by bytes: dense0's forward reads its 25.7 MB weight for
// 0.54 GFLOP, 0.00903 ms. The loads are what its design is for: 16-byte
// copies along the weight's k, a stage ring deep enough (4 stages of 32 k)
// to keep a block's next copies in flight, and slices of K enough for
// every SM.
//
// The entry point launches once on the given stream and returns
// cudaGetLastError(); the caller allocates the output, the workspace, and
// the tickets (zeroed once, left zeroed by every launch).
#include "rank_gemm.cuh"

namespace {

struct Shape {
  const float* a;
  const float* b;
  float* out;
  float* work;
  unsigned int* tickets;
  long long as_r, as_m, as_k;  // a's strides (elements)
  long long bs_r, bs_k, bs_n;  // b's
  int M, N, K;
  int tiles_n, tiles;
  int splits, kc;
  bool a_vec, b_vec;           // 16-byte copies along the unit axis
};

template <int BM, int BN, bool AK, bool BKM>
__global__ void __launch_bounds__(rank_gemm::Tile<BM, BN>::kThreads,
                                rank_gemm::Tile<BM, BN>::kMinBlocks)
    rank_bmm_kernel(const Shape s) {
  constexpr int kThreads = rank_gemm::Tile<BM, BN>::kThreads;
  extern __shared__ float4 smem4[];

  const int r = blockIdx.y;
  const int split = blockIdx.x % s.splits;
  const int tile = blockIdx.x / s.splits;
  const int m0 = (tile / s.tiles_n) * BM;
  const int n0 = (tile % s.tiles_n) * BN;
  const int k_begin = split * s.kc;
  const int k_end = min(s.K, k_begin + s.kc);

  const rank_gemm::Strided<BM, kThreads, AK> la{s.a + (long long)r * s.as_r, s.as_m, s.as_k,
                                                s.M, m0, s.a_vec};
  const rank_gemm::Strided<BN, kThreads, BKM> lb{s.b + (long long)r * s.bs_r, s.bs_n, s.bs_k,
                                                 s.N, n0, s.b_vec};
  rank_gemm::run<BM, BN, AK, BKM>(la, lb, reinterpret_cast<float*>(smem4),
                                  s.out + (long long)r * s.M * s.N, s.M, s.N, m0, n0, k_begin,
                                  k_end, s.work, s.tickets, (long long)r * s.tiles + tile,
                                  s.splits, split);
}

template <int BM, int BN, bool AK, bool BKM>
int launch(const Shape& s, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = rank_gemm::Smem<BM, BN, AK, BKM>::kBytes;
  static bool opted[64] = {};
  const int err = rank_gemm::allow_smem(rank_bmm_kernel<BM, BN, AK, BKM>, bytes, opted);
  if (err) return err;
  rank_bmm_kernel<BM, BN, AK, BKM>
      <<<grid, rank_gemm::Tile<BM, BN>::kThreads, bytes, stream>>>(s);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_layout(const Shape& s, bool ak, bool bk, dim3 grid, cudaStream_t stream) {
  if (ak && bk) return launch<BM, BN, true, true>(s, grid, stream);
  if (ak) return launch<BM, BN, true, false>(s, grid, stream);
  if (bk) return launch<BM, BN, false, true>(s, grid, stream);
  return launch<BM, BN, false, false>(s, grid, stream);
}

bool aligned(const float* p, long long s0, long long s1) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0;
}

}  // namespace

// a: [R, M, K] and b: [R, K, N] f32 at the element strides given (any,
// 0 included); out: [R, M, N] contiguous f32. bm x bn: the block tile, one
// of {16, 32, 48, 64} x {32, 64, 128}; kc: the length of a slice of K, a
// multiple of 32, splits = ceil(K / kc). When splits > 1, work: R * tiles
// * splits * bm * bn floats and tickets: R * tiles unsigned ints, zero
// (every launch leaves them zero), tiles = ceil(M / bm) * ceil(N / bn);
// both unused otherwise.
extern "C" int tm_rank_bmm(const float* a, const float* b, float* out, float* work,
                           unsigned int* tickets, int R, int M, int N, int K, int bm, int bn,
                           int kc, long long a_rank_stride, long long a_row_stride,
                           long long a_k_stride, long long b_rank_stride, long long b_k_stride,
                           long long b_col_stride, void* stream) {
  if (R < 1 || R > 65535 || M < 1 || N < 1 || K < 1 || kc < rank_gemm::kBK ||
      kc % rank_gemm::kBK || a_rank_stride < 0 || a_row_stride < 0 || a_k_stride < 0 ||
      b_rank_stride < 0 || b_k_stride < 0 || b_col_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Shape s;
  s.a = a; s.b = b; s.out = out; s.work = work; s.tickets = tickets;
  s.as_r = a_rank_stride; s.as_m = a_row_stride; s.as_k = a_k_stride;
  s.bs_r = b_rank_stride; s.bs_k = b_k_stride; s.bs_n = b_col_stride;
  s.M = M; s.N = N; s.K = K;
  s.tiles_n = (N + bn - 1) / bn;
  const long long tiles = (long long)((M + bm - 1) / bm) * s.tiles_n;
  s.kc = kc;
  s.splits = (K + kc - 1) / kc;
  if (tiles * s.splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.tiles = (int)tiles;
  if (s.splits > 1 && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  // k-major unless only the row (column) is the unit axis
  const bool ak = a_k_stride == 1 || a_row_stride != 1;
  const bool bk = b_k_stride == 1 || b_col_stride != 1;
  s.a_vec = ak ? a_k_stride == 1 && aligned(a, a_rank_stride, a_row_stride)
               : aligned(a, a_rank_stride, a_k_stride);
  s.b_vec = bk ? b_k_stride == 1 && aligned(b, b_rank_stride, b_col_stride)
               : aligned(b, b_rank_stride, b_k_stride);
  const dim3 grid((unsigned int)(s.tiles * s.splits), (unsigned int)R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TM_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch_layout<BM_, BN_>(s, ak, bk, grid, st);
  TM_TILE(16, 32) TM_TILE(16, 64) TM_TILE(32, 32) TM_TILE(32, 64)
  TM_TILE(48, 32) TM_TILE(48, 64) TM_TILE(64, 32) TM_TILE(64, 128)
#undef TM_TILE
  return (int)cudaErrorInvalidValue;
}
