// The weight gradient of a convolution, one per rank, for R ranks at once.
//
// Replaces no TPU kernel: the JAX package takes this gradient from XLA.
// It repairs a fault of the port (ROADMAP C6). Under the engine's
// rank_map='vmap' a convolution of rank-stacked weights becomes one grouped
// convolution, and cuDNN picks the algorithm of its weight gradient by the
// number of groups, so a rank's gradient depended on how many ranks its
// process stacked: a job of 2 processes x 4 ranks parted from one process
// of 8 at its second step. Here every rank's gradient is summed in an order
// fixed by that rank's data and the shape alone, so it is the same bits
// whether the launch holds 8, 4 or 2 ranks.
//
// What it computes: x [R, B, C, H, W] and dy [R, B, O, Ho, Wo], f32; out
// [R, O, C, kh, kw] with
//   out[r, o, c, i, j] = sum over (b, oy, ox) of
//       dy[r, b, o, oy, ox] * x[r, b, c, oy*sh + i*dh - ph, ox*sw + j*dw - pw]
// (an input position outside the image reads 0): the weight gradient of a
// groups=1 convolution with that stride, padding and dilation. Each image
// is contiguous; the ranks and the images lie at the strides given, so the
// engine passes vmap's grouped convolution ([B, R*C, H, W], a group a rank)
// as [R, B, C, H, W] views with no copy (engine/rankwise.py).
//
// Design: an implicit GEMM per rank, M = O rows, N = C*kh*kw columns, K =
// B*Ho*Wo, through csrc/rank_gemm.cuh's mainloop (3xTF32 on the tensor
// cores, a ring of cp.async stages, slices of K added in slice order; its
// note says why one TF32 term is not enough and why the order is fixed).
// A is dy, read along k (an image's output positions) in 16-byte copies
// when Ho*Wo and the strides are multiples of 4, else in 4-byte ones. B is
// the patch matrix, gathered from x straight into shared memory by 4-byte
// copies that zero-fill the padding: no column tensor is written to device
// memory. A block keeps a table of its BN columns' (c, i, j) offsets, so
// an element costs two adds and a bounds check. The tile (BM x BN from
// {16, 32, 48, 64} x {32, 64, 128}) and the slices of K come from the shape
// alone (ops/rank_gemm.py:plan): LeNet's conv1 (O = 64, N = 800) takes 64 x
// 128 tiles, conv0 (O = 32, N = 25) 32 x 32, which wastes 7 columns of 32
// where a 64-wide tile wasted 39.
//
// Bound: 2*M*N*K operations a rank, which the tensor cores can do at f32
// accuracy as 3xTF32 at 165 TFLOP/s (a third of TF32's 495), against
// reading x and dy once and writing out once at 3.35 TB/s. For LeNet's
// conv1 at 8 ranks of 42 images (the engine's config-1 step) 6.74 GFLOP:
// 0.0408 ms by operations (0.1007 ms at the CUDA cores' f32 67 TFLOP/s);
// conv0 reads 34.7 MB for 0.42 GFLOP, bound by bytes (0.0104 ms).
//
// The entry point launches once on the given stream and returns
// cudaGetLastError(); the caller allocates the output, the workspace, and
// the tickets (zeroed once, left zeroed by every launch).
#include "rank_gemm.cuh"

namespace {

using rank_gemm::kBK;
using rank_gemm::kLdK;

struct Shape {
  const float* x;
  const float* dy;
  float* out;
  float* work;
  unsigned int* tickets;
  long long xs_r, xs_b;  // x's strides (elements) between ranks and between images
  long long ds_r, ds_b;  // dy's
  int C, H, W;           // input, per image
  int O, Ho, Wo;         // output gradient, per image
  int kh, kw;            // kernel
  int sh, sw, ph, pw, dh, dw;
  int M, N, K;           // O, C*kh*kw, B*Ho*Wo
  int tiles_n, tiles;    // tiles of N, tiles of the M x N output
  int splits, kc;        // slices of K and their length
  bool dy_vec;           // dy in 16-byte copies
};

// A: dy's rows o, element (o, k) at dy[b, o, pos] for k = b*HoWo + pos,
// k-major.
template <int BM, int THREADS> struct DyLoader {
  const float* p;  // this rank's dy
  long long sb;
  int hw, extent, i0;
  bool vec;

  __device__ __forceinline__ void prepare() {}

  __device__ __forceinline__ void load(float* tile, int k0, int k_end) const {
    if (vec) {
      // 8 chunks of 4 along a row's 32 k; a thread's chunk column is fixed
      constexpr int kChunks = BM * kBK / 4;
      const int c = 4 * (threadIdx.x % (kBK / 4));
      const int k = k0 + c;
      const int b = k / hw;
      const float* base = p + (long long)b * sb + (k - b * hw);
      const bool k_ok = k < k_end;  // k_end and k are multiples of 4
#pragma unroll
      for (int q = 0; q < (kChunks + THREADS - 1) / THREADS; ++q) {
        const int e = threadIdx.x + q * THREADS;
        if (kChunks % THREADS != 0 && e >= kChunks) break;
        const int row = e / (kBK / 4);
        const bool ok = k_ok && i0 + row < extent;
        rank_gemm::cp16(tile + row * kLdK + c, ok ? base + (long long)(i0 + row) * hw : p, ok);
      }
    } else {
      constexpr int kElems = BM * kBK;
      const int kk = threadIdx.x % kBK;
      const int k = k0 + kk;
      const int b = k / hw;
      const float* base = p + (long long)b * sb + (k - b * hw);
      const bool k_ok = k < k_end;
#pragma unroll
      for (int q = 0; q < (kElems + THREADS - 1) / THREADS; ++q) {
        const int e = threadIdx.x + q * THREADS;
        if (kElems % THREADS != 0 && e >= kElems) break;
        const int row = e / kBK;
        const bool ok = k_ok && i0 + row < extent;
        rank_gemm::cp4(tile + row * kLdK + kk, ok ? base + (long long)(i0 + row) * hw : p, ok);
      }
    }
  }
};

// A column's entry of the table, read from shared memory at every stage:
// kept in registers across the stages, the 16 entries of a thread in the
// 64 x 128 tile would take 64 of them.
__device__ __forceinline__ int4 column(const int4* p) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// B: the patch matrix, element (n, k) = x[b, c, oy*sh + ti, ox*sw + tj]
// for n = (c, i, j) (ti = i*dh - ph, tj = j*dw - pw) and k = (b, oy, ox),
// k-major, gathered by 4-byte copies; cols[n - n0] = {c*H*W + ti*W + tj,
// ti, tj, n < N}.
template <int BN, int THREADS> struct PatchLoader {
  const float* p;  // this rank's x
  const int4* cols;
  long long sb;
  int H, W, Wo, hwo, sh, sw;

  __device__ __forceinline__ void prepare() {}

  __device__ __forceinline__ void load(float* tile, int k0, int k_end) const {
    constexpr int kElems = BN * kBK;
    const int kk = threadIdx.x % kBK;  // a thread's k is fixed, its rows step
    const int k = k0 + kk;
    const bool k_ok = k < k_end;
    const int b = k / hwo;
    const int pos = k - b * hwo;
    const int oy = pos / Wo;
    const int ky = oy * sh, kx = (pos - oy * Wo) * sw;
    const float* base = p + (long long)b * sb + (ky * W + kx);
#pragma unroll
    for (int q = 0; q < (kElems + THREADS - 1) / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS;
      if (kElems % THREADS != 0 && e >= kElems) break;
      const int row = e / kBK;
      const int4 col = column(cols + row);
      const int iy = ky + col.y, ix = kx + col.z;
      const bool ok = k_ok && col.w && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
      rank_gemm::cp4(tile + row * kLdK + kk, ok ? base + col.x : p, ok);
    }
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(rank_gemm::Tile<BM, BN>::kThreads,
                                rank_gemm::Tile<BM, BN>::kMinBlocks)
    conv_wgrad_kernel(const Shape s) {
  constexpr int kThreads = rank_gemm::Tile<BM, BN>::kThreads;
  extern __shared__ float4 smem4[];
  __shared__ int4 cols[BN];

  const int r = blockIdx.y;
  const int split = blockIdx.x % s.splits;
  const int tile = blockIdx.x / s.splits;
  const int m0 = (tile / s.tiles_n) * BM;
  const int n0 = (tile % s.tiles_n) * BN;
  const int k_begin = split * s.kc;
  const int k_end = min(s.K, k_begin + s.kc);

  const int khw = s.kh * s.kw;
  for (int j = threadIdx.x; j < BN; j += kThreads) {
    const int n = n0 + j;
    const int c = n / khw, rem = n - (n / khw) * khw;
    const int ti = (rem / s.kw) * s.dh - s.ph;
    const int tj = (rem % s.kw) * s.dw - s.pw;
    cols[j] = make_int4(c * s.H * s.W + ti * s.W + tj, ti, tj, n < s.N);
  }
  __syncthreads();

  const DyLoader<BM, kThreads> la{s.dy + (long long)r * s.ds_r, s.ds_b, s.Ho * s.Wo, s.M, m0,
                                  s.dy_vec};
  const PatchLoader<BN, kThreads> lb{s.x + (long long)r * s.xs_r, cols, s.xs_b, s.H, s.W,
                                     s.Wo, s.Ho * s.Wo, s.sh, s.sw};
  rank_gemm::run<BM, BN, true, true>(la, lb, reinterpret_cast<float*>(smem4),
                                     s.out + (long long)r * s.M * s.N, s.M, s.N, m0, n0, k_begin,
                                     k_end, s.work, s.tickets, (long long)r * s.tiles + tile,
                                     s.splits, split);
}

template <int BM, int BN> int launch(const Shape& s, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = rank_gemm::Smem<BM, BN, true, true>::kBytes;
  static bool opted[64] = {};
  const int err = rank_gemm::allow_smem(conv_wgrad_kernel<BM, BN>, bytes, opted);
  if (err) return err;
  conv_wgrad_kernel<BM, BN><<<grid, rank_gemm::Tile<BM, BN>::kThreads, bytes, stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [R, B, C, H, W] and dy: [R, B, O, Ho, Wo] f32, each image's [C, H, W]
// (and [O, Ho, Wo]) contiguous, the ranks and the images at the strides
// given in elements (a grouped convolution's [B, G*C, H, W] seen as [G, B,
// C, H, W] needs no copy); out: [R, O, C, kh, kw] contiguous f32. bm x bn:
// the block tile, one of {16, 32, 48, 64} x {32, 64, 128}; kc: the length
// of a slice of K = B Ho Wo, a multiple of 32, splits = ceil(K / kc). When
// splits > 1, work: R * tiles * splits * bm * bn floats and tickets: R *
// tiles unsigned ints, zero (every launch leaves them zero), tiles =
// ceil(O / bm) * ceil(C kh kw / bn); both unused otherwise.
extern "C" int tm_conv_wgrad(const float* x, const float* dy, float* out, float* work,
                             unsigned int* tickets, int R, int B, int C, int H, int W, int O,
                             int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                             int dh, int dw, int bm, int bn, int kc, long long x_rank_stride,
                             long long x_batch_stride, long long dy_rank_stride,
                             long long dy_batch_stride, void* stream) {
  if (R < 1 || R > 65535 || B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || Ho < 1 || Wo < 1 ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 || dh < 1 || dw < 1 ||
      kc < kBK || kc % kBK) {
    return (int)cudaErrorInvalidValue;
  }
  const long long K = (long long)B * Ho * Wo;
  const long long N = (long long)C * kh * kw;
  if (K > 0x7fffffffLL || N > 0x7fffffffLL || (long long)C * H * W > 0x7fffffffLL ||
      (long long)O * Ho * Wo > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Shape s;
  s.x = x; s.dy = dy; s.out = out; s.work = work; s.tickets = tickets;
  s.xs_r = x_rank_stride; s.xs_b = x_batch_stride;
  s.ds_r = dy_rank_stride; s.ds_b = dy_batch_stride;
  s.C = C; s.H = H; s.W = W;
  s.O = O; s.Ho = Ho; s.Wo = Wo;
  s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  s.M = O; s.N = (int)N; s.K = (int)K;
  s.tiles_n = (s.N + bn - 1) / bn;
  const long long tiles = (long long)((s.M + bm - 1) / bm) * s.tiles_n;
  s.kc = kc;
  s.splits = (int)((K + kc - 1) / kc);
  if (tiles * s.splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.tiles = (int)tiles;
  if (s.splits > 1 && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  // 16-byte copies of dy when an image's positions and every stride keep
  // 4-float chunks aligned and inside one image
  s.dy_vec = (Ho * Wo) % 4 == 0 && dy_batch_stride % 4 == 0 && dy_rank_stride % 4 == 0 &&
             reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const dim3 grid((unsigned int)(s.tiles * s.splits), (unsigned int)R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TM_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch<BM_, BN_>(s, grid, st);
  TM_TILE(16, 32) TM_TILE(16, 64) TM_TILE(32, 32) TM_TILE(32, 64)
  TM_TILE(48, 32) TM_TILE(48, 64) TM_TILE(64, 32) TM_TILE(64, 128)
#undef TM_TILE
  return (int)cudaErrorInvalidValue;
}
