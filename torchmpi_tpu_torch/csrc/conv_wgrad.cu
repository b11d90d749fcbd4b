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
// as [R, B, C, H, W] views with no copy (engine/rankconv.py).
//
// Design: an implicit GEMM per rank, M = O rows, N = C*kh*kw columns, K =
// B*Ho*Wo. A block computes a 64 x 64 tile of one rank's output over one
// slice of K. Each step it reads a 16-deep slice of dy (A) and the matching
// 16 x 64 patch columns of x (B) straight into shared memory, computing the
// patch addresses on the fly: no column tensor is written to global memory.
// 256 threads each keep 4 x 4 sums in registers and add k in increasing
// order. K is split into S slices of Kc (a multiple of 16) chosen from the
// shape alone (conv_wgrad_splits), so the 64 x 64 tiles of one rank give
// about 128 blocks whatever R is. Each block writes its partial tile to a
// workspace; the last of a tile's S blocks to finish (an atomic ticket)
// adds the S partials in slice order 0..S-1 and writes the tile. The ticket
// picks which block adds, never the order of the adds, so the result is
// deterministic and independent of R.
//
// Bound: 2*M*N*K operations a rank at 67 TFLOP/s (f32 outside the tensor
// cores: the callers run with TF32 off), against reading x and dy once and
// writing out once at 3.35 TB/s; for LeNet's conv1 at 8 ranks of 42 images
// (the engine's config-1 step) 6.74 GFLOP, 0.1007 ms, operations bound.
// The FMAs run on the CUDA cores in f32; the tensor cores' TF32 would give
// other bits than the f32 plain version. A first kernel: right and simple,
// made faster later.
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
constexpr int kPad = 4;  // shared rows of 68 floats: 16-byte aligned, fewer bank conflicts

struct Shape {
  long long xs_r, xs_b;    // x's strides (elements) between ranks and between images
  long long ds_r, ds_b;    // dy's
  int B, C, H, W;       // input, per rank
  int O, Ho, Wo;        // output gradient, per rank
  int kh, kw;           // kernel
  int sh, sw, ph, pw, dh, dw;
  int M, N, K;          // O, C*kh*kw, B*Ho*Wo
  int tiles_n, tiles;   // tiles of N, tiles of the M x N output
  int splits, kc;       // slices of K and their length
};

__global__ void __launch_bounds__(kThreads)
    conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
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

  const long long x_rank = (long long)r * s.xs_r;
  const long long dy_rank = (long long)r * s.ds_r;
  const int HWo = s.Ho * s.Wo;
  const int HW = s.H * s.W;

  // this thread's loads: depth kk of the slice, rows/columns lr + 16 q
  const int kk = t % kBK;
  const int lr = t / kBK;
  // the patch offsets of its 4 columns n = n0 + lr + 16 q
  int col_c[4], col_i[4], col_j[4];
  bool col_ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + lr + 16 * q;
    col_ok[q] = n < s.N;
    const int nn = col_ok[q] ? n : 0;
    const int khw = s.kh * s.kw;
    col_c[q] = (nn / khw) * HW;
    col_i[q] = ((nn % khw) / s.kw) * s.dh - s.ph;
    col_j[q] = (nn % s.kw) * s.dw - s.pw;
  }

  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
    const int k = k0 + kk;
    const bool k_ok = k < k_end;
    const int kk2 = k_ok ? k : k_begin;
    const int b = kk2 / HWo;
    const int pos = kk2 - b * HWo;
    const int oy = pos / s.Wo;
    const int ox = pos - oy * s.Wo;
    const float* dyp = dy + dy_rank + (long long)b * s.ds_b + pos;
    const float* xp = x + x_rank + (long long)b * s.xs_b;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + lr + 16 * q;
      a_reg[q] = (k_ok && m < s.O) ? __ldg(dyp + (long long)m * HWo) : 0.0f;
      const int iy = oy * s.sh + col_i[q];
      const int ix = ox * s.sw + col_j[q];
      const bool in = k_ok && col_ok[q] && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
      b_reg[q] = in ? __ldg(xp + col_c[q] + iy * s.W + ix) : 0.0f;
    }
  };

  // thread (ty, tx) sums rows ty*4.. and columns tx*4.. of the tile
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
      As[kk][lr + 16 * q] = a_reg[q];
      Bs[kk][lr + 16 * q] = b_reg[q];
    }
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);  // the next slice's loads in flight
#pragma unroll
    for (int d = 0; d < kBK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&As[d][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[d][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
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

  // the partial tile to the workspace, then the ticket
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

// x: [R, B, C, H, W] and dy: [R, B, O, Ho, Wo] f32, each image's [C, H, W]
// (and [O, Ho, Wo]) contiguous, the ranks and the images at the strides
// given in elements (a grouped convolution's [B, G*C, H, W] seen as [G, B,
// C, H, W] needs no copy); out: [R, O, C, kh, kw] contiguous f32. work: R * tiles * splits * 64 * 64 floats and
// tickets: R * tiles zeroed unsigned ints when splits > 1 (unused
// otherwise), tiles = ceil(O / 64) * ceil(C kh kw / 64). kc: the length of
// a slice of K = B Ho Wo, a multiple of 16, splits = ceil(K / kc).
extern "C" int tm_conv_wgrad(const float* x, const float* dy, float* out, float* work,
                             unsigned int* tickets, int R, int B, int C, int H, int W, int O,
                             int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                             int dh, int dw, int kc, long long x_rank_stride,
                             long long x_batch_stride, long long dy_rank_stride,
                             long long dy_batch_stride, void* stream) {
  if (R < 1 || R > 65535 || B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || Ho < 1 || Wo < 1 ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 || dh < 1 || dw < 1 ||
      kc < kBK || kc % kBK) {
    return (int)cudaErrorInvalidValue;
  }
  Shape s;
  s.xs_r = x_rank_stride; s.xs_b = x_batch_stride;
  s.ds_r = dy_rank_stride; s.ds_b = dy_batch_stride;
  s.B = B; s.C = C; s.H = H; s.W = W;
  s.O = O; s.Ho = Ho; s.Wo = Wo;
  s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  const long long K = (long long)B * Ho * Wo;
  const long long N = (long long)C * kh * kw;
  if (K > 0x7fffffffLL || N > 0x7fffffffLL || (long long)C * H * W > 0x7fffffffLL ||
      (long long)O * Ho * Wo > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  s.M = O; s.N = (int)N; s.K = (int)K;
  s.tiles_n = (s.N + kBN - 1) / kBN;
  s.tiles = ((s.M + kBM - 1) / kBM) * s.tiles_n;
  s.kc = kc;
  s.splits = (int)((K + kc - 1) / kc);
  if ((long long)s.tiles * s.splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (s.splits > 1 && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(s.tiles * s.splits), (unsigned int)R);
  conv_wgrad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dy, out, work, tickets, s);
  return (int)cudaGetLastError();
}
