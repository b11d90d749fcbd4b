// Ring attention over virtual ranks on one card, bf16 inputs, on Hopper's
// bf16 tensor cores: the forward (K8), the bidirectional forward (K9) and
// the analytic backward (K10). The f32 inputs' kernels are
// ring_attention.cu's (3xTF32 on mma.sync); this file holds the only bf16
// form.
//
// Replaces, in torchmpi_tpu/ops/ring_attention_kernel.py (the functions
// and the arithmetic as ring_attention.cu's note gives them):
// - _ring_attn_kernel (K8, :117, via :407) and _ring_attn_bidir_kernel
//   (K9, :506, via :407): fwd_wgmma_kernel, one kernel in two visiting
//   orders (visit_src);
// - _ring_attn_bwd_kernel (K10, :852, via :1098): bwd_dq_wgmma_kernel (dQ,
//   and D = rowsum(dO * O) for the second launch), then
//   bwd_dkv_wgmma_kernel (dK, dV), over the ranks in ring order with no
//   atomics, as ring_attention.cu's two launches.
//
// Arithmetic: the JAX kernel's, in f32 whatever the input dtype (it
// upcasts bf16 and takes f32 dots, ring_attention_kernel.py:84-103,
// 940-975). S = Q K^T and dP = dO V^T (and S^T, dP^T in the dK/dV launch)
// are bf16 x bf16 products, each exact in f32, summed in f32. P and dS are
// f32 from the softmax; they enter the tensor cores as two bf16 terms, hi
// = bf16_rn(x) and lo = bf16_rn(x - hi), about 16 of P's 24 bits, and each
// product with V, dO, Q or K takes the lo term, then the hi term. One term
// (FlashAttention's form) puts a relative error of 2^-9 on each P and dS:
// emulated on the CPU against f64 at [4, 1, 1024, 2, 64] causal it misses
// every f32 limit the kernels are held to (dq, dk, dv 5.4e-3, 4.3e-3,
// 7.8e-3 against 2e-4; o 2.1e-3 against 2e-5), where hi and lo hold them
// 6-15x inside (tests/test_torch_tf32.py). The tensor cores truncate as
// they accumulate, so each tile's P B product is summed in a fresh
// accumulator and added to the running sum in f32. Kept from the f32
// kernels: the log2-domain online softmax with ex2.approx, the causal
// skips (key_tiles), K8's and K9's visiting orders, the heaviest query
// tiles first, l = max(l, 1e-30), lse = m + log l, o cast to bf16.
//
// Bound: operations at the bf16 tensor-core rate (989 TFLOP/s). At the LM
// path's [4, 4, 1024, 8, 64] causal the forward needs 4 d flops a kept
// (query, key) pair, 68.7 GFLOP, 0.0695 ms, and the backward 10 d, 0.1738
// ms. This design does 3 product passes a kept pair where 2 are useful
// (hi and lo for P V) and 10 where 5 are (two launches, each recomputing
// S and dP, hi and lo for the three P or dS products): floors of 0.104
// and 0.348 ms at the peak rate. What this design reaches on an H100 is in
// PERF.md (chip_smoke.py --attention prints it).
//
// Design. A block is three warpgroups: two consumer warpgroups of 64 rows
// each (queries in the forward and the dQ launch, keys in the dK/dV
// launch), so a block owns 128 rows, and one producer warpgroup, of which
// one thread issues every copy. The block's own rows (Q; Q and dO; K and
// V) are loaded once; the visited tiles (128 keys of K and V in the
// forward; 64 rows of K and V, or of Q, dO and their lse and D, in the
// backward) stream through a ring of kStages stages in shared memory, each
// filled by TMA tile loads that complete on the stage's "full" mbarrier;
// each consumer warp arrives on the stage's "empty" mbarrier when its
// products have read it, and the producer waits on that before it refills
// the stage. The producer gives up registers (setmaxnreg.dec to 40) and the
// consumers take them (setmaxnreg.inc to 232); ptxas still compiles the
// consumers within the launch's 168, so each warpgroup keeps one tile in
// flight: it waits on its products, and the other warpgroup's softmax runs
// meanwhile (a pipeline of two tiles a warpgroup spilled and ran slower
// on an H100). ptxas serializes every product of a kernel that issues one
// under a branch, or that writes a product's registers while its group is
// open, so no product sits under a branch (a tile masked for a warpgroup's
// rows is taken too, as a no-op) and each group has its own wgmma.fence.
//
// Every product is wgmma.mma_async with f32 accumulators: m64n128k16 for
// the forward's S (a 128-key tile, half the waits a key of a 64-key one),
// m64n64k16 for the rest. The products of two stored tiles (Q K^T, dO V^T,
// K Q^T, V dO^T) read both operands from shared memory through
// descriptors, both K-major. The products with P or dS take A from
// registers: the accumulator of S (or dS) holds, in each warp, rows g and
// g + 8 and columns 2t, 2t+1 of every 8-column step, which is exactly the
// register A fragment of a k16 step (pairs packed), so P goes in where it
// was computed, converted to its hi and lo terms, and no score tile goes
// through shared memory. B is the V, dO, Q or K tile, read as an MN-major
// operand (its d columns contiguous), which 16-bit types allow through the
// descriptor's transpose bit.
//
// Layout. Every tile sits in shared memory as 64-column atoms of 128-byte
// rows with the 128-byte swizzle that TMA writes and wgmma reads: one atom
// up to D = 64 (the LM's head dim, where a bf16 row is 128 bytes), two at
// D = 128. The tensor maps are 5-D over the port's [p, B, n, H, D] layout,
// dims (D, H, n, B, p) and box (64, 1, rows, 1, 1): rows past n_local
// read as zeros, not as the next rank's rows, and at D < 64 the columns
// past D read as zeros too, so d = 8, 16 and 32 take the same kernels, the
// k16 steps over the zero padding multiplying zeros. lse and D stream
// through 1-D maps over [p, B, H, n] (a box of 64; what lies past a cell's
// n is masked). The maps are encoded on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPointByVersion, so the library needs
// no link to libcuda, and passed as __grid_constant__ kernel parameters.
//
// A wait on an mbarrier that has not completed after 2^28 polls (seconds)
// traps: a fault in the pipeline ends the launch with an error instead of
// hanging the card.
//
// Every entry point returns a cudaError_t (cudaErrorInvalidValue where the
// tensor maps cannot be encoded) so the wrapper can raise.
#include "common.cuh"

#include <cuda.h>

namespace tmpi {
namespace attn16 {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;           // rows of a visited tile of the backward (keys, or queries)
constexpr int kFwdTile = 128;       // keys of a visited tile of the forward
constexpr int kWgRows = 64;         // rows a consumer warpgroup owns
constexpr int kConsumers = 2;       // consumer warpgroups a block
constexpr int kRows = kWgRows * kConsumers;       // rows a block owns
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kStages = 3;
constexpr int kAtomBytes = 128;  // a swizzled row: 64 bf16 columns

struct Geometry {
  int p, B, n, H;
  float scale;
  int causal;
  // element offset of row i of cell `cell` on rank r, for head dim D
  __device__ __forceinline__ size_t row(int r, int cell, int i, int D) const {
    const int b = cell / H, h = cell - b * H;
    return ((((size_t)r * B + b) * n + i) * H + h) * (size_t)D;
  }
  // offset into a [p, B, H, n] statistic (lse, delta)
  __device__ __forceinline__ size_t stat(int r, int cell, int i) const {
    return ((size_t)r * B * H + cell) * n + i;
  }
};

// The rank whose K/V block rank r merges at visit i (0 <= i < p).
__device__ __forceinline__ int visit_src(int r, int i, int p, bool bidir) {
  if (!bidir || i == 0) return (r - i + p) % p;
  const int t = (i + 1) / 2;  // odd i: the R chain's step t; even i: the L chain's
  return (i & 1) ? (r - t + p) % p : (r + t) % p;
}

// Key tiles of `tile` keys of block src that the queries of rank r before
// q_end need.
__device__ __forceinline__ int key_tiles(const Geometry& g, int r, int src, int q_end, int tile) {
  const int all = (g.n + tile - 1) / tile;
  if (!g.causal || src < r) return all;
  if (src > r) return 0;
  const int need = (q_end + tile - 1) / tile;
  return need < all ? need : all;
}

// A launch's (visit, tile) pairs in order: visit s covers tiles [lo, hi)
// by range(s, lo, hi); s == p once there is none left.
template <typename Range>
__device__ __forceinline__ void first_tile(int& s, int& t, int p, const Range& range) {
  int lo, hi;
  for (s = 0; s < p; ++s) {
    range(s, lo, hi);
    if (lo < hi) {
      t = lo;
      return;
    }
  }
}
template <typename Range>
__device__ __forceinline__ void next_tile(int& s, int& t, int p, const Range& range) {
  int lo, hi;
  range(s, lo, hi);
  if (++t < hi) return;
  for (++s; s < p; ++s) {
    range(s, lo, hi);
    if (lo < hi) {
      t = lo;
      return;
    }
  }
}

// 2^x by the hardware's approximation (2^-1e29 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------- barriers and copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of `bar` with this parity has completed; trap after
// 2^28 polls (seconds).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1 << 28)) __trap();
  }
}

// One TMA tile load of a 5-D map's box at coordinates (c0 .. c4) into dst,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_load1(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// --------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major: rows of 128 bytes, 8-row groups 1024 bytes apart; a k16 step
// is 32 bytes along the row
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_sw128(addr, 16, 1024); }
// MN-major: the k rows of 128 bytes, 8-row groups 1024 bytes apart; a k16
// step is two groups (2048 bytes)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_sw128(addr, 8192, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments: read by the products until their wait, so
// kept live (and unwritten) until then.
template <int K> __device__ __forceinline__ void fence_frag(const uint32_t (&x)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(x[i][j]) : "memory");
}

#define TMPI_ACC32                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define TMPI_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64n64k16, A and B from shared memory (both K-major);
// accumulate unless `zero`.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TMPI_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TMPI_ACC32
      : "l"(a), "l"(b), "r"((uint32_t)zero));
}

#define TMPI_ACC64 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
      "+f"(d[63])
#define TMPI_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B, m64n128k16, A and B from shared memory (both K-major);
// accumulate unless `zero`.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TMPI_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TMPI_ACC64
      : "l"(a), "l"(b), "r"((uint32_t)zero));
}

// d (+)= A B, m64n64k16, A from registers (the k16 fragment, pairs
// packed), B from shared memory MN-major; accumulate unless `zero`.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TMPI_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TMPI_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((uint32_t)zero));
}

// The two bf16 terms of a pair of f32 values, packed as an A register
// (x0 in the low half): hi = bf16_rn(x), lo = bf16_rn(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The hi and lo A fragments of the K k16 steps of a 16 K-column score
// accumulator x: step kk takes columns 16 kk .. 16 kk + 15, the 8-column
// steps 2 kk and 2 kk + 1 (registers 8 kk .. 8 kk + 7).
template <int K>
__device__ __forceinline__ void split_scores(const float (&x)[8 * K], uint32_t (&hi)[K][4],
                                             uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// Atoms of a tile: 64-column blocks of rows x 128 bytes each.
template <int D> struct Atoms {
  static constexpr int kN = D > 64 ? 2 : 1;
  static constexpr int kSteps = (D + 15) / 16;  // k16 steps over the head dim
  __host__ __device__ static constexpr uint32_t bytes(int rows) {
    return (uint32_t)rows * kAtomBytes;
  }
};

// acc (+)= A B^T over the head dim, A's 64 rows at `a` (a tile of a_rows
// rows, the warpgroup's offset added) and B's 2 N rows at `b` (a tile of
// as many rows), both stored tiles: N accumulator registers, 32 (m64n64)
// or 64 (m64n128).
template <int D, int N>
__device__ __forceinline__ void product_abt(float (&acc)[N], uint32_t a, int a_rows, uint32_t b) {
#pragma unroll
  for (int k = 0; k < Atoms<D>::kSteps; ++k) {
    const uint32_t off = (k % 4) * 32;  // a k16 step is 32 bytes of the row
    wgmma_ss(acc, desc_k(a + (k / 4) * Atoms<D>::bytes(a_rows) + off),
             desc_k(b + (k / 4) * Atoms<D>::bytes(2 * N) + off), k == 0);
  }
}

// tile = P B over the 16 K rows of B (keys, or queries in dK/dV) for the
// 64 columns of one atom, P as its hi and lo fragments (lo first), B at `b`
// (the atom of a tile of 16 K rows), MN-major; a fresh sum.
template <int K>
__device__ __forceinline__ void product_pb(float (&tile)[32], const uint32_t (&hi)[K][4],
                                           const uint32_t (&lo)[K][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const uint64_t db = desc_mn(b + kk * 2048);
    wgmma_rs(tile, lo[kk], db, kk == 0);
    wgmma_rs(tile, hi[kk], db, false);
  }
}

__device__ __forceinline__ void store_bf16x2(unsigned short* p, float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// The block's shared memory: the 1024-aligned start of the dynamic
// allocation (which asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024 - (smem_addr(raw) & 1023)) & 1023;
  return raw + pad;
}

// The thread's warpgroup, broadcast from lane 0 so that the compiler sees
// it is the same across the warp (CUTLASS's canonical_warp_group_idx).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// The producer gives up registers, the consumers take them: 128 x 40 +
// 256 x 232 = 384 x 168, the launch's allocation.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
}

// ------------------------------------------------------------- forward

template <int D> struct FwdSmem {
  static constexpr uint32_t kQ = Atoms<D>::kN * kRows * kAtomBytes;
  static constexpr uint32_t kKV = Atoms<D>::kN * kFwdTile * kAtomBytes;  // one K or V tile
  static constexpr uint32_t kBars = kQ + 2 * kStages * kKV;
  static constexpr size_t kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int D, bool kBidir>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, unsigned short* __restrict__ o,
                     float* __restrict__ lse, Geometry g) {
  using A = Atoms<D>;
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  const uint32_t qs = smem_addr(sm), ks = qs + L::kQ, vs = ks + kStages * L::kKV;

  // the heaviest blocks first: a later rank's later query tile sees more keys
  const int qtile = gridDim.x - 1 - blockIdx.x, cell = blockIdx.y;
  const int r = gridDim.z - 1 - blockIdx.z;
  const int b = cell / g.H, h = cell - b * g.H;
  const int q0 = qtile * kRows;
  const auto range = [&](int s, int& lo, int& hi) {
    lo = 0;
    hi = key_tiles(g, r, visit_src(r, s, g.p, kBidir), q0 + kRows, kFwdTile);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {  // the producer
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(qfull, L::kQ);
    for (int a = 0; a < A::kN; ++a)
      tma_load5(sm + a * A::bytes(kRows), &tm_q, qfull, 64 * a, h, q0, b, r);
    int s, t = 0;
    first_tile(s, t, g.p, range);
    for (int it = 0; s < g.p; ++it) {
      const int stage = it % kStages, round = it / kStages;
      if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
      const int src = visit_src(r, s, g.p, kBidir);
      mbar_expect_tx(&full[stage], 2 * L::kKV);
      unsigned char* kb = sm + L::kQ + stage * L::kKV;
      unsigned char* vb = kb + kStages * L::kKV;
      for (int a = 0; a < A::kN; ++a) {
        tma_load5(kb + a * A::bytes(kFwdTile), &tm_k, &full[stage], 64 * a, h, t * kFwdTile, b,
                  src);
        tma_load5(vb + a * A::bytes(kFwdTile), &tm_v, &full[stage], 64 * a, h, t * kFwdTile, b,
                  src);
      }
      next_tile(s, t, g.p, range);
    }
    return;
  }

  consumer_regs();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int w0 = q0 + kWgRows * wg;             // the warpgroup's first query
  const int row = w0 + 16 * warp + (lane >> 2);  // the lane's rows: row, row + 8
  const uint32_t qw = qs + kWgRows * wg * kAtomBytes;

  // The online softmax in the log2 domain: x = s scale log2(e), m the
  // running max of x, P = 2^(x - m). Each lane keeps its own share of a
  // row's sum l (the quad's four are added at the end) and of its output
  // columns in acc (atom a's 8-column step j, element e at acc[a][4 j + e]).
  const float c = g.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[A::kN][32];
#pragma unroll
  for (int a = 0; a < A::kN; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;

  // One loop body with no product under a branch, each product group
  // behind its own wgmma.fence: ptxas serializes every product of a
  // kernel that issues one on a divergent path, or that writes a
  // product's registers while its group is open. So both warpgroups merge
  // every tile of the block; on the diagonal the first warpgroup's rows
  // see half of the last one. While one warpgroup waits on its products,
  // the other's softmax runs.
  mbar_wait(qfull, 0);
  int s, t = 0;
  first_tile(s, t, g.p, range);
  for (int it = 0; s < g.p; ++it) {
    const int stage = it % kStages, round = it / kStages;
    mbar_wait(&full[stage], round & 1);
    const bool diag = g.causal && visit_src(r, s, g.p, kBidir) == r;
    const int k0 = t * kFwdTile;
    float sc[64];
    wg_fence();
    product_abt<D>(sc, qw, kRows, ks + stage * L::kKV);
    wg_commit();
    wg_wait0();
    fence_acc(sc);
    // a tile inside the causal and ragged edges keeps every pair; a
    // masked score is kNegInf, whose P is 0
    const bool inner = k0 + kFwdTile <= g.n && (!diag || k0 + kFwdTile - 1 <= w0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kFwdTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!inner) {
          const int kj = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          if (kj >= g.n || (diag && kj > row + 8 * (e >> 1))) sc[4 * j + e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * c);  // c > 0: max(s) c = max(s c)
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < kFwdTile / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], c, -m[(i >> 1) & 1]));  // P
      l[(i >> 1) & 1] += sc[i];
    }
    uint32_t hi[kFwdTile / 16][4], lo[kFwdTile / 16][4];
    split_scores(sc, hi, lo);
#pragma unroll
    for (int a = 0; a < A::kN; ++a) {
      float tile[32];
      wg_fence();
      product_pb(tile, hi, lo, vs + stage * L::kKV + a * A::bytes(kFwdTile));
      wg_commit();
      wg_wait0();
      fence_acc(tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = acc[a][i] * alpha[(i >> 1) & 1] + tile[i];
    }
    fence_frag(hi);
    fence_frag(lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    next_tile(s, t, g.p, range);
  }

  // the epilogue: l = max(l, 1e-30), o = acc / l, lse = m + log(l)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row + 8 * hh;
    if (qi >= g.n) continue;
    const float li = fmaxf(l[hh], 1e-30f);
    unsigned short* out = o + g.row(r, cell, qi, D) + 2 * (lane & 3);
#pragma unroll
    for (int a = 0; a < A::kN; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * a + 8 * j < D)
          store_bf16x2(out + 64 * a + 8 * j, acc[a][4 * j + 2 * hh] / li,
                       acc[a][4 * j + 2 * hh + 1] / li);
    if ((lane & 3) == 0) lse[g.stat(r, cell, qi)] = m[hh] * kLn2 + logf(li);
  }
}

// --------------------------------------------------------- backward: dQ

template <int D> struct BwdSmem {
  static constexpr uint32_t kOwn = Atoms<D>::kN * kRows * kAtomBytes;    // one own tile
  static constexpr uint32_t kTileB = Atoms<D>::kN * kTile * kAtomBytes;  // one visited tile
  static constexpr uint32_t kStats = 2 * kStages * kTile * 4;            // lse, D stages
  static constexpr uint32_t kBars = 2 * kOwn + 2 * kStages * kTileB + kStats;
  static constexpr size_t kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const unsigned short* __restrict__ o,
                        const unsigned short* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, unsigned short* __restrict__ dq, Geometry g) {
  using A = Atoms<D>;
  using L = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own = empty + kStages;
  const uint32_t qs = smem_addr(sm), dos = qs + L::kOwn, ks = dos + L::kOwn,
                 vs = ks + kStages * L::kTileB;

  // the heaviest blocks first: a later rank's later query tile sees more keys
  const int qtile = gridDim.x - 1 - blockIdx.x, cell = blockIdx.y;
  const int r = gridDim.z - 1 - blockIdx.z;
  const int b = cell / g.H, h = cell - b * g.H;
  const int q0 = qtile * kRows;
  const auto range = [&](int s, int& lo, int& hi) {
    lo = 0;
    hi = key_tiles(g, r, (r - s + g.p) % g.p, q0 + kRows, kTile);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {  // the producer
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(own, 2 * L::kOwn);
    for (int a = 0; a < A::kN; ++a) {
      tma_load5(sm + a * A::bytes(kRows), &tm_q, own, 64 * a, h, q0, b, r);
      tma_load5(sm + L::kOwn + a * A::bytes(kRows), &tm_do, own, 64 * a, h, q0, b, r);
    }
    int s, t = 0;
    first_tile(s, t, g.p, range);
    for (int it = 0; s < g.p; ++it) {
      const int stage = it % kStages, round = it / kStages;
      if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
      const int src = (r - s + g.p) % g.p;
      mbar_expect_tx(&full[stage], 2 * L::kTileB);
      unsigned char* kb = sm + 2 * L::kOwn + stage * L::kTileB;
      unsigned char* vb = kb + kStages * L::kTileB;
      for (int a = 0; a < A::kN; ++a) {
        tma_load5(kb + a * A::bytes(kTile), &tm_k, &full[stage], 64 * a, h, t * kTile, b, src);
        tma_load5(vb + a * A::bytes(kTile), &tm_v, &full[stage], 64 * a, h, t * kTile, b, src);
      }
      next_tile(s, t, g.p, range);
    }
    return;
  }

  consumer_regs();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int w0 = q0 + kWgRows * wg;
  const int row = w0 + 16 * warp + (lane >> 2);  // the lane's rows: row, row + 8
  const uint32_t qw = qs + kWgRows * wg * kAtomBytes, dow = dos + kWgRows * wg * kAtomBytes;
  const float c = g.scale * kLog2e;

  // D = rowsum(dO * O) of the lane's rows, written for the dK/dV launch;
  // the four lanes of a row each sum every fourth column
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row + 8 * hh;
    float sum = 0.f;
    if (qi < g.n) {
      const size_t off = g.row(r, cell, qi, D);
      for (int d = lane & 3; d < D; d += 4)
        sum += __bfloat162float(__ushort_as_bfloat16(dout[off + d])) *
               __bfloat162float(__ushort_as_bfloat16(o[off + d]));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    del_r[hh] = sum;
    lse_r[hh] = qi < g.n ? lse[g.stat(r, cell, qi)] * kLog2e : 0.f;  // log2 domain
    if ((lane & 3) == 0 && qi < g.n) delta[g.stat(r, cell, qi)] = sum;
  }

  float acc[A::kN][32];
#pragma unroll
  for (int a = 0; a < A::kN; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;

  // As the forward's loop: no product under a branch, each group behind
  // its own wgmma.fence; a tile all masked for this warpgroup's rows (on
  // the diagonal) is taken too: its dS is 0.
  mbar_wait(own, 0);
  int s, t = 0;
  first_tile(s, t, g.p, range);
  for (int it = 0; s < g.p; ++it) {
    const int stage = it % kStages, round = it / kStages;
    mbar_wait(&full[stage], round & 1);
    const bool diag = g.causal && (r - s + g.p) % g.p == r;
    const int k0 = t * kTile;
    const uint32_t kb = ks + stage * L::kTileB, vb = vs + stage * L::kTileB;
    float sc[32], dp[32];
    wg_fence();
    product_abt<D>(sc, qw, kRows, kb);
    product_abt<D>(dp, dow, kRows, vb);
    wg_commit();
    wg_wait0();
    fence_acc(sc);
    fence_acc(dp);
    // a tile inside the causal and ragged edges keeps every pair
    const bool inner =
        k0 + kTile <= g.n && w0 + kWgRows <= g.n && (!diag || k0 + kTile - 1 <= w0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float pv = ex2(fmaf(sc[i], c, -lse_r[hh]));  // P = 2^(s scale log2 e - lse log2 e)
      if (!inner) {
        const int qi = row + 8 * hh, kj = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (qi >= g.n || kj >= g.n || (diag && kj > qi)) pv = 0.f;
      }
      sc[i] = pv * (dp[i] - del_r[hh]);  // dS
    }
    uint32_t hi[4][4], lo[4][4];
    split_scores(sc, hi, lo);
#pragma unroll
    for (int a = 0; a < A::kN; ++a) {
      float tile[32];
      wg_fence();
      product_pb(tile, hi, lo, kb + a * A::bytes(kTile));
      wg_commit();
      wg_wait0();
      fence_acc(tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] += tile[i];
    }
    fence_frag(hi);
    fence_frag(lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    next_tile(s, t, g.p, range);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row + 8 * hh;
    if (qi >= g.n) continue;
    unsigned short* out = dq + g.row(r, cell, qi, D) + 2 * (lane & 3);
#pragma unroll
    for (int a = 0; a < A::kN; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * a + 8 * j < D)
          store_bf16x2(out + 64 * a + 8 * j, acc[a][4 * j + 2 * hh] * g.scale,
                       acc[a][4 * j + 2 * hh + 1] * g.scale);
  }
}

// ------------------------------------------------------ backward: dK, dV

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_lse,
                         const __grid_constant__ CUtensorMap tm_delta,
                         unsigned short* __restrict__ dk, unsigned short* __restrict__ dv,
                         Geometry g) {
  using A = Atoms<D>;
  using L = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own = empty + kStages;
  const uint32_t ks = smem_addr(sm), vs = ks + L::kOwn, qs = vs + L::kOwn,
                 dos = qs + kStages * L::kTileB;
  const float* stats = reinterpret_cast<const float*>(sm + 2 * L::kOwn + 2 * kStages * L::kTileB);

  const int ktile = blockIdx.x, cell = blockIdx.y, j = blockIdx.z;
  const int b = cell / g.H, h = cell - b * g.H;
  const int k0 = ktile * kRows;
  const int nqt = (g.n + kTile - 1) / kTile;
  // visit s: the rank rr = (j + s) mod p; under causal none of its queries
  // sees block j when j > rr, and on the diagonal only query tiles from
  // the block's first key on
  const auto range = [&](int s, int& lo, int& hi) {
    const int rr = (j + s) % g.p;
    lo = g.causal && rr == j ? k0 / kTile : 0;
    hi = g.causal && j > rr ? 0 : nqt;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {  // the producer
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(own, 2 * L::kOwn);
    for (int a = 0; a < A::kN; ++a) {
      tma_load5(sm + a * A::bytes(kRows), &tm_k, own, 64 * a, h, k0, b, j);
      tma_load5(sm + L::kOwn + a * A::bytes(kRows), &tm_v, own, 64 * a, h, k0, b, j);
    }
    int s, t = 0;
    first_tile(s, t, g.p, range);
    for (int it = 0; s < g.p; ++it) {
      const int stage = it % kStages, round = it / kStages;
      if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
      const int rr = (j + s) % g.p;
      mbar_expect_tx(&full[stage], 2 * L::kTileB + 2 * kTile * 4);
      unsigned char* qb = sm + 2 * L::kOwn + stage * L::kTileB;
      unsigned char* dob = qb + kStages * L::kTileB;
      unsigned char* st = sm + 2 * L::kOwn + 2 * kStages * L::kTileB + stage * 2 * kTile * 4;
      for (int a = 0; a < A::kN; ++a) {
        tma_load5(qb + a * A::bytes(kTile), &tm_q, &full[stage], 64 * a, h, t * kTile, b, rr);
        tma_load5(dob + a * A::bytes(kTile), &tm_do, &full[stage], 64 * a, h, t * kTile, b, rr);
      }
      const int at = (int)(((size_t)rr * g.B * g.H + cell) * g.n + t * kTile);
      tma_load1(st, &tm_lse, &full[stage], at);
      tma_load1(st + kTile * 4, &tm_delta, &full[stage], at);
      next_tile(s, t, g.p, range);
    }
    return;
  }

  consumer_regs();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int w0 = k0 + kWgRows * wg;             // the warpgroup's first key
  const int row = w0 + 16 * warp + (lane >> 2);  // the lane's keys: row, row + 8
  const uint32_t kw = ks + kWgRows * wg * kAtomBytes, vw = vs + kWgRows * wg * kAtomBytes;
  const float c = g.scale * kLog2e;

  float dka[A::kN][32], dva[A::kN][32];
#pragma unroll
  for (int a = 0; a < A::kN; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[a][i] = dva[a][i] = 0.f;
  mbar_wait(own, 0);

  // One loop body with no branch around a product (ptxas serializes
  // products on a divergent path): every tile of the block is taken, one
  // all masked for this warpgroup's keys (on the diagonal) too: its P and
  // dS are 0.
  int s, t = 0;
  first_tile(s, t, g.p, range);
  for (int it = 0; s < g.p; ++it) {
    const int stage = it % kStages, round = it / kStages;
    mbar_wait(&full[stage], round & 1);
    const int rr = (j + s) % g.p;
    const bool diag = g.causal && rr == j;
    const int q0 = t * kTile;
    const uint32_t qb = qs + stage * L::kTileB, dob = dos + stage * L::kTileB;
    const float* lse_s = stats + stage * 2 * kTile;
    const float* del_s = lse_s + kTile;
    // transposed scores: st[i] is key row + 8 ((i / 2) % 2) against query
    // q0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    float st[32], dpt[32];
    wg_fence();
    product_abt<D>(st, kw, kRows, qb);
    product_abt<D>(dpt, vw, kRows, dob);
    wg_commit();
    wg_wait0();
    fence_acc(st);
    fence_acc(dpt);
    const bool inner =
        q0 + kTile <= g.n && w0 + kWgRows <= g.n && (!diag || w0 + kWgRows - 1 <= q0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      // the lane's two query columns of step jj, adjacent
      const int col = 8 * jj + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(del_s + col);
      const float la = l2.x * kLog2e, lb = l2.y * kLog2e;  // lse in the log2 domain
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float lq = (e & 1) ? lb : la, dq_ = (e & 1) ? d2.y : d2.x;
        float pv = ex2(fmaf(st[i], c, -lq));  // P^T
        if (!inner) {
          const int qi = q0 + col + (e & 1), kj = row + 8 * (e >> 1);
          if (qi >= g.n || kj >= g.n || (diag && kj > qi)) pv = 0.f;
        }
        dpt[i] = pv * (dpt[i] - dq_);  // dS^T, dq_ the column's D
        st[i] = pv;
      }
    }
    // P^T dO, then dS^T Q, each atom's sum in one fresh tile; dS^T is split
    // while the first P^T dO runs
    uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
    float tile[32];
    split_scores(st, phi, plo);
    wg_fence();
    product_pb(tile, phi, plo, dob);
    wg_commit();
    split_scores(dpt, shi, slo);
#pragma unroll
    for (int a = 0; a < A::kN; ++a) {
      if (a > 0) {
        wg_fence();
        product_pb(tile, phi, plo, dob + a * A::bytes(kTile));
        wg_commit();
      }
      wg_wait0();
      fence_acc(tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) dva[a][i] += tile[i];
    }
    fence_frag(phi);
    fence_frag(plo);
#pragma unroll
    for (int a = 0; a < A::kN; ++a) {
      wg_fence();
      product_pb(tile, shi, slo, qb + a * A::bytes(kTile));
      wg_commit();
      wg_wait0();
      fence_acc(tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[a][i] += tile[i];
    }
    fence_frag(shi);
    fence_frag(slo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    next_tile(s, t, g.p, range);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = row + 8 * hh;
    if (kj >= g.n) continue;
    const size_t off = g.row(j, cell, kj, D) + 2 * (lane & 3);
#pragma unroll
    for (int a = 0; a < A::kN; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (64 * a + 8 * c < D) {
          store_bf16x2(dk + off + 64 * a + 8 * c, dka[a][4 * c + 2 * hh] * g.scale,
                       dka[a][4 * c + 2 * hh + 1] * g.scale);
          store_bf16x2(dv + off + 64 * a + 8 * c, dva[a][4 * c + 2 * hh],
                       dva[a][4 * c + 2 * hh + 1]);
        }
  }
}

// ------------------------------------------------------------ launchers

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once at first use
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [p, B, n, H, D] bf16 tensor as dims (D, H, n, B, p), box (64, 1, rows,
// 1, 1), 128-byte swizzle, out-of-bounds elements read as zeros.
inline bool map_rows(CUtensorMap* map, const void* ptr, const Geometry& g, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)g.H, (cuuint64_t)g.n, (cuuint64_t)g.B,
                              (cuuint64_t)g.p};
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t strides[4] = {row, row * g.H, row * g.H * g.n, row * g.H * g.n * g.B};
  const cuuint32_t box[5] = {64, 1, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [p, B, H, n] f32 statistic as one dim, a box of kTile.
inline bool map_stat(CUtensorMap* map, const float* ptr, const Geometry& g) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)g.p * g.B * g.H * g.n};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t box[1] = {kTile};
  const cuuint32_t step[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (row block, cell, rank) blocks of kRows rows each
inline dim3 grid_of(const Geometry& g) {
  return dim3((unsigned)((g.n + kRows - 1) / kRows), (unsigned)(g.B * g.H), (unsigned)g.p);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Geometry& g, bool bidir, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!map_rows(&tq, q, g, D, kRows) || !map_rows(&tk, k, g, D, kFwdTile) ||
      !map_rows(&tv, v, g, D, kFwdTile))
    return cudaErrorInvalidValue;
  auto kernel = bidir ? fwd_wgmma_kernel<D, true> : fwd_wgmma_kernel<D, false>;
  constexpr size_t bytes = FwdSmem<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g), kThreads, bytes, stream>>>(tq, tk, tv, static_cast<unsigned short*>(o),
                                                  lse, g);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const Geometry& g, cudaStream_t stream) {
  CUtensorMap q_own, do_own, k_tile, v_tile, k_own, v_own, q_tile, do_tile, t_lse, t_delta;
  if (!map_rows(&q_own, q, g, D, kRows) || !map_rows(&do_own, dout, g, D, kRows) ||
      !map_rows(&k_tile, k, g, D, kTile) || !map_rows(&v_tile, v, g, D, kTile) ||
      !map_rows(&k_own, k, g, D, kRows) || !map_rows(&v_own, v, g, D, kRows) ||
      !map_rows(&q_tile, q, g, D, kTile) || !map_rows(&do_tile, dout, g, D, kTile) ||
      !map_stat(&t_lse, lse, g) || !map_stat(&t_delta, delta, g))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = BwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma_kernel<D><<<grid_of(g), kThreads, bytes, stream>>>(
      q_own, do_own, k_tile, v_tile, static_cast<const unsigned short*>(o),
      static_cast<const unsigned short*>(dout), lse, delta, static_cast<unsigned short*>(dq), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_wgmma_kernel<D><<<grid_of(g), kThreads, bytes, stream>>>(
      k_own, v_own, q_tile, do_tile, t_lse, t_delta, static_cast<unsigned short*>(dk),
      static_cast<unsigned short*>(dv), g);
  return cudaGetLastError();
}

inline bool geometry(int p, int B, int n, int H, int D, int causal, Geometry* g) {
  if (p < 1 || B < 1 || n < 1 || H < 1 || (long long)B * H > 65535 || p > 65535) return false;
  // the statistics' 1-D maps address [p, B, H, n] with 32-bit coordinates
  if ((long long)p * B * H * n >= (1ll << 31)) return false;
  *g = Geometry{p, B, n, H, 1.0f / sqrtf((float)D), causal ? 1 : 0};
  return true;
}

}  // namespace attn16
}  // namespace tmpi

#define TMPI_ATTN16_DISPATCH(D_, FN, ...)            \
  switch (D_) {                                      \
    case 8: return (int)FN<8>(__VA_ARGS__);          \
    case 16: return (int)FN<16>(__VA_ARGS__);        \
    case 32: return (int)FN<32>(__VA_ARGS__);        \
    case 64: return (int)FN<64>(__VA_ARGS__);        \
    case 128: return (int)FN<128>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;      \
  }

// q, k, v, o: [p, B, n, H, D] contiguous bf16; lse: [p, B, H, n] f32.
// bidir selects K9's visiting order.
extern "C" int tm_ring_attention_bf16_fwd(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int p, int B, int n, int H, int D,
                                          int causal, int bidir, void* stream) {
  using namespace tmpi::attn16;
  Geometry g;
  if (!geometry(p, B, n, H, D, causal, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  TMPI_ATTN16_DISPATCH(D, launch_fwd, q, k, v, o, l, g, bidir != 0, s)
}

// Inputs as the forward's, with o and dout of q's shape and lse the
// forward's; delta: [p, B, H, n] f32 scratch; dq, dk, dv: bf16 outputs of
// q's shape. Two launches: dQ (which writes delta), then dK/dV.
extern "C" int tm_ring_attention_bf16_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int p,
                                          int B, int n, int H, int D, int causal, void* stream) {
  using namespace tmpi::attn16;
  Geometry g;
  if (!geometry(p, B, n, H, D, causal, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* del = static_cast<float*>(delta);
  TMPI_ATTN16_DISPATCH(D, launch_bwd, q, k, v, o, dout, l, del, dq, dk, dv, g, s)
}
