// Fused self-attention forward, softmax(Q K^T d^-1/2) V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bioengine_tpu/ops/pallas/attention.py
// (_attn_kernel, launched by pl.pallas_call in _flash_forward). Same
// arithmetic: online softmax with a running max m, a normaliser l and an f32
// accumulator, a padding mask (col < n), an optional causal mask that skips
// key tiles wholly above the diagonal, and zeros for rows whose l is 0.
//
// Layout: q, k, v, o are contiguous (B*H, n, D), D in {32, 64, 128}, at
// 16-byte-aligned addresses (TMA's rule). Work split, both paths: one block
// per (b*h, query tile of 64 rows per consumer warpgroup), linear in
// blockIdx.x = bh * q_tiles + q_tile,
// so the query tiles of one head run next to each other and share that head's
// K and V through L2. The TPU kernel carried m/l/acc across a sequential kv
// grid axis in scratch; CUDA blocks run in no order, so a loop inside the
// block walks the key/value tiles. The ragged end of n is masked in the
// kernel: nothing is padded to a tile multiple, and D is not padded to 128
// (both were TPU tiling rules). The caller passes the launch plan
// (ops/attention.py launch_plan); the entry point refuses any plan other than
// its own. In both paths TMA loads Q once and K/V tiles into a ring in shared
// memory under mbarrier full/empty pairs, and consumer warpgroups (128
// threads each) run the products with wgmma and the softmax. The tensor maps are
// 3-D over (D, n, B*H), so rows past n come back zero-filled instead of as
// the next head's rows; a box is one 128-byte row (the swizzle width) wide.
//
// Bound on an H100 SXM at the ViT-B/14 main-path shape (64, 12, 257, 64)
// bf16: 4 tensors x 12.6 M elements x 2 B = 101 MB at 3.35 TB/s is 30 us;
// 4*B*H*N^2*D = 13.0 GFLOP at 989 TFLOP/s is 13 us; 50.7 M exponentials at
// the MUFU rate take ~15 us. So the bound is memory, ~30 us a call.
//
// bf16 path ("wgmma"): both products on the tensor cores, tiles in by TMA.
// - One producer warp issues the loads into a 2-stage ring. A box is 64 rows
//   x 64 columns (128 B), and D = 128 takes two boxes per tile, D = 32 one
//   box whose upper 32 columns TMA fills with zeros.
// - S = Q K^T: wgmma m64n64k16, both operands from 128-byte-swizzled shared
//   memory (K stored as key rows is K-major for B), D/16 k-steps, f32
//   accumulators in registers.
// - Online softmax in registers: a row of the accumulator lies on 4 threads,
//   so row max takes two xor shuffles; log2(e) d^-1/2 is one multiplier and
//   exponentials are ex2.approx; only the last key tile (ragged n) and the
//   causal diagonal tile are masked.
// - O += P V: wgmma with P from registers (the S accumulator fragment is the
//   A fragment, converted to bf16 in place), V as an MN-major B from shared
//   memory. P never touches shared memory. O is rescaled by alpha between
//   tiles, divided by l once, rounded once to bf16 and stored for rows < n.
// Not yet: two consumer warpgroups, overlap of softmax with the products,
// register rebalancing with setmaxnreg (the consumer fits its launch-bound
// budget).
//
// f32 path ("tf32x3"): both products as 3xTF32 on the tensor cores, so f32
// inputs agree with the f32 reference within the JAX suite's 2e-5. It
// replaces a CUDA-core kernel of plain f32 FMAs, which was bound at 0.194 ms
// by the 67 TFLOP/s of f32 FMA at the main shape and ran at ~0.9-1.0 ms,
// slower than the library's f32 attention.
// - Bound at (64, 12, 257, 64) f32: 202 MB at 3.35 TB/s is 0.0603 ms; the
//   3 x 13.0 GFLOP of tf32 products at 495 TFLOP/s are 0.0787 ms, so the
//   bound is operations.
// - The split: x = big + small + r, big = tf32(x) and small = tf32(x - big),
//   both rounded to nearest with ties away from zero (cvt.rna's rounding,
//   done with two integer operations); x - big is exact in f32. x y is summed as
//   small(x) big(y) + big(x) small(y) + big(x) big(y) into f32 accumulators,
//   the small terms first; small(x) small(y) (~2^-22 relative) is dropped.
//   q is scaled by d^-1/2 before its split, as the plain version scales q
//   before the product; softmax runs in f32 with expf.
// - Each operand is split once, in shared memory, off the products' path.
//   Issuing a wgmma holds its warp for about the product's own time, so a
//   consumer could not split while its products ran. A splitter warpgroup
//   does it: its thread 0 issues the TMA loads of f32 K/V tiles into a
//   landing ring (2 deep at D = 32, else 1, K and V released apart so that
//   one loads while the other is split), and all 128 threads split each tile
//   into a 2-deep working ring of K big and small and V^T big and small,
//   under mbarrier full/empty pairs with the consumers. V is transposed
//   because tf32 wgmma takes no transpose: both operands must be K-major.
//   Each consumer splits its Q once, in place (big over the landed f32)
//   plus a small copy.
// - Two consumer warpgroups (one at D = 128, for shared memory), each on its
//   own 64 query rows, share each split tile and take turns at the tensor
//   cores (S of one, S of the other, P V of one, ...) through a pair of
//   mbarriers, so that one's softmax runs under the other's products. A
//   consumer whose rows all lie past n takes no part.
// - P stays in registers, with no shuffles: the S accumulator gives thread
//   (g = lane / 4, t = lane % 4) columns 2t and 2t + 1 of each 8-key block,
//   and the tf32 A fragment of a k8 step wants columns t and t + 4. P V sums
//   over keys in any order, so the keys of each 8-block are permuted in V^T
//   (A column t <- key 2t, t + 4 <- key 2t + 1); then the S fragment is the
//   A fragment as it stands, and only P's split happens in registers.
// - Key tiles are 64 rows (32 at D = 128, to fit 227 KB), wgmma m64nNk8 with
//   N = 64 (32) for S and N = min(D, 64) for O.
// Open: the last key tile computes all its columns (a wgmma of a width set
// by the data sits on a branch, and ptxas then serialises every wgmma: at
// n = 257, 320 keys a row for 257); the last query tile at n = 257 holds one
// row but computes 64 (m64 is wgmma's least M), in a block of its own whose
// second consumer has no rows; each block fills its ring from empty.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // key/value rows per tile of the bf16 path
constexpr float kNegInf = -1e30f;  // as the TPU kernel: finite, so m - m_new never makes NaN
static_assert(kBlockQ == kBlockK, "the causal diagonal tile is the key tile with the query tile's index");

// dtype and path codes shared with ops/attention.py
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kPathTf32x3 = 0;
constexpr int kPathWgmma = 1;

// ---------------------------------------------------------------------------
// Both paths: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumerThreads = 128;                    // one warpgroup
constexpr int kWgmmaThreads = kConsumerThreads + 32;     // + one producer warp
constexpr int kStages = 2;                               // K/V ring depth
constexpr int kSwizzleBytes = 128;                       // a swizzled row; 8 of them make a 1 KB atom
constexpr int kChunkCols = 64;                           // bf16 columns in one 128-byte swizzled row
constexpr int kChunkBytes = kBlockK * kChunkCols * 2;    // one 64 x 64 bf16 box: 8 KB
constexpr int kBarrierBytes = 128;
constexpr int kAlignSlack = 1024;                        // 128-byte swizzle wants 1024-byte-aligned tiles
constexpr unsigned long long kWaitLimitCycles = 1ull << 33;  // ~5 s: a stuck pipeline traps, not hangs

__host__ __device__ constexpr int chunks_for(int d) { return d > kChunkCols ? d / kChunkCols : 1; }
__host__ __device__ constexpr int wgmma_smem_bytes(int d) {
  // Q, then K[stage][chunk], V[stage][chunk], then the barriers
  return (1 + 2 * kStages) * chunks_for(d) * kChunkBytes + kBarrierBytes + kAlignSlack;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if ((unsigned long long)(clock64() - t0) > kWaitLimitCycles) __trap();
  }
}

// TMA: a box of the 3-D tensor map at (c0, c1, c2) into shared memory; the
// bytes are counted on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address >> 4 (bits 0-13), leading byte offset (16-29) and stride byte
// offset (32-45) in 16-byte units, base offset 0 (tiles are 1024-byte
// aligned), layout B128 (bits 62-63). SBO is 1024 B, the step from one group
// of 8 rows to the next. K-major operands (Q, K) ignore LBO; the MN-major V
// reads one 64-column swizzle atom per instruction, so LBO (the step to the
// next atom along N) is never taken either, and both fields hold 1024 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous product (the asm statements are ordered; plain code is not).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---------------------------------------------------------------------------
// bf16 path
// ---------------------------------------------------------------------------

// d (64 x 64, f32) = A (64 x 16) B (16 x 64) [+ d], A and B from shared memory,
// both K-major. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B from
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, the lower column
  return *reinterpret_cast<uint32_t*>(&h);
}

// Accumulator fragment of wgmma m64nN (f32): thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + 8 h, h = 0, 1, and in each 8-column block
// j the columns 8 j + 2 (t % 4) + e, e = 0, 1, as register 4 j + 2 h + e.
template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 2)
flash_attn_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int n, int q_tiles,
                        float scale_log2, int causal) {
  constexpr int CH = chunks_for(D);  // 64-column boxes per tile
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int TILE = CH * kChunkBytes;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + kAlignSlack - 1) & ~uint32_t(kAlignSlack - 1);
  const uint32_t k_s = q_s + TILE;             // [stage][chunk]
  const uint32_t v_s = k_s + kStages * TILE;   // [stage][chunk]
  const uint32_t bars = v_s + kStages * TILE;  // q_full, k_full[], v_full[], empty[]
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int bh = blockIdx.x / q_tiles;
  const int qt = blockIdx.x - bh * q_tiles;
  const int q0 = qt * kBlockQ;
  // Causal: key tiles past the diagonal tile add nothing.
  const int kv_tiles = causal ? qt + 1 : (n + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer warp: one thread issues every load.
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load_3d(q_s + c * kChunkBytes, &tm_q, q_full, c * kChunkCols, q0, bh);
      for (int j = 0; j < kv_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t phase = (j / kStages) & 1;
        mbar_wait(empty + 8 * s, phase ^ 1);  // the first round finds every stage free
        // a box's full bytes count, rows TMA fills with zeros included
        mbar_expect_tx(k_full + 8 * s, TILE);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load_3d(k_s + s * TILE + c * kChunkBytes, &tm_k, k_full + 8 * s,
                      c * kChunkCols, j * kBlockK, bh);
        mbar_expect_tx(v_full + 8 * s, TILE);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load_3d(v_s + s * TILE + c * kChunkBytes, &tm_v, v_full + 8 * s,
                      c * kChunkCols, j * kBlockK, bh);
      }
    }
    return;
  }

  // Consumer warpgroup.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8 of the tile
  const int c_lo = 2 * (lane & 3);           // first column in each 8-column block

  float s_acc[32];
  float o_acc[CH][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[c][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's part of the row sum

  mbar_wait(q_full, 0);

  for (int j = 0; j < kv_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t k_tile = k_s + s * TILE;
    const uint32_t v_tile = v_s + s * TILE;

    // S = Q K^T
    mbar_wait(k_full + 8 * s, phase);
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // k-step ks reads 16 columns (32 B) inside box ks / 4
      const uint32_t off = (ks / 4) * kChunkBytes + (ks % 4) * 32;
      wgmma_ss(s_acc, sw128_desc(q_s + off), sw128_desc(k_tile + off), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // Online softmax. Only the last tile (ragged n) and the causal
    // diagonal tile have masked entries.
    const int k0 = j * kBlockK;
    const bool masked = k0 + kBlockK > n || (causal && j == qt);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i / 4) + c_lo + (i & 1);
        const int row = q0 + r_lo + 8 * ((i / 2) & 1);
        if (col >= n || (causal && col > row)) s_acc[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s_acc[i]);
    float m_new[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m_run[h], mx[h] * scale_log2);
      alpha[h] = ex2(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) & 1;
      float p = ex2(fmaf(s_acc[i], scale_log2, -m_new[h]));
      if (masked) {
        const int col = k0 + 8 * (i / 4) + c_lo + (i & 1);
        const int row = q0 + r_lo + 8 * h;
        if (col >= n || (causal && col > row)) p = 0.f;
      }
      s_acc[i] = p;
      rs[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + rs[h];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[c][i] *= alpha[(i / 2) & 1];

    // P to bf16 A fragments: k-step kk covers keys 16 kk .. 16 kk + 15, which
    // are accumulator registers 8 kk .. 8 kk + 7 in the A register order.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s_acc[8 * kk + 2 * r], s_acc[8 * kk + 2 * r + 1]);

    // O += P V
    mbar_wait(v_full + 8 * s, phase);
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(o_acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        // 16 key rows of 128 B further down the box
        wgmma_rs(o_acc[c], pa[kk], sw128_desc(v_tile + c * kChunkBytes + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(o_acc[c]);
    mbar_arrive(empty + 8 * s);  // this thread no longer reads stage s
  }

  // O / l, rounded once; rows past n are not stored.
  __nv_bfloat16* ob = o + (size_t)bh * n * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    // a row with no visible key has l == 0: write 0, not NaN
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int row = q0 + r_lo + 8 * h;
    if (row >= n) continue;
    __nv_bfloat16* dst = ob + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int col = c * kChunkCols + 8 * jb + c_lo;
        if (col < D)  // D = 32 computes a padded 64-column box
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              o_acc[c][4 * jb + 2 * h] * inv, o_acc[c][4 * jb + 2 * h + 1] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// f32 path: 3xTF32
// ---------------------------------------------------------------------------

constexpr int kF32Cols = kSwizzleBytes / 4;  // f32 columns in one swizzled row

constexpr int kSplitThreads = 128;  // the splitter warpgroup
constexpr int kWorkStages = 2;      // ring of split K and V^T tiles

// Per head dim, so that the buffers fit 227 KB: consumer warpgroups, each on
// its own 64 query rows (2, or 1 at D = 128); key rows per tile (64, or 32 at
// D = 128); f32 K/V tiles in flight from TMA (2 at D = 32, else 1).
__host__ __device__ constexpr int tf32x3_consumers(int d) { return d == 128 ? 1 : 2; }
__host__ __device__ constexpr int tf32x3_block_k(int d) { return d == 128 ? 32 : 64; }
__host__ __device__ constexpr int tf32x3_land_stages(int d) { return d == 32 ? 2 : 1; }
__host__ __device__ constexpr int tf32x3_threads(int d) {
  return tf32x3_consumers(d) * kConsumerThreads + kSplitThreads;
}
__host__ __device__ constexpr int tf32x3_smem_bytes(int d) {
  // each consumer's Q big (over its landed f32 Q) and small; the landing
  // ring of f32 K and V tiles; the working ring of K big and small and V^T
  // big and small; then the barriers
  return 4 * (2 * tf32x3_consumers(d) * kBlockQ * d +
              (2 * tf32x3_land_stages(d) + 4 * kWorkStages) * tf32x3_block_k(d) * d) +
         kBarrierBytes + kAlignSlack;
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from zero,
// the low 13 bits cleared: cvt.rna.tf32.f32 for every finite x and for inf,
// in two integer operations (half a tf32 ulp added to the magnitude's bits,
// then the mask). A nan may come out as inf, but its small half is then
// x - big = nan, so a nan input still gives nan.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x = big + small + (what 3xTF32 drops); x - big is exact in f32.
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - big);
}

__device__ __forceinline__ void split_tf32(const float4& x, float4& big, float4& small) {
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#ifdef FLASH_ATTN_PROBES
// Cycles of each phase of a tf32x3 tile, summed over blocks by thread 0 of
// the first consumer (phases 0-7) and of the splitter (8-14); [15] counts
// the first consumer's tiles. scripts/profile_torch_flash_attn.py builds
// this file with -DFLASH_ATTN_PROBES and reads them through
// flash_attn_read_probes. Without the flag the probes are empty.
__device__ unsigned long long g_probe_cycles[16];
#define PROBE_START(on)   \
  const bool probe_on_ = (on); \
  long long probe_[15] = {};   \
  long long probe_t_ = clock64()
#define PROBE(i)                        \
  do {                                  \
    const long long t_ = clock64();     \
    probe_[i] += t_ - probe_t_;         \
    probe_t_ = t_;                      \
  } while (0)
#define PROBE_FLUSH(tiles)                                                         \
  do {                                                                             \
    if (probe_on_) {                                                               \
      for (int i_ = 0; i_ < 15; ++i_)                                              \
        if (probe_[i_]) atomicAdd(&g_probe_cycles[i_], (unsigned long long)probe_[i_]); \
      atomicAdd(&g_probe_cycles[15], (unsigned long long)(tiles));                 \
    }                                                                              \
  } while (0)
#else
#define PROBE_START(on)
#define PROBE(i)
#define PROBE_FLUSH(tiles)
#endif

// The threads of one warpgroup (named barrier `id`; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

#define ACC4(d, i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define OUT4(d, i) "=f"(d[(i)]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]), "=f"(d[(i) + 3])

// d (64 x N, f32) = A (64 x 8) B (8 x N) [+ d] in tf32, A and B from shared
// memory, both K-major (tf32 wgmma takes no transpose); N = 2 R. Without
// ACC, d is overwritten and only written, so that it holds no value live
// from the tile before.
template <bool ACC, int R>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[R], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (R == 16) {
#define WGMMA_TF32_N32(D4)                                                             \
  asm volatile(                                                                        \
      "{\n\t.reg .pred p;\n\t"                                                         \
      "setp.ne.b32 p, %18, 0;\n\t"                                                     \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "                           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "      \
      "%16, %17, p, 1, 1;\n\t}"                                                        \
      : D4(d, 0), D4(d, 4), D4(d, 8), D4(d, 12)                                       \
      : "l"(desc_a), "l"(desc_b), "r"(int(ACC)))
    if constexpr (ACC) WGMMA_TF32_N32(ACC4); else WGMMA_TF32_N32(OUT4);
#undef WGMMA_TF32_N32
  } else {
    static_assert(R == 32, "S takes n32 or n64");
#define WGMMA_TF32_N64(D4)                                                             \
  asm volatile(                                                                        \
      "{\n\t.reg .pred p;\n\t"                                                         \
      "setp.ne.b32 p, %34, 0;\n\t"                                                     \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "                           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1;\n\t}"                                                        \
      : D4(d, 0), D4(d, 4), D4(d, 8), D4(d, 12), D4(d, 16), D4(d, 20), D4(d, 24),     \
        D4(d, 28)                                                                      \
      : "l"(desc_a), "l"(desc_b), "r"(int(ACC)))
    if constexpr (ACC) WGMMA_TF32_N64(ACC4); else WGMMA_TF32_N64(OUT4);
#undef WGMMA_TF32_N64
  }
}

// d (64 x N, f32) += A (64 x 8, tf32 in registers) B (8 x N), B from shared
// memory, K-major; N = 2 R.
template <int R>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[R], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (R == 16) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %21, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n\t}"
        : ACC4(d, 0), ACC4(d, 4), ACC4(d, 8), ACC4(d, 12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    static_assert(R == 32, "O takes n32 or n64");
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %37, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
        : ACC4(d, 0), ACC4(d, 4), ACC4(d, 8), ACC4(d, 12), ACC4(d, 16), ACC4(d, 20),
          ACC4(d, 24), ACC4(d, 28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

#undef ACC4
#undef OUT4

// addr, as a value the compiler cannot see through: descriptors derived from
// it are formed where they are used instead of being hoisted out of the key
// loop, where they would take a register pair each for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(addr));
  return r;
}

// Thread t of the warpgroup holds S and O as the wgmma accumulator fragment:
// rows 16 (t / 32) + (t % 32) / 4 + 8 h, h = 0, 1, and in each 8-column block
// j the columns 8 j + 2 (t % 4) + e, e = 0, 1, as register 4 j + 2 h + e. The
// tf32 A fragment of a k8 step is (row g, col t % 4), (g + 8, t % 4),
// (g, t % 4 + 4), (g + 8, t % 4 + 4) with g that row; with the keys of each
// 8-block permuted in V^T (A column c <- key 2 c for c < 4, key 2 (c - 4) + 1
// after), A register r of block j is S register 4 j + a_from_s(r): 0, 2, 1, 3.
__host__ __device__ constexpr int a_from_s(int r) { return ((r & 1) << 1) | (r >> 1); }

template <int D>
__global__ void __launch_bounds__(tf32x3_threads(D), 1)
flash_attn_tf32x3_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v, float* __restrict__ o,
                         int n, int q_tiles, float scale, int causal) {
  constexpr int NC = tf32x3_consumers(D);        // consumer warpgroups
  constexpr int BK = tf32x3_block_k(D);          // key rows per tile
  constexpr int LS = tf32x3_land_stages(D);      // f32 K/V tiles TMA keeps in flight
  constexpr int WS = kWorkStages;                // split K/V tiles ready for the products
  constexpr int BOXES = D / kF32Cols;            // 32-column boxes across d
  constexpr int KS = D / 8;                      // k8 steps of Q K^T
  constexpr int NB = BK / 8;                     // 8-key blocks: k8 steps of P V
  constexpr int ON = D < 64 ? D : 64;            // columns of O per P V instruction
  constexpr int OC = D / ON;
  constexpr int Q_BOX = kBlockQ * kSwizzleBytes;  // one 32-column box of Q
  constexpr int K_BOX = BK * kSwizzleBytes;       // of a K or V tile
  constexpr int VT_BOX = D * kSwizzleBytes;       // V^T: D rows x 32 keys
  constexpr int TQ = BOXES * Q_BOX;
  constexpr int TK = BOXES * K_BOX;  // an f32 K or V tile, and V^T

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + kAlignSlack - 1) & ~uint32_t(kAlignSlack - 1);
  uint8_t* const base = smem_raw + (q_s - smem_u32(smem_raw));  // generic view of q_s
  // consumer c's Q big is q_s + 2 c TQ, its Q small the TQ after it
  const uint32_t k_land = q_s + 2 * NC * TQ;   // [LS], f32 as TMA lands it
  const uint32_t v_land = k_land + LS * TK;    // [LS]
  const uint32_t k_big = v_land + LS * TK;     // [WS], then k_small, vt_big, vt_small
  const uint32_t k_small = k_big + WS * TK;
  const uint32_t vt_big = k_small + WS * TK;
  const uint32_t vt_small = vt_big + WS * TK;
  // q_full, k_full[], v_full[], k_empty[], v_empty[], work_full[],
  // work_empty[], turn[]
  const uint32_t bars = vt_small + WS * TK;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = k_full + 8 * LS;
  const uint32_t work_full = v_full + 8 * LS;
  const uint32_t work_empty = work_full + 8 * WS;
  const uint32_t turn = work_empty + 8 * WS;  // consumer c may issue products: turn + 8 c
  auto at = [&](uint32_t addr) { return base + (addr - q_s); };

  // The block's NC x 64 query rows; consumers whose rows all lie past n
  // take no part.
  const int bh = blockIdx.x / q_tiles;
  const int qb = (blockIdx.x - bh * q_tiles) * NC * kBlockQ;
  const int active = min(NC, (n - qb + kBlockQ - 1) / kBlockQ);
  // Causal: keys past the block's last row add nothing.
  const int kv_len = causal ? min(n, qb + NC * kBlockQ) : n;
  const int kv_tiles = (kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < LS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
    }
#pragma unroll
    for (int s = 0; s < WS; ++s) {
      mbar_init(work_full + 8 * s, kSplitThreads);
      mbar_init(work_empty + 8 * s, active * kConsumerThreads);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) mbar_init(turn + 8 * c, kConsumerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * kConsumerThreads) {
    // Splitter warpgroup: its thread 0 issues every TMA load; all of it
    // splits each landed K and V tile into the working ring.
    const int st = threadIdx.x - NC * kConsumerThreads;
    PROBE_START(st == 0);
    // TMA of tile j of K (or V) into its landing stage; a box's full bytes
    // count, zero-filled rows too
    auto load = [&](const CUtensorMap* map, uint32_t land, uint32_t full, int j) {
      const int ls = j % LS;
      mbar_expect_tx(full + 8 * ls, TK);
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
        tma_load_3d(land + ls * TK + c * K_BOX, map, full + 8 * ls, c * kF32Cols, j * BK, bh);
    };
    if (st == 0) {
      mbar_expect_tx(q_full, active * TQ);
      for (int w = 0; w < active; ++w)
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(q_s + 2 * w * TQ + c * Q_BOX, &tm_q, q_full, c * kF32Cols,
                      qb + w * kBlockQ, bh);
      for (int j = 0; j < LS && j < kv_tiles; ++j) {
        load(&tm_k, k_land, k_full, j);
        load(&tm_v, v_land, v_full, j);
      }
    }
    for (int j = 0; j < kv_tiles; ++j) {
      const int ls = j % LS;
      const uint32_t lphase = (j / LS) & 1;
      const int ws = j % WS;
      mbar_wait(work_empty + 8 * ws, ((j / WS) & 1) ^ 1);  // the first round finds it free
      PROBE(8);

      // K into big and small, at the same swizzled offsets TMA wrote.
      mbar_wait(k_full + 8 * ls, lphase);
      PROBE(9);
      const float4* kl = reinterpret_cast<const float4*>(at(k_land + ls * TK));
#pragma unroll
      for (int it = 0; it < TK / 16 / kSplitThreads; ++it) {
        const int i = it * kSplitThreads + st;
        float4 b, sm;
        split_tf32(kl[i], b, sm);
        reinterpret_cast<float4*>(at(k_big + ws * TK))[i] = b;
        reinterpret_cast<float4*>(at(k_small + ws * TK))[i] = sm;
      }
      PROBE(10);
      if (j + LS < kv_tiles) {
        named_sync(2, kSplitThreads);  // no splitter thread reads K's landing stage ls any more
        if (st == 0) load(&tm_k, k_land, k_full, j + LS);
      }
      PROBE(11);

      // V^T big and small, keys permuted within each 8-block. A thread
      // writes 16 B of one V^T row (one column r of V): positions
      // 4 u .. 4 u + 3, which hold keys 8 (u / 2) + 2 i + u % 2, i = 0..3.
      mbar_wait(v_full + 8 * ls, lphase);
      PROBE(12);
#pragma unroll
      for (int it = 0; it < D * BK / 4 / kSplitThreads; ++it) {
        const int idx = it * kSplitThreads + st;
        const int r = idx % D;  // a warp takes 32 consecutive columns: no bank conflicts
        const int u = idx / D;
        const int cc = r % kF32Cols;
        const uint8_t* src = at(v_land + ls * TK) + (r / kF32Cols) * K_BOX;
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 8 * (u >> 1) + 2 * i + (u & 1);
          // 128-byte swizzle: the 16-byte chunk index XOR the row within its 8
          x[i] = *reinterpret_cast<const float*>(src + key * kSwizzleBytes +
                                                 (((cc >> 2) ^ (key & 7)) << 4) + ((cc & 3) << 2));
        }
        float4 b, sm;
        split_tf32(make_float4(x[0], x[1], x[2], x[3]), b, sm);
        const uint32_t off = (u / 8) * VT_BOX + r * kSwizzleBytes + (((u & 7) ^ (r & 7)) << 4);
        *reinterpret_cast<float4*>(at(vt_big + ws * TK + off)) = b;
        *reinterpret_cast<float4*>(at(vt_small + ws * TK + off)) = sm;
      }
      fence_proxy_async();  // the products read the ring through the async proxy
      mbar_arrive(work_full + 8 * ws);
      PROBE(13);
      if (j + LS < kv_tiles) {
        named_sync(2, kSplitThreads);  // nor V's
        if (st == 0) load(&tm_v, v_land, v_full, j + LS);
      }
      PROBE(14);
    }
    PROBE_FLUSH(0);
    return;
  }

  // Consumer warpgroups: the products and the softmax, each on its own 64
  // query rows. With two, they take turns at issuing products (S, then
  // P V), so that one's softmax runs under the other's products.
  const int wg = threadIdx.x / kConsumerThreads;
  if (wg >= active) return;
  const int q0 = qb + wg * kBlockQ;
  const uint32_t q_big = q_s + 2 * wg * TQ;
  const uint32_t q_small = q_big + TQ;
  const bool turns = active == 2;
  int phase_no = 0;  // product phases this warpgroup has issued
  auto wait_turn = [&]() {
    // consumer 0 opens; phase k of one waits for phase k (consumer 1) or
    // k - 1 (consumer 0) of the other
    if (turns && (wg == 1 || phase_no > 0))
      mbar_wait(turn + 8 * wg, (wg == 1 ? phase_no : phase_no - 1) & 1);
  };
  auto pass_turn = [&]() {
    if (turns) mbar_arrive(turn + 8 * (1 - wg));
    ++phase_no;
  };
  const int tid = threadIdx.x % kConsumerThreads;
  PROBE_START(wg == 0 && tid == 0);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8 of the tile
  const int c_lo = 2 * (lane & 3);           // first column in each 8-column block

  // Q * d^-1/2 split in place into big, and small beside it. The product is
  // rounded once, as the plain version rounds q * scale (no FMA contraction).
  mbar_wait(q_full, 0);
#pragma unroll
  for (int it = 0; it < TQ / 16 / kConsumerThreads; ++it) {
    const int i = it * kConsumerThreads + tid;
    float4* big = reinterpret_cast<float4*>(at(q_big)) + i;
    float4 x = *big;
    x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale),
                    __fmul_rn(x.w, scale));
    float4 b, sm;
    split_tf32(x, b, sm);
    *big = b;
    reinterpret_cast<float4*>(at(q_small))[i] = sm;
  }
  fence_proxy_async();
  named_sync(1 + 2 * wg, kConsumerThreads);  // every thread of this consumer has written its Q

  float s_acc[BK / 2];
  float o_acc[OC][ON / 2];
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) o_acc[c][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max
  float l_run[2] = {0.f, 0.f};          // this thread's part of the row sum

  for (int j = 0; j < kv_tiles; ++j) {
    const int ws = j % WS;
    const int k0 = j * BK;
    mbar_wait(work_full + 8 * ws, (j / WS) & 1);
    PROBE(0);

    // S = Q K^T: small terms first, then big big. A descriptor moves by
    // (bytes >> 4) with its start address.
    {
      const uint64_t dq_big = sw128_desc(opaque(q_big)), dq_small = sw128_desc(opaque(q_small));
      const uint64_t dk_big = sw128_desc(opaque(k_big + ws * TK));
      const uint64_t dk_small = sw128_desc(opaque(k_small + ws * TK));
      wait_turn();
      PROBE(1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // k8 step ks reads 8 columns (32 B) inside box ks / 4
        const uint32_t qo = ((ks / 4) * Q_BOX + (ks % 4) * 32) >> 4;
        const uint32_t ko = ((ks / 4) * K_BOX + (ks % 4) * 32) >> 4;
        if (ks == 0)
          wgmma_tf32_ss<false>(s_acc, dq_small + qo, dk_big + ko);
        else
          wgmma_tf32_ss<true>(s_acc, dq_small + qo, dk_big + ko);
        wgmma_tf32_ss<true>(s_acc, dq_big + qo, dk_small + ko);
        wgmma_tf32_ss<true>(s_acc, dq_big + qo, dk_big + ko);
      }
      wgmma_commit();
      pass_turn();
      PROBE(2);
      wgmma_wait_all();
      fence_regs(s_acc);
      PROBE(3);
    }

    // Online softmax. Only the last tile (ragged n) and the causal diagonal
    // are masked; P is 0 there, and V's rows past n are TMA's zeros.
    const bool masked = k0 + BK > n || (causal && k0 + BK - 1 > q0);
    if (masked) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + c_lo + (i & 1);
        const int row = q0 + r_lo + 8 * ((i / 2) & 1);
        if (col >= n || (causal && col > row)) s_acc[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s_acc[i]);
    float m_new[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) & 1;
      float p = expf(s_acc[i] - m_new[h]);
      if (masked) {
        const int col = k0 + 8 * (i / 4) + c_lo + (i & 1);
        const int row = q0 + r_lo + 8 * h;
        if (col >= n || (causal && col > row)) p = 0.f;
      }
      s_acc[i] = p;
      rs[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + rs[h];
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) o_acc[c][i] *= alpha[(i / 2) & 1];

    // P into big and small A fragments, in registers.
    uint32_t pa_big[NB][4], pa_small[NB][4];
#pragma unroll
    for (int kk = 0; kk < NB; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float b, sm;
        split_tf32(s_acc[4 * kk + a_from_s(r)], b, sm);
        pa_big[kk][r] = __float_as_uint(b);
        pa_small[kk][r] = __float_as_uint(sm);
      }

    PROBE(4);

    // O += P V: small terms first, then big big.
    const uint64_t dv_big = sw128_desc(opaque(vt_big + ws * TK));
    const uint64_t dv_small = sw128_desc(opaque(vt_small + ws * TK));
#pragma unroll
    for (int c = 0; c < OC; ++c) fence_regs(o_acc[c]);
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      fence_regs(pa_big[kk]);
      fence_regs(pa_small[kk]);
    }
    wait_turn();
    PROBE(5);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      // k8 step kk: 8 keys (32 B) inside V^T box kk / 4; O's columns in
      // 64-row steps of V^T
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const uint32_t co = ((kk / 4) * VT_BOX + (kk % 4) * 32 + c * ON * kSwizzleBytes) >> 4;
        wgmma_tf32_rs(o_acc[c], pa_small[kk], dv_big + co);
        wgmma_tf32_rs(o_acc[c], pa_big[kk], dv_small + co);
        wgmma_tf32_rs(o_acc[c], pa_big[kk], dv_big + co);
      }
    }
    wgmma_commit();
    pass_turn();
    PROBE(6);
    wgmma_wait_all();
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      fence_regs(pa_big[kk]);
      fence_regs(pa_small[kk]);
    }
#pragma unroll
    for (int c = 0; c < OC; ++c) fence_regs(o_acc[c]);
    mbar_arrive(work_empty + 8 * ws);  // this thread's products no longer read the stage
    PROBE(7);
  }
  PROBE_FLUSH(kv_tiles);

  // O / l; rows past n are not stored.
  float* ob = o + (size_t)bh * n * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + r_lo + 8 * h;
    if (row >= n) continue;
    float* dst = ob + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int jb = 0; jb < ON / 8; ++jb) {
        const int i = 4 * jb + 2 * h;
        // a row with no visible key has l == 0: write 0, not NaN
        *reinterpret_cast<float2*>(dst + c * ON + 8 * jb + c_lo) =
            l == 0.f ? make_float2(0.f, 0.f)
                     : make_float2(o_acc[c][i] / l, o_acc[c][i + 1] / l);
      }
  }
}

// cuTensorMapEncodeTiled is a driver API function; taking it through the
// runtime's entry-point query keeps the library free of -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 3-D map over a contiguous (bh, n, d) bf16 or f32 tensor, dims innermost
// first: boxes of `box_rows` rows x one 128-byte row (64 bf16 or 32 f32
// columns), 128-byte swizzle, out-of-bounds elements read as zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int n, int d, bool f32,
                     int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {d * elem, n * d * elem};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)(kSwizzleBytes / elem), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh, int n,
                         float scale, int causal, int q_tiles, int grid, int smem,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, bh, n, D, false, kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, bh, n, D, false, kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, bh, n, D, false, kBlockK)) != cudaSuccess) return err;
  auto kernel = flash_attn_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kWgmmaThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), n,
                                                q_tiles, scale * log2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o, int bh, int n,
                          float scale, int causal, int q_tiles, int grid, int smem,
                          cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  constexpr int BK = tf32x3_block_k(D);
  if ((err = make_map(&tq, q, bh, n, D, true, kBlockQ)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, bh, n, D, true, BK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, bh, n, D, true, BK)) != cudaSuccess) return err;
  auto kernel = flash_attn_tf32x3_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tf32x3_threads(D), smem, stream>>>(tq, tk, tv, static_cast<float*>(o), n,
                                                    q_tiles, scale, causal);
  return cudaGetLastError();
}

// The launch plan for these arguments, as ops/attention.py launch_plan
// computes it. Returns false for what no path takes.
struct Plan {
  int path, q_tiles, grid, threads, smem_bytes;
};

bool plan_for(int dtype, int bh, int n, int d, Plan* plan) {
  if (bh <= 0 || n <= 0 || (d != 32 && d != 64 && d != 128)) return false;
  if (dtype == kDtypeF32) {
    plan->path = kPathTf32x3;
    plan->threads = tf32x3_threads(d);
    plan->smem_bytes = tf32x3_smem_bytes(d);
  } else if (dtype == kDtypeBF16) {
    plan->path = kPathWgmma;
    plan->threads = kWgmmaThreads;
    plan->smem_bytes = wgmma_smem_bytes(d);
  } else {
    return false;
  }
  // query rows per block: 64 for each consumer warpgroup
  const long long rows = dtype == kDtypeF32 ? tf32x3_consumers(d) * kBlockQ : kBlockQ;
  const long long q_tiles = (n + rows - 1) / rows;
  const long long grid = q_tiles * bh;
  if (grid > INT_MAX) return false;
  plan->q_tiles = (int)q_tiles;
  plan->grid = (int)grid;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; path: 0 = tf32x3, 1 = wgmma.
// q_tiles, grid, threads and smem_bytes are the caller's launch plan; a plan
// that differs from plan_for's is refused. Returns the cudaError_t of the
// launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                              int n, int d, float scale, int causal, int dtype, int path,
                              int q_tiles, int grid, int threads, int smem_bytes,
                              void* stream) {
  Plan plan;
  if (!plan_for(dtype, bh, n, d, &plan) || path != plan.path || q_tiles != plan.q_tiles ||
      grid != plan.grid || threads != plan.threads || smem_bytes != plan.smem_bytes)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA wants 16-byte-aligned global addresses
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (path == kPathTf32x3) {
    switch (d) {
      case 32: return launch_tf32x3<32>(q, k, v, o, bh, n, scale, causal, q_tiles, grid, smem_bytes, s);
      case 64: return launch_tf32x3<64>(q, k, v, o, bh, n, scale, causal, q_tiles, grid, smem_bytes, s);
      case 128: return launch_tf32x3<128>(q, k, v, o, bh, n, scale, causal, q_tiles, grid, smem_bytes, s);
    }
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 32: return launch_wgmma<32>(q, k, v, o, bh, n, scale, causal, q_tiles, grid, smem_bytes, s);
    case 64: return launch_wgmma<64>(q, k, v, o, bh, n, scale, causal, q_tiles, grid, smem_bytes, s);
    case 128: return launch_wgmma<128>(q, k, v, o, bh, n, scale, causal, q_tiles, grid, smem_bytes, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef FLASH_ATTN_PROBES
// The probes' sums since the last call (which it then zeroes); see PROBE.
extern "C" int flash_attn_read_probes(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_probe_cycles, sizeof(g_probe_cycles));
  const unsigned long long zero[16] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_probe_cycles, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
