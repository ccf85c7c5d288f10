// Fused self-attention forward, softmax(Q K^T d^-1/2) V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bioengine_tpu/ops/pallas/attention.py
// (_attn_kernel, launched by pl.pallas_call in _flash_forward). Same
// arithmetic: online softmax with a running max m, a normaliser l and an f32
// accumulator, a padding mask (col < n), an optional causal mask that skips
// key tiles wholly above the diagonal, and zeros for rows whose l is 0.
//
// Layout: q, k, v, o are contiguous (B*H, n, D), D in {32, 64, 128}. Work
// split, both paths: one block per (b*h, 64-row query tile), linear in
// blockIdx.x = bh * q_tiles + q_tile, so the query tiles of one head run
// next to each other and share that head's K and V through L2. The TPU kernel
// carried m/l/acc across a sequential kv grid axis in scratch; CUDA blocks
// run in no order, so a loop inside the block walks the 64-row key/value
// tiles. The ragged end of n is masked in the kernel: nothing is padded to a
// tile multiple, and D is not padded to 128 (both were TPU tiling rules).
// The caller passes the launch plan (ops/attention.py launch_plan); the entry
// point refuses any plan other than its own.
//
// Bound on an H100 SXM at the ViT-B/14 main-path shape (64, 12, 257, 64)
// bf16: 4 tensors x 12.6 M elements x 2 B = 101 MB at 3.35 TB/s is 30 us;
// 4*B*H*N^2*D = 13.0 GFLOP at 989 TFLOP/s is 13 us; 50.7 M exponentials at
// the MUFU rate take ~15 us. So the bound is memory, ~30 us a call.
//
// bf16 path ("wgmma"): both products on the tensor cores, tiles in by TMA.
// - One warpgroup (128 threads) computes; one producer warp loads. The
//   producer issues TMA loads of Q once and of K/V tiles into a 2-stage ring
//   in shared memory, under mbarrier full/empty pairs. The tensor maps are
//   3-D over (D, n, B*H), so rows past n come back zero-filled instead of as
//   the next head's rows; a box is 64 rows x 64 columns (128 B, the swizzle
//   width), and D = 128 takes two boxes per tile, D = 32 one box whose upper
//   32 columns TMA fills with zeros.
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
// f32 path ("cuda_core_f32"): products as plain f32 FMAs on the CUDA cores
// and expf (no TF32, no fast math), so f32 inputs agree with the f32
// reference to ~1e-6, as the JAX suite's 2e-5 tolerance requires. It is
// chosen by dtype, not as a fallback.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // key/value rows per tile
constexpr float kNegInf = -1e30f;  // as the TPU kernel: finite, so m - m_new never makes NaN
static_assert(kBlockQ == kBlockK, "the causal diagonal tile is the key tile with the query tile's index");

// dtype and path codes shared with ops/attention.py
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kPathCudaCoreF32 = 0;
constexpr int kPathWgmma = 1;

// ---------------------------------------------------------------------------
// f32 path: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;        // 16 row groups x 16 column groups
constexpr int kPStride = kBlockK + 16;  // P row stride: rows r and r+1 fall in disjoint banks

__host__ __device__ constexpr int f32_smem_bytes(int d) {
  return (int)sizeof(float) * (3 * kBlockK * (d + 1) + kBlockQ * kPStride);
}

// Stage rows [row0, row0 + 64) of a row-major (n, D) matrix into shared
// memory with row stride D + 1 (conflict-free column reads), times `mul`.
// Rows at or past n are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int row0, int n, float mul) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kF32Threads) {
    const int r = idx / D;
    const int c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? src[(size_t)g * D + c] * mul : 0.f;
  }
}

// Sum or max over the 16 lanes of a half warp (the 16 column groups that
// share one row group). xor butterflies give every lane the same value.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int n,
                      int q_tiles, float scale, int causal) {
  constexpr int RI = kBlockQ / 16;  // query rows per thread
  constexpr int CJ = kBlockK / 16;  // score columns per thread
  constexpr int DJ = D / 16;        // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                      // kBlockQ x (D + 1), pre-scaled
  float* ks = qs + kBlockQ * (D + 1);    // kBlockK x (D + 1)
  float* vs = ks + kBlockK * (D + 1);    // kBlockK x (D + 1)
  float* ps = vs + kBlockK * (D + 1);    // kBlockQ x kPStride

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kBlockQ;
  const size_t base = (size_t)bh * n * D;
  const int tx = threadIdx.x & 15;  // column group
  const int ty = threadIdx.x >> 4;  // row group: rows ty + 16 i

  // q * scale, as the plain version scales q before the product.
  load_tile_f32<D>(qs, q + base, q0, n, scale);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // Causal: key tiles that start past this query tile's last row add nothing.
  const int kv_end = causal ? min(n, q0 + kBlockQ) : n;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks, vs and ps are no longer read
    load_tile_f32<D>(ks, k + base, k0, n, 1.f);
    load_tile_f32<D>(vs, v + base, k0, n, 1.f);
    __syncthreads();

    // S = (q * scale) K^T for this thread's RI x CJ entries.
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + e];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + e];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax over this tile; P goes to shared memory for P V.
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[CJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < n && (!causal || col <= row);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* dst = o + base + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      // a row with no visible key has l == 0: write 0, not NaN
      dst[tx + 16 * j] = l[i] == 0.f ? 0.f : acc[i][j] / l[i];
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int n,
                       float scale, int causal, int q_tiles, int grid, int smem,
                       cudaStream_t stream) {
  auto kernel = flash_attn_f32_kernel<D>;
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, q_tiles, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumerThreads = 128;                    // one warpgroup
constexpr int kWgmmaThreads = kConsumerThreads + 32;     // + one producer warp
constexpr int kStages = 2;                               // K/V ring depth
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
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

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

// 3-D map over a contiguous (bh, n, d) bf16 tensor, dims innermost first:
// 64 x 64 boxes, 128-byte swizzle, out-of-bounds elements read as zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int n, int d) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};  // bytes
  const cuuint32_t box[3] = {kChunkCols, kBlockK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
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
  if ((err = make_map(&tq, q, bh, n, D)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, bh, n, D)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, bh, n, D)) != cudaSuccess) return err;
  auto kernel = flash_attn_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kWgmmaThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), n,
                                                q_tiles, scale * log2e, causal);
  return cudaGetLastError();
}

// The launch plan for these arguments, as ops/attention.py launch_plan
// computes it. Returns false for what no path takes.
struct Plan {
  int path, q_tiles, grid, threads, smem_bytes;
};

bool plan_for(int dtype, int bh, int n, int d, Plan* plan) {
  if (bh <= 0 || n <= 0 || (d != 32 && d != 64 && d != 128)) return false;
  const long long q_tiles = (n + (long long)kBlockQ - 1) / kBlockQ;
  const long long grid = q_tiles * bh;
  if (grid > INT_MAX) return false;
  plan->q_tiles = (int)q_tiles;
  plan->grid = (int)grid;
  switch (dtype) {
    case kDtypeF32:
      plan->path = kPathCudaCoreF32;
      plan->threads = kF32Threads;
      plan->smem_bytes = f32_smem_bytes(d);
      return true;
    case kDtypeBF16:
      plan->path = kPathWgmma;
      plan->threads = kWgmmaThreads;
      plan->smem_bytes = wgmma_smem_bytes(d);
      return true;
    default:
      return false;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; path: 0 = cuda_core_f32, 1 = wgmma.
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
  if (path == kPathCudaCoreF32) {
    switch (d) {
      case 32: return launch_f32<32>(q, k, v, o, n, scale, causal, q_tiles, grid, smem_bytes, s);
      case 64: return launch_f32<64>(q, k, v, o, n, scale, causal, q_tiles, grid, smem_bytes, s);
      case 128: return launch_f32<128>(q, k, v, o, n, scale, causal, q_tiles, grid, smem_bytes, s);
    }
    return cudaErrorInvalidValue;
  }
  // TMA wants 16-byte-aligned global addresses
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
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
