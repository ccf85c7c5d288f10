// Fused self-attention forward, softmax(Q K^T d^-1/2) V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bioengine_tpu/ops/pallas/attention.py
// (_attn_kernel, launched by pl.pallas_call in _flash_forward). Same
// arithmetic: online softmax with a running max m, a normaliser l and an f32
// accumulator, a padding mask (col < n), an optional causal mask that skips
// key tiles wholly above the diagonal, and zeros for rows whose l is 0.
//
// Layout: q, k, v, o are contiguous (B*H, n, D) in f32 or bf16.
// Work split: one block per (b*h, 64-row query tile). The TPU kernel carried
// m/l/acc across a sequential kv grid axis in scratch; CUDA blocks run in no
// order, so here a loop inside the block walks the key/value tiles, with m, l
// and acc in f32 registers and the tiles staged in shared memory as f32. The
// ragged end of n is masked in the kernel: nothing is padded to a tile
// multiple, and D is not padded to 128 (both were TPU tiling rules).
//
// Arithmetic is plain f32 FMAs and expf (no TF32, no fast math), so f32
// inputs agree with the f32 reference to ~1e-6; bf16 inputs are widened to
// f32 on load and the output is rounded once.
//
// Bound on an H100 SXM at the ViT-B/14 main-path shape (64, 12, 257, 64)
// bf16: 4 tensors x 12.6 M elements x 2 B = 101 MB at 3.35 TB/s is 30 us;
// 4*B*H*N^2*D = 13.0 GFLOP at 989 TFLOP/s (bf16 tensor cores) is 13 us. So the
// bound is memory, ~30 us a call. This first kernel runs its products on the
// CUDA cores in f32 and is far from that bound; wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;         // query rows per block
constexpr int kBlockK = 64;         // key/value rows per tile
constexpr int kThreads = 256;       // 16 row groups x 16 column groups
constexpr int kPStride = kBlockK + 16;  // P row stride: rows r and r+1 fall in disjoint banks
constexpr float kNegInf = -1e30f;   // as the TPU kernel: finite, so m - m_new never makes NaN
static_assert(kBlockQ == kBlockK, "load_tile stages 64-row tiles of q, k and v alike");

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Stage rows [row0, row0 + 64) of a row-major (n, D) matrix into shared
// memory as f32 with row stride D + 1 (conflict-free column reads), times
// `mul`. Rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n, float mul) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? to_f32(src[(size_t)g * D + c]) * mul : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int n,
                      float scale, int causal) {
  constexpr int RI = kBlockQ / 16;  // query rows per thread
  constexpr int CJ = kBlockK / 16;  // score columns per thread
  constexpr int DJ = D / 16;        // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                      // kBlockQ x (D + 1), pre-scaled
  float* ks = qs + kBlockQ * (D + 1);    // kBlockK x (D + 1)
  float* vs = ks + kBlockK * (D + 1);    // kBlockK x (D + 1)
  float* ps = vs + kBlockK * (D + 1);    // kBlockQ x kPStride

  const size_t base = (size_t)blockIdx.x * n * D;
  const int q0 = blockIdx.y * kBlockQ;
  const int tx = threadIdx.x & 15;  // column group
  const int ty = threadIdx.x >> 4;  // row group: rows ty + 16 i

  // q * scale, as the plain version scales q before the product.
  load_tile<T, D>(qs, q + base, q0, n, scale);

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
    load_tile<T, D>(ks, k + base, k0, n, 1.f);
    load_tile<T, D>(vs, v + base, k0, n, 1.f);
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
    T* dst = o + base + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      // a row with no visible key has l == 0: write 0, not NaN
      const float val = l[i] == 0.f ? 0.f : acc[i][j] / l[i];
      dst[tx + 16 * j] = from_f32<T>(val);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int n, float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBlockQ * (D + 1) + 2 * (size_t)kBlockK * (D + 1) +
                       (size_t)kBlockQ * kPStride);
  auto kernel = flash_attn_fwd_kernel<T, D>;
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (n + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int bh, int n, int d, float scale, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, n, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, n, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, n, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int bh, int n, int d, float scale,
                              int causal, int dtype, void* stream) {
  // grid.y is at most 65535 tiles of 64 rows
  if (bh <= 0 || n <= 0 || (n + kBlockQ - 1) / kBlockQ > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, bh, n, d, scale, causal, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, n, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
