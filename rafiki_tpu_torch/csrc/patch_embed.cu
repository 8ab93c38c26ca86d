// Tiled x @ w + b, for Hopper (sm_90a): the ViT patch projection.
//
// matmul_bias_kernel replaces _matmul_bias_kernel (B7) of the JAX package's
// rafiki_tpu/ops/patch_embed.py: out = (x @ w + b) for row-major x (m, k),
// w (k, n) and b (n,), all of one type (f32 or bf16), every product and sum
// in f32, the result rounded once to that type. ViT-B/16 gives it
// (B * 196, 768) x (768, 768) + (768,).
//
// What bounds it on this card: 2*m*n*k operations against (m*k + k*n + n +
// m*n) elements moved. At ViT-B/16's serving shape (m = 64 * 196 = 12544,
// n = k = 768, bf16) that is 14.8 GFLOP against 39.7 MB, ~370 operations
// per byte: above the H100's ~295 bf16 operations per byte, so the ideal
// bound is operations (0.015 ms at 989 TFLOP/s, against 0.012 ms for the
// bytes). This design runs its arithmetic as f32 FMA on the CUDA cores, at
// most 67 TFLOP/s, so it cannot come within 15x of that bound; tensor cores
// (mma.sync / wgmma) and TMA loads are later work.
//
// What this design does, in its simple first form: one block of 256
// threads per 64 x 64 output tile walks k in 32-wide tiles staged through
// shared memory as f32: the x tile stored transposed, so a thread's 4 rows
// come in one 128-bit load, the w tile as it lies, so its 4 columns do too.
// Each thread holds a 4 x 4 register tile (rows 4 ty .. 4 ty + 3, columns
// 4 tx .. 4 tx + 3) and does 16 FMA per two shared-memory loads. The bias
// is added in the epilogue. The ragged edges of m, n and k are masked in the
// kernel (zeros in the tiles, no stores past the edge): the JAX wrapper's
// pad to block multiples was TPU tiling and has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // depth of one staged k tile
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kR = 4;          // rows / columns of a thread's tile
constexpr int kXS = kBM + 4;   // padded row of the transposed x tile

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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Block (n tile blockIdx.x, m tile blockIdx.y).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_bias_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ out, int m,
                       int n, int k) {
  __shared__ __align__(16) float xs[kBK][kXS];  // xs[kk][r] = x[m0 + r][k0 + kk]
  __shared__ __align__(16) float ws[kBK][kBN];  // ws[kk][c] = w[k0 + kk][n0 + c]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x: neighbouring threads read neighbouring k of one row (coalesced)
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK;
      const int c = idx - r * kBK;
      const int row = m0 + r;
      const int col = k0 + c;
      xs[c][r] = row < m && col < k
                     ? to_f32<T>(x[static_cast<size_t>(row) * k + col])
                     : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN;
      const int c = idx - r * kBN;
      const int row = k0 + r;
      const int col = n0 + c;
      ws[r][c] = row < k && col < n
                     ? to_f32<T>(w[static_cast<size_t>(row) * n + col])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * kR]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * kR]);
      const float a[kR] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[kR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are consumed
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = m0 + ty * kR + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int col = n0 + tx * kR + j;
      if (col < n)
        out[static_cast<size_t>(row) * n + col] =
            from_f32<T>(acc[i][j] + to_f32<T>(b[col]));
    }
  }
}

template <typename T>
int run(const void* x, const void* w, const void* b, void* out, int m, int n,
        int k, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_bias_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and out share it). Layouts are
// contiguous row-major: x (m, k), w (k, n), b (n,), out (m, n); m, n, k > 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rt_matmul_bias(int dtype, const void* x, const void* w,
                              const void* b, void* out, int m, int n, int k,
                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w, b, out, m, n, k, st);
  if (dtype == 1) return run<__nv_bfloat16>(x, w, b, out, m, n, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
