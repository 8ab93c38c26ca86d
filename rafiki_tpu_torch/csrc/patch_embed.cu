// Tiled x @ w + b, for Hopper (sm_90a): the ViT patch projection.
//
// Replaces _matmul_bias_kernel (B7) of the JAX package's
// rafiki_tpu/ops/patch_embed.py: out = (x @ w + b) for row-major x (m, k),
// w (k, n) and b (n,), all of one type (f32 or bf16), every product and sum
// in f32, the result rounded once to that type. ViT-B/16 gives it
// (B * 196, 768) x (768, 768) + (768,).
//
// What bounds it on this card: 2*m*n*k operations against (m*k + k*n + n +
// m*n) elements moved. At ViT-B/16's serving shape (m = 64 * 196 = 12544,
// n = k = 768, bf16) that is 14.8 GFLOP against 39.7 MB, ~370 operations
// per byte: above the H100's ~295 bf16 operations per byte, so the bound is
// operations (0.015 ms at 989 TFLOP/s, against 0.012 ms for the bytes), and
// only the tensor cores can come near it.
//
// Two bodies, one C entry; the host picks the body and its copy width from
// the dtype and the shapes (ops/patch_embed.py _matmul_plan):
//
// - bf16, matmul_bias_mma_kernel: Hopper's warpgroup tensor-core product
//   (wgmma). One block of 2 warpgroups per 128 x 192 output tile walks k in
//   64-deep tiles through a 4-stage shared-memory ring. With 16-byte
//   aligned rows (k and n multiples of 8, as every ViT shape is) each
//   stage's x tile (128 x 64) and w tile (64 x 192) arrive by 16-byte
//   cp.async.cg copies, three tiles ahead; a chunk past m, n or k is
//   zero-filled (cp.async's src-size 0). The tiles land in the layouts
//   wgmma's 128-byte swizzle reads: x K-major, 128-byte rows; w N-major, as
//   three 64-column blocks of 128-byte rows; in both, 8 rows make a 1024-byte
//   atom whose 16-byte chunk c of row r sits at c ^ (r & 7). Each
//   warpgroup issues, per 64-deep tile, four wgmma m64n192k16 bf16 x bf16 ->
//   f32 straight from shared memory (two descriptors, w with the transpose
//   bit), into 96 f32 registers a thread, and keeps that batch in flight
//   while the previous tile's batch finishes and its stage is refilled. A
//   bf16 product is exact in f32, so this computes the JAX kernel's
//   function; only the order of the f32 sums differs. The epilogue adds the
//   bias in f32, rounds once into a tile staged in the freed ring, and
//   stores whole rows in 16-byte pieces, masked past m and n. Rows that are
//   not 16-byte aligned (k = 75, n = 33) take the same kernel with element
//   copies through registers into the same swizzled ring, and element
//   stores: every bf16 shape runs on the tensor cores.
//   Tiles and waves: at ViT's shape the grid is 98 x 4 = 392 blocks, one
//   per SM (160 KB of ring, ~186 registers a thread): 2.97 waves on 132
//   SMs, the last one full. wgmma reads each operand from shared memory
//   once per warpgroup; warp-level mma.sync reads it once per warp, about
//   as fast as the tensor cores take it (PERF.md). What is left: the
//   threads still issue the copies and wait at two barriers a tile, and a
//   block's fill and epilogue overlap nothing; TMA loads from a producer
//   warp and persistent blocks are the next step.
// - f32, matmul_bias_fma_kernel: the exactness legs. TF32 would break the f32
//   tolerance, so it stays the first design: one block of 256 threads per
//   64 x 64 output tile, 32-deep k tiles staged through shared memory, 4 x 4
//   register tiles of f32 FMA on the CUDA cores, the bias in the epilogue,
//   ragged edges masked.
//
// The JAX wrapper's pad of every dimension to block multiples was TPU
// tiling and has no counterpart here: both kernels mask the edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- f32 body

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // depth of one staged k tile
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kR = 4;          // rows / columns of a thread's tile
constexpr int kXS = kBM + 4;   // padded row of the transposed x tile

// Block (n tile blockIdx.x, m tile blockIdx.y).
__global__ void __launch_bounds__(kThreads)
    matmul_bias_fma_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ out, int m, int n, int k) {
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
      xs[c][r] = row < m && col < k ? x[static_cast<size_t>(row) * k + col]
                                    : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN;
      const int c = idx - r * kBN;
      const int row = k0 + r;
      const int col = n0 + c;
      ws[r][c] = row < k && col < n ? w[static_cast<size_t>(row) * n + col]
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
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[i][j] + b[col];
    }
  }
}

// ---------------------------------------------------------------- bf16 body

constexpr int kTM = 128;             // output rows per block
constexpr int kTN = 192;             // output columns per block
constexpr int kTK = 64;              // depth of one ring stage
constexpr int kStages = 4;           // ring stages
constexpr int kGroups = 2;           // warpgroups, 64 rows each
constexpr int kMmaThreads = 128 * kGroups;
constexpr int kAElems = kTM * kTK;   // one x stage: 128 rows of 128 bytes
constexpr int kBElems = kTK * kTN;   // one w stage: 3 blocks of 64 x 64
constexpr int kOStride = kTN + 8;    // a row of the staged output tile
constexpr size_t kRingBytes =
    static_cast<size_t>(kStages) * (kAElems + kBElems) * sizeof(bf16);
constexpr size_t kMmaSmem = kRingBytes + 1024;  // + alignment slack
static_assert(kRingBytes == 163840, "the ring is 160 KB: one block per SM");
static_assert(kTM * kOStride <= kStages * (kAElems + kBElems),
              "the output tile is staged in the ring");
static_assert((kAElems * sizeof(bf16)) % 1024 == 0 &&
                  (kBElems * sizeof(bf16)) % 1024 == 0,
              "every tile starts on a 1024-byte swizzle atom");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by the threads (cp.async, stores) made visible to
// the tensor cores' reads, which go through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d (64 x 192 per warpgroup, f32) += a (64 x 16, K-major) . b (16 x 192,
// N-major), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's wgmma batches are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Where element (r, c) of a stage lands: the x tile as 128 rows of 128
// bytes (K-major, one 64-deep row each), the w tile as 3 blocks of 64
// k-rows x 64 columns (N-major); in both, 8 rows of 128 bytes make a
// 1024-byte swizzle atom whose 16-byte chunk c of row r lands at c ^ (r &
// 7): the layout wgmma's 128-byte swizzle mode reads.
__device__ __forceinline__ int a_off(int r, int c) {
  return r * kTK + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}
__device__ __forceinline__ int b_off(int r, int c) {
  const int cb = c & 63;
  return (c >> 6) * (kTK * 64) + r * 64 + (((cb >> 3) ^ (r & 7)) << 3) +
         (cb & 7);
}

// Fill one ring stage: the x tile rows m0.., depth k0.. and the w tile
// depth k0.., columns n0..; everything past m, n or k is zero. kVec: 16-byte
// cp.async copies (rows 16-byte aligned), else element copies.
template <bool kVec>
__device__ __forceinline__ void load_stage(bf16* a_s, bf16* b_s,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int m,
                                           int n, int k, int m0, int n0,
                                           int k0) {
  if constexpr (kVec) {
    constexpr int kAC = kTK / 8;  // 8 chunks per x row
    constexpr int kBC = kTN / 8;  // 24 chunks per w row
    for (int c = threadIdx.x; c < kTM * kAC; c += kMmaThreads) {
      const int r = c / kAC;
      const int ch = c - r * kAC;
      const bool live = m0 + r < m && k0 + ch * 8 < k;
      const bf16* src =
          live ? x + static_cast<size_t>(m0 + r) * k + k0 + ch * 8 : x;
      cp_async_16(a_s + a_off(r, ch * 8), src, live);
    }
    for (int c = threadIdx.x; c < kTK * kBC; c += kMmaThreads) {
      const int r = c / kBC;
      const int ch = c - r * kBC;
      const bool live = k0 + r < k && n0 + ch * 8 < n;
      const bf16* src =
          live ? w + static_cast<size_t>(k0 + r) * n + n0 + ch * 8 : w;
      cp_async_16(b_s + b_off(r, ch * 8), src, live);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < kTM * kTK; e += kMmaThreads) {
      const int r = e / kTK;
      const int c = e - r * kTK;
      a_s[a_off(r, c)] =
          m0 + r < m && k0 + c < k ? x[static_cast<size_t>(m0 + r) * k + k0 + c]
                                   : zero;
    }
    for (int e = threadIdx.x; e < kTK * kTN; e += kMmaThreads) {
      const int r = e / kTN;
      const int c = e - r * kTN;
      b_s[b_off(r, c)] =
          k0 + r < k && n0 + c < n ? w[static_cast<size_t>(k0 + r) * n + n0 + c]
                                   : zero;
    }
  }
}

// Block (n tile blockIdx.x, m tile blockIdx.y); warpgroup wg owns rows
// wg * 64 .. of the block's tile and all of its 192 columns.
template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads, 1)
    matmul_bias_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const bf16* __restrict__ b, bf16* __restrict__ out,
                           int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  bf16* ring = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  auto stage_a = [&](int st) { return ring + st * (kAElems + kBElems); };
  auto stage_b = [&](int st) {
    return ring + st * (kAElems + kBElems) + kAElems;
  };
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int n_kt = (k + kTK - 1) / kTK;

  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt)
      load_stage<kVec>(stage_a(st), stage_b(st), x, w, m, n, k, m0, n0,
                       st * kTK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();  // tile kt has landed
    const bf16* a_s = stage_a(kt % kStages) + wg * 64 * kTK;
    const bf16* b_s = stage_b(kt % kStages);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      // x: K-major, a 16-deep step is 32 bytes into each 128-byte row, the
      // 8-row atoms 1024 bytes apart; w: N-major, a 16-deep step is 16 rows
      // (2048 bytes) on, the 8-row atoms 1024 bytes apart in k and the
      // 64-column blocks 8192 bytes apart in n
      wgmma_192(acc, smem_desc(a_s + kk * 16, 16, 1024),
                smem_desc(b_s + kk * 16 * 64, kTK * 64 * 2, 1024));
    wgmma_commit();
    // tile kt's products run on while tile kt - 1's finish: then its
    // stage, the next one to fill, is free in both warpgroups
    wgmma_wait<1>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < n_kt)
      load_stage<kVec>(stage_a(nxt % kStages), stage_b(nxt % kStages), x, w,
                       m, n, k, m0, n0, nxt * kTK);
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it

  // epilogue: + bias in f32, one rounding, into the staged tile; thread
  // (warp, lane) holds rows 16 (warp % 4) + lane / 4 (+ 8) of its
  // warpgroup's 64 and columns 8 j + 2 (lane % 4), + 1, in acc[4 j ..]
  bf16* o_s = ring;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j) {
    const int c = j * 8 + c2;
    const float b0 = n0 + c < n ? __bfloat162float(b[n0 + c]) : 0.f;
    const float b1 = n0 + c + 1 < n ? __bfloat162float(b[n0 + c + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(o_s + (r0 + h * 8) * kOStride + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] + b0,
                                acc[4 * j + 2 * h + 1] + b1);
  }
  __syncthreads();
  if constexpr (kVec) {  // n % 8 == 0: a row's chunks are whole or past n
    constexpr int kOC = kTN / 8;
    for (int c = threadIdx.x; c < kTM * kOC; c += kMmaThreads) {
      const int r = c / kOC;
      const int col = (c - r * kOC) * 8;
      if (m0 + r < m && n0 + col < n)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * n +
                                  n0 + col) =
            *reinterpret_cast<const uint4*>(o_s + r * kOStride + col);
    }
  } else {
    for (int e = threadIdx.x; e < kTM * kTN; e += kMmaThreads) {
      const int r = e / kTN;
      const int col = e - r * kTN;
      if (m0 + r < m && n0 + col < n)
        out[static_cast<size_t>(m0 + r) * n + n0 + col] =
            o_s[r * kOStride + col];
    }
  }
}

template <bool kVec>
int run_mma(const void* x, const void* w, const void* b, void* out, int m,
            int n, int k, cudaStream_t stream) {
  auto kern = matmul_bias_mma_kernel<kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  kern<<<grid, kMmaThreads, kMmaSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

int run_fma(const void* x, const void* w, const void* b, void* out, int m,
            int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_bias_fma_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and out share it). Layouts are
// contiguous row-major: x (m, k), w (k, n), b (n,), out (m, n); m, n, k > 0.
// copy_bytes, the plan's copy width (ops/patch_embed.py _matmul_plan): 4
// for f32 (the FMA body); for bf16 16 (cp.async, which needs k and n
// multiples of 8 and x, w, out 16-byte aligned) or 2 (element copies).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan the shapes do not allow.
extern "C" int rt_matmul_bias(int dtype, const void* x, const void* w,
                              const void* b, void* out, int m, int n, int k,
                              int copy_bytes, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && copy_bytes == 4) return run_fma(x, w, b, out, m, n, k, st);
  if (dtype == 1 && copy_bytes == 16 && k % 8 == 0 && n % 8 == 0 &&
      aligned16(x) && aligned16(w) && aligned16(out))
    return run_mma<true>(x, w, b, out, m, n, k, st);
  if (dtype == 1 && copy_bytes == 2)
    return run_mma<false>(x, w, b, out, m, n, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
