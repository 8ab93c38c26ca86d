// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Two kernels, one per Pallas kernel of the JAX package:
//
//   paged_decode_kernel  replaces rafiki_tpu/ops/paged_attention.py
//                        _paged_decode_kernel (wrapper paged_decode_attention):
//                        one query token per slot, the generation hot loop.
//   paged_window_kernel  replaces rafiki_tpu/ops/paged_attention.py
//                        _paged_window_kernel (wrapper paged_window_attention):
//                        an s >= 1 window of query tokens per slot with a
//                        per-row causal horizon (chunked prefill).
//
// Both run the same block body (attend_tile below), so a window of length 1
// computes bit for bit what the decode kernel computes.
//
// What bounds them: memory. Per call the least traffic is the live K/V bytes
// (live tokens x kv heads x head_dim x 2 x element size) plus q and out; the
// arithmetic is 4 x rows x live tokens x head_dim per kv head, a few
// operations per byte for decode (rep = 4 query rows per kv head) and about
// 128 per byte for a 32-token window, both below the card's ratio of ~295.
//
// What the design does about it: one block per (kv head, slot, query tile)
// walks the slot's live pages 0 .. t_last / page_size in a loop inside the
// block (a TPU grid carries its running softmax state across sequential grid
// steps; CUDA blocks run in no order, so the page walk is a loop here). Each
// page's K and V rows are read from device memory once into shared memory and
// shared by every query row of the block: the rep grouped query heads of the
// kv head (GQA) times the tile's block_q window tokens. Dead pages (at or past
// the live count) are never read; the block reads its own page ids from the
// table (no scalar prefetch on this card). Scores, the running max/sum and
// the weighted-V accumulator stay in f32 (registers and shared memory); bf16
// pools are widened on load and the output is rounded once to q's dtype.
//
// This is the simple first version: f32 FMA, one page in shared memory at a
// time, no TMA, no wgmma, no split over pages (flash-decoding). Those are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // rafiki_tpu/ops/attention.py NEG_INF
constexpr int kMaxWarps = 8;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Geometry {
  int s;          // window length (1 for the decode kernel)
  int n_heads;    // query heads
  int n_kv;       // kv heads
  int dh;         // head dim
  int page_size;  // tokens per pool page
  int n_tables;   // table columns (may be a live-width slice)
  int rep;        // n_heads / n_kv
  int block_q;    // window tokens per block
  float sm_scale;
};

// Shared memory, in floats, for a block of block_q * rep query rows.
inline size_t smem_floats(const Geometry& g, int n_warps) {
  const size_t rows = static_cast<size_t>(g.block_q) * g.rep;
  return 2 * rows * g.dh                              // q (scaled), acc
         + 2 * rows                                   // running max, sum
         + static_cast<size_t>(g.page_size) * (g.dh + 1)  // K page (padded)
         + static_cast<size_t>(g.page_size) * g.dh        // V page
         + static_cast<size_t>(n_warps) * g.page_size;    // per-warp probs
}

// One block: kv head blockIdx.x, slot blockIdx.y, query tile blockIdx.z.
// Row r of the tile is window token q0 + r / rep at query head
// kh * rep + r % rep. Layouts: q/out (b, s, n_heads, dh); pools
// (n_pages, page_size, n_kv, dh); tables (b, n_tables); positions (b, s).
template <typename T>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out,
    const Geometry g) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * g.block_q;
  const int nq = min(g.block_q, g.s - q0);
  const int rows = nq * g.rep;
  const int rows_cap = g.block_q * g.rep;
  const int D = g.dh;
  const int P = g.page_size;
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float* q_s = smem;                      // [rows][D], pre-scaled
  float* acc_s = q_s + rows_cap * D;      // [rows][D]
  float* m_s = acc_s + rows_cap * D;      // [rows]
  float* l_s = m_s + rows_cap;            // [rows]
  float* k_s = l_s + rows_cap;            // [P][D + 1], padded: no bank
                                          // conflicts across keys
  float* v_s = k_s + P * (D + 1);         // [P][D]
  float* p_s = v_s + P * D;               // [n_warps][P]

  const int* pos_b = positions + static_cast<size_t>(b) * g.s;
  auto row_offset = [&](int r) {
    const int tok = q0 + r / g.rep;
    const int head = kh * g.rep + r % g.rep;
    return (static_cast<size_t>(b) * g.s + tok) * g.n_heads * D +
           static_cast<size_t>(head) * D;
  };

  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    q_s[idx] = to_f32<T>(q[row_offset(r) + d]) * g.sm_scale;
    acc_s[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // positions are nondecreasing along the window, so the tile's last row
  // bounds its live pages; the walk also ends at the table's last column,
  // as the TPU grid's n_tables page steps do
  const int t_last = pos_b[q0 + nq - 1];
  const int n_live = min(t_last / P + 1, g.n_tables);
  const int* table = tables + static_cast<size_t>(b) * g.n_tables;

  for (int pg = 0; pg < n_live; ++pg) {
    __syncthreads();  // the previous page is consumed (and q/acc are set)
    const size_t page = static_cast<size_t>(table[pg]);
    for (int idx = threadIdx.x; idx < P * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx - j * D;
      const size_t off = ((page * P + j) * g.n_kv + kh) * D + d;
      k_s[j * (D + 1) + d] = to_f32<T>(k_pool[off]);
      v_s[j * D + d] = to_f32<T>(v_pool[off]);
    }
    __syncthreads();

    float* pw = p_s + warp * P;
    for (int r = warp; r < rows; r += n_warps) {
      const int t_r = pos_b[q0 + r / g.rep];
      const float* qr = q_s + r * D;
      float m_loc = kNegInf;
      for (int j = lane; j < P; j += 32) {
        const float* kj = k_s + j * (D + 1);
        float sc = 0.f;
        for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kj[d], sc);
        if (pg * P + j > t_r) sc = kNegInf;  // k_pos <= t: the causal mask
        pw[j] = sc;
        m_loc = fmaxf(m_loc, sc);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(m_loc));
      float l_loc = 0.f;
      for (int j = lane; j < P; j += 32) {
        const float p = expf(pw[j] - m_new);
        pw[j] = p;
        l_loc += p;
      }
      const float l_page = warp_sum(l_loc);
      __syncwarp();
      const float alpha = expf(m_prev - m_new);
      for (int d = lane; d < D; d += 32) {
        float a = acc_s[r * D + d] * alpha;
        for (int j = 0; j < P; ++j) a = fmaf(pw[j], v_s[j * D + d], a);
        acc_s[r * D + d] = a;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + l_page;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // position 0 is always live, so l > 0 on every row
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    out[row_offset(r) + d] =
        from_f32<T>(acc_s[idx] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_decode_kernel(const T* q, const T* k_pool, const T* v_pool,
                        const int* tables, const int* positions, T* out,
                        Geometry g) {
  attend_tile<T>(q, k_pool, v_pool, tables, positions, out, g);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_window_kernel(const T* q, const T* k_pool, const T* v_pool,
                        const int* tables, const int* positions, T* out,
                        Geometry g) {
  attend_tile<T>(q, k_pool, v_pool, tables, positions, out, g);
}

template <typename T>
int launch(bool window, int batch, const Geometry& g, const void* q,
           const void* k_pool, const void* v_pool, const int* tables,
           const int* positions, void* out, cudaStream_t stream) {
  const int rows_cap = g.block_q * g.rep;
  const int n_warps = rows_cap < kMaxWarps ? rows_cap : kMaxWarps;
  const size_t smem = smem_floats(g, n_warps) * sizeof(float);
  const dim3 grid(g.n_kv, batch, (g.s + g.block_q - 1) / g.block_q);
  const dim3 block(32 * n_warps);
  auto kernel = window ? paged_window_kernel<T> : paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, positions, static_cast<T*>(out),
      g);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool window, int dtype, int batch, const Geometry& g,
             const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* positions, void* out,
             void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(window, batch, g, q, k_pool, v_pool, tab, pos, out,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(window, batch, g, q, k_pool, v_pool, tab,
                                 pos, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rt_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, int batch,
    int n_heads, int n_kv, int dh, int page_size, int n_tables,
    float sm_scale, void* stream) {
  const Geometry g{1, n_heads, n_kv, dh, page_size, n_tables,
                   n_heads / n_kv, 1, sm_scale};
  return dispatch(false, dtype, batch, g, q, k_pool, v_pool, tables,
                  positions, out, stream);
}

extern "C" int rt_paged_window_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, int batch, int s,
    int n_heads, int n_kv, int dh, int page_size, int n_tables, int block_q,
    float sm_scale, void* stream) {
  const Geometry g{s, n_heads, n_kv, dh, page_size, n_tables,
                   n_heads / n_kv, block_q, sm_scale};
  return dispatch(true, dtype, batch, g, q, k_pool, v_pool, tables,
                  positions, out, stream);
}
