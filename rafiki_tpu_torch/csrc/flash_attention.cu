// Flash attention forward and backward, for Hopper (sm_90a).
//
// Four kernels, one per Pallas kernel of the JAX package's
// rafiki_tpu/ops/attention.py:
//
//   flash_fwd_kernel      replaces _attn_fwd_kernel (B3): out and the row
//                         log-sum-exp for one (batch*head, query tile).
//   flash_fwd_mh_kernel   replaces _attn_fwd_mh_kernel (B4): B3's function
//                         for block_h consecutive heads of one example
//                         (one kv_len) per block.
//   flash_bwd_dq_kernel   replaces _attn_bwd_dq_kernel (B5): dQ for one
//                         (batch*head, query tile), streaming key tiles.
//   flash_bwd_dkv_kernel  replaces _attn_bwd_dkv_kernel (B6): dK and dV for
//                         one (batch*head, key tile), streaming query tiles.
//
// Semantics (the JAX kernels'): key j is masked from every row when
// j >= kv_len[b] and, causal, from row i when j > i; masked scores are
// -1e30; a row with no visible key writes zeros and LSE 1e30, so every
// gradient through it is exactly zero. delta = rowsum(dO * O) comes in
// precomputed (plain torch), as JAX computes it in XLA.
//
// What bounds them on this card: the work is 4*d operations per visible
// (query, key) pair forward, 6*d for dQ and 8*d for dK/dV. At
// chip_smoke.py's Llama shapes (b 4, 32 heads, s 1024, d 128, causal,
// kv_len 1024/700/1/0) that is ~190 (B3), ~220 (B5) and ~220 (B6)
// operations per byte the function must move (keys below kv_len and the
// rows that see a key read once, outputs written in full): below the
// H100's ~295 bf16 operations per byte, so the ideal bound is bytes. At
// ViT-B/16's (s 197, d 64, no mask) it is ~100 for B3/B4: bytes again.
// This f32-FMA design is far from either bound: its arithmetic runs on the
// CUDA cores at about a fifteenth of the bf16 tensor-core rate, so it
// takes tens of times its bound, and the operations it executes are what
// limit it in practice.
//
// What this design does about it, in its simple first form: one block of
// 256 threads walks the sequential TPU grid axis as a loop (key tiles for
// B3/B4/B5, query tiles for B6), so nothing carries between blocks and no
// atomics are needed (results are deterministic). Each 64-row tile of K and
// V (B3/B5) or of Q and dO (B6) is read from device memory once per block
// into shared memory, widened to f32, and serves all 64 rows of the block:
// each thread holds a 4 x 4 register tile of scores (rows ty + 16 i,
// columns tx + 16 j) fed by 128-bit shared-memory loads along the head dim,
// and a 4 x ceil(d/16) tile of the f32 accumulator. The online softmax
// (B3) and the p / ds terms (B5/B6) stay in registers; p or ds passes
// through shared memory once to feed the second product. All arithmetic is
// f32 FMA on the CUDA cores: tensor cores (mma / wgmma), TMA and a GQA-native
// K/V walk are later work.
//
// B4 runs B3's tile body once per head of its tile, in B3's order, so its
// output and LSE equal B3's bit for bit. On the TPU a head tile batches
// block_h heads into one program to amortize per-program overhead at short
// sequences; here it only makes the grid block_h times smaller and reads
// kv_len once, and whether that pays is what chip_smoke.py measures.
//
// Head dims: every d that the ViT, BERT and Llama templates give (8 .. 192,
// all multiples of 4, as the 128-bit loads need; tile_pv masks the columns
// of a d that is not a multiple of 16). Shared memory is f32 tiles with rows
// padded by 4 floats where a tile is read as the B operand of tile_dot
// (16 distinct rows per 8-thread phase, so the pad spreads them over the
// banks). A tile read only as the A operand needs no pad (its 8-thread
// phase reads one row: a broadcast), so B6 keeps its K and V tiles unpadded:
// at d = 192 that brings B6 to exactly the 227 KB (232,448 B) a block may
// take, where the padded plan needed 234,496 B. B3 takes 166 KB and B5
// 218 KB at d = 192.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;     // rafiki_tpu/ops/attention.py NEG_INF
constexpr float kLseMasked = 1e30f;   // LSE_MASKED
constexpr int kBQ = 64;               // query rows per tile
constexpr int kBK = 64;               // key rows per tile
constexpr int kThreads = 256;         // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kR = 4;                 // tile rows / columns per thread
constexpr int kPS = kBK + 1;          // padded row of a p / ds tile
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may take
static_assert(kBQ == kBK, "load_tile and the p / ds tiles take one size");

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

// max / sum over the 16 lanes that share a ty (one half of the warp)
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [row0, row0 + 64) of a (rows, D) slab into shared memory as f32
// with row stride `stride` floats, times `mul`; rows at or past n_rows are
// zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * stride + d] =
        row < n_rows ? to_f32<T>(src[static_cast<size_t>(row) * D + d]) * mul
                     : 0.f;
  }
}

// acc[i][j] += a_i . b_j over D, for the thread's rows a = A[ty + 16 i] and
// b = B[tx + 16 j] of two shared-memory tiles: A with row stride AS, B
// padded (row stride D + 4).
template <int D, int AS = D + 4>
__device__ __forceinline__ void tile_dot(float (&acc)[kR][kR],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int DP = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[kR], b[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * AS + d);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][c] += sum_k P[ty + 16 i][k] * V[k][tx + 16 c] over a 64-long k,
// P with row stride kPS, V with row stride vs.
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[kR][(D + 15) / 16],
                                        const float* P, const float* V,
                                        int vs, int ty, int tx) {
  constexpr int CD = (D + 15) / 16;
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float p[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) p[i] = P[(ty + 16 * i) * kPS + kk];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) {
        const float vv = V[kk * vs + col];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
}

template <int D>
struct Smem {
  static constexpr int DP = D + 4;
  // forward: q, k (padded), v, p
  static constexpr size_t fwd =
      (2 * kBQ * DP + kBK * D + kBQ * kPS) * sizeof(float);
  // dq: q, dO, k, v (padded), ds, lse, delta
  static constexpr size_t dq =
      (4 * kBQ * DP + kBQ * kPS + 2 * kBQ) * sizeof(float);
  // dkv: k, v (unpadded: A operands only), q, dO (padded), p^T, ds^T,
  // lse, delta
  static constexpr size_t dkv =
      (2 * kBK * D + 2 * kBQ * DP + 2 * kBK * kPS + 2 * kBQ) * sizeof(float);
  static_assert(fwd <= kMaxSmem && dq <= kMaxSmem && dkv <= kMaxSmem,
                "a tile plan exceeds the shared memory of one block");
};

struct Geom {
  int h, s_q, s_kv, causal;
  float scale;
};

// ---------------------------------------------------------------- B3, B4
// One (bh, query tile) of the forward: rows [q0, q0 + 64) of head bh over
// the keys below kv_len. Layouts: q/out (b*h, s_q, D); k/v (b*h, s_kv, D);
// lse (b*h, s_q) f32 or null.
template <typename T, int D>
__device__ __forceinline__ void fwd_tile(const T* __restrict__ q,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         int kv_len, T* __restrict__ out,
                                         float* __restrict__ lse, int bh,
                                         int q0, const Geom& g,
                                         float* smem) {
  constexpr int DP = D + 4;
  constexpr int CD = (D + 15) / 16;
  float* q_s = smem;                             // [BQ][DP], pre-scaled
  float* k_s = q_s + kBQ * DP;                   // [BK][DP]
  float* v_s = k_s + kBK * DP;                   // [BK][D]
  float* p_s = v_s + kBK * D;                    // [BQ][kPS]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* qb = q + static_cast<size_t>(bh) * g.s_q * D;
  const T* kb = k + static_cast<size_t>(bh) * g.s_kv * D;
  const T* vb = v + static_cast<size_t>(bh) * g.s_kv * D;

  load_tile<T, D>(q_s, DP, qb, q0, g.s_q, g.scale);

  float m[kR], l[kR], acc[kR][CD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // key tiles past kv_len, and (causal) past this tile's last row, are
  // fully masked: skip them
  int kv_end = kv_len;
  if (g.causal) kv_end = min(kv_end, q0 + kBQ);
  const int n_kt = (kv_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D>(k_s, DP, kb, k0, g.s_kv, 1.f);
    load_tile<T, D>(v_s, D, vb, k0, g.s_kv, 1.f);
    __syncthreads();

    float s[kR][kR] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool vis = k_pos < kv_len && (!g.causal || k_pos <= q_pos);
        s[i][j] = vis ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<D>(acc, p_s, v_s, D, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.s_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(bh) * g.s_q + row) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) o[col] = from_f32<T>(acc[i][c] * inv);
    }
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * g.s_q + row] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kLseMasked;
  }
}

// B3: block (bh = blockIdx.x, query tile blockIdx.y).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ out, float* __restrict__ lse, Geom g) {
  extern __shared__ float4 smem4[];
  const int bh = blockIdx.x;
  fwd_tile<T, D>(q, k, v, lens[bh / g.h], out, lse, bh, blockIdx.y * kBQ, g,
                 reinterpret_cast<float*>(smem4));
}

// B4: block (head tile blockIdx.x, query tile blockIdx.y) runs heads
// [blockIdx.x * block_h, + block_h), all of one example (h % block_h == 0),
// one after another through B3's tile body.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mh_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ out, float* __restrict__ lse,
                        int block_h, Geom g) {
  extern __shared__ float4 smem4[];
  const int bh0 = blockIdx.x * block_h;
  const int kv_len = lens[bh0 / g.h];  // the whole tile is one example
  for (int j = 0; j < block_h; ++j) {
    if (j > 0) __syncthreads();  // the previous head's tiles are consumed
    fwd_tile<T, D>(q, k, v, kv_len, out, lse, bh0 + j, blockIdx.y * kBQ, g,
                   reinterpret_cast<float*>(smem4));
  }
}

// Rows [q0, q0 + 64) of lse and delta into shared memory; rows past s_q
// get LSE_MASKED (p = 0) and delta 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, size_t base,
                                          int q0, int s_q) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < s_q;
    lse_s[r] = in ? lse[base + q0 + r] : kLseMasked;
    delta_s[r] = in ? delta[base + q0 + r] : 0.f;
  }
}

// ---------------------------------------------------------------- B5
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ lens, T* __restrict__ dq,
                        Geom g) {
  constexpr int DP = D + 4;
  constexpr int CD = (D + 15) / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* do_s = q_s + kBQ * DP;                  // [BQ][DP]
  float* k_s = do_s + kBQ * DP;                  // [BK][DP]
  float* v_s = k_s + kBK * DP;                   // [BK][DP]
  float* ds_s = v_s + kBK * DP;                  // [BQ][kPS]
  float* lse_s = ds_s + kBQ * kPS;               // [BQ]
  float* delta_s = lse_s + kBQ;                  // [BQ]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_len = lens[bh / g.h];
  const size_t qbase = static_cast<size_t>(bh) * g.s_q;
  const T* kb = k + static_cast<size_t>(bh) * g.s_kv * D;
  const T* vb = v + static_cast<size_t>(bh) * g.s_kv * D;

  load_tile<T, D>(q_s, DP, q + qbase * D, q0, g.s_q, 1.f);
  load_tile<T, D>(do_s, DP, dout + qbase * D, q0, g.s_q, 1.f);
  load_rows(lse_s, delta_s, lse, delta, qbase, q0, g.s_q);

  float acc[kR][CD];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  int kv_end = kv_len;
  if (g.causal) kv_end = min(kv_end, q0 + kBQ);
  const int n_kt = (kv_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, D>(k_s, DP, kb, k0, g.s_kv, 1.f);
    load_tile<T, D>(v_s, DP, vb, k0, g.s_kv, 1.f);
    __syncthreads();

    float s[kR][kR] = {};
    float dp[kR][kR] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool vis = k_pos < kv_len && (!g.causal || k_pos <= q_pos);
        const float p = vis ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
        ds_s[r * kPS + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * g.scale;
      }
    }
    __syncthreads();
    tile_pv<D>(acc, ds_s, k_s, DP, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.s_q) continue;
    T* o = dq + (qbase + row) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) o[col] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------- B6
// Block (bh = blockIdx.x, key tile blockIdx.y). Thread rows are keys
// (ty + 16 i), thread columns queries (tx + 16 j) in the score tile and
// head-dim columns (tx + 16 c) in dK / dV.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ lens, T* __restrict__ dk,
                         T* __restrict__ dv, Geom g) {
  constexpr int DP = D + 4;
  constexpr int CD = (D + 15) / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* v_s = k_s + kBK * D;                    // [BK][D]
  float* q_s = v_s + kBK * D;                    // [BQ][DP]
  float* do_s = q_s + kBQ * DP;                  // [BQ][DP]
  float* pt_s = do_s + kBQ * DP;                 // [BK][kPS]  p^T
  float* dst_s = pt_s + kBK * kPS;               // [BK][kPS]  ds^T
  float* lse_s = dst_s + kBK * kPS;              // [BQ]
  float* delta_s = lse_s + kBQ;                  // [BQ]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_len = lens[bh / g.h];
  const size_t qbase = static_cast<size_t>(bh) * g.s_q;
  const size_t kbase = static_cast<size_t>(bh) * g.s_kv;

  float adk[kR][CD], adv[kR][CD];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) adk[i][c] = adv[i][c] = 0.f;

  // a key tile wholly past kv_len sees no query: its loop is skipped and
  // it writes zeros
  if (k0 < kv_len) {
    load_tile<T, D>(k_s, D, k + kbase * D, k0, g.s_kv, 1.f);
    load_tile<T, D>(v_s, D, v + kbase * D, k0, g.s_kv, 1.f);
    // causal: the first query row that sees key k0 is row k0
    const int qt0 = g.causal ? k0 / kBQ : 0;
    const int n_qt = (g.s_q + kBQ - 1) / kBQ;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();
      load_tile<T, D>(q_s, DP, q + qbase * D, q0, g.s_q, 1.f);
      load_tile<T, D>(do_s, DP, dout + qbase * D, q0, g.s_q, 1.f);
      load_rows(lse_s, delta_s, lse, delta, qbase, q0, g.s_q);
      __syncthreads();

      float s[kR][kR] = {};
      float dp[kR][kR] = {};
      tile_dot<D, D>(s, k_s, q_s, ty, tx);    // s^T[key][query]
      tile_dot<D, D>(dp, v_s, do_s, ty, tx);  // dp^T[key][query]
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kr = ty + 16 * i;
        const int k_pos = k0 + kr;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int qc = tx + 16 * j;
          const int q_pos = q0 + qc;
          const bool vis = k_pos < kv_len && q_pos < g.s_q &&
                           (!g.causal || k_pos <= q_pos);
          const float p = vis ? expf(s[i][j] * g.scale - lse_s[qc]) : 0.f;
          pt_s[kr * kPS + qc] = p;
          dst_s[kr * kPS + qc] = p * (dp[i][j] - delta_s[qc]) * g.scale;
        }
      }
      __syncthreads();
      tile_pv<D>(adv, pt_s, do_s, DP, ty, tx);
      tile_pv<D>(adk, dst_s, q_s, DP, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= g.s_kv) continue;
    T* ok = dk + (kbase + row) * D;
    T* ov = dv + (kbase + row) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) {
        ok[col] = from_f32<T>(adk[i][c]);
        ov[col] = from_f32<T>(adv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

// Above 48 KB, dynamic shared memory must be asked for per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Ptrs {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  const int* lens;
  void *out, *lse_out, *dk, *dv;
  int block_h;  // B4's heads per block
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kFwdMh = 3 };

template <typename T, int D>
int run(Which which, int bh, const Geom& g, const Ptrs& p,
        cudaStream_t stream) {
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const float* lse = static_cast<const float*>(p.lse_in);
  const float* delta = static_cast<const float*>(p.delta);
  const dim3 block(kThreads);
  const int n_qt = (g.s_q + kBQ - 1) / kBQ;
  cudaError_t err;
  if (which == kFwd) {
    auto kern = flash_fwd_kernel<T, D>;
    if ((err = allow_smem(kern, Smem<D>::fwd)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<dim3(bh, n_qt), block, Smem<D>::fwd, stream>>>(
        q, k, v, p.lens, static_cast<T*>(p.out),
        static_cast<float*>(p.lse_out), g);
  } else if (which == kFwdMh) {
    auto kern = flash_fwd_mh_kernel<T, D>;
    if ((err = allow_smem(kern, Smem<D>::fwd)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<dim3(bh / p.block_h, n_qt), block, Smem<D>::fwd, stream>>>(
        q, k, v, p.lens, static_cast<T*>(p.out),
        static_cast<float*>(p.lse_out), p.block_h, g);
  } else if (which == kDq) {
    auto kern = flash_bwd_dq_kernel<T, D>;
    if ((err = allow_smem(kern, Smem<D>::dq)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<dim3(bh, n_qt), block, Smem<D>::dq, stream>>>(
        q, k, v, dout, lse, delta, p.lens, static_cast<T*>(p.out), g);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, D>;
    if ((err = allow_smem(kern, Smem<D>::dkv)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<dim3(bh, (g.s_kv + kBK - 1) / kBK), block, Smem<D>::dkv,
           stream>>>(q, k, v, dout, lse, delta, p.lens,
                     static_cast<T*>(p.dk), static_cast<T*>(p.dv), g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(Which which, int d, int bh, const Geom& g, const Ptrs& p,
           cudaStream_t stream) {
  switch (d) {
    case 8: return run<T, 8>(which, bh, g, p, stream);
    case 12: return run<T, 12>(which, bh, g, p, stream);
    case 16: return run<T, 16>(which, bh, g, p, stream);
    case 24: return run<T, 24>(which, bh, g, p, stream);
    case 32: return run<T, 32>(which, bh, g, p, stream);
    case 48: return run<T, 48>(which, bh, g, p, stream);
    case 64: return run<T, 64>(which, bh, g, p, stream);
    case 96: return run<T, 96>(which, bh, g, p, stream);
    case 128: return run<T, 128>(which, bh, g, p, stream);
    case 192: return run<T, 192>(which, bh, g, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(Which which, int dtype, int d, int b, int h, const Geom& g,
             const Ptrs& p, void* stream) {
  if (b <= 0 || h <= 0 || g.s_q <= 0 || g.s_kv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (which == kFwdMh && (p.block_h < 1 || h % p.block_h != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(which, d, b * h, g, p, st);
  if (dtype == 1) return by_dim<__nv_bfloat16>(which, d, b * h, g, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share it;
// lse and delta are f32). d: the head dim, one of 8, 12, 16, 24, 32, 48,
// 64, 96, 128, 192.
// Layouts are contiguous: q/out/dO/dq (b*h, s_q, d), k/v/dk/dv
// (b*h, s_kv, d), lse/delta (b*h, s_q), kv_lens (b,) int32 in [0, s_kv].
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int rt_flash_fwd(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* kv_lens, void* out,
                            void* lse, int b, int h, int s_q, int s_kv,
                            int causal, float sm_scale, void* stream) {
  Ptrs p{q, k, v, nullptr, nullptr, nullptr,
         static_cast<const int*>(kv_lens), out, lse, nullptr, nullptr, 1};
  return dispatch(kFwd, dtype, d, b, h, Geom{h, s_q, s_kv, causal, sm_scale},
                  p, stream);
}

// B4: rt_flash_fwd's function, block_h heads per block (block_h >= 1 and
// dividing h, else cudaErrorInvalidValue).
extern "C" int rt_flash_fwd_mh(int dtype, int d, const void* q,
                               const void* k, const void* v,
                               const void* kv_lens, void* out, void* lse,
                               int b, int h, int s_q, int s_kv, int causal,
                               float sm_scale, int block_h, void* stream) {
  Ptrs p{q, k, v, nullptr, nullptr, nullptr,
         static_cast<const int*>(kv_lens), out, lse, nullptr, nullptr,
         block_h};
  return dispatch(kFwdMh, dtype, d, b, h,
                  Geom{h, s_q, s_kv, causal, sm_scale}, p, stream);
}

extern "C" int rt_flash_bwd_dq(int dtype, int d, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* lse, const void* delta,
                               const void* kv_lens, void* dq, int b, int h,
                               int s_q, int s_kv, int causal, float sm_scale,
                               void* stream) {
  Ptrs p{q, k, v, dout, lse, delta, static_cast<const int*>(kv_lens),
         dq, nullptr, nullptr, nullptr, 1};
  return dispatch(kDq, dtype, d, b, h, Geom{h, s_q, s_kv, causal, sm_scale},
                  p, stream);
}

extern "C" int rt_flash_bwd_dkv(int dtype, int d, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* kv_lens,
                                void* dk, void* dv, int b, int h, int s_q,
                                int s_kv, int causal, float sm_scale,
                                void* stream) {
  Ptrs p{q, k, v, dout, lse, delta, static_cast<const int*>(kv_lens),
         nullptr, nullptr, dk, dv, 1};
  return dispatch(kDkv, dtype, d, b, h, Geom{h, s_q, s_kv, causal, sm_scale},
                  p, stream);
}
