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
// ViT-B/16's (s 197, d 64, no mask) it is ~100 for B3/B4: bytes again. A
// block reads each K/V tile once per 64-row query tile, so the bytes that
// reach the SMs are s / 64 times the bound's; the grid runs a head's query
// tiles together, so the L2 serves the repeats.
//
// The bf16 forward (fwd_heads_wgmma; B3 and B4 share it) runs on the
// tensor cores as Hopper's warpgroup products (wgmma):
//
// - One warpgroup (4 warps) per 64-row query tile. Q, and 64-key K and V
//   tiles in a ring of 3 stages (2 above d = 64), arrive by cp.async in the
//   layout wgmma's 128-byte swizzle reads: 64-column blocks of 128-byte
//   rows, 8 rows to a 1024-byte atom whose 16-byte chunk c of row r sits
//   at c ^ (r & 7). The head dim is padded with zero columns to whole
//   blocks (8 .. 48 to 64, 96 to 128; the templates' main paths, 64 and
//   128, need none), written once per block: cp.async never touches them.
//   Copies are 16 bytes, or 8 where a row is not whole 16-byte chunks
//   (d = 12: 24 bytes); a row past s_q or s_kv is zero-filled (src-size 0).
// - S = Q.K^T is one wgmma m64n64k16 per 16 of the padded head dim, both
//   operands K-major from shared memory, into 32 f32 registers a thread.
//   The scale goes onto the f32 scores, as the plain version applies it
//   after the product: folded into log2(e), inside exp2's argument as one
//   fused multiply-add. Only a tile that crosses kv_len or a warp's causal
//   diagonal is masked (-1e30).
// - The online softmax stays in registers: each thread holds 2 rows x 16
//   keys of a tile, quad shuffles give the rows' max and sum. The
//   roundings are spelled out (__fmul_rn, __fmaf_rn): left to the compiler,
//   B3's and B4's kernels contract them differently.
// - O += P.V is wgmma m64n{64,128,192}k16 with P from registers as the A
//   operand (its fragment layout is the score's) and V N-major (the
//   transpose bit), P as two bf16 terms hi + lo: one bf16 rounding of P
//   errs by up to 2^-9 of a weight, above the per-element tolerance 1e-3 +
//   2^-8 |out| on a few-key row whose output is near 0 (ops/attention.py
//   _flash_mma_reference models both and the CPU tests show the one-term
//   form failing); the pair costs one more product per step.
// - No atomics and no cross-block state: two calls give the same bits.
//
// What limits it (A/B runs on an H100 80GB HBM3 at 700 W, PERF.md): at
// ViT-B/16's shape neither the tensor cores nor shared memory: a third
// fewer products, or half the shared-memory reads per product, moved it by
// a few percent at most. What is left is each warp's serial chain per
// 64-key tile: S products, wait, softmax on the CUDA cores, P.V products,
// wait, with few warps an SM and a short key loop (197 keys: 4 tiles) to
// hide it in. Overlapping one warpgroup's softmax with another's products
// (two consumer warpgroups, TMA loads from a producer warp) is the next
// step.
//
// B4 runs the same body for block_h heads of one example per block, the
// heads in order, each (head, query tile) with the same instructions in the
// same key order as B3's block, so its output and LSE equal B3's bit for
// bit. The ring runs on across the heads, so the next head's first tiles
// load while this head's last tile computes; it reads kv_len once; a
// later head's Q is loaded after the block drains its copies.
// chip_smoke.py times B4 beside B3 in the same call: on an H100 at
// ViT-B/16's shape it buys little or nothing (PERF.md), since B3's grid of
// block_h times as many blocks fills the SMs as well. B4 stays as the port
// of the JAX kernel and of the block_h knob that selects it.
//
// The bf16 backward (bwd_dq_wgmma, bwd_dkv_wgmma) runs on the same
// machinery, one warpgroup per block:
//
// - B5: a 64-row query tile; Q, dO and the rows' lse and delta stay
//   resident, 64-key K/V tiles stream through the cp.async ring. Per tile,
//   S = Q.K^T and dP = dO.V^T (wgmma, K-major operands), P = exp2(S scale
//   log2 e - lse log2 e) as one fused argument and dS = P (dP - delta)
//   scale in registers, then dQ += dS.K with dS as register A operands and
//   K N-major: the forward's P.V step.
// - B6: a 64-key tile; K and V stay resident, 64-row Q/dO tiles and their
//   lse/delta rows stream through the ring. Per tile, transposed with the
//   keys as M: S^T = K.Q^T, dP^T = V.dO^T, P^T and dS^T in registers (lse
//   and delta index the columns), dV += P^T.dO and dK += dS^T.Q. Causal
//   tiles start at the query tile of k0; a key tile wholly past kv_len
//   writes zeros. Above d = 128 B6 keeps the FMA body below: dK's and dV's
//   accumulators alone (96 f32 registers each a thread at d = 192) leave
//   no room for S^T and dP^T in 255 registers.
// - P and dS each enter their products as two bf16 terms hi + lo: one
//   rounding fails the per-element tolerance 1e-3 + 2^-8 |plain| by 1.3-
//   4.7x on plain random inputs at every head dim (ops/attention.py
//   _flash_bwd_mma_reference models both; the CPU tests hold the choice).
// - Only tiles that cross kv_len, s_q (B6) or a warp's causal diagonal are
//   masked. A head's tiles run on consecutive blocks, so its repeated K/V
//   (B5) or Q/dO (B6) reads hit L2; B5's causal tiles run longest first.
// - No atomics and no cross-block state: two calls give the same bits.
//
// The f32 kernels (the exactness legs; TF32 would break their tolerance)
// keep the first design: one block of 256 threads walks the sequential TPU
// grid axis as a loop (key tiles for B3/B4/B5, query tiles for B6), so
// nothing carries between blocks and no atomics are needed. Each 64-row
// tile of K and V (B3/B5) or of Q and dO (B6) is read into shared memory,
// widened to f32, and serves all 64 rows of the block: each thread holds a
// 4 x 4 register tile of scores (rows ty + 16 i, columns tx + 16 j) fed by
// 128-bit shared-memory loads along the head dim, and a 4 x ceil(d/16) tile
// of the f32 accumulator; p or ds passes through shared memory once to feed
// the second product. bf16 B6 at d = 192 runs this body too.
//
// Head dims: every d that the ViT, BERT and Llama templates give (8 .. 192,
// all multiples of 4, as the 128-bit loads need; tile_pv masks the columns
// of a d that is not a multiple of 16). The f32 tiles pad rows by 4 floats
// where a tile is read as the B operand of tile_dot (16 distinct rows per
// 8-thread phase, so the pad spreads them over the banks). A tile read only
// as the A operand needs no pad (its 8-thread phase reads one row: a
// broadcast), so B6 keeps its K and V tiles unpadded: at d = 192 that
// brings B6 to exactly the 227 KB (232,448 B) a block may take, where the
// padded plan needed 234,496 B. B5 takes 218 KB at d = 192; the bf16
// forward 121 KB, the bf16 B5 145 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------- bf16 B3, B4
using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMmaWarps = 4;  // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) global -> shared, or as many zero bytes when !live
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(live ? 16 : 0)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(live ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(live ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two f32 values as two bf16 pairs, hi + lo (.x is the low half of each
// word): together they carry each value to about 2^-17 of itself, where
// one bf16 alone errs by up to 2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __bfloat162float(h.x),
                                                 x1 - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// S (64 x 64, f32) += Q (64 x 16, K-major) . K^T (K-major), both in
// shared memory.
__device__ __forceinline__ void wgmma_s64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// O (64 x DP, f32) += P (64 x 16, bf16 registers) . V (16 x DP, N-major
// in shared memory), DP = 64, 128 or 192.
__device__ __forceinline__ void wgmma_o64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_o128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_o192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
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
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// The forward's plan for head dim D (ops/attention.py _flash_plan mirrors
// it; rt_flash_fwd_plan reports it): Q, K and V tiles of 64 rows, the head
// dim padded with zero columns to whole 64-column blocks of 128-byte rows
// (DP), 16-byte copies (8-byte where a row is not whole 16-byte chunks:
// d = 12), a ring of 3 K/V stages (2 above d = 64); + 1024 bytes to align
// the swizzle atoms.
template <int D>
struct WgFwd {
  static constexpr int kDP = (D + 63) / 64 * 64;
  static constexpr int kCopy = (2 * D) % 16 == 0 ? 16 : 8;
  static constexpr int kCopyElems = kCopy / 2;
  static constexpr int kTileElems = kBK * kDP;
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr size_t kSmem =
      static_cast<size_t>(1 + 2 * kStages) * kTileElems * sizeof(bf16) + 1024;
  static_assert(D % kCopyElems == 0, "rows of whole copies");
  static_assert(kSmem <= kMaxSmem, "the ring exceeds a block's memory");
};

// Where element (row r, column c) of a 64-row tile lands: 64-column blocks
// of 128-byte rows, 8 rows to a 1024-byte atom whose 16-byte chunk ch of
// row r sits at ch ^ (r & 7), the layout wgmma's 128-byte swizzle reads.
__device__ __forceinline__ int wg_off(int r, int c) {
  const int cb = c & 63;
  return (c >> 6) * (kBK * 64) + r * 64 + (((cb >> 3) ^ (r & 7)) << 3) +
         (cb & 7);
}

// Issue the cp.async copies of rows [r0, r0 + 64) of one head's (rows, D)
// slab into a tile; rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void wg_load(bf16* dst,
                                        const bf16* __restrict__ src, int r0,
                                        int n_rows) {
  using C = WgFwd<D>;
  constexpr int kCopies = D / C::kCopyElems;  // per row
  for (int c = threadIdx.x; c < kBK * kCopies; c += kMmaThreads) {
    const int row = c / kCopies;
    const int e = (c - row * kCopies) * C::kCopyElems;
    const bool live = r0 + row < n_rows;
    const size_t off = live ? static_cast<size_t>(r0 + row) * D + e : 0;
    cp_async<C::kCopy>(dst + wg_off(row, e), src + off, live);
  }
}

// Zero the padded head-dim columns [D, kDP) of n consecutive 64-row tiles
// from base, once per block: cp.async never writes them, and the block's
// first fence and barrier publish them to the tensor cores.
template <int D>
__device__ __forceinline__ void wg_zero_pad(bf16* base, int n_tiles) {
  using C = WgFwd<D>;
  if constexpr (C::kDP > D) {
    constexpr int kPad = C::kDP - D;
    for (int i = threadIdx.x; i < n_tiles * kBK * kPad; i += kMmaThreads) {
      const int row = i / kPad;  // over every tile's rows
      base[(row / kBK) * C::kTileElems +
           wg_off(row % kBK, D + (i - row * kPad))] = __float2bfloat16(0.f);
    }
  }
}

// The first 1024-aligned byte of a block's dynamic shared memory (the
// swizzle atoms need that alignment; the plans add 1024 bytes for it).
__device__ __forceinline__ bf16* wg_base(unsigned char* smem_raw) {
  return reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
}

// O (64 x DP, f32) += A (64 x 16, bf16 registers) . B (16 x DP, N-major in
// shared memory).
template <int DP>
__device__ __forceinline__ void wgmma_o(float (&d)[DP / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  if constexpr (DP == 64)
    wgmma_o64(d, a, desc_b);
  else if constexpr (DP == 128)
    wgmma_o128(d, a, desc_b);
  else
    wgmma_o192(d, a, desc_b);
}

// One warpgroup's 64 query rows of one head: the f32 accumulator and the
// online-softmax state (base 2). A wgmma accumulator places a thread's
// values so: warp w holds rows 16 w + lane / 4 and + 8, columns 8 j + 2
// (lane % 4), + 1 in registers 4 j ..; a register A operand takes the same
// layout per 16 columns, so P goes from S to P.V without a shuffle.
template <int D>
struct WgRows {
  static constexpr int DP = WgFwd<D>::kDP;
  float o[DP / 2];
  float m[2], l[2];
  int lane, r_lo;

  __device__ __forceinline__ void reset(int q0) {
    lane = threadIdx.x & 31;
    r_lo = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // One 64-key tile starting at key k0, Q, K and V from shared memory.
  __device__ __forceinline__ void tile(const bf16* q_s, const bf16* k_s,
                                       const bf16* v_s, int k0, int kv_len,
                                       const Geom& g) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      // K-major Q and K: a 16-deep step is 32 bytes into the 128-byte
      // rows of a column block, the 8-row atoms 1024 bytes apart
      const int off = (kk >> 2) * (kBK * 64) + (kk & 3) * 16;
      wgmma_s64(s, smem_desc(q_s + off, 16, 1024),
                smem_desc(k_s + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    // mask, scale, and the online softmax of rows lo and hi. Only a tile
    // that crosses kv_len, or (causal) the warp's diagonal, is masked; the
    // scale goes into exp2's argument as one fused multiply-add, the max
    // taken on the unscaled scores (rounding keeps the order, the scale is
    // positive). The roundings are spelled out (__fmul_rn, __fmaf_rn): left
    // to the compiler, B3's and B4's kernels contract them differently, and
    // B4 must give B3's bits.
    const float sl2 = __fmul_rn(g.scale, kLog2e);
    const int w0 = r_lo - (lane >> 2);  // the warp's first row
    if (k0 + kBK > kv_len || (g.causal && k0 + kBK - 1 > w0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int qpos = r_lo + ((i >> 1) & 1) * 8;
        if (kpos >= kv_len || (g.causal && kpos > qpos)) s[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float al[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], __fmul_rn(quad_max(mx[h]), sl2));
      al[h] = exp2f(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(__fmaf_rn(s[i], sl2, -m[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)  // this thread's columns; summed at the end
      l[h] = __fmaf_rn(l[h], al[h], sum[h]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= al[(i >> 1) & 1];
    // O += P . V, 16 keys per step, P as register A operands hi + lo; V
    // N-major: a step is 16 rows (2048 bytes) on, the 8-row atoms 1024
    // bytes apart, the 64-column blocks 8192 bytes apart
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t ph[4], pl[4];
      split_bf16(s[8 * ks + 0], s[8 * ks + 1], ph[0], pl[0]);
      split_bf16(s[8 * ks + 2], s[8 * ks + 3], ph[1], pl[1]);
      split_bf16(s[8 * ks + 4], s[8 * ks + 5], ph[2], pl[2]);
      split_bf16(s[8 * ks + 6], s[8 * ks + 7], ph[3], pl[3]);
      const uint64_t dv = smem_desc(v_s + ks * 16 * 64, kBK * 64 * 2, 1024);
      if constexpr (DP == 64) {
        wgmma_o64(o, ph, dv);
        wgmma_o64(o, pl, dv);
      } else if constexpr (DP == 128) {
        wgmma_o128(o, ph, dv);
        wgmma_o128(o, pl, dv);
      } else {
        wgmma_o192(o, ph, dv);
        wgmma_o192(o, pl, dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
  }

  // Normalize and write rows lo and hi of head bh (those inside s_q); a
  // row that saw no key (l = 0) writes zeros and LSE_MASKED.
  __device__ __forceinline__ void store(bf16* __restrict__ out,
                                        float* __restrict__ lse, int bh,
                                        const Geom& g) {
    const int col = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l_all = quad_sum(l[h]);
      const int row = r_lo + h * 8;
      if (row >= g.s_q) continue;
      const float inv = 1.f / fmaxf(l_all, 1e-30f);
      bf16* dst = out + (static_cast<size_t>(bh) * g.s_q + row) * D;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd)
        // d is even: a column pair is wholly inside d or wholly past it
        if (DP == D || nd * 8 + col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8 + col) =
              __floats2bfloat162_rn(o[4 * nd + 2 * h] * inv,
                                    o[4 * nd + 2 * h + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[static_cast<size_t>(bh) * g.s_q + row] =
            l_all > 0.f ? __fmaf_rn(m[h], kLn2, logf(l_all)) : kLseMasked;
    }
  }
};

// Query rows [q0, q0 + 64) of heads bh0 .. bh0 + n_heads - 1, all of one
// example (one kv_len), one head after another, the ring of K/V tiles
// running on across the heads; B3 is n_heads = 1. Layouts: q/out (b*h,
// s_q, D); k/v (b*h, s_kv, D); lse (b*h, s_q) f32 or null. Q goes through
// shared memory (wgmma's A operand): the first head's with the first tile,
// a later head's (B4) after the block drains its copies.
template <int D>
__device__ __forceinline__ void fwd_heads_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int kv_len, bf16* __restrict__ out,
    float* __restrict__ lse, int bh0, int n_heads, int q0, const Geom& g,
    unsigned char* smem_raw) {
  using C = WgFwd<D>;
  constexpr int S = C::kStages;
  bf16* q_s = wg_base(smem_raw);
  bf16* ring = q_s + C::kTileElems;
  wg_zero_pad<D>(q_s, 1 + 2 * S);  // the Q tile and every stage
  auto stage_k = [&](int st) { return ring + st * 2 * C::kTileElems; };
  auto stage_v = [&](int st) {
    return ring + st * 2 * C::kTileElems + C::kTileElems;
  };
  int kv_end = kv_len;
  if (g.causal) kv_end = min(kv_end, q0 + kBQ);
  const int n_kt = (kv_end + kBK - 1) / kBK;
  const int total = n_heads * n_kt;
  const size_t head_q = static_cast<size_t>(g.s_q) * D;
  const size_t head_kv = static_cast<size_t>(g.s_kv) * D;
  auto issue = [&](int t) {
    const int j = t / n_kt;
    const int st = t % S;
    const int k0 = (t - j * n_kt) * kBK;
    wg_load<D>(stage_k(st), k + (bh0 + j) * head_kv, k0, g.s_kv);
    wg_load<D>(stage_v(st), v + (bh0 + j) * head_kv, k0, g.s_kv);
  };
  if (total > 0) wg_load<D>(q_s, q + bh0 * head_q, q0, g.s_q);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < total) issue(t);
    cp_async_commit();
  }
  WgRows<D> rows;
  for (int j = 0; j < n_heads; ++j) {
    const int bh = bh0 + j;
    rows.reset(q0);
    if (j > 0 && n_kt > 0) {
      __syncthreads();  // the last head's products have read its Q
      wg_load<D>(q_s, q + bh * head_q, q0, g.s_q);
      cp_async_commit();
      cp_async_wait<0>();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int t = j * n_kt + kt;
      cp_async_wait<S - 2>();
      fence_async_shared();
      __syncthreads();  // tile t has landed, and tile t - 1 is consumed
      if (t + S - 1 < total) issue(t + S - 1);
      cp_async_commit();
      const int st = t % S;
      rows.tile(q_s, stage_k(st), stage_v(st), kt * kBK, kv_len, g);
    }
    rows.store(out, lse, bh, g);
  }
  cp_async_wait<0>();
}

template <typename T, int D>
struct Fwd {  // the f32 body: 256 threads, f32 tiles
  static constexpr int kThreadsPerBlock = kThreads;
  static constexpr size_t kSmem = Smem<D>::fwd;
};
// d = 64 and 128 (the templates' main paths) take the wgmma body
template <int D>
struct Fwd<bf16, D> {  // the bf16 body: a warpgroup, the bf16 ring
  static constexpr int kThreadsPerBlock = kMmaThreads;
  static constexpr size_t kSmem = WgFwd<D>::kSmem;
};

// The forward's grid is one dimension, query tiles fastest: block i runs
// query tile i % n_qt of head (or head tile) i / n_qt, so the blocks that
// read one head's K/V run together and its repeats come from L2. (With
// heads fastest, a head's next query tile ran b * h blocks later, after
// the other heads' K/V had pushed its own out of L2: ViT-B/16's 39 MB and
// Llama's 64 MB of K/V do not stay beside the streamed q and out.)
__device__ __forceinline__ int fwd_n_qt(const Geom& g) {
  return (g.s_q + kBQ - 1) / kBQ;
}

// B3: block (head bh, query tile qt), i = bh * n_qt + qt. The explicit
// minimum of one block per SM changes ptxas's choice for the bf16 body: at
// d = 128 it takes 204 registers instead of 178 (two blocks per SM either
// way), and Llama-3-8B's B3 ran faster in an A/B on an H100.
template <typename T, int D>
__global__ void __launch_bounds__(Fwd<T, D>::kThreadsPerBlock, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ out, float* __restrict__ lse, Geom g) {
  extern __shared__ float4 smem4[];
  const int n_qt = fwd_n_qt(g);
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kBQ;
  if constexpr (std::is_same<T, bf16>::value)
    fwd_heads_wgmma<D>(q, k, v, lens[bh / g.h], out, lse, bh, 1, q0, g,
                       reinterpret_cast<unsigned char*>(smem4));
  else
    fwd_tile<T, D>(q, k, v, lens[bh / g.h], out, lse, bh, q0, g,
                   reinterpret_cast<float*>(smem4));
}

// B4: block (head tile ht, query tile qt), i = ht * n_qt + qt, runs heads
// [ht * block_h, + block_h), all of one example (h % block_h == 0), one
// after another through B3's body.
template <typename T, int D>
__global__ void __launch_bounds__(Fwd<T, D>::kThreadsPerBlock, 1)
    flash_fwd_mh_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ out, float* __restrict__ lse,
                        int block_h, Geom g) {
  extern __shared__ float4 smem4[];
  const int n_qt = fwd_n_qt(g);
  const int ht = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - ht * n_qt) * kBQ;
  const int bh0 = ht * block_h;
  const int kv_len = lens[bh0 / g.h];  // the whole tile is one example
  if constexpr (std::is_same<T, bf16>::value) {
    fwd_heads_wgmma<D>(q, k, v, kv_len, out, lse, bh0, block_h, q0, g,
                       reinterpret_cast<unsigned char*>(smem4));
  } else {
    for (int j = 0; j < block_h; ++j) {
      if (j > 0) __syncthreads();  // the previous head's tiles are consumed
      fwd_tile<T, D>(q, k, v, kv_len, out, lse, bh0 + j, q0, g,
                     reinterpret_cast<float*>(smem4));
    }
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

// ---------------------------------------------------------------- bf16 B5, B6
// The backward's tensor-core plan for head dim D (ops/attention.py
// _flash_bwd_plan mirrors it; rt_flash_bwd_plan reports it): the forward's
// tiles, padding and copies; a ring of 3 stages up to d = 64, 2 above.
// B5 keeps Q and dO resident and streams K/V; B6 keeps K and V resident
// and streams Q, dO and the rows' lse and delta. B6 runs the FMA body above
// d = 128: its dK and dV accumulators (d / 2 f32 registers each a thread),
// with S^T and dP^T, do not fit 255 registers at d = 192.
template <int D>
struct WgBwd {
  using F = WgFwd<D>;
  static constexpr int kDP = F::kDP;
  static constexpr int kTileElems = F::kTileElems;
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr size_t kTiles =
      static_cast<size_t>(2 + 2 * kStages) * kTileElems * sizeof(bf16);
  static constexpr size_t kDqSmem = kTiles + 1024;
  static constexpr size_t kDkvSmem =
      kTiles + static_cast<size_t>(kStages) * 2 * kBQ * sizeof(float) + 1024;
  static constexpr bool kDkvMma = kDP <= 128;
  static_assert(kDqSmem <= kMaxSmem && kDkvSmem <= kMaxSmem,
                "the backward's ring exceeds a block's memory");
};

// dQ for rows [q0, q0 + 64) of head bh: per 64-key tile S = Q.K^T and
// dP = dO.V^T (wgmma, both operands K-major), P = exp2(S scale log2 e -
// lse log2 e) and dS = P (dP - delta) scale in registers, then dQ += dS.K
// with dS from registers as hi + lo bf16 A operands and K N-major (the
// forward's P.V step). Layouts as the forward's; lse and delta (b*h, s_q).
template <int D>
__device__ __forceinline__ void bwd_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    int kv_len, bf16* __restrict__ dq, int bh, int q0, const Geom& g,
    unsigned char* smem_raw) {
  using C = WgBwd<D>;
  constexpr int S = C::kStages;
  constexpr int DP = C::kDP;
  constexpr int T = C::kTileElems;
  bf16* q_s = wg_base(smem_raw);
  bf16* do_s = q_s + T;
  bf16* ring = do_s + T;  // stage st: K at ring + 2 T st, V after it
  wg_zero_pad<D>(q_s, 2 + 2 * S);
  const int lane = threadIdx.x & 31;
  const int r_lo = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int w0 = r_lo - (lane >> 2);  // the warp's first row
  int kv_end = kv_len;
  if (g.causal) kv_end = min(kv_end, q0 + kBQ);
  const int n_kt = (kv_end + kBK - 1) / kBK;
  const size_t head_q = static_cast<size_t>(bh) * g.s_q;
  const bf16* kb = k + static_cast<size_t>(bh) * g.s_kv * D;
  const bf16* vb = v + static_cast<size_t>(bh) * g.s_kv * D;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if (n_kt > 0) {
    auto issue = [&](int t) {
      bf16* st = ring + (t % S) * 2 * T;
      wg_load<D>(st, kb, t * kBK, g.s_kv);
      wg_load<D>(st + T, vb, t * kBK, g.s_kv);
    };
    wg_load<D>(q_s, q + head_q * D, q0, g.s_q);
    wg_load<D>(do_s, dout + head_q * D, q0, g.s_q);
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (t < n_kt) issue(t);
      cp_async_commit();
    }
    // this thread's rows lo and hi: lse in base 2 (a row past s_q takes
    // LSE_MASKED: p = 0), delta
    float l2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      const bool in = row < g.s_q;
      l2[h] = (in ? lse[head_q + row] : kLseMasked) * kLog2e;
      dl[h] = in ? delta[head_q + row] : 0.f;
    }
    const float sl2 = g.scale * kLog2e;
    for (int kt = 0; kt < n_kt; ++kt) {
      cp_async_wait<S - 2>();
      fence_async_shared();
      __syncthreads();  // tile kt has landed, and tile kt - 1 is consumed
      if (kt + S - 1 < n_kt) issue(kt + S - 1);
      cp_async_commit();
      const bf16* k_s = ring + (kt % S) * 2 * T;
      const bf16* v_s = k_s + T;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk >> 2) * (kBK * 64) + (kk & 3) * 16;
        wgmma_s64(s, smem_desc(q_s + off, 16, 1024),
                  smem_desc(k_s + off, 16, 1024));
        wgmma_s64(dp, smem_desc(do_s + off, 16, 1024),
                  smem_desc(v_s + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      // P and dS in registers; only a tile that crosses kv_len or (causal)
      // the warp's diagonal is masked
      const int k0 = kt * kBK;
      const bool edge =
          k0 + kBK > kv_len || (g.causal && k0 + kBK - 1 > w0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f(fmaf(s[i], sl2, -l2[h]));
        if (edge) {
          const int kpos = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
          const int qpos = r_lo + 8 * h;
          if (kpos >= kv_len || (g.causal && kpos > qpos)) p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[h]) * g.scale;
      }
      // dQ += dS . K, 16 keys per step: K N-major, a step 16 rows on
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_bf16(dp[8 * ks + 2 * j], dp[8 * ks + 2 * j + 1], hi[j],
                     lo[j]);
        const uint64_t dk = smem_desc(k_s + ks * 16 * 64, kBK * 64 * 2, 1024);
        wgmma_o<DP>(acc, hi, dk);
        wgmma_o<DP>(acc, lo, dk);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    cp_async_wait<0>();
  }
  // rows lo and hi inside s_q; a row that sees no key writes zeros
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if (row >= g.s_q) continue;
    bf16* dst = dq + (head_q + row) * D;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd)
      if (DP == D || nd * 8 + col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8 + col) =
            __floats2bfloat162_rn(acc[4 * nd + 2 * h],
                                  acc[4 * nd + 2 * h + 1]);
  }
}

// dK and dV for keys [k0, k0 + 64) of head bh, computed transposed with the
// keys as wgmma's M: per 64-row query tile S^T = K.Q^T and dP^T = V.dO^T,
// P^T and dS^T in registers (lse and delta index the columns), then dV +=
// P^T.dO and dK += dS^T.Q with A from registers (hi + lo) and dO, Q
// N-major. Causal: the query tiles from k0 / 64 on; a key tile wholly past
// kv_len writes zeros.
template <int D>
__device__ __forceinline__ void bwd_dkv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    int kv_len, bf16* __restrict__ dk, bf16* __restrict__ dv, int bh,
    int k0, const Geom& g, unsigned char* smem_raw) {
  using C = WgBwd<D>;
  constexpr int S = C::kStages;
  constexpr int DP = C::kDP;
  constexpr int T = C::kTileElems;
  bf16* k_s = wg_base(smem_raw);
  bf16* v_s = k_s + T;
  bf16* ring = v_s + T;  // stage st: Q at ring + 2 T st, dO after it
  // stage st's lse and delta rows: rows_s + 2 * kBQ * st, + kBQ
  float* rows_s = reinterpret_cast<float*>(ring + 2 * S * T);
  wg_zero_pad<D>(k_s, 2 + 2 * S);
  const int lane = threadIdx.x & 31;
  const int kr_lo = k0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int kw_last = kr_lo - (lane >> 2) + 15;  // the warp's last key
  const int col = (lane & 3) * 2;
  const size_t head_q = static_cast<size_t>(bh) * g.s_q;
  const size_t head_kv = static_cast<size_t>(bh) * g.s_kv;
  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.f;
  // causal: the first query row that sees key k0 is row k0
  const int qt0 = g.causal ? k0 / kBQ : 0;
  const int n_qt = k0 < kv_len ? (g.s_q + kBQ - 1) / kBQ - qt0 : 0;
  if (n_qt > 0) {
    const bf16* qb = q + head_q * D;
    const bf16* dob = dout + head_q * D;
    auto issue = [&](int t) {
      const int st = t % S;
      const int q0 = (qt0 + t) * kBQ;
      wg_load<D>(ring + st * 2 * T, qb, q0, g.s_q);
      wg_load<D>(ring + st * 2 * T + T, dob, q0, g.s_q);
      // rows past s_q are zero-filled; the mask hides them
      float* ls = rows_s + st * 2 * kBQ;
      for (int r = threadIdx.x; r < 2 * kBQ; r += kMmaThreads) {
        const int row = q0 + (r & (kBQ - 1));
        const bool live = row < g.s_q;
        const float* src = (r < kBQ ? lse : delta) + (live ? head_q + row : 0);
        cp_async<4>(ls + r, src, live);
      }
    };
    wg_load<D>(k_s, k + head_kv * D, k0, g.s_kv);
    wg_load<D>(v_s, v + head_kv * D, k0, g.s_kv);
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (t < n_qt) issue(t);
      cp_async_commit();
    }
    const float sl2 = g.scale * kLog2e;
    for (int t = 0; t < n_qt; ++t) {
      cp_async_wait<S - 2>();
      fence_async_shared();
      __syncthreads();  // tile t has landed, and tile t - 1 is consumed
      if (t + S - 1 < n_qt) issue(t + S - 1);
      cp_async_commit();
      const int st = t % S;
      const bf16* q_s = ring + st * 2 * T;
      const bf16* do_s = q_s + T;
      const float* lse_s = rows_s + st * 2 * kBQ;
      const float* delta_s = lse_s + kBQ;
      const int q0 = (qt0 + t) * kBQ;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk >> 2) * (kBK * 64) + (kk & 3) * 16;
        wgmma_s64(s, smem_desc(k_s + off, 16, 1024),
                  smem_desc(q_s + off, 16, 1024));
        wgmma_s64(dp, smem_desc(v_s + off, 16, 1024),
                  smem_desc(do_s + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      // P^T and dS^T: row (key) kr_lo + 8 h, column (query) q0 + 8 j + col
      // + e in register 4 j + 2 h + e. Masked only where the tile crosses
      // kv_len, s_q or (causal) the warp's diagonal.
      const bool edge = k0 + kBK > kv_len || q0 + kBQ > g.s_q ||
                        (g.causal && q0 < kw_last);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(lse_s + 8 * j +
                                                           col);
        const float2 dj = *reinterpret_cast<const float2*>(delta_s + 8 * j +
                                                           col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = (e ? lj.y : lj.x) * kLog2e;
          const float de = e ? dj.y : dj.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2f(fmaf(s[i], sl2, -l2));
            if (edge) {
              const int kpos = kr_lo + 8 * h;
              const int qpos = q0 + 8 * j + col + e;
              if (kpos >= kv_len || qpos >= g.s_q ||
                  (g.causal && kpos > qpos))
                p = 0.f;
            }
            s[i] = p;
            dp[i] = p * (dp[i] - de) * g.scale;
          }
        }
      }
      // dV += P^T . dO and dK += dS^T . Q, 16 queries per step
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBQ / 16; ++ks) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1], ph[j], pl[j]);
          split_bf16(dp[8 * ks + 2 * j], dp[8 * ks + 2 * j + 1], dh[j],
                     dl[j]);
        }
        const uint64_t d_do =
            smem_desc(do_s + ks * 16 * 64, kBK * 64 * 2, 1024);
        const uint64_t d_q = smem_desc(q_s + ks * 16 * 64, kBK * 64 * 2, 1024);
        wgmma_o<DP>(adv, ph, d_do);
        wgmma_o<DP>(adv, pl, d_do);
        wgmma_o<DP>(adk, dh, d_q);
        wgmma_o<DP>(adk, dl, d_q);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    cp_async_wait<0>();
  }
  // key rows lo and hi inside s_kv
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kr_lo + 8 * h;
    if (row >= g.s_kv) continue;
    bf16* ok = dk + (head_kv + row) * D;
    bf16* ov = dv + (head_kv + row) * D;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd)
      if (DP == D || nd * 8 + col < D) {
        *reinterpret_cast<__nv_bfloat162*>(ok + nd * 8 + col) =
            __floats2bfloat162_rn(adk[4 * nd + 2 * h],
                                  adk[4 * nd + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ov + nd * 8 + col) =
            __floats2bfloat162_rn(adv[4 * nd + 2 * h],
                                  adv[4 * nd + 2 * h + 1]);
      }
  }
}

// B5 bf16: block i runs query tile n_qt - 1 - i % n_qt of head i / n_qt:
// a head's tiles on consecutive blocks (its K/V repeats hit L2), the
// causal ones with the most key tiles first.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ lens,
                            bf16* __restrict__ dq, Geom g) {
  extern __shared__ float4 smem4[];
  const int n_qt = fwd_n_qt(g);
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (blockIdx.x - bh * n_qt)) * kBQ;
  bwd_dq_wgmma<D>(q, k, v, dout, lse, delta, lens[bh / g.h], dq, bh, q0, g,
                  reinterpret_cast<unsigned char*>(smem4));
}

// B6 bf16: block i runs key tile i % n_kt of head i / n_kt (its Q/dO
// repeats hit L2; causal, key tile 0 walks the most query tiles).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ lens,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Geom g) {
  extern __shared__ float4 smem4[];
  const int n_kt = (g.s_kv + kBK - 1) / kBK;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - bh * n_kt) * kBK;
  bwd_dkv_wgmma<D>(q, k, v, dout, lse, delta, lens[bh / g.h], dk, dv, bh, k0,
                   g, reinterpret_cast<unsigned char*>(smem4));
}

// Which body B5 and B6 run for (T, D): bf16 the tensor-core bodies (B6 up to
// d = 128), f32 the FMA ones.
template <typename T, int D>
struct Bwd {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr bool kDqMma = kBf16;
  static constexpr bool kDkvMma = kBf16 && WgBwd<D>::kDkvMma;
};

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
  using F = Fwd<T, D>;
  if (which == kFwd) {
    auto kern = flash_fwd_kernel<T, D>;
    if ((err = allow_smem(kern, F::kSmem)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<bh * n_qt, F::kThreadsPerBlock, F::kSmem, stream>>>(
        q, k, v, p.lens, static_cast<T*>(p.out),
        static_cast<float*>(p.lse_out), g);
  } else if (which == kFwdMh) {
    auto kern = flash_fwd_mh_kernel<T, D>;
    if ((err = allow_smem(kern, F::kSmem)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<bh / p.block_h * n_qt, F::kThreadsPerBlock, F::kSmem, stream>>>(
        q, k, v, p.lens, static_cast<T*>(p.out),
        static_cast<float*>(p.lse_out), p.block_h, g);
  } else if (which == kDq) {
    if constexpr (Bwd<T, D>::kDqMma) {
      auto kern = flash_bwd_dq_mma_kernel<D>;
      constexpr size_t smem = WgBwd<D>::kDqSmem;
      if ((err = allow_smem(kern, smem)) != cudaSuccess)
        return static_cast<int>(err);
      kern<<<bh * n_qt, kMmaThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, p.lens, static_cast<T*>(p.out), g);
    } else {
      auto kern = flash_bwd_dq_kernel<T, D>;
      if ((err = allow_smem(kern, Smem<D>::dq)) != cudaSuccess)
        return static_cast<int>(err);
      kern<<<dim3(bh, n_qt), block, Smem<D>::dq, stream>>>(
          q, k, v, dout, lse, delta, p.lens, static_cast<T*>(p.out), g);
    }
  } else {
    const int n_kt = (g.s_kv + kBK - 1) / kBK;
    if constexpr (Bwd<T, D>::kDkvMma) {
      auto kern = flash_bwd_dkv_mma_kernel<D>;
      constexpr size_t smem = WgBwd<D>::kDkvSmem;
      if ((err = allow_smem(kern, smem)) != cudaSuccess)
        return static_cast<int>(err);
      kern<<<bh * n_kt, kMmaThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, p.lens, static_cast<T*>(p.dk),
          static_cast<T*>(p.dv), g);
    } else {
      auto kern = flash_bwd_dkv_kernel<T, D>;
      if ((err = allow_smem(kern, Smem<D>::dkv)) != cudaSuccess)
        return static_cast<int>(err);
      kern<<<dim3(bh, n_kt), block, Smem<D>::dkv, stream>>>(
          q, k, v, dout, lse, delta, p.lens, static_cast<T*>(p.dk),
          static_cast<T*>(p.dv), g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's plan for (T, D): body (1 bf16 wgmma, 0 f32 FMA), padded
// head dim, copy bytes, ring stages, threads, dynamic shared memory.
template <typename T, int D>
int plan(int* o) {
  if constexpr (std::is_same<T, bf16>::value) {
    using C = WgFwd<D>;
    o[0] = 1, o[1] = C::kDP, o[2] = C::kCopy, o[3] = C::kStages;
  } else {
    o[0] = 0, o[1] = D, o[2] = 4, o[3] = 1;
  }
  o[4] = Fwd<T, D>::kThreadsPerBlock;
  o[5] = static_cast<int>(Fwd<T, D>::kSmem);
  return 0;
}

// The backward's plans for (T, D), B5's into o[0..5] and B6's into
// o[6..11], as plan() reports the forward's: the FMA bodies copy one
// element at a time.
template <typename T, int D>
int bwd_plan(int* o) {
  using W = WgBwd<D>;
  using F = WgFwd<D>;
  constexpr int kElem = static_cast<int>(sizeof(T));
  if constexpr (Bwd<T, D>::kDqMma) {
    o[0] = 1, o[1] = W::kDP, o[2] = F::kCopy, o[3] = W::kStages;
    o[4] = kMmaThreads, o[5] = static_cast<int>(W::kDqSmem);
  } else {
    o[0] = 0, o[1] = D, o[2] = kElem, o[3] = 1;
    o[4] = kThreads, o[5] = static_cast<int>(Smem<D>::dq);
  }
  if constexpr (Bwd<T, D>::kDkvMma) {
    o[6] = 1, o[7] = W::kDP, o[8] = F::kCopy, o[9] = W::kStages;
    o[10] = kMmaThreads, o[11] = static_cast<int>(W::kDkvSmem);
  } else {
    o[6] = 0, o[7] = D, o[8] = kElem, o[9] = 1;
    o[10] = kThreads, o[11] = static_cast<int>(Smem<D>::dkv);
  }
  return 0;
}

template <typename T>
int plan_by_dim(int d, bool backward, int* o) {
  switch (d) {
#define RT_PLAN_CASE(DIM) \
  case DIM:               \
    return backward ? bwd_plan<T, DIM>(o) : plan<T, DIM>(o);
    RT_PLAN_CASE(8)
    RT_PLAN_CASE(12)
    RT_PLAN_CASE(16)
    RT_PLAN_CASE(24)
    RT_PLAN_CASE(32)
    RT_PLAN_CASE(48)
    RT_PLAN_CASE(64)
    RT_PLAN_CASE(96)
    RT_PLAN_CASE(128)
    RT_PLAN_CASE(192)
#undef RT_PLAN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The plan rt_flash_fwd and rt_flash_fwd_mh run for (dtype, d), into
// out[6]: body (1 = bf16 wgmma, 0 = f32 FMA), padded head dim, copy bytes,
// ring stages, threads per block, dynamic shared memory in bytes.
// ops/attention.py _flash_plan is its host-side mirror.
extern "C" int rt_flash_fwd_plan(int dtype, int d, int* out) {
  if (dtype == 0) return plan_by_dim<float>(d, false, out);
  if (dtype == 1) return plan_by_dim<bf16>(d, false, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plans rt_flash_bwd_dq (out[0..5]) and rt_flash_bwd_dkv (out[6..11])
// run for (dtype, d), each as rt_flash_fwd_plan reports the forward's.
// ops/attention.py _flash_bwd_plan is its host-side mirror.
extern "C" int rt_flash_bwd_plan(int dtype, int d, int* out) {
  if (dtype == 0) return plan_by_dim<float>(d, true, out);
  if (dtype == 1) return plan_by_dim<bf16>(d, true, out);
  return static_cast<int>(cudaErrorInvalidValue);
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
