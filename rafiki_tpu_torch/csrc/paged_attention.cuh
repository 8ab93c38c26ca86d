// Paged attention over a block-table KV pool, for Hopper (sm_90a): the
// kernel templates. Two translation units instantiate them, each into a
// library of its own with the same C entries (so the two build in
// parallel):
//
//   paged_attention.cu       f32 and bf16 pools (q, pools and out share
//                            the element type)
//   paged_attention_int8.cu  int8 pools with f32 per-row scales, for f32
//                            and bf16 queries
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
// Both instantiate one block body (split_attend below) and one merge kernel,
// with the same plan for a decode call and a window of one, so a window of
// length 1 computes bit for bit what the decode kernel computes.
//
// What bounds them: memory. Per call the least traffic is the live K/V bytes
// (live tokens x kv heads x head_dim x 2 x element size, plus two f32 scales
// a token and kv head for an int8 pool) plus q and out. The arithmetic is 4 x
// rows x live tokens x head_dim per kv head: about 2 operations per byte for
// decode (rep = 4 query rows per kv head; 4 for an int8 pool) and about 64
// per byte for a 32-token window, both below the card's ~295. So the kernels
// must keep enough loads in flight to stream K/V at the memory rate, on
// every SM, and must not let the arithmetic fall behind.
//
// What the design does about it:
//
// - Split over pages (flash-decoding). The grid is (kv head, slot x query
//   tile, split): each block walks pages_per_split pages of one tile's live
//   range, so a long context spreads over many blocks instead of one block
//   walking every page in series. The host picks the split from shapes
//   alone (ops/paged_attention.py _split_plan), never from positions. A
//   split past a tile's live horizon (positions[tile_last] / page_size)
//   returns at once and writes nothing; the merge derives the same horizon
//   from positions and reads only the live splits.
// - Asynchronous page loads. Keys arrive in tiles of 64; each key row
//   looks up its own page (token >> log2 page_size) in the table, so a tile
//   may hold 64 pages of one token or half a page of 128 (the block reads
//   each page id itself, and dead entries are never read). A tile is
//   copied with 16-byte cp.async copies (8-byte where a row is not whole
//   16-byte chunks: bf16 d = 12) into a ring of shared-memory stages (3 for
//   bf16, 2 for f32), so the next tiles load while this one computes. Each
//   key row of one kv head is dh x element-size contiguous bytes; in shared
//   memory it is padded to whole 128-byte lines, its 16-byte chunks
//   XOR-swizzled by (key & 7), so the ldmatrix reads of 8 keys at one chunk
//   hit 8 different bank groups whatever pages the keys come from. Rows of
//   pages past the live range are zero-filled (cp.async's src-size 0) and
//   masked.
// - Head dims off the tile: the products run over dh padded with zero
//   columns to the mma k-step of 16 (bf16) or to 32 lanes (f32); the block
//   zeroes those columns of every stage once, and cp.async never writes
//   them. q's padded columns are zero registers; out writes dh columns.
// - Tensor cores for bf16 pools. Each warp owns a 16-row query fragment:
//   Q in registers as mma.sync m16n8k16 A operands, K read with ldmatrix, S
//   = Q.K^T in f32 registers, the per-row causal mask, an online softmax in
//   f32 (base 2, the scale folded into log2 e), P split in registers into
//   two bf16 terms hi + lo as the A operands of P.V (one bf16 rounding of
//   P errs by up to 2^-9 of each weight, which on a row of a few keys is
//   above the per-element tolerance 1e-3 + 2^-8 |out|; the pair costs one
//   more mma per P.V step, and the kernel stays memory-bound), V read with
//   ldmatrix.trans, the accumulator in f32 registers. A window tile's rows
//   (block_q x rep, up to 128) fill up to 8 warps. A decode tile has only
//   rep rows (4 at Llama-3-8B), which fill one fragment, so four warps
//   share it and split each 64-key tile into four 16-key groups, merged in
//   shared memory in fixed order at the end: the block keeps 4 warps'
//   loads and products busy instead of one (rather than one warp per block
//   and 4x the splits, whose partials and merge would grow 4x), and the
//   split grid keeps the SMs busy.
// - f32 pools (the exactness legs) use the same grid, plan, ring and merge
//   with an f32 FMA body: no TF32.
// - int8 pools (the kv_cache_int8 branch of the Pallas kernels: each K/V
//   row scaled by its own f32 absmax scale inside the softmax math). The
//   plan, grid, page lookup, masking and merge are the ones above; the pool
//   type is a template parameter of its own. A ring stage holds the tile's
//   int8 rows (d bytes padded to 16, copied 16, 8 or, at d = 12, 4 bytes at
//   a time) and each key row's two f32 scales (4-byte cp.async copies):
//   half the bytes of a bf16 stage. Once a tile has landed the block
//   widens it into one staging tile in the body's element type and swizzled
//   layout, and the body runs on that:
//   * bf16 queries (the main path): an int8 value in [-127, 127] is exact
//     in bf16, so the staging tile holds the int8 values themselves and no
//     rounding happens there. The scales are factored out of the products
//     and applied in f32: s_j = k_scale_j (q . int8_j) on the score column
//     before the mask, and v_scale_j folded into P in f32 before P's hi +
//     lo split, so acc = sum_j (p_j v_scale_j) int8_j. K and V are never
//     rounded to bf16 after the dequantization, which would err by up to
//     2^-9 of a value where the reference computes them in f32
//     (ops/paged_attention.py _paged_int8_mma_reference models this body).
//   * f32 queries: the staging tile holds int8_j x scale_j in f32 (the
//     reference's one rounding), and the f32 body runs unchanged.
//   No dequantized copy of the cache exists outside shared memory.
// - A deterministic merge. With more than one split, each block writes its
//   rows' f32 partials (running max m in log2 units, sum l, unnormalized
//   acc) to a workspace the wrapper allocated, and paged_merge_kernel gives
//   one warp per (slot, token, query head) row: M = max m, L = sum l
//   2^(m - M), out = sum acc 2^(m - M) / max(L, 1e-30), in split order and
//   rounded once. A split in which a row sees no key holds m = -1e30 (the
//   finite NEG_INF of the JAX kernels) and its factor 2^(-1e30 - M) is
//   exactly 0, since split 0 always holds key 0, which every row sees. With
//   one split the split kernel writes the output itself. No atomics: the
//   same inputs give the same bits on every run.
//
// Supported: head_dim 8, 12, 16, 24, 32, 48, 64, 96, 128 or 192 (the flash
// kernels' HEAD_DIMS), page_size a power of two from 1 to 128 (a split is a
// whole number of pages and of 64-key tiles: pages_per_split a multiple of
// max(1, 64 / page_size)), window tiles of at most 128 query rows (f32: 64,
// 32 above d = 128). The wrapper raises for anything else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // rafiki_tpu/ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileKeys = 64;  // keys per ring stage
constexpr int kFragRows = 16;  // query rows of one warp (the mma M)
constexpr int kMaxWarps = 8;
constexpr int kMergeRows = 8;  // rows (one per warp) of a merge block
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may take

struct Geometry {
  int s;                // window length (1 for the decode kernel)
  int n_heads;          // query heads
  int n_kv;             // kv heads
  int page_size;        // tokens per pool page (a power of two)
  int page_shift;       // log2(page_size)
  int n_tables;         // table columns (may be a live-width slice)
  int rep;              // n_heads / n_kv
  int block_q;          // window tokens per query tile
  int pages_per_split;  // a multiple of max(1, kTileKeys / page_size)
  int n_splits;         // ceil(n_tables / pages_per_split)
  float scale_log2;     // sm_scale * log2(e)
};

// ---- PTX helpers
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ---- end PTX helpers

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

// Four int8 values (the bytes of w, lowest first) as exact floats: byte b
// + 128 as the low mantissa bits of 2^23, minus 2^23 + 128.
__device__ __forceinline__ void widen_int8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
           8388736.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// The pool element of a library: the query type itself, or int8.
template <typename T, bool kInt8>
using PoolOf = std::conditional_t<kInt8, int8_t, T>;

// Compile-time shape of one configuration: query/output type T, pool
// element P (T, or int8 with f32 row scales), head dim D, and G key groups
// (warps that share one 16-row fragment, each taking 64 / G keys of every
// tile). The body reads tiles of T: the products run over kDC columns (D
// padded with zeros to the bf16 mma k-step of 16, or to the f32 body's 32
// lanes); a tile row holds kDS elements (D padded to whole 128-byte lines,
// 8 swizzled 16-byte chunks each). With a T pool the ring stages are such
// tiles; with an int8 pool a stage holds int8 rows of kRow8 bytes and the
// rows' scales, and the block widens it into one staging tile of T.
template <typename T, typename P, int D, int G>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int kKeysPerWarp = kTileKeys / G;
  static constexpr int kDC = kBf16 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32;
  static constexpr int kDS = kBf16 ? (D + 63) / 64 * 64 : kDC;
  static constexpr int kChunkElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = kDS / kChunkElems;  // 16-byte chunks a row
  // bytes per copy of a pool row: 16, else 8, else (an int8 row of 12) 4
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(P));
  static constexpr int kCopy =
      kRowBytes % 16 == 0 ? 16 : (kRowBytes % 8 == 0 ? 8 : 4);
  static constexpr int kCopyElems = kCopy / static_cast<int>(sizeof(P));
  static constexpr int kStages = kBf16 ? 3 : 2;
  static constexpr int kTileElems = kTileKeys * kDS;  // one K or V tile of T
  static constexpr int kRow8 = (D + 15) / 16 * 16;    // an int8 stage row
  // one ring stage: K and V tiles of T, or int8 K and V rows + their scales
  static constexpr int kStageBytes =
      kInt8 ? 2 * kTileKeys * (kRow8 + 4)
            : 2 * kTileElems * static_cast<int>(sizeof(T));
  static constexpr int kDumpStride = kDC + 4;  // f32 row of the merge scratch
  static_assert(kChunks % 8 == 0, "the (key & 7) swizzle needs 8 chunks");
  static_assert(kKeysPerWarp % 16 == 0, "P.V takes 16 keys per mma");
  static_assert(D % kCopyElems == 0 && D % 4 == 0, "rows of whole copies");
  static_assert(kStageBytes % 16 == 0, "stages start 16-byte aligned");
};

// Element offset of (key, element e) in a swizzled tile of T.
template <typename T, int D>
__device__ __forceinline__ int swz(int key, int e) {
  using C = Cfg<T, T, D, 1>;
  const int ch = e / C::kChunkElems;
  return key * C::kDS + ((ch ^ (key & 7)) * C::kChunkElems) +
         (e - ch * C::kChunkElems);
}

// Zero the padded columns [D, kDC) of n_tiles consecutive K/V tiles of T,
// once per block: nothing else writes them, and the first barrier of the
// page walk publishes them.
template <typename T, int D>
__device__ __forceinline__ void zero_pad(T* tiles, int n_tiles) {
  using C = Cfg<T, T, D, 1>;
  if constexpr (C::kDC > D) {
    constexpr int kPad = C::kDC - D;
    for (int i = threadIdx.x; i < n_tiles * kTileKeys * kPad;
         i += blockDim.x) {
      const int row = i / kPad;  // over every tile's rows
      tiles[(row / kTileKeys) * C::kTileElems +
            swz<T, D>(row % kTileKeys, D + (i - row * kPad))] =
          from_f32<T>(0.f);
    }
  }
}

// Issue the cp.async copies of the 64-key tile whose first key is at
// position key0 (of kv head kh) into a stage: each key row looks up its own
// page, so a tile may span many small pages or half of one of 128 keys;
// rows of pages at or past page_end are zero-filled, and their table
// entries are not read. An int8 stage also takes each row's two scales.
template <typename T, typename P, int D, int G>
__device__ __forceinline__ void load_tile(
    unsigned char* stage, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    int key0, int page_end, int kh, const Geometry& g) {
  using C = Cfg<T, P, D, G>;
  constexpr int kCopies = D / C::kCopyElems;  // per key row
  // an int8 row also takes one more "copy": its pair of scales
  constexpr int kParts = C::kInt8 ? kCopies + 1 : kCopies;
  for (int c = threadIdx.x; c < kTileKeys * kParts; c += blockDim.x) {
    const int key = c / kParts;
    const int part = c - key * kParts;
    const int tok = key0 + key;  // position in the slot's sequence
    const int pg = tok >> g.page_shift;
    const bool live = pg < page_end;
    size_t row = 0;  // the token's (page, slot) row of the pool
    if (live)
      row = (static_cast<size_t>(table[pg]) << g.page_shift) +
            (tok & (g.page_size - 1));
    const size_t vec = row * g.n_kv + kh;  // its kv head's vector
    if constexpr (C::kInt8) {
      int8_t* k_s = reinterpret_cast<int8_t*>(stage);
      int8_t* v_s = k_s + kTileKeys * C::kRow8;
      float* ks_s = reinterpret_cast<float*>(v_s + kTileKeys * C::kRow8);
      if (part < kCopies) {
        const int e = part * C::kCopyElems;
        const int dst = key * C::kRow8 + e;
        cp_async<C::kCopy>(k_s + dst, k_pool + vec * D + e, live);
        cp_async<C::kCopy>(v_s + dst, v_pool + vec * D + e, live);
      } else {
        cp_async<4>(ks_s + key, k_scale + vec, live);
        cp_async<4>(ks_s + kTileKeys + key, v_scale + vec, live);
      }
    } else {
      T* k_s = reinterpret_cast<T*>(stage);
      const int e = part * C::kCopyElems;
      const int dst = swz<T, D>(key, e);
      cp_async<C::kCopy>(k_s + dst, k_pool + vec * D + e, live);
      cp_async<C::kCopy>(k_s + C::kTileElems + dst, v_pool + vec * D + e,
                         live);
    }
  }
}

// An int8 stage that has landed, widened into the staging K and V tiles of
// T (swizzled as a T stage): bf16 takes the int8 values as they are (exact),
// f32 the dequantized rows int8 x scale (one rounding, as the reference).
template <typename T, int D, int G>
__device__ __forceinline__ void widen_tile(T* k_t,
                                           const unsigned char* stage) {
  using C = Cfg<T, int8_t, D, G>;
  constexpr int kU = D % 8 == 0 ? 8 : 4;  // int8 elements a thread widens
  constexpr int kUnits = D / kU;          // per row
  const int8_t* k_s = reinterpret_cast<const int8_t*>(stage);
  const float* ks_s =
      reinterpret_cast<const float*>(k_s + 2 * kTileKeys * C::kRow8);
  for (int c = threadIdx.x; c < 2 * kTileKeys * kUnits; c += blockDim.x) {
    const int kv = c / (kTileKeys * kUnits);  // 0: K, 1: V
    const int r = c - kv * (kTileKeys * kUnits);
    const int key = r / kUnits;
    const int e = (r - key * kUnits) * kU;
    const int8_t* src = k_s + (kv * kTileKeys + key) * C::kRow8 + e;
    T* dst = k_t + kv * C::kTileElems + swz<T, D>(key, e);
    float f[kU];
    if constexpr (kU == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(src);
      widen_int8x4(w.x, f);
      widen_int8x4(w.y, f + 4);
    } else {
      widen_int8x4(*reinterpret_cast<const uint32_t*>(src), f);
    }
    if constexpr (C::kBf16) {
      uint32_t packed[kU / 2];
#pragma unroll
      for (int i = 0; i < kU / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        packed[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      if constexpr (kU == 8)
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
    } else {
      const float sc = ks_s[kv * kTileKeys + key];
#pragma unroll
      for (int i = 0; i < kU; i += 4)  // 16-byte chunks of 4 floats
        *reinterpret_cast<float4*>(k_t + kv * C::kTileElems +
                                   swz<T, D>(key, e + i)) =
            make_float4(f[i] * sc, f[i + 1] * sc, f[i + 2] * sc,
                        f[i + 3] * sc);
      (void)dst;
    }
  }
}

// Where a tile row r lives: window token q0 + r / rep at query head
// kh * rep + r % rep; its row of q/out (b, s, n_heads, D) and of the
// partials (b * s * n_heads rows).
struct Rows {
  int b, q0, kh, rows;
  const int* pos_b;
  __device__ __forceinline__ size_t index(int r, const Geometry& g) const {
    const int tok = q0 + r / g.rep;
    const int head = kh * g.rep + r % g.rep;
    return (static_cast<size_t>(b) * g.s + tok) * g.n_heads + head;
  }
  // the causal horizon of row r; rows past the tile see no key
  __device__ __forceinline__ int horizon(int r, const Geometry& g) const {
    return r < rows ? pos_b[q0 + r / g.rep] : -1;
  }
};

// The bf16 body: one warp, fragment rows f * 16 .., keys key0 .. key0 + 63
// / G of every tile. Thread layout of the mma fragments: group = lane / 4
// holds rows group and group + 8, tig = lane % 4 holds columns 2 tig, +1.
// kScaled: the tile holds int8 values, and each key's f32 scales apply to
// its score column (k_sc) and to its weight in P.V (v_sc).
template <int D, int G, bool kScaled>
struct MmaBody {
  using T = __nv_bfloat16;
  using C = Cfg<T, T, D, G>;
  static constexpr int kNT = C::kKeysPerWarp / 8;  // 8-key n tiles of S
  static constexpr int kDC = C::kDC;
  static constexpr int kDS = C::kDS;
  uint32_t qa[kDC / 16][4];
  float acc[kDC / 8][4];
  float m_lo, m_hi, l_lo, l_hi;
  int t_lo, t_hi, key0, lane;

  // Q stays in registers: no shared memory past the ring
  static __host__ __device__ size_t extra_floats(int, int) { return 0; }

  __device__ __forceinline__ void init(const T* __restrict__ q, int f, int g_,
                                       const Rows& rw, const Geometry& g,
                                       float*) {
    lane = threadIdx.x & 31;
    key0 = g_ * C::kKeysPerWarp;
    const int r_lo = f * kFragRows + (lane >> 2);
    const int r_hi = r_lo + 8;
    t_lo = rw.horizon(r_lo, g);
    t_hi = rw.horizon(r_hi, g);
    const T* q_lo = r_lo < rw.rows ? q + rw.index(r_lo, g) * D : nullptr;
    const T* q_hi = r_hi < rw.rows ? q + rw.index(r_hi, g) * D : nullptr;
    const int col = (lane & 3) * 2;
    // a column pair (even d) lies wholly inside d or wholly in the padding
    auto pair = [&](const T* row, int c) {
      return row != nullptr && (kDC == D || c < D)
                 ? *reinterpret_cast<const uint32_t*>(row + c)
                 : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < kDC / 16; ++kk) {
      const int c = kk * 16 + col;
      qa[kk][0] = pair(q_lo, c);
      qa[kk][1] = pair(q_hi, c);
      qa[kk][2] = pair(q_lo, c + 8);
      qa[kk][3] = pair(q_hi, c + 8);
    }
#pragma unroll
    for (int nd = 0; nd < kDC / 8; ++nd)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nd][j] = 0.f;
    m_lo = m_hi = kNegInf;
    l_lo = l_hi = 0.f;
  }

  // One tile: its first key is at position kt0; keys at or past kend (the
  // live range's end) are masked. k_sc / v_sc: the tile's 64 key and value
  // scales (kScaled only).
  __device__ __forceinline__ void tile(const T* k_s, const T* v_s,
                                       const float* k_sc, const float* v_sc,
                                       int kt0, int kend, const Geometry& g) {
    const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
    float sc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDC / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        uint32_t b[4];
        const int key = key0 + (nt + (mi >> 1)) * 8 + (lane & 7);
        const int ch = kk * 2 + (mi & 1);
        ldmatrix_x4(b, k_s + key * kDS + ((ch ^ (key & 7)) * 8));
        mma_bf16(sc[nt], qa[kk], b[0], b[1]);
        mma_bf16(sc[nt + 1], qa[kk], b[2], b[3]);
      }
    }
    // scale, mask, and the online softmax of rows lo and hi
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = key0 + nt * 8 + (lane & 3) * 2 + (j & 1);
        const int kpos = kt0 + kl;
        const int t = j < 2 ? t_lo : t_hi;
        float s = sc[nt][j];
        if constexpr (kScaled) s *= k_sc[kl];
        const float v = (kpos <= t && kpos < kend) ? s * g.scale_log2
                                                   : kNegInf;
        sc[nt][j] = v;
        if (j < 2)
          mx_lo = fmaxf(mx_lo, v);
        else
          mx_hi = fmaxf(mx_hi, v);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float al_lo = exp2f(m_lo - mn_lo);
    const float al_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - mn_lo);
      sc[nt][1] = exp2f(sc[nt][1] - mn_lo);
      sc[nt][2] = exp2f(sc[nt][2] - mn_hi);
      sc[nt][3] = exp2f(sc[nt][3] - mn_hi);
      s_lo += sc[nt][0] + sc[nt][1];
      s_hi += sc[nt][2] + sc[nt][3];
    }
    l_lo = l_lo * al_lo + s_lo;  // this thread's columns; summed at the end
    l_hi = l_hi * al_hi + s_hi;
#pragma unroll
    for (int nd = 0; nd < kDC / 8; ++nd) {
      acc[nd][0] *= al_lo;
      acc[nd][1] *= al_lo;
      acc[nd][2] *= al_hi;
      acc[nd][3] *= al_hi;
    }
    if constexpr (kScaled) {  // P's weights times their values' scales
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int kl = key0 + nt * 8 + (lane & 3) * 2;
        const float v0 = v_sc[kl], v1 = v_sc[kl + 1];
        sc[nt][0] *= v0;
        sc[nt][1] *= v1;
        sc[nt][2] *= v0;
        sc[nt][3] *= v1;
      }
    }
    // acc += P . V, 16 keys per step, P as the A operands hi + lo
#pragma unroll
    for (int ks = 0; ks < kNT / 2; ++ks) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * ks][0], sc[2 * ks][1], ph[0], pl[0]);
      split_bf16(sc[2 * ks][2], sc[2 * ks][3], ph[1], pl[1]);
      split_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3], ph[3], pl[3]);
      const int key = key0 + ks * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < kDC / 8; nd += 2) {
        uint32_t b[4];
        const int ch = nd + (mi >> 1);
        ldmatrix_x4_trans(b, v_s + key * kDS + ((ch ^ (key & 7)) * 8));
        mma_bf16(acc[nd], ph, b[0], b[1]);
        mma_bf16(acc[nd], pl, b[0], b[1]);
        mma_bf16(acc[nd + 1], ph, b[2], b[3]);
        mma_bf16(acc[nd + 1], pl, b[2], b[3]);
      }
    }
  }

  // Rows w * 16 .. of the merge scratch: (m, l) and the unnormalized acc.
  __device__ __forceinline__ void dump(float* dump, float* ml, int w) {
    const float l_lo_all = quad_sum(l_lo);
    const float l_hi_all = quad_sum(l_hi);
    const int r_lo = w * kFragRows + (lane >> 2);
    const int r_hi = r_lo + 8;
    const int col = (lane & 3) * 2;
#pragma unroll
    for (int nd = 0; nd < kDC / 8; ++nd) {
      float* lo = dump + r_lo * C::kDumpStride + nd * 8 + col;
      float* hi = dump + r_hi * C::kDumpStride + nd * 8 + col;
      lo[0] = acc[nd][0];
      lo[1] = acc[nd][1];
      hi[0] = acc[nd][2];
      hi[1] = acc[nd][3];
    }
    if ((lane & 3) == 0) {
      ml[2 * r_lo] = m_lo;
      ml[2 * r_lo + 1] = l_lo_all;
      ml[2 * r_hi] = m_hi;
      ml[2 * r_hi + 1] = l_hi_all;
    }
  }
};

// The f32 body: one warp, fragment rows f * 16 .., keys key0 .. of every
// tile. S goes through the warp's shared scratch p_s (16 x keys); lane r
// (and r + 16, which repeats it) keeps row r's running max and sum; lane j
// accumulates elements j * kDC / 32 .. of every row of acc (those past D
// stay zero: V's padded columns are). Its tiles hold f32 values: an int8
// pool's arrive dequantized (widen_tile), so the scales are not read here.
template <int D, int G>
struct FmaBody {
  using T = float;
  using C = Cfg<T, T, D, G>;
  static constexpr int kKW = C::kKeysPerWarp;
  static constexpr int kDS = C::kDS;
  static constexpr int kDPL = C::kDC / 32;  // acc elements per lane and row
  static constexpr int kQStride = C::kDC + 4;
  float acc[kFragRows][kDPL];
  float m, l;
  int key0, lane, f;
  const float* q_s;  // the block's Q rows, f32, padded rows
  float* p_s;        // this warp's 16 x kKW scores / probabilities
  float* a_s;        // this warp's 16 rescale factors
  const int* t_s;    // the block's row horizons

  // Shared layout past the ring: q_s [F * 16][kDC + 4], p_s [W][16][kKW],
  // a_s [W][16], t_s [F * 16] (ints).
  static __host__ __device__ size_t extra_floats(int n_frag, int n_warps) {
    return static_cast<size_t>(n_frag) * kFragRows * kQStride +
           static_cast<size_t>(n_warps) * kFragRows * (kKW + 1) +
           static_cast<size_t>(n_frag) * kFragRows;
  }

  __device__ __forceinline__ void init(const T* __restrict__ q, int f_,
                                       int g_, const Rows& rw,
                                       const Geometry& g, float* extra) {
    lane = threadIdx.x & 31;
    f = f_;
    key0 = g_ * kKW;
    const int n_warps = blockDim.x >> 5;
    const int n_frag = n_warps / G;
    const int w = threadIdx.x >> 5;
    float* qs = extra;
    p_s = qs + n_frag * kFragRows * kQStride + w * kFragRows * kKW;
    a_s = qs + n_frag * kFragRows * kQStride + n_warps * kFragRows * kKW +
          w * kFragRows;
    int* ts = reinterpret_cast<int*>(qs + n_frag * kFragRows * kQStride +
                                     n_warps * kFragRows * (kKW + 1));
    // the whole block fills q_s and t_s (the ring loop's first barrier
    // publishes them)
    for (int idx = threadIdx.x; idx < n_frag * kFragRows * D;
         idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx - r * D;
      qs[r * kQStride + d] = r < rw.rows ? q[rw.index(r, g) * D + d] : 0.f;
    }
    for (int r = threadIdx.x; r < n_frag * kFragRows; r += blockDim.x)
      ts[r] = rw.horizon(r, g);
    q_s = qs;
    t_s = ts;
#pragma unroll
    for (int r = 0; r < kFragRows; ++r)
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
    m = kNegInf;
    l = 0.f;
  }

  __device__ __forceinline__ void tile(const T* k_s, const T* v_s,
                                       const float*, const float*, int kt0,
                                       int kend, const Geometry& g) {
    // S for the 16 x kKW (row, key) pairs, 32 at a time
    for (int pair = lane; pair < kFragRows * kKW; pair += 32) {
      const int r = pair / kKW;
      const int key = key0 + (pair - r * kKW);
      const float* qr = q_s + (f * kFragRows + r) * kQStride;
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < D / 4; ++c) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + c * 4);
        const float4 kv = *reinterpret_cast<const float4*>(
            k_s + key * kDS + ((c ^ (key & 7)) * 4));
        dot = fmaf(qv.x, kv.x, dot);
        dot = fmaf(qv.y, kv.y, dot);
        dot = fmaf(qv.z, kv.z, dot);
        dot = fmaf(qv.w, kv.w, dot);
      }
      const int kpos = kt0 + key;
      const int t = t_s[f * kFragRows + r];
      p_s[pair] =
          (kpos <= t && kpos < kend) ? dot * g.scale_log2 : kNegInf;
    }
    __syncwarp();
    // the online softmax of row lane % 16
    const int r = lane & (kFragRows - 1);
    float* pr = p_s + r * kKW;
    float mx = kNegInf;
    for (int k = 0; k < kKW; ++k) mx = fmaxf(mx, pr[k]);
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    float sum = 0.f;
    for (int k = 0; k < kKW; ++k) sum += exp2f(pr[k] - mn);
    __syncwarp();  // every lane has read its row before lanes 0..15 write
    if (lane < kFragRows) {
      for (int k = 0; k < kKW; ++k) pr[k] = exp2f(pr[k] - mn);
      a_s[r] = alpha;
    }
    m = mn;
    l = l * alpha + sum;
    __syncwarp();
    // acc = acc * alpha + P . V, lane's elements of every row
#pragma unroll
    for (int rr = 0; rr < kFragRows; ++rr) {
      const float al = a_s[rr];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[rr][i] *= al;
    }
    const int d0 = lane * kDPL;
    for (int k = 0; k < kKW; ++k) {
      const int key = key0 + k;
      float v[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i)  // 3 or 6 a lane cross 16-byte chunks
        v[i] = v_s[swz<T, D>(key, d0 + i)];
#pragma unroll
      for (int rr = 0; rr < kFragRows; ++rr) {
        const float p = p_s[rr * kKW + k];
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[rr][i] = fmaf(p, v[i], acc[rr][i]);
      }
    }
    __syncwarp();  // p_s and a_s are read before the next tile rewrites them
  }

  __device__ __forceinline__ void dump(float* dump, float* ml, int w) {
#pragma unroll
    for (int rr = 0; rr < kFragRows; ++rr)
#pragma unroll
      for (int i = 0; i < kDPL; ++i)
        dump[(w * kFragRows + rr) * C::kDumpStride + lane * kDPL + i] =
            acc[rr][i];
    if (lane < kFragRows) {
      ml[2 * (w * kFragRows + lane)] = m;
      ml[2 * (w * kFragRows + lane) + 1] = l;
    }
  }
};

template <typename T, typename P, int D, int G>
struct BodyOf;
template <typename P, int D, int G>
struct BodyOf<__nv_bfloat16, P, D, G> {
  using type = MmaBody<D, G, std::is_same<P, int8_t>::value>;
};
template <typename P, int D, int G>
struct BodyOf<float, P, D, G> {
  using type = FmaBody<D, G>;
};

// Shared memory of a block of n_warps warps (n_frag fragments): the ring
// (and an int8 pool's staging tiles), reused after the page walk as the
// merge scratch, then the body's extra.
template <typename T, typename P, int D, int G>
__host__ __device__ size_t ring_bytes(int n_warps) {
  using C = Cfg<T, P, D, G>;
  const size_t ring =
      static_cast<size_t>(C::kStages) * C::kStageBytes +
      (C::kInt8 ? 2 * static_cast<size_t>(C::kTileElems) * sizeof(T) : 0);
  const size_t scratch = static_cast<size_t>(n_warps) * kFragRows *
                         (C::kDumpStride + 2) * sizeof(float);
  return ring > scratch ? ring : scratch;
}

template <typename T, typename P, int D, int G>
size_t smem_bytes(int n_frag, int n_warps) {
  return ring_bytes<T, P, D, G>(n_warps) +
         BodyOf<T, P, D, G>::type::extra_floats(n_frag, n_warps) *
             sizeof(float);
}

// One block: kv head blockIdx.x, (slot, query tile) blockIdx.y, split
// blockIdx.z; warp w takes fragment w % n_frag and key group w / n_frag.
// Layouts: q/out (b, s, n_heads, D); pools (n_pages, page_size, n_kv, D);
// scales (n_pages, page_size, n_kv), int8 pools only; tables (b,
// n_tables); positions (b, s); part_acc (b * s * n_heads, n_splits, D) and
// part_ml (b * s * n_heads, n_splits, 2), f32.
template <typename T, typename P, int D, int G>
__device__ __forceinline__ void split_attend(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const Geometry g) {
  using C = Cfg<T, P, D, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qtiles = (g.s + g.block_q - 1) / g.block_q;
  Rows rw;
  rw.kh = blockIdx.x;
  rw.b = blockIdx.y / n_qtiles;
  rw.q0 = (blockIdx.y - rw.b * n_qtiles) * g.block_q;
  const int nq = min(g.block_q, g.s - rw.q0);
  rw.rows = nq * g.rep;
  rw.pos_b = positions + static_cast<size_t>(rw.b) * g.s;
  const int sp = blockIdx.z;

  // positions are nondecreasing along the window, so the tile's last row
  // bounds its live pages; the walk also ends at the table's last column,
  // as the TPU grid's n_tables page steps do
  const int t_last = rw.pos_b[rw.q0 + nq - 1];
  const int n_live = min((t_last >> g.page_shift) + 1, g.n_tables);
  const int page_begin = sp * g.pages_per_split;
  if (page_begin >= n_live) return;  // past the horizon: the merge skips it
  const int page_end = min(page_begin + g.pages_per_split, n_live);
  // the split's keys in 64-key tiles (a page of 128 spans two); only the
  // last live split may end inside a tile, whose rest is zero-filled
  const int key_begin = page_begin << g.page_shift;
  const int n_tiles =
      (((page_end - page_begin) << g.page_shift) + kTileKeys - 1) / kTileKeys;
  const int kend = n_live << g.page_shift;

  const int n_warps = blockDim.x >> 5;
  const int n_frag = n_warps / G;
  const int w = threadIdx.x >> 5;
  // an int8 pool's staging tiles (K then V, of T) follow the ring
  T* staging = reinterpret_cast<T*>(smem + C::kStages * C::kStageBytes);
  float* extra =
      reinterpret_cast<float*>(smem + ring_bytes<T, P, D, G>(n_warps));
  const int* table = tables + static_cast<size_t>(rw.b) * g.n_tables;

  if constexpr (C::kInt8)
    zero_pad<T, D>(staging, 2);
  else
    zero_pad<T, D>(reinterpret_cast<T*>(smem), C::kStages * 2);
  typename BodyOf<T, P, D, G>::type body;
  body.init(q, w % n_frag, w / n_frag, rw, g, extra);

  auto stage = [&](int st) { return smem + st * C::kStageBytes; };
#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < n_tiles)
      load_tile<T, P, D, G>(stage(st), k_pool, v_pool, k_scale, v_scale,
                            table, key_begin + st * kTileKeys, page_end,
                            rw.kh, g);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile it has landed, and tile it - 1 is consumed
    const int nxt = it + C::kStages - 1;
    if (nxt < n_tiles)
      load_tile<T, P, D, G>(stage(nxt % C::kStages), k_pool, v_pool, k_scale,
                            v_scale, table, key_begin + nxt * kTileKeys,
                            page_end, rw.kh, g);
    cp_async_commit();
    const int kt0 = key_begin + it * kTileKeys;
    if constexpr (C::kInt8) {
      const unsigned char* st = stage(it % C::kStages);
      widen_tile<T, D, G>(staging, st);
      __syncthreads();  // the staging tiles are written
      const float* sc = reinterpret_cast<const float*>(
          st + 2 * kTileKeys * C::kRow8);  // the tile's K, then V scales
      body.tile(staging, staging + C::kTileElems, sc, sc + kTileKeys, kt0,
                kend, g);
    } else {
      const T* st = reinterpret_cast<const T*>(stage(it % C::kStages));
      body.tile(st, st + C::kTileElems, nullptr, nullptr, kt0, kend, g);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it as the merge scratch

  float* dump = reinterpret_cast<float*>(smem);
  float* ml = dump + n_warps * kFragRows * C::kDumpStride;
  body.dump(dump, ml, w);
  __syncthreads();

  // merge the G key groups of each row (fixed order), then write the
  // output (one split) or this split's partial
  constexpr int kQuads = D / 4;
  for (int idx = threadIdx.x; idx < rw.rows * kQuads; idx += blockDim.x) {
    const int r = idx / kQuads;
    const int d = (idx - r * kQuads) * 4;
    const int f = r / kFragRows;
    const int rr = r - f * kFragRows;
    float mx = kNegInf;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      mx = fmaxf(mx, ml[2 * ((gg * n_frag + f) * kFragRows + rr)]);
    float sum = 0.f;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const int row = (gg * n_frag + f) * kFragRows + rr;
      const float wgt = exp2f(ml[2 * row] - mx);
      sum += ml[2 * row + 1] * wgt;
      const float* src = dump + row * C::kDumpStride + d;
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] += src[i] * wgt;
    }
    const size_t grow = rw.index(r, g);
    if (g.n_splits == 1) {
      // position 0 is always live, so sum > 0 on every row
      const float den = fmaxf(sum, 1e-30f);
      T* o = out + grow * D + d;
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = from_f32<T>(a[i] / den);
    } else {
      const size_t prow = grow * g.n_splits + sp;
      *reinterpret_cast<float4*>(part_acc + prow * D + d) =
          make_float4(a[0], a[1], a[2], a[3]);
      if (d == 0) {
        part_ml[2 * prow] = mx;
        part_ml[2 * prow + 1] = sum;
      }
    }
  }
}

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_decode_kernel(const T* q, const P* k_pool, const P* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* positions, T* out,
                        float* part_acc, float* part_ml, Geometry g) {
  split_attend<T, P, D, G>(q, k_pool, v_pool, k_scale, v_scale, tables,
                           positions, out, part_acc, part_ml, g);
}

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_window_kernel(const T* q, const P* k_pool, const P* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* positions, T* out,
                        float* part_acc, float* part_ml, Geometry g) {
  split_attend<T, P, D, G>(q, k_pool, v_pool, k_scale, v_scale, tables,
                           positions, out, part_acc, part_ml, g);
}

// One warp per (slot, token, query head) row: the live splits' partials in
// split order, one rounding.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeRows * 32)
    paged_merge_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int n_rows, Geometry g) {
  const int row = blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int bt = row / g.n_heads;  // slot * s + token
  const int b = bt / g.s;
  const int q0 = ((bt - b * g.s) / g.block_q) * g.block_q;
  const int last = min(q0 + g.block_q, g.s) - 1;
  const int t_last = positions[static_cast<size_t>(b) * g.s + last];
  const int n_live = min((t_last >> g.page_shift) + 1, g.n_tables);
  const int n_live_splits =
      (n_live + g.pages_per_split - 1) / g.pages_per_split;
  const float* ml = part_ml + static_cast<size_t>(row) * g.n_splits * 2;
  float mx = kNegInf;
  for (int sp = 0; sp < n_live_splits; ++sp) mx = fmaxf(mx, ml[2 * sp]);
  constexpr int kDPL = (D + 31) / 32;  // lane takes elements lane + 32 i
  float sum = 0.f;
  float a[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) a[i] = 0.f;
  const float* acc =
      part_acc + static_cast<size_t>(row) * g.n_splits * D + lane;
  for (int sp = 0; sp < n_live_splits; ++sp) {
    const float wgt = exp2f(ml[2 * sp] - mx);
    sum += ml[2 * sp + 1] * wgt;
#pragma unroll
    for (int i = 0; i < kDPL; ++i)
      if (D % 32 == 0 || lane + 32 * i < D)
        a[i] += acc[sp * D + 32 * i] * wgt;
  }
  const float den = fmaxf(sum, 1e-30f);
  T* o = out + static_cast<size_t>(row) * D + lane;
#pragma unroll
  for (int i = 0; i < kDPL; ++i)
    if (D % 32 == 0 || lane + 32 * i < D) o[32 * i] = from_f32<T>(a[i] / den);
}

// The pointers of one call, typed.
template <typename T, typename P>
struct Operands {
  const T* q;
  const P* k_pool;
  const P* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* positions;
  T* out;
  float* part_acc;
  float* part_ml;
};

template <typename T, typename P, int D, int G>
int launch_split(bool window, int batch, const Geometry& g,
                 const Operands<T, P>& o, cudaStream_t stream) {
  const int n_frag = (g.block_q * g.rep + kFragRows - 1) / kFragRows;
  const int n_warps = n_frag * G;
  const size_t smem = smem_bytes<T, P, D, G>(n_frag, n_warps);
  if (n_warps > kMaxWarps || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window ? paged_window_kernel<T, P, D, G>
                       : paged_decode_kernel<T, P, D, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_qtiles = (g.s + g.block_q - 1) / g.block_q;
  const dim3 grid(g.n_kv, batch * n_qtiles, g.n_splits);
  kernel<<<grid, 32 * n_warps, smem, stream>>>(
      o.q, o.k_pool, o.v_pool, o.k_scale, o.v_scale, o.tables, o.positions,
      o.out, o.part_acc, o.part_ml, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, int D>
int launch(bool window, int batch, const Geometry& g, const void* q,
           const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* positions,
           void* out, void* part_acc, void* part_ml, cudaStream_t stream) {
  const Operands<T, P> o{static_cast<const T*>(q),
                         static_cast<const P*>(k_pool),
                         static_cast<const P*>(v_pool),
                         static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale),
                         static_cast<const int*>(tables),
                         static_cast<const int*>(positions),
                         static_cast<T*>(out),
                         static_cast<float*>(part_acc),
                         static_cast<float*>(part_ml)};
  // one fragment (rep <= 16 decode rows): four warps split each tile's keys
  const bool one_frag = g.block_q * g.rep <= kFragRows;
  int err = one_frag ? launch_split<T, P, D, 4>(window, batch, g, o, stream)
                     : launch_split<T, P, D, 1>(window, batch, g, o, stream);
  if (err != 0 || g.n_splits == 1) return err;
  const int n_rows = batch * g.s * g.n_heads;
  paged_merge_kernel<T, D>
      <<<(n_rows + kMergeRows - 1) / kMergeRows, kMergeRows * 32, 0,
         stream>>>(o.part_acc, o.part_ml, o.positions, o.out, n_rows, g);
  return static_cast<int>(cudaGetLastError());
}

// kInt8: the library's pools are int8 with both scales (else of q's type,
// with none).
template <bool kInt8>
int dispatch(bool window, int dtype, int batch, int dh, const Geometry& g,
             const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* positions, void* out, void* part_acc, void* part_ml,
             void* stream) {
  const int ps = g.page_size;
  // a split is whole pages and whole 64-key tiles
  const int unit_pages = ps > 0 && ps < kTileKeys ? kTileKeys / ps : 1;
  const bool ok =
      ps >= 1 && ps <= 128 && (ps & (ps - 1)) == 0 &&
      (1 << g.page_shift) == ps && g.pages_per_split > 0 &&
      g.pages_per_split % unit_pages == 0 &&
      g.n_splits >= 1 &&
      static_cast<long long>(g.n_splits) * g.pages_per_split >= g.n_tables &&
      (g.n_splits == 1 || (part_acc != nullptr && part_ml != nullptr)) &&
      (kInt8 ? (k_scale != nullptr && v_scale != nullptr)
             : (k_scale == nullptr && v_scale == nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  using BF = __nv_bfloat16;
  switch (dh) {
#define RT_PAGED_CASE(DIM)                                                   \
  case DIM:                                                                  \
    return dtype == 0                                                        \
               ? launch<float, PoolOf<float, kInt8>, DIM>(                   \
                     window, batch, g, q, k_pool, v_pool, k_scale, v_scale,  \
                     tables, positions, out, part_acc, part_ml, st)          \
               : launch<BF, PoolOf<BF, kInt8>, DIM>(                         \
                     window, batch, g, q, k_pool, v_pool, k_scale, v_scale,  \
                     tables, positions, out, part_acc, part_ml, st);
    RT_PAGED_CASE(8)
    RT_PAGED_CASE(12)
    RT_PAGED_CASE(16)
    RT_PAGED_CASE(24)
    RT_PAGED_CASE(32)
    RT_PAGED_CASE(48)
    RT_PAGED_CASE(64)
    RT_PAGED_CASE(96)
    RT_PAGED_CASE(128)
    RT_PAGED_CASE(192)
#undef RT_PAGED_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Geometry make_geometry(int s, int n_heads, int n_kv, int page_size,
                       int n_tables, int block_q, int pages_per_split,
                       int n_splits, float sm_scale) {
  int shift = 0;
  while (shift < 30 && (1 << shift) < page_size) ++shift;
  return Geometry{s,        n_heads,  n_kv,
                  page_size, shift,   n_tables,
                  n_heads / n_kv,     block_q,  pages_per_split,
                  n_splits, sm_scale * kLog2e};
}

}  // namespace

// The two C entries of a library; kInt8 as in dispatch. dtype: 0 =
// float32, 1 = bfloat16 (q and out; the pools too, unless int8).
// pages_per_split / n_splits: the plan (ops/paged_attention.py
// _split_plan); part_acc (b * s * n_heads, n_splits, dh) and part_ml
// (b * s * n_heads, n_splits, 2) are f32 workspaces, unused (may be null)
// with one split. Each returns the first nonzero cudaGetLastError() of the
// split launch and the merge launch (0 on success); cudaErrorInvalidValue
// for a head dim, page size, plan, query tile or scale pointers the kernels
// do not take.
#define RT_PAGED_ENTRIES(INT8)                                                \
  extern "C" int rt_paged_decode_attention(                                   \
      int dtype, const void* q, const void* k_pool, const void* v_pool,       \
      const void* k_scale, const void* v_scale, const void* tables,           \
      const void* positions, void* out, void* part_acc, void* part_ml,        \
      int batch, int n_heads, int n_kv, int dh, int page_size, int n_tables,  \
      int pages_per_split, int n_splits, float sm_scale, void* stream) {      \
    const Geometry g = make_geometry(1, n_heads, n_kv, page_size, n_tables,   \
                                     1, pages_per_split, n_splits, sm_scale); \
    return dispatch<INT8>(false, dtype, batch, dh, g, q, k_pool, v_pool,      \
                          k_scale, v_scale, tables, positions, out, part_acc, \
                          part_ml, stream);                                   \
  }                                                                           \
  extern "C" int rt_paged_window_attention(                                   \
      int dtype, const void* q, const void* k_pool, const void* v_pool,       \
      const void* k_scale, const void* v_scale, const void* tables,           \
      const void* positions, void* out, void* part_acc, void* part_ml,        \
      int batch, int s, int n_heads, int n_kv, int dh, int page_size,         \
      int n_tables, int block_q, int pages_per_split, int n_splits,           \
      float sm_scale, void* stream) {                                         \
    const Geometry g =                                                        \
        make_geometry(s, n_heads, n_kv, page_size, n_tables, block_q,         \
                      pages_per_split, n_splits, sm_scale);                   \
    return dispatch<INT8>(true, dtype, batch, dh, g, q, k_pool, v_pool,       \
                          k_scale, v_scale, tables, positions, out, part_acc, \
                          part_ml, stream);                                   \
  }
