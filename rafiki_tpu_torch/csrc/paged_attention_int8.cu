// Paged attention over int8 KV pools with f32 per-row scales, for Hopper
// (sm_90a): the instances of paged_attention.cuh for the int8 pool of
// kv_cache_int8 serving, with f32 and bf16 queries. A translation unit of
// its own, so it builds beside the f32/bf16 one. The design and what bounds
// the kernels: see the header. Replaces rafiki_tpu/ops/paged_attention.py
// _paged_decode_kernel and _paged_window_kernel (quantized=True).

#include "paged_attention.cuh"

RT_PAGED_ENTRIES(true)
