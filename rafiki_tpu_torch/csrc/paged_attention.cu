// Paged attention over f32 and bf16 KV pools, for Hopper (sm_90a): the
// instances of paged_attention.cuh whose pools share q's element type.
// The design and what bounds the kernels: see the header. Replaces
// rafiki_tpu/ops/paged_attention.py _paged_decode_kernel and
// _paged_window_kernel (quantized=False).

#include "paged_attention.cuh"

RT_PAGED_ENTRIES(false)
