"""Paged attention straight off a block-table KV pool.

Ports ``rafiki_tpu/ops/paged_attention.py``:

- :func:`paged_decode_attention` ← ``paged_decode_attention`` (Pallas
  ``_paged_decode_kernel``): one query token per slot, the generation hot
  loop.
- :func:`paged_window_attention` ← ``paged_window_attention`` (Pallas
  ``_paged_window_kernel``): an s >= 1 window per slot with a per-row
  causal horizon (chunked prefill).
- :func:`_paged_attention_reference` / :func:`_paged_window_reference` ←
  the same-named XLA oracles: gather the pages into logical order and run
  the masked softmax in f32. These are the kernels' plain versions.
- :func:`kv_cache_write` ← ``kv_cache_write``, an in-place ``index_put_``.

Both wrappers keep the JAX signatures and layouts. A tensor on the CPU
runs the plain version; any other device launches the hand-written CUDA
kernel in ``csrc/paged_attention.cu`` (built by ``ops/_build.py`` at first
use) or raises — there is no silent fallback. Each wrapper counts its
kernel launches in a plain integer attribute, ``launches``.

The int8 KV pool (``k_scale``/``v_scale``) is accepted by the signatures
and raises ``NotImplementedError`` in this slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rafiki_tpu_torch.ops import _build
from rafiki_tpu_torch.ops.attention import NEG_INF
from rafiki_tpu_torch.ops.common import KERNEL_DTYPES as _DTYPE_CODES
from rafiki_tpu_torch.ops.common import check_launch as _raise_on
from rafiki_tpu_torch.ops.common import gqa_repeat_factor
from rafiki_tpu_torch.ops.common import runs_kernel as _runs_kernel

#: query rows (window tokens x GQA rep) one window-kernel block carries
_WINDOW_ROWS = 128


def kv_cache_write(cache: torch.Tensor, idx0: torch.Tensor,
                   idx1: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``cache[idx0[b, i], idx1[b, i]] = values[b, i]`` in place — ``(pool
    page, page slot)`` indices for the paged layout, ``(batch row,
    position)`` for the contiguous one. Returns ``cache``.

    The JAX version returns an updated copy that the compiled step
    donates; the port writes into the live cache tensor instead, so no
    second cache is ever allocated. Duplicate indices (idle rows re-fed at
    their own position) carry identical values, so which write lands does
    not matter."""
    return cache.index_put_((idx0.long(), idx1.long()),
                            values.to(cache.dtype))


def _check_int8(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV pools (k_scale/v_scale) are not ported yet")


def _check_shapes(q, k_pool, v_pool, page_tables, positions, s) -> None:
    b, n_heads, dh = q.shape[0], q.shape[-2], q.shape[-1]
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool/v_pool must share one (n_pages, "
                         f"page_size, n_kv, dh) shape, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if k_pool.shape[3] != dh:
        raise ValueError(f"head_dim mismatch: q has {dh}, pool "
                         f"{k_pool.shape[3]}")
    gqa_repeat_factor(n_heads, k_pool.shape[2])
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables must be (b={b}, n_tables), got "
                         f"{tuple(page_tables.shape)}")
    want = (b,) if s is None else (b, s)
    if tuple(positions.shape) != want:
        raise ValueError(f"positions must be {want}, got "
                         f"{tuple(positions.shape)}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rt_paged_decode_attention.argtypes = (
        [i32] + [ptr] * 6 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.rt_paged_decode_attention.restype = i32
    lib.rt_paged_window_attention.argtypes = (
        [i32] + [ptr] * 6 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.rt_paged_window_attention.restype = i32
    return lib


def _cuda_operands(q, k_pool, v_pool, page_tables, positions):
    """Validate what the kernel takes (it checks nothing itself) and
    return contiguous q/tables/positions. The pools must already be
    contiguous: they are the live cache, never copied."""
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_tables", page_tables),
                    ("positions", positions)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q/k_pool/v_pool must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("k_pool/v_pool must be contiguous")
    return q.contiguous(), page_tables.contiguous(), positions.contiguous()


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_tables: torch.Tensor,
                           positions: torch.Tensor, sm_scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token decode attention straight off a paged KV pool.

    - ``q``: (b, n_heads, dh) — this step's query vector per slot.
    - ``k_pool``/``v_pool``: (n_pages, page_size, n_kv_heads, dh), the
      per-layer pool, float32 or bfloat16.
    - ``page_tables``: (b, n_tables) int32 logical→pool page map; dead
      entries point at a valid page (the engine keeps them at 0, its
      scratch page). The table may be a live-width slice narrower than
      ``max_len / page_size``.
    - ``positions``: (b,) int32; keys ``k_pos <= positions[i]`` are
      visible to slot i.

    Returns (b, n_heads, dh) in ``q``'s dtype; q head h reads kv head
    ``h // rep``."""
    _check_int8(k_scale, v_scale)
    if q.dim() != 3:
        raise ValueError(f"q must be (b, n_heads, dh), got "
                         f"{tuple(q.shape)}")
    _check_shapes(q, k_pool, v_pool, page_tables, positions, None)
    if not _runs_kernel(q):
        return _paged_attention_reference(q, k_pool, v_pool, page_tables,
                                          positions, sm_scale)
    lib = _library()
    q, page_tables, positions = _cuda_operands(q, k_pool, v_pool,
                                               page_tables, positions)
    b, n_heads, dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.rt_paged_decode_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b, n_heads, k_pool.shape[2], dh,
            k_pool.shape[1], page_tables.shape[1], float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_window_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_tables: torch.Tensor,
                           positions: torch.Tensor, sm_scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Multi-token window attention straight off a paged KV pool.

    - ``q``: (b, s, n_heads, dh) — a window of s query vectors per slot.
    - pools and ``page_tables``: as in :func:`paged_decode_attention`;
      the window's own K/V rows are already written into the pool.
    - ``positions``: (b, s) int32 absolute positions, NONDECREASING along
      each row (the engine repeats the last real entry into overhang
      rows); row i sees keys ``k_pos <= positions[b, i]``.

    Returns (b, s, n_heads, dh) in ``q``'s dtype. With s == 1 the kernel
    computes bit for bit what :func:`paged_decode_attention` computes
    (both run one block body)."""
    _check_int8(k_scale, v_scale)
    if q.dim() != 4:
        raise ValueError(f"q must be (b, s, n_heads, dh), got "
                         f"{tuple(q.shape)}")
    _check_shapes(q, k_pool, v_pool, page_tables, positions, q.shape[1])
    if not _runs_kernel(q):
        return _paged_window_reference(q, k_pool, v_pool, page_tables,
                                       positions, sm_scale)
    lib = _library()
    q, page_tables, positions = _cuda_operands(q, k_pool, v_pool,
                                               page_tables, positions)
    b, s, n_heads, dh = q.shape
    out = torch.empty_like(q)
    rep = n_heads // k_pool.shape[2]
    block_q = min(s, max(1, _WINDOW_ROWS // rep))
    with torch.cuda.device(q.device):
        err = lib.rt_paged_window_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b, s, n_heads, k_pool.shape[2], dh,
            k_pool.shape[1], page_tables.shape[1], block_q,
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_window_attention")
    paged_window_attention.launches += 1
    return out


paged_window_attention.launches = 0


def _paged_window_reference(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_tables: torch.Tensor,
                            positions: torch.Tensor,
                            sm_scale: float) -> torch.Tensor:
    """Plain window version: gather the pages back into logical order
    and run the per-row masked softmax in f32."""
    b, s, n_heads, dh = q.shape
    _, page_size, n_kv, _ = k_pool.shape
    rep = gqa_repeat_factor(n_heads, n_kv)
    length = page_tables.shape[1] * page_size
    tabs = page_tables.long()

    def rows(pool):  # (b, length, n_kv, dh) logical view
        return pool[tabs].reshape(b, length, n_kv, dh).float() \
            .repeat_interleave(rep, dim=2)

    k, v = rows(k_pool), rows(v_pool)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * sm_scale
    k_pos = torch.arange(length, device=q.device)[None, None, None, :]
    t = positions.long()[:, None, :, None]  # (b, 1, s, 1)
    scores = torch.where(k_pos <= t, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def _paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_tables: torch.Tensor,
                               positions: torch.Tensor,
                               sm_scale: float) -> torch.Tensor:
    """Plain single-token version: the window version at s == 1."""
    return _paged_window_reference(q[:, None], k_pool, v_pool, page_tables,
                                   positions[:, None], sm_scale)[:, 0]
