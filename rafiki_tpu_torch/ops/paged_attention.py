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
kernels of ``csrc/paged_attention.cuh`` (the libraries of
``paged_attention.cu`` and ``paged_attention_int8.cu``, built by
``ops/_build.py`` at first use) or raises — there is no silent fallback. The kernels split each
slot's pages over several blocks (:func:`_split_plan`, from shapes alone)
and merge the splits' partial softmax states in a second, deterministic
pass; :func:`_paged_split_reference` is the plain model of that split and
merge, held against the JAX kernels on the CPU. Each wrapper counts its
calls that launch the kernels in a plain integer attribute, ``launches``
(one per call, merge pass or not).

An int8 pool (the ``kv_cache_int8`` branch, ``quantized=True`` in the
Pallas kernels) comes with ``k_scale``/``v_scale``, one f32 absmax scale
per (page, slot, kv head) row: the plain versions dequantize each row as
the JAX oracles do (``int8 · scale`` in f32), and on the card the int8
instances of the same kernels (``csrc/paged_attention_int8.cu``) scale the
rows inside the softmax math. :func:`_paged_int8_mma_reference` is the
plain model of their bf16-query numerics.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from rafiki_tpu_torch.ops import _build
from rafiki_tpu_torch.ops.attention import HEAD_DIMS, NEG_INF, _bf16_terms
from rafiki_tpu_torch.ops.common import KERNEL_DTYPES as _DTYPE_CODES
from rafiki_tpu_torch.ops.common import check_launch as _raise_on
from rafiki_tpu_torch.ops.common import gqa_repeat_factor
from rafiki_tpu_torch.ops.common import runs_kernel as _runs_kernel

#: keys per pipeline stage of the kernels: a split is a whole number of them
_TILE_KEYS = 64
#: page sizes the kernels take: every power of two up to 128, the divisors
#: of the LlamaLoRA knobs' max_len (head dims: the flash kernels' HEAD_DIMS,
#: every head dim the templates' knobs give)
_PAGE_SIZES = tuple(1 << i for i in range(8))
#: blocks the split plan aims for: a few per SM of an H100 (132 SMs), so
#: every SM keeps loads in flight through the whole call
_TARGET_BLOCKS = 4 * 132


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


def _check_shapes(q, k_pool, v_pool, page_tables, positions, s,
                  k_scale=None, v_scale=None) -> None:
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
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None:
        rows = tuple(k_pool.shape[:3])
        if tuple(k_scale.shape) != rows or tuple(v_scale.shape) != rows:
            raise ValueError(f"k_scale/v_scale must be (n_pages, page_size, "
                             f"n_kv) = {rows}, got {tuple(k_scale.shape)} / "
                             f"{tuple(v_scale.shape)}")


def _tile_rows(dtype: torch.dtype, dh: int) -> int:
    """Query rows (window tokens x GQA rep) one kernel block carries at
    most: eight 16-row warp fragments; the f32 body also keeps its rows in
    shared memory, so it takes half, and a quarter above dh = 128 (its K/V
    ring alone is 192 KB at dh = 192)."""
    if dtype == torch.bfloat16:
        return 128
    return 64 if dh <= 128 else 32


def _split_plan(b: int, n_kv: int, n_qtiles: int, n_tables: int,
                page_size: int, rows_per_tile: int) -> Tuple[int, int]:
    """``(pages_per_split, n_splits)`` of a kernel launch, from shapes
    alone (the host never reads positions back from the card).

    - A split is a whole number of units (at least one) of
      ``max(64, page_size)`` keys: whole 64-key tiles and whole pages, so
      no tile straddles two splits and a page of 128 keys (two tiles) is
      never cut; the splits cover all ``n_tables`` columns, the last one
      possibly short.
    - The grid (kv heads x slots x query tiles x splits) aims for
      ``_TARGET_BLOCKS`` blocks.
    - Each split writes ``rows_per_tile`` f32 partial rows of dh + 2 and
      the merge reads them back: a split keeps at least 4 keys per row, so
      that traffic stays under half of the split's K/V bytes. A window
      tile of 128 rows therefore takes splits of 512 keys or more, and a
      decode tile (rep rows) is held only by the 64-key tile.

    A decode call and a window of one give the same arguments, hence the
    same plan."""
    unit_pages = max(1, _TILE_KEYS // page_size)
    unit_keys = unit_pages * page_size
    n_units = -(-n_tables // unit_pages)
    base = b * n_kv * n_qtiles
    want = -(-_TARGET_BLOCKS // max(1, base))
    min_units = max(1, -(-4 * rows_per_tile // unit_keys))
    n_splits = max(1, min(want, n_units // min_units))
    units_per_split = -(-n_units // n_splits)
    n_splits = -(-n_units // units_per_split)
    return units_per_split * unit_pages, n_splits


class _Plan(NamedTuple):
    block_q: int          # window tokens per query tile
    pages_per_split: int
    n_splits: int
    blocks: int           # blocks of the split kernel's grid


def _launch_plan(b: int, s: int, n_heads: int, n_kv: int, n_tables: int,
                 page_size: int, dtype: torch.dtype, dh: int) -> _Plan:
    """The query tiling and split plan of one call (``s == 1`` for the
    decode kernel, which therefore plans exactly as a window of one)."""
    rep = n_heads // n_kv
    block_q = min(s, max(1, _tile_rows(dtype, dh) // rep))
    n_qtiles = -(-s // block_q)
    pps, n_splits = _split_plan(b, n_kv, n_qtiles, n_tables, page_size,
                                block_q * rep)
    return _Plan(block_q, pps, n_splits, n_kv * b * n_qtiles * n_splits)


def _check_kernel_shapes(dh: int, page_size: int, rep: int,
                         dtype: torch.dtype) -> None:
    """What the CUDA kernels are compiled for; anything else raises."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"the paged-attention kernels take head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if page_size not in _PAGE_SIZES:
        raise ValueError(f"the paged-attention kernels take page_size in "
                         f"{_PAGE_SIZES}, got {page_size}")
    rows = _tile_rows(dtype, dh)
    if rep > rows:
        raise ValueError(f"the paged-attention kernels take at most {rows} "
                         f"query heads per kv head for {dtype} at head_dim "
                         f"{dh}, got {rep}")


def _workspace(q: torch.Tensor, n_rows: int, n_splits: int, dh: int):
    """The split partials (acc, then (m, l)) in f32, or ``(None, None)``
    with one split: the kernels allocate nothing themselves."""
    if n_splits == 1:
        return None, None
    return (torch.empty((n_rows, n_splits, dh), dtype=torch.float32,
                        device=q.device),
            torch.empty((n_rows, n_splits, 2), dtype=torch.float32,
                        device=q.device))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _library(int8: bool = False) -> ctypes.CDLL:
    """The kernels' library: ``paged_attention`` (pools of q's type) or
    ``paged_attention_int8`` (int8 pools and their scales). Both export
    the same two entries."""
    lib = _build.library("paged_attention_int8" if int8
                         else "paged_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rt_paged_decode_attention.argtypes = (
        [i32] + [ptr] * 10 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.rt_paged_decode_attention.restype = i32
    lib.rt_paged_window_attention.argtypes = (
        [i32] + [ptr] * 10 + [i32] * 10 + [ctypes.c_float, ptr])
    lib.rt_paged_window_attention.restype = i32
    return lib


def _cuda_operands(q, k_pool, v_pool, page_tables, positions, k_scale,
                   v_scale):
    """Validate what the kernel takes (it checks nothing itself) and
    return contiguous q/tables/positions. The pools and scales must
    already be contiguous: they are the live cache, never copied."""
    dev = q.device
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("page_tables", page_tables), ("positions", positions)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
    if k_scale is None:
        if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
                or v_pool.dtype != q.dtype:
            raise TypeError(f"q/k_pool/v_pool must share float32 or "
                            f"bfloat16 (or the pools be int8 with "
                            f"k_scale/v_scale), got {q.dtype}/"
                            f"{k_pool.dtype}/{v_pool.dtype}")
    else:
        if q.dtype not in _DTYPE_CODES or k_pool.dtype != torch.int8 \
                or v_pool.dtype != torch.int8:
            raise TypeError(f"with k_scale/v_scale the pools must be int8 "
                            f"and q float32 or bfloat16, got {q.dtype}/"
                            f"{k_pool.dtype}/{v_pool.dtype}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"k_scale/v_scale must be float32, got "
                            f"{k_scale.dtype}/{v_scale.dtype}")
        if not (k_scale.is_contiguous() and v_scale.is_contiguous()):
            raise ValueError("k_scale/v_scale must be contiguous")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("k_pool/v_pool must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("k_pool/v_pool must start 16-byte aligned (the "
                         "kernels copy pool rows in 16-, 8- or 4-byte "
                         "pieces)")
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
      per-layer pool: float32 or bfloat16 (q's type on the card), or int8
      with ``k_scale``/``v_scale``, the f32 absmax scales of its rows,
      (n_pages, page_size, n_kv_heads) each (both or neither).
    - ``page_tables``: (b, n_tables) int32 logical→pool page map; dead
      entries point at a valid page (the engine keeps them at 0, its
      scratch page). The table may be a live-width slice narrower than
      ``max_len / page_size``.
    - ``positions``: (b,) int32; keys ``k_pos <= positions[i]`` are
      visible to slot i.

    Returns (b, n_heads, dh) in ``q``'s dtype; q head h reads kv head
    ``h // rep``."""
    if q.dim() != 3:
        raise ValueError(f"q must be (b, n_heads, dh), got "
                         f"{tuple(q.shape)}")
    _check_shapes(q, k_pool, v_pool, page_tables, positions, None, k_scale,
                  v_scale)
    if not _runs_kernel(q):
        return _paged_attention_reference(q, k_pool, v_pool, page_tables,
                                          positions, sm_scale, k_scale,
                                          v_scale)
    lib = _library(k_scale is not None)
    q, page_tables, positions = _cuda_operands(
        q, k_pool, v_pool, page_tables, positions, k_scale, v_scale)
    b, n_heads, dh = q.shape
    _, page, n_kv, _ = k_pool.shape
    _check_kernel_shapes(dh, page, n_heads // n_kv, q.dtype)
    plan = _launch_plan(b, 1, n_heads, n_kv, page_tables.shape[1], page,
                        q.dtype, dh)
    out = torch.empty_like(q)
    acc, ml = _workspace(q, b * n_heads, plan.n_splits, dh)
    with torch.cuda.device(q.device):
        err = lib.rt_paged_decode_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            _ptr(acc), _ptr(ml), b, n_heads, n_kv, dh, page,
            page_tables.shape[1], plan.pages_per_split, plan.n_splits,
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
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
    - pools, scales and ``page_tables``: as in
      :func:`paged_decode_attention`; the window's own K/V rows are
      already written into the pool.
    - ``positions``: (b, s) int32 absolute positions, NONDECREASING along
      each row (the engine repeats the last real entry into overhang
      rows); row i sees keys ``k_pos <= positions[b, i]``.

    Returns (b, s, n_heads, dh) in ``q``'s dtype. With s == 1 the kernel
    computes bit for bit what :func:`paged_decode_attention` computes
    (both run one block body)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (b, s, n_heads, dh), got "
                         f"{tuple(q.shape)}")
    _check_shapes(q, k_pool, v_pool, page_tables, positions, q.shape[1],
                  k_scale, v_scale)
    if not _runs_kernel(q):
        return _paged_window_reference(q, k_pool, v_pool, page_tables,
                                       positions, sm_scale, k_scale, v_scale)
    lib = _library(k_scale is not None)
    q, page_tables, positions = _cuda_operands(
        q, k_pool, v_pool, page_tables, positions, k_scale, v_scale)
    b, s, n_heads, dh = q.shape
    _, page, n_kv, _ = k_pool.shape
    _check_kernel_shapes(dh, page, n_heads // n_kv, q.dtype)
    plan = _launch_plan(b, s, n_heads, n_kv, page_tables.shape[1], page,
                        q.dtype, dh)
    out = torch.empty_like(q)
    acc, ml = _workspace(q, b * s * n_heads, plan.n_splits, dh)
    with torch.cuda.device(q.device):
        err = lib.rt_paged_window_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            _ptr(acc), _ptr(ml), b, s, n_heads, n_kv, dh, page,
            page_tables.shape[1], plan.block_q, plan.pages_per_split,
            plan.n_splits, float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_window_attention")
    paged_window_attention.launches += 1
    return out


paged_window_attention.launches = 0


def _rows(pool, scale, tabs, rep):
    """A pool gathered into logical order, (b, length, n_heads, dh) f32,
    each row times its scale when the pool is int8 (the JAX oracles'
    ``rows(k).astype(f32) * rows(k_scale)[..., None]``), the kv heads
    repeated ``rep`` times."""
    b, n_tab = tabs.shape
    _, page_size, n_kv, dh = pool.shape
    x = pool[tabs].reshape(b, n_tab * page_size, n_kv, dh).float()
    if scale is not None:
        x = x * scale[tabs].reshape(b, n_tab * page_size, n_kv)[..., None]
    return x.repeat_interleave(rep, dim=2)


def _position_mask(positions, length):
    """(b, 1, s, length): key ``k`` is visible to row ``i`` when ``k <=
    positions[b, i]``."""
    k_pos = torch.arange(length, device=positions.device)
    return k_pos[None, None, None, :] <= positions.long()[:, None, :, None]


def _masked_scores(q, k_pool, v_pool, page_tables, positions, sm_scale,
                   k_scale=None, v_scale=None):
    """The pages gathered into logical order and the f32 scores of every
    (query row, key), masked to ``NEG_INF`` past each row's position:
    ``(scores (b, h, s, length), v (b, length, h, dh))``. int8 pools are
    dequantized row by row in f32 first."""
    rep = gqa_repeat_factor(q.shape[2], k_pool.shape[2])
    tabs = page_tables.long()
    k = _rows(k_pool, k_scale, tabs, rep)
    v = _rows(v_pool, v_scale, tabs, rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * sm_scale
    mask = _position_mask(positions, k.shape[1])
    return torch.where(mask, scores, NEG_INF), v


def _paged_window_reference(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_tables: torch.Tensor,
                            positions: torch.Tensor, sm_scale: float,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain window version: gather the pages back into logical order
    (dequantizing an int8 pool's rows in f32) and run the per-row masked
    softmax in f32."""
    scores, v = _masked_scores(q, k_pool, v_pool, page_tables, positions,
                               sm_scale, k_scale, v_scale)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def _split_partials(q, k_pool, v_pool, page_tables, positions, sm_scale,
                    pages_per_split, k_scale=None, v_scale=None):
    """Each split's online-softmax state over its keys, as the kernels
    leave it: ``(m, l, acc)``, stacked over splits in order, with ``m``
    and ``l`` (n_splits, b, h, s, 1) and ``acc`` (n_splits, b, h, s, dh),
    all f32. A row that sees no key of a split keeps the finite
    ``NEG_INF`` as its max there, and its ``l`` counts the masked keys
    (each weighs exp(0) = 1), as the JAX kernels' running state does."""
    scores, v = _masked_scores(q, k_pool, v_pool, page_tables, positions,
                               sm_scale, k_scale, v_scale)
    step = pages_per_split * k_pool.shape[1]
    ms, ls, accs = [], [], []
    for k0 in range(0, scores.shape[-1], step):
        sc = scores[..., k0:k0 + step]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p,
                                 v[:, k0:k0 + step]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def _merge_partials(m: torch.Tensor, l: torch.Tensor,
                    acc: torch.Tensor) -> torch.Tensor:
    """The merge pass: ``M = max m``, each split weighted by
    ``exp(m - M)`` (exactly 0 for a split whose ``m`` is ``NEG_INF``,
    since split 0 holds key 0, which every row sees), ``sum acc·w /
    max(sum l·w, 1e-30)``. Returns (b, h, s, dh) f32."""
    w = torch.exp(m - m.amax(dim=0))
    return (acc * w).sum(dim=0) / (l * w).sum(dim=0).clamp_min(1e-30)


def _paged_split_reference(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_tables: torch.Tensor,
                           positions: torch.Tensor, sm_scale: float,
                           pages_per_split: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain model of the kernels' split over pages and their merge, in
    f32, for a window ``q`` (b, s, n_heads, dh) with positions (b, s) (a
    decode call is the window of one): the table's columns cut into
    splits of ``pages_per_split`` pages, each split's softmax state
    (:func:`_split_partials`), then :func:`_merge_partials`. The tests
    hold it against the JAX kernels; nothing on the serving path calls
    it."""
    out = _merge_partials(*_split_partials(q, k_pool, v_pool, page_tables,
                                           positions, sm_scale,
                                           pages_per_split, k_scale,
                                           v_scale))
    return out.transpose(1, 2).to(q.dtype)


def _paged_int8_mma_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor,
                              page_tables: torch.Tensor,
                              positions: torch.Tensor, sm_scale: float,
                              pages_per_split: int, p_terms: int = 2,
                              dequant_bf16: bool = False) -> torch.Tensor:
    """Plain model of the int8 kernels' bf16-query numerics, for a window
    ``q`` (b, s, n_heads, dh) bf16 over int8 pools: per split, the f32
    scores ``k_scale_j · (q · int8_j)`` (bf16 × int8 products are exact,
    the sums f32) times ``sm_scale``; the split's softmax state; P·V as
    ``Σ_j terms(p_j · v_scale_j) · int8_j``, with ``p_j · v_scale_j``
    carried as ``p_terms`` bf16 terms (2: hi + lo, the kernel's; 1: one
    rounding); the splits merged as :func:`_merge_partials` does and the
    output rounded once to q's dtype.

    ``dequant_bf16`` models the design the kernel avoids: K and V
    dequantized in f32 and rounded to bf16 before the products (P still
    hi + lo). The tests hold this model, and not that one, within the
    bf16 tolerance of the plain version."""
    rep = gqa_repeat_factor(q.shape[2], k_pool.shape[2])
    tabs = page_tables.long()
    if dequant_bf16:
        k = _rows(k_pool, k_scale, tabs, rep).bfloat16().float()
        v = _rows(v_pool, v_scale, tabs, rep).bfloat16().float()
        ks = vs = torch.ones(k.shape[:3], device=q.device)
    else:
        k = _rows(k_pool, None, tabs, rep)
        v = _rows(v_pool, None, tabs, rep)
        ks = _rows(k_scale[..., None], None, tabs, rep)[..., 0]
        vs = _rows(v_scale[..., None], None, tabs, rep)[..., 0]
    raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), k)
    scores = raw * ks.permute(0, 2, 1)[:, :, None, :] * sm_scale
    scores = torch.where(_position_mask(positions, k.shape[1]), scores,
                         NEG_INF)
    step = pages_per_split * k_pool.shape[1]
    ms, ls, accs = [], [], []
    for k0 in range(0, scores.shape[-1], step):
        sc = scores[..., k0:k0 + step]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        pv = _bf16_terms(p * vs[:, k0:k0 + step].permute(0, 2, 1)[:, :, None],
                         p_terms)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", pv,
                                 v[:, k0:k0 + step]))
    out = _merge_partials(torch.stack(ms), torch.stack(ls),
                          torch.stack(accs))
    return out.transpose(1, 2).to(q.dtype)


def _paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_tables: torch.Tensor,
                               positions: torch.Tensor, sm_scale: float,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain single-token version: the window version at s == 1."""
    return _paged_window_reference(q[:, None], k_pool, v_pool, page_tables,
                                   positions[:, None], sm_scale, k_scale,
                                   v_scale)[:, 0]
