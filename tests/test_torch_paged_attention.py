"""Port parity: the paged-attention ops of ``rafiki_tpu_torch`` against the
JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as its own tests do. The
same numpy inputs (from a seed) feed both. Tolerance: 1e-5 absolute at
f32 — the two sides sum in different orders (the kernel merges page
partials by LSE, the plain version soft-maxes the gathered row).

int8 pools (``k_scale``/``v_scale``, the ``kv_cache_int8`` branch) are
held the same way at pages 1, 4, 16 and 128 and head dims 8 and 128, and
``_paged_int8_mma_reference``, the plain model of the int8 kernels'
bf16-query numerics, against the plain version within the bf16
tolerance.

The CUDA kernels split each slot's pages over blocks and merge the
splits' softmax states: ``_split_plan`` (shapes in, plan out) and the
plain model of that split and merge, ``_paged_split_reference``, are held
here — the model against the JAX kernels, over splits of 1, 2 and 3
pages, positions on and beside split boundaries, and window rows that see
no key of a split.

The CUDA kernels themselves run only on the card:
``tests/test_torch_kernels_cuda.py`` holds them against these plain
versions there.
"""

import contextlib
import functools
import types

import numpy as np
import pytest
import torch

from rafiki_tpu.ops.paged_attention import \
    paged_decode_attention as jax_decode
from rafiki_tpu.ops.paged_attention import \
    paged_window_attention as jax_window
from rafiki_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

ATOL = 1e-5
PAGE = 4
MAX_LEN = 32  # a full table would be MAX_LEN // PAGE = 8 columns


def _pool_case(seed, n_heads, n_kv, dh, last_positions, n_tab):
    """Pools with garbage on scratch page 0, and one table row per slot
    whose live pages (``t // PAGE + 1``) are distinct random pool pages;
    dead entries point at page 0. ``n_tab`` columns: a live-width slice
    when it is below ``MAX_LEN // PAGE``."""
    rng = np.random.default_rng(seed)
    b = len(last_positions)
    n_live = [t // PAGE + 1 for t in last_positions]
    n_pages = 1 + sum(n_live) + 3
    shape = (n_pages, PAGE, n_kv, dh)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    k_pool[0] = 1e3 * rng.standard_normal(shape[1:])  # scratch garbage
    v_pool[0] = 1e3 * rng.standard_normal(shape[1:])
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((b, n_tab), np.int32)
    used = 0
    for i, n in enumerate(n_live):
        tables[i, :n] = perm[used:used + n]
        used += n
    return rng, k_pool, v_pool, tables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_kv", [4, 2, 1], ids=["rep1", "rep2", "rep4"])
def test_decode_matches_jax_kernel(n_kv):
    """GQA rep 1/2/4, partial last pages (positions not on a page
    boundary), garbage on page 0, a live-width table (4 of 8 columns)."""
    n_heads, dh = 4, 8
    positions = np.array([0, 5, 13, 10], np.int32)
    rng, k_pool, v_pool, tables = _pool_case(0, n_heads, n_kv, dh,
                                             positions, n_tab=4)
    q = rng.standard_normal((len(positions), n_heads, dh)).astype(
        np.float32)
    sm = 1.0 / np.sqrt(dh)
    want = np.asarray(jax_decode(q, k_pool, v_pool, tables, positions,
                                 sm_scale=sm, interpret=True))
    got = pa.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool),
                                    _t(tables), _t(positions), sm).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got).max() < 10  # the page-0 garbage never leaked in


@pytest.mark.parametrize("n_kv", [4, 2, 1], ids=["rep1", "rep2", "rep4"])
def test_window_matches_jax_kernel(n_kv):
    """A window per slot at nondecreasing positions: an idle row re-fed
    at position 0, a chunk whose overhang repeats its last real entry,
    and a chunk that crosses a page boundary — causal inside the
    window."""
    n_heads, dh = 4, 8
    positions = np.array([[0, 0, 0, 0, 0],
                          [3, 4, 5, 6, 6],
                          [9, 10, 11, 12, 13]], np.int32)
    rng, k_pool, v_pool, tables = _pool_case(1, n_heads, n_kv, dh,
                                             positions[:, -1], n_tab=4)
    q = rng.standard_normal(positions.shape + (n_heads, dh)).astype(
        np.float32)
    sm = 1.0 / np.sqrt(dh)
    want = np.asarray(jax_window(q, k_pool, v_pool, tables, positions,
                                 sm_scale=sm, interpret=True))
    got = pa.paged_window_attention(_t(q), _t(k_pool), _t(v_pool),
                                    _t(tables), _t(positions), sm).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_window_of_one_equals_step():
    """s == 1: the window op returns exactly what the step op returns
    (and matches JAX's s == 1 window kernel)."""
    n_heads, n_kv, dh = 4, 2, 8
    positions = np.array([2, 7, 12], np.int32)
    rng, k_pool, v_pool, tables = _pool_case(2, n_heads, n_kv, dh,
                                             positions, n_tab=8)
    q = rng.standard_normal((3, n_heads, dh)).astype(np.float32)
    sm = 1.0 / np.sqrt(dh)
    step = pa.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool),
                                     _t(tables), _t(positions), sm)
    win = pa.paged_window_attention(_t(q[:, None]), _t(k_pool),
                                    _t(v_pool), _t(tables),
                                    _t(positions[:, None]), sm)[:, 0]
    assert torch.equal(step, win)
    want = np.asarray(jax_window(q[:, None], k_pool, v_pool, tables,
                                 positions[:, None], sm_scale=sm,
                                 interpret=True))[:, 0]
    np.testing.assert_allclose(win.numpy(), want, atol=ATOL, rtol=0)


def test_bf16_plain_version_computes_in_f32():
    """bf16 pools: the plain version widens to f32 and rounds the output
    once to q's dtype — equal to running it on the widened inputs."""
    n_heads, n_kv, dh = 4, 2, 8
    positions = np.array([6, 11], np.int32)
    rng, k_pool, v_pool, tables = _pool_case(3, n_heads, n_kv, dh,
                                             positions, n_tab=4)
    q = rng.standard_normal((2, n_heads, dh)).astype(np.float32)
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k_pool, v_pool))
    got = pa.paged_decode_attention(qb, kb, vb, _t(tables), _t(positions),
                                    0.25)
    ref = pa.paged_decode_attention(qb.float(), kb.float(), vb.float(),
                                    _t(tables), _t(positions), 0.25)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.bfloat16())


def test_kv_cache_write_in_place():
    """``cache[idx0, idx1] = values``, written into the live tensor."""
    rng = np.random.default_rng(4)
    cache = np.zeros((5, PAGE, 2, 8), np.float32)
    idx0 = np.array([[1, 1], [3, 0]], np.int32)
    idx1 = np.array([[2, 3], [0, 1]], np.int32)
    vals = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    ct = _t(cache.copy())
    out = pa.kv_cache_write(ct, _t(idx0), _t(idx1), _t(vals))
    cache[idx0, idx1] = vals
    assert out is ct
    np.testing.assert_array_equal(ct.numpy(), cache)


# ------------------------------------------------------ int8 pools

def _q8(u):
    """K/V rows as the JAX cache writes them: int8 and one f32 absmax
    scale per row."""
    scale = np.maximum(np.abs(u).max(-1), 1e-8) / np.float32(127)
    q = np.clip(np.round(u / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def _int8_case(seed, page, dh, last, n_kv=2, n_heads=4, s=None,
               magnitude=(1.0, 1.0)):
    """An int8 pool quantized from f32 rows (K and V of the two
    ``magnitude`` standard deviations), with
    garbage rows and huge scales on scratch page 0, a table 1 column past
    the longest slot, and q of (b, n_heads, dh) or, with ``s``, a window
    (b, s, n_heads, dh) ending at each slot's position whose last row
    repeats (overhang); positions (b,) or (b, s)."""
    rng = np.random.default_rng(seed)
    n_live = last // page + 1
    n_pages = 1 + int(n_live.sum()) + 2
    shape = (n_pages, page, n_kv, dh)
    kq, ks = _q8(magnitude[0] * rng.standard_normal(shape).astype(
        np.float32))
    vq, vs = _q8(magnitude[1] * rng.standard_normal(shape).astype(
        np.float32))
    ks[0], vs[0] = 1e3, -1e3
    tables = np.zeros((len(last), int(n_live.max()) + 1), np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for i, n in enumerate(n_live):
        tables[i, :n] = perm[used:used + n]
        used += n
    if s is None:
        q = rng.standard_normal((len(last), n_heads, dh))
        pos = last
    else:
        q = rng.standard_normal((len(last), s, n_heads, dh))
        pos = np.maximum(0, last[:, None] - np.arange(s - 2, -2, -1)[None])
        pos[:, -1] = pos[:, -2]
    return (q.astype(np.float32), kq, vq, ks, vs, tables,
            pos.astype(np.int32))


#: positions per page size: on and beside page and 64-key tile bounds
_INT8_LAST = {1: [0, 5, 63, 64], 4: [3, 17, 64, 70], 16: [0, 31, 100, 130],
              128: [5, 127, 128, 300]}


@pytest.mark.parametrize("dh", [8, 128])
@pytest.mark.parametrize("page", [1, 4, 16, 128])
def test_int8_decode_matches_jax_kernel(page, dh):
    """int8 pools with their scales: the plain decode version (each row
    dequantized in f32) against the JAX decode kernel with
    ``k_scale``/``v_scale``, f32 within 1e-5 + 1e-5·|ref|; the scratch
    page's garbage never leaks in."""
    last = np.array(_INT8_LAST[page], np.int32)
    q, kq, vq, ks, vs, tab, pos = _int8_case(page + dh, page, dh, last)
    sm = 1.0 / np.sqrt(dh)
    want = np.asarray(jax_decode(q, kq, vq, tab, pos, sm_scale=sm,
                                 k_scale=ks, v_scale=vs, interpret=True))
    got = pa.paged_decode_attention(_t(q), _t(kq), _t(vq), _t(tab), _t(pos),
                                    sm, _t(ks), _t(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(got).max() < 10


@pytest.mark.parametrize("dh", [8, 128])
@pytest.mark.parametrize("page", [1, 4, 16, 128])
def test_int8_window_matches_jax_kernel(page, dh):
    """The same for 5-token windows ending at each slot's position, the
    last row an overhang repeat, and for the split model over the plan's
    splits (forced to several: one kv head, a small batch)."""
    last = np.array(_INT8_LAST[page], np.int32)
    q, kq, vq, ks, vs, tab, pos = _int8_case(page * dh, page, dh, last, s=5)
    sm = 1.0 / np.sqrt(dh)
    want = np.asarray(jax_window(q, kq, vq, tab, pos, sm_scale=sm,
                                 k_scale=ks, v_scale=vs, interpret=True))
    args = (_t(q), _t(kq), _t(vq), _t(tab), _t(pos), sm)
    got = pa.paged_window_attention(*args, _t(ks), _t(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    n_tab = tab.shape[1]
    unit = max(1, pa._TILE_KEYS // page)
    split = pa._paged_split_reference(*args, unit, _t(ks), _t(vs)).numpy()
    assert -(-n_tab // unit) > 1 or page == 128
    np.testing.assert_allclose(split, want, atol=1e-5, rtol=1e-5)


def test_int8_scales_come_together_with_the_rows_shape():
    """As in JAX: k_scale without v_scale (or the reverse) raises
    ValueError, and so do scales that are not (n_pages, page_size,
    n_kv)."""
    q, kq, vq, ks, vs, tab, pos = _int8_case(0, 4, 8, np.array([5, 9]))
    args = (_t(q), _t(kq), _t(vq), _t(tab), _t(pos), 0.5)
    for kw in ({"k_scale": _t(ks)}, {"v_scale": _t(vs)}):
        with pytest.raises(ValueError, match="together"):
            pa.paged_decode_attention(*args, **kw)
    with pytest.raises(ValueError, match="k_scale/v_scale"):
        pa.paged_decode_attention(*args, _t(ks[:, :2]), _t(vs[:, :2]))
    wargs = (_t(q[:, None]),) + args[1:4] + (_t(pos[:, None]), 0.5)
    with pytest.raises(ValueError, match="together"):
        pa.paged_window_attention(*wargs, k_scale=_t(ks))


def _over_bf16_tol(got, ref):
    return ((got.float() - ref).abs()
            / (1e-3 + 2.0 ** -8 * ref.abs())).max().item()


@pytest.mark.parametrize("dh", [8, 12, 64, 128, 192])
@pytest.mark.parametrize("page", [1, 16, 128])
def test_int8_mma_model_within_bf16_tolerance(page, dh):
    """The int8 kernels' bf16-query numerics (scores ``k_scale·(q·int8)``
    in f32, ``p·v_scale`` as hi + lo bf16 terms against the int8 values,
    bf16 staging of the int8 values exact) over the split plan the
    kernels take, against the plain version in f32: every element within
    1e-3 + 2^-8·|ref| (one rounding of the output)."""
    last = np.array([0, 1, 63, 64, 300], np.int32)
    q, kq, vq, ks, vs, tab, pos = _int8_case(dh, page, dh, last,
                                             n_heads=8, s=3,
                                             magnitude=(3.0, 20.0))
    qb = _t(q).bfloat16()
    args = (_t(kq), _t(vq), _t(tab), _t(pos))
    sm = 1.0 / np.sqrt(dh)
    ref = pa._paged_window_reference(qb.float(), *args[:2], args[2],
                                     args[3], sm, _t(ks), _t(vs))
    plan = pa._launch_plan(len(last), 3, 8, 2, tab.shape[1], page,
                           torch.bfloat16, dh)
    got = pa._paged_int8_mma_reference(qb, *args[:2], _t(ks), _t(vs),
                                       *args[2:], sm, plan.pages_per_split)
    assert got.dtype == torch.bfloat16
    assert _over_bf16_tol(got, ref) <= 1.0


def test_int8_mma_model_needs_unrounded_rows_and_two_terms():
    """What decides the design: with K and V dequantized in f32 and
    rounded to bf16 before the products (the obvious way onto the tensor
    cores) the output misses the tolerance by far, and so does P·v_scale
    carried as one bf16 term; the kernel's factored scales with hi + lo
    meet it."""
    last = np.array([0, 1, 2, 40, 200], np.int32)
    q, kq, vq, ks, vs, tab, pos = _int8_case(3, 16, 64, last, s=3,
                                             magnitude=(3.0, 20.0))
    qb = _t(q).bfloat16()
    args = (_t(kq), _t(vq), _t(ks), _t(vs), _t(tab), _t(pos), 0.125, 4)
    ref = pa._paged_window_reference(qb.float(), _t(kq), _t(vq), _t(tab),
                                     _t(pos), 0.125, _t(ks), _t(vs))
    assert _over_bf16_tol(pa._paged_int8_mma_reference(qb, *args), ref) \
        <= 1.0
    assert _over_bf16_tol(pa._paged_int8_mma_reference(
        qb, *args, dequant_bf16=True), ref) > 10.0
    assert _over_bf16_tol(pa._paged_int8_mma_reference(
        qb, *args, p_terms=1), ref) > 2.0


# ------------------------------------------------- the split over pages

@pytest.mark.parametrize("shape", [
    (8, 8, 1, 128, 16, 4),     # Llama-3-8B decode, max_len 2048
    (8, 8, 1, 128, 16, 128),   # its 32-token prefill window (rep 4)
    (8, 8, 1, 9, 16, 4),       # a live-width table of 9 columns
    (8, 8, 2, 7, 8, 128),      # two query tiles, 7 columns of 8
    (1, 1, 1, 5, 64, 4),       # one block per split, 64-token pages
    (64, 32, 1, 3, 32, 16),    # the card already full: one split
    (4, 2, 1, 32, 1, 4),       # head dim 8 served at page 1 (max_len 32)
    (4, 2, 1, 8, 4, 4),        # ... at page 4
    (2, 2, 1, 16, 128, 4),     # pages of 128 keys: two tiles each
    (1, 1, 2, 5, 128, 128),    # ... a window, 5 columns
])
def test_split_plan_covers_the_table_from_shapes(shape):
    """``_split_plan`` takes shapes only and returns the same plan every
    time; its splits are whole 64-key tiles that cover the ``n_tables``
    columns exactly (the last one may be short, none is empty); a split
    keeps at least 4 keys per query row, unless the table is one tile;
    and the grid reaches ``_TARGET_BLOCKS`` unless the table runs out of
    tiles first."""
    b, n_kv, n_qtiles, n_tables, page, rows = shape
    pps, n_splits = pa._split_plan(*shape)
    assert (pps, n_splits) == pa._split_plan(*shape)
    tile_pages = max(1, pa._TILE_KEYS // page)
    assert pps % tile_pages == 0 and n_splits >= 1
    assert (pps * page) % pa._TILE_KEYS == 0  # whole tiles, whole pages
    assert (n_splits - 1) * pps < n_tables <= n_splits * pps
    n_tiles = -(-n_tables // tile_pages)
    if n_tiles > 1:
        assert pps * page >= min(4 * rows, n_tiles * tile_pages * page // 2)
    blocks = b * n_kv * n_qtiles * n_splits
    assert blocks >= pa._TARGET_BLOCKS or pps == tile_pages or \
        pps * page >= 4 * rows or n_splits == 1


class _RecordingLib:
    """Stands in for the CUDA libraries: records each entry's arguments,
    and which library (int8 pools or not) was asked for."""

    def __init__(self):
        self.calls = {}
        self.int8 = None

    def library(self, int8):
        self.int8 = int8
        return self

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture()
def recording_kernel_path(monkeypatch):
    """CPU tensors down the kernel path, into a recording library."""
    lib = _RecordingLib()
    monkeypatch.setattr(pa, "_runs_kernel", lambda t: True)
    monkeypatch.setattr(pa, "_library",
                        lambda int8=False: lib.library(int8))
    monkeypatch.setattr(pa, "_cuda_operands",
                        lambda q, k, v, tab, pos, ks, vs: (q, tab, pos))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_decode_and_window_of_one_launch_one_plan(recording_kernel_path):
    """The decode wrapper and a window of one pass the kernels the same
    plan (pages per split, splits) and shapes, and one launch each; the
    workspace exists exactly when there is more than one split."""
    lib = recording_kernel_path
    b, n_heads, n_kv, dh, page, n_tab = 8, 32, 8, 64, 16, 128
    q = torch.zeros(b, n_heads, dh, dtype=torch.bfloat16)
    pool = torch.zeros(3, page, n_kv, dh, dtype=torch.bfloat16)
    tab = torch.zeros(b, n_tab, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    launches = (pa.paged_decode_attention.launches,
                pa.paged_window_attention.launches)
    pa.paged_decode_attention(q, pool, pool, tab, pos, 0.125)
    pa.paged_window_attention(q[:, None], pool, pool, tab, pos[:, None],
                              0.125)
    assert (pa.paged_decode_attention.launches,
            pa.paged_window_attention.launches) == (launches[0] + 1,
                                                    launches[1] + 1)
    dec = lib.calls["rt_paged_decode_attention"]
    win = lib.calls["rt_paged_window_attention"]
    # (dtype, q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
    # part_acc, part_ml), then decode: (b, n_heads, n_kv, dh, page,
    # n_tables, pps, splits, scale); window: (b, s, n_heads, n_kv, dh,
    # page, n_tables, block_q, pps, splits, scale)
    assert lib.int8 is False and dec[4:6] == win[4:6] == (None, None)
    assert dec[11:17] == (b, n_heads, n_kv, dh, page, n_tab)
    assert win[11:21] == (b, 1, n_heads, n_kv, dh, page, n_tab, 1) + \
        dec[17:19]
    assert dec[17:19] == pa._split_plan(b, n_kv, 1, n_tab, page,
                                        n_heads // n_kv)
    assert dec[17:19][1] > 1
    assert all(p is not None for p in dec[9:11] + win[9:11])
    assert dec[19] == win[21] == 0.125


def test_int8_pools_launch_the_int8_library_with_the_same_plan(
        recording_kernel_path):
    """An int8 pool and its scales go to the int8 library's entries with
    the plan and shapes a bf16 pool gets: the ring holds the same tiles,
    so the split plan does not change."""
    lib = recording_kernel_path
    b, n_heads, n_kv, dh, page, n_tab = 8, 32, 8, 128, 16, 128
    q = torch.zeros(b, 1, n_heads, dh, dtype=torch.bfloat16)
    pool = torch.zeros(3, page, n_kv, dh, dtype=torch.int8)
    scale = torch.ones(3, page, n_kv)
    tab = torch.zeros(b, n_tab, dtype=torch.int32)
    pos = torch.zeros(b, 1, dtype=torch.int32)
    pa.paged_window_attention(q, pool.bfloat16(), pool.bfloat16(), tab, pos,
                              0.125)
    plain = lib.calls.pop("rt_paged_window_attention")
    assert lib.int8 is False
    pa.paged_window_attention(q, pool, pool, tab, pos, 0.125, scale, scale)
    got = lib.calls["rt_paged_window_attention"]
    assert lib.int8 is True
    assert got[4:6] == (scale.data_ptr(), scale.data_ptr())
    assert got[11:] == plain[11:]


@pytest.mark.parametrize("what,dh,page", [("head_dim", 40, 16),
                                          ("page_size", 64, 3),
                                          ("page_size", 128, 256)])
def test_kernel_path_refuses_unsupported_shapes(recording_kernel_path,
                                                what, dh, page):
    """A head dim or page size the kernels are not compiled for raises
    ValueError naming the supported values; nothing launches."""
    q = torch.zeros(2, 4, dh)
    pool = torch.zeros(3, page, 2, dh)
    tab = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: pa.paged_decode_attention(q, pool, pool, tab, pos,
                                                   0.5),
                 lambda: pa.paged_window_attention(q[:, None], pool, pool,
                                                   tab, pos[:, None], 0.5)):
        with pytest.raises(ValueError, match=what):
            call()
    assert not recording_kernel_path.calls


def test_kernel_shapes_take_every_head_dim_and_page():
    """The kernels take every head dim of the flash kernels' HEAD_DIMS
    (all the templates' knobs give) and every power-of-two page from 1 to
    128 (the divisors of the LlamaLoRA knobs' max_len), in both dtypes;
    a head dim off that list, a page that is not such a power of two, or
    more query heads per kv head than a block's rows raise ValueError."""
    from rafiki_tpu_torch.ops.attention import HEAD_DIMS

    assert pa._PAGE_SIZES == (1, 2, 4, 8, 16, 32, 64, 128)
    for dt in (torch.float32, torch.bfloat16):
        for dh in HEAD_DIMS:
            for page in pa._PAGE_SIZES:
                pa._check_kernel_shapes(dh, page, 4, dt)
            pa._check_kernel_shapes(dh, 16, pa._tile_rows(dt, dh), dt)
            with pytest.raises(ValueError, match="query heads"):
                pa._check_kernel_shapes(dh, 16, pa._tile_rows(dt, dh) + 1,
                                        dt)
        for dh in (4, 40, 100, 256):
            with pytest.raises(ValueError, match="head_dim"):
                pa._check_kernel_shapes(dh, 16, 4, dt)
        for page in (0, 3, 6, 12, 256):
            with pytest.raises(ValueError, match="page_size"):
                pa._check_kernel_shapes(64, page, 4, dt)
    assert pa._tile_rows(torch.float32, 192) == 32


@pytest.mark.parametrize("page", [1, 4, 128])
def test_split_plan_model_at_small_and_large_pages(page):
    """The split model with the plan ``_split_plan`` gives (forced to
    several splits: one slot, one kv head) equals the plain window version
    at pages of 1 token (64 pages to a tile), 4, and 128 (a page spans two
    tiles and a split is whole pages); positions reach past a tile and a
    page."""
    rng = np.random.default_rng(page)
    n_heads, n_kv, dh, s = 4, 2, 8, 3
    length = 512
    n_tab = length // page
    n_pages = 1 + n_tab
    k_pool, v_pool = (_t(rng.standard_normal(
        (n_pages, page, n_kv, dh)).astype(np.float32)) for _ in range(2))
    tables = _t(rng.permutation(np.arange(1, n_pages)).astype(
        np.int32)[None])
    positions = _t(np.array([[130, 300, 511]], np.int32))
    q = _t(rng.standard_normal((1, s, n_heads, dh)).astype(np.float32))
    pps, n_splits = pa._split_plan(1, n_kv, 1, n_tab, page, s * 2)
    assert n_splits > 1 and (pps * page) % pa._TILE_KEYS == 0
    got = pa._paged_split_reference(q, k_pool, v_pool, tables, positions,
                                    0.35, pps)
    want = pa._paged_window_reference(q, k_pool, v_pool, tables, positions,
                                      0.35)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


#: decode positions on and beside the split boundaries of 1, 2 and 3
#: pages of 4 tokens (keys 4, 8, 12, 24 open a split)
_SPLIT_POSITIONS = np.array([0, 3, 4, 5, 7, 8, 9, 11, 12, 13, 23, 24, 31],
                            np.int32)
#: windows: an idle row at 0; rows 9..11 that see no key of the split
#: opening at 12 (1 or 3 pages) while the tile's last row does; overhang
#: repeating the last entry; a window across the 24 boundary
_SPLIT_WINDOWS = np.array([[0, 0, 0, 0, 0],
                           [9, 10, 11, 12, 13],
                           [3, 4, 5, 6, 6],
                           [21, 22, 23, 24, 25],
                           [13, 14, 15, 16, 17]], np.int32)


@functools.lru_cache(maxsize=None)
def _split_case(n_kv, window):
    """Inputs and the JAX kernel's output, once per (rep, kind)."""
    n_heads, dh = 4, 8
    if window:  # a 7-column live-width table: not a multiple of 2 or 3
        positions, n_tab = _SPLIT_WINDOWS, 7
        rng, k_pool, v_pool, tables = _pool_case(7, n_heads, n_kv, dh,
                                                 positions[:, -1], n_tab)
        q = rng.standard_normal(positions.shape + (n_heads, dh)).astype(
            np.float32)
        want = jax_window(q, k_pool, v_pool, tables, positions,
                          sm_scale=1.0 / np.sqrt(dh), interpret=True)
    else:
        positions, n_tab = _SPLIT_POSITIONS, 8
        rng, k_pool, v_pool, tables = _pool_case(6, n_heads, n_kv, dh,
                                                 positions, n_tab)
        q = rng.standard_normal((len(positions), n_heads, dh)).astype(
            np.float32)
        want = jax_decode(q, k_pool, v_pool, tables, positions,
                          sm_scale=1.0 / np.sqrt(dh), interpret=True)
    return q, k_pool, v_pool, tables, positions, np.asarray(want)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("n_kv", [4, 2, 1], ids=["rep1", "rep2", "rep4"])
def test_split_reference_matches_jax_decode(n_kv, pages_per_split):
    """The split-and-merge model against the JAX decode kernel: GQA rep
    1/2/4, splits of 1, 2 and 3 pages (3 does not divide the 8 columns),
    positions on and beside the split boundaries, garbage on page 0."""
    q, k_pool, v_pool, tables, positions, want = _split_case(n_kv, False)
    got = pa._paged_split_reference(
        _t(q[:, None]), _t(k_pool), _t(v_pool), _t(tables),
        _t(positions[:, None]), 1.0 / np.sqrt(q.shape[-1]),
        pages_per_split)[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got).max() < 10  # the page-0 garbage never leaked in


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("n_kv", [4, 2, 1], ids=["rep1", "rep2", "rep4"])
def test_split_reference_matches_jax_window(n_kv, pages_per_split):
    """The model against the JAX window kernel on a 7-column table:
    window rows that see no key of a split their tile's last row reaches,
    an idle row, an overhang, a window across a split boundary."""
    q, k_pool, v_pool, tables, positions, want = _split_case(n_kv, True)
    got = pa._paged_split_reference(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(positions),
        1.0 / np.sqrt(q.shape[-1]), pages_per_split).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pages_per_split", [1, 3])
def test_masked_split_contributes_exactly_zero(pages_per_split):
    """A split in which a row sees no key: its max is the finite NEG_INF,
    its sum counts the masked keys (each weighs exp(0) = 1, and its acc
    holds their V — scratch garbage included), and the merge weighs it by
    exactly 0."""
    q, k_pool, v_pool, tables, positions, _ = _split_case(1, True)
    m, l, acc = pa._split_partials(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(positions),
        1.0 / np.sqrt(q.shape[-1]), pages_per_split)
    step = pages_per_split * PAGE
    first_key = torch.arange(m.shape[0])[:, None, None, None] * step
    blind = first_key > _t(positions).long()[None, :, None, :]  # (sp,b,1,s)
    blind = blind.expand(m.shape[:-1])
    assert blind.any() and (~blind).any()
    assert torch.all(m[..., 0][blind] == pa.NEG_INF)
    keys = torch.tensor([min(step, tables.shape[1] * PAGE - k0)
                         for k0 in range(0, tables.shape[1] * PAGE, step)],
                        dtype=torch.float32)
    assert torch.equal(l[..., 0][blind],
                       keys[:, None, None, None].expand(blind.shape)[blind])
    weight = torch.exp(m - m.amax(dim=0))[..., 0]
    assert torch.all(weight[blind] == 0)
    assert torch.all(weight[~blind] > 0)
