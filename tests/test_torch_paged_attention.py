"""Port parity: the paged-attention ops of ``rafiki_tpu_torch`` against the
JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as its own tests do. The
same numpy inputs (from a seed) feed both. Tolerance: 1e-5 absolute at
f32 — the two sides sum in different orders (the kernel merges page
partials by LSE, the plain version soft-maxes the gathered row).

The CUDA kernels themselves run only on the card:
``tests/test_torch_kernels_cuda.py`` holds them against these plain
versions there.
"""

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


def test_int8_pools_raise_not_implemented():
    q = torch.zeros(1, 2, 8)
    pool = torch.zeros(3, PAGE, 1, 8)
    tab = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    scale = torch.ones(3, PAGE, 1)
    with pytest.raises(NotImplementedError):
        pa.paged_decode_attention(q, pool, pool, tab, pos, 1.0,
                                  k_scale=scale, v_scale=scale)
    with pytest.raises(NotImplementedError):
        pa.paged_window_attention(q[:, None], pool, pool, tab,
                                  pos[:, None], 1.0, k_scale=scale,
                                  v_scale=scale)
