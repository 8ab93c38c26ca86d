"""The port's CUDA kernels against their plain versions, on the card.

``cuda``-marked: each test skips on a host without a CUDA device (decided
inside the test). The file imports nothing of the JAX package, so it runs
on a machine that has PyTorch and a card but no Flax::

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

The CPU parity of the plain versions with the JAX Pallas kernels is
``tests/test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from rafiki_tpu_torch.ops import paged_attention as pa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_card(dtype):
    """On a CUDA card: both kernels against their plain versions (run in
    f32) at GQA rep 4, dh 128, page 16, with garbage on page 0 and a
    window whose overhang repeats; a window of one is bit-identical to
    the step. Tolerance 1e-5 at f32 (sums in another order); at bf16
    1e-3 + 2^-8·max|ref| (one rounding of the output to bf16, at most
    2^-8 of its magnitude, plus the f32 noise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)

    def tol(ref):
        if dt == torch.float32:
            return 1e-5
        return 1e-3 + 2.0 ** -8 * ref.abs().max().item()
    b, n_heads, n_kv, dh, page = 4, 32, 8, 128, 16
    last = np.array([0, 17, 300, 511], np.int32)
    n_live = last // page + 1
    rng = np.random.default_rng(5)
    n_pages = 1 + int(n_live.sum())
    tables = np.zeros((b, 32), np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for i, n in enumerate(n_live):
        tables[i, :n] = perm[used:used + n]
        used += n
    dev = torch.device("cuda")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k_pool = put(rng.standard_normal((n_pages, page, n_kv, dh))).to(dt)
    v_pool = put(rng.standard_normal((n_pages, page, n_kv, dh))).to(dt)
    k_pool[0] = 1e3
    v_pool[0] = -1e3
    tab = put(tables)
    sm = 1.0 / np.sqrt(dh)
    q = put(rng.standard_normal((b, n_heads, dh))).to(dt)
    pos = put(last)
    got = pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm)
    ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                        v_pool.float(), tab, pos, sm)
    assert (got.float() - ref).abs().max().item() <= tol(ref)
    win1 = pa.paged_window_attention(q[:, None], k_pool, v_pool, tab,
                                     pos[:, None], sm)[:, 0]
    assert torch.equal(win1, got)
    wpos = np.maximum(0, last[:, None] - np.arange(31, -1, -1)[None, :])
    wpos[:, -1] = wpos[:, -2]  # overhang row
    wpos = put(wpos.astype(np.int32))
    qw = put(rng.standard_normal((b, 32, n_heads, dh))).to(dt)
    got_w = pa.paged_window_attention(qw, k_pool, v_pool, tab, wpos, sm)
    ref_w = pa._paged_window_reference(qw.float(), k_pool.float(),
                                       v_pool.float(), tab, wpos, sm)
    torch.cuda.synchronize()
    assert (got_w.float() - ref_w).abs().max().item() <= tol(ref_w)
