"""The port's CUDA kernels against their plain versions, on the card.

``cuda``-marked: each test skips on a host without a CUDA device (decided
inside the test). The file imports nothing of the JAX package, so it runs
on a machine that has PyTorch and a card but no Flax::

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

The CPU parity of the plain versions with the JAX Pallas kernels is
``tests/test_torch_paged_attention.py`` (B1/B2),
``tests/test_torch_attention.py`` (B3/B4/B5/B6) and
``tests/test_torch_patch_embed.py`` (B7).
"""

import numpy as np
import pytest
import torch

from rafiki_tpu_torch.models.llama_lora import _quantize_int8
from rafiki_tpu_torch.ops import paged_attention as pa
from rafiki_tpu_torch.ops.attention import HEAD_DIMS


def _paged_tol(dtype, ref):
    """Per-element tolerance of B1/B2 against their plain versions run in
    f32, as for the flash kernels: f32 1e-5 + 1e-5·|ref| (sums in another
    order); bf16 one rounding of the output (2^-8 of the element's
    magnitude) plus 1e-3."""
    if dtype == torch.float32:
        return 1e-5 + 1e-5 * ref.abs()
    return 1e-3 + 2.0 ** -8 * ref.abs()


def _paged_within(got, ref, dtype):
    return bool(torch.all((got.float() - ref).abs() <= _paged_tol(dtype,
                                                                  ref)))


def _paged_pools(rng, last, n_kv, dh, page, n_tab, dt, dev):
    """Pools with 1e3 / -1e3 garbage on scratch page 0, and a table row
    per slot whose live pages are distinct random pages, dead entries on
    page 0."""
    n_live = last // page + 1
    n_pages = 1 + int(n_live.sum())
    tables = np.zeros((len(last), n_tab), np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for i, n in enumerate(n_live):
        tables[i, :n] = perm[used:used + n]
        used += n
    shape = (n_pages, page, n_kv, dh)
    k_pool = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(dt)
    v_pool = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(dt)
    k_pool[0] = 1e3
    v_pool[0] = -1e3
    return k_pool, v_pool, torch.from_numpy(tables).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_card(dtype):
    """On a CUDA card: both kernels against their plain versions (run in
    f32) at GQA rep 4, dh 128, page 16, with garbage on page 0 and a
    window whose overhang repeats; a window of one is bit-identical to
    the step. Per-element tolerance (``_paged_tol``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    b, n_heads, n_kv, dh, page = 4, 32, 8, 128, 16
    last = np.array([0, 17, 300, 511], np.int32)
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    k_pool, v_pool, tab = _paged_pools(rng, last, n_kv, dh, page, 32, dt,
                                       dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sm = 1.0 / np.sqrt(dh)
    q = put(rng.standard_normal((b, n_heads, dh))).to(dt)
    pos = put(last)
    got = pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm)
    ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                        v_pool.float(), tab, pos, sm)
    assert _paged_within(got, ref, dt)
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
    assert _paged_within(got_w, ref_w, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("page", [1, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_sweep_on_card(dtype, dh, page, rep):
    """B1 and B2 against their plain versions across the shapes the split
    plan must handle: positions 63 / 64 / 127 / 128 / 2047 (on and beside
    64-key tiles, one slot far past the rest), a live-width table 3
    columns wider than the longest slot (not a multiple of any split),
    windows of 1, 7, 32, 33 and 128 tokens ending at each slot's position
    (ragged query tiles, rows that see no key of the tile's last split);
    head dims padded to the mma step (8, 16 and 32) and not, pages of one
    token (64 to a tile) up to 128 (two tiles to a page); a window of one
    equals the decode step bit for bit, and a second call on the same
    inputs gives the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    n_kv, dev = 2, torch.device("cuda")
    n_heads = n_kv * rep
    last = np.array([63, 64, 127, 128, 2047], np.int32)
    rng = np.random.default_rng(dh + page + rep)
    n_tab = int(last.max()) // page + 4
    k_pool, v_pool, tab = _paged_pools(rng, last, n_kv, dh, page, n_tab, dt,
                                       dev)
    sm = 1.0 / np.sqrt(dh)
    pools = (k_pool, v_pool, tab)
    q = torch.from_numpy(rng.standard_normal(
        (len(last), n_heads, dh)).astype(np.float32)).to(dev).to(dt)
    pos = torch.from_numpy(last).to(dev)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, *pools[:2], tab, pos, sm)
    again = pa.paged_decode_attention(q, *pools[:2], tab, pos, sm)
    assert pa.paged_decode_attention.launches == before + 2
    ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                        v_pool.float(), tab, pos, sm)
    win1 = pa.paged_window_attention(q[:, None], k_pool, v_pool, tab,
                                     pos[:, None], sm)[:, 0]
    torch.cuda.synchronize()
    assert _paged_within(got, ref, dt)
    assert torch.equal(again, got) and torch.equal(win1, got)
    for c in (1, 7, 32, 33, 128):
        wpos = np.maximum(0, last[:, None] - np.arange(c - 1, -1, -1)[None])
        wpos = torch.from_numpy(wpos.astype(np.int32)).to(dev)
        qw = torch.from_numpy(rng.standard_normal(
            (len(last), c, n_heads, dh)).astype(np.float32)).to(dev).to(dt)
        got_w = pa.paged_window_attention(qw, k_pool, v_pool, tab, wpos, sm)
        again_w = pa.paged_window_attention(qw, k_pool, v_pool, tab, wpos,
                                            sm)
        ref_w = pa._paged_window_reference(qw.float(), k_pool.float(),
                                           v_pool.float(), tab, wpos, sm)
        torch.cuda.synchronize()
        assert _paged_within(got_w, ref_w, dt), c
        assert torch.equal(again_w, got_w), c


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 12, 16, 24, 32, 48, 64, 96, 128, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_every_head_dim_on_card(dtype, dh):
    """B1 and B2 at every head dim of HEAD_DIMS (bf16 d = 12's 24-byte rows
    take 8-byte copies; f32 above d = 128 takes 32-row query tiles), GQA
    rep 8, pages of 4 and 128: the decode step and windows of 1, 33 and
    128 tokens against the plain versions run in f32, per element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    n_kv, rep, dev = 2, 8, torch.device("cuda")
    last = np.array([0, 63, 200, 700], np.int32)
    sm = 1.0 / np.sqrt(dh)
    for page in (4, 128):
        rng = np.random.default_rng(dh + page)
        k_pool, v_pool, tab = _paged_pools(
            rng, last, n_kv, dh, page, int(last.max()) // page + 2, dt, dev)
        q = torch.from_numpy(rng.standard_normal(
            (len(last), n_kv * rep, dh)).astype(np.float32)).to(dev).to(dt)
        pos = torch.from_numpy(last).to(dev)
        got = pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm)
        ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                            v_pool.float(), tab, pos, sm)
        torch.cuda.synchronize()
        assert _paged_within(got, ref, dt), page
        for c in (1, 33, 128):
            wpos = np.maximum(0, last[:, None] - np.arange(c - 1, -1, -1))
            wpos = torch.from_numpy(wpos.astype(np.int32)).to(dev)
            qw = torch.from_numpy(rng.standard_normal(
                (len(last), c, n_kv * rep, dh)).astype(np.float32)).to(
                dev).to(dt)
            got_w = pa.paged_window_attention(qw, k_pool, v_pool, tab, wpos,
                                              sm)
            ref_w = pa._paged_window_reference(qw.float(), k_pool.float(),
                                               v_pool.float(), tab, wpos, sm)
            torch.cuda.synchronize()
            assert _paged_within(got_w, ref_w, dt), (page, c)


@pytest.mark.cuda
def test_paged_kernels_refuse_unsupported_shapes_on_card():
    """Head dims and page sizes the kernels are not compiled for (a head
    dim off HEAD_DIMS, a page that is not a power of two from 1 to 128)
    raise ValueError on the card; nothing launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    tab = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    before = pa.paged_decode_attention.launches
    for dh, page in ((40, 16), (64, 3), (64, 256)):
        q = torch.zeros(1, 4, dh, device=dev)
        pool = torch.zeros(2, page, 2, dh, device=dev)
        with pytest.raises(ValueError):
            pa.paged_decode_attention(q, pool, pool, tab, pos, 0.5)
    assert pa.paged_decode_attention.launches == before


def _int8_pools(rng, last, n_kv, dh, page, n_tab, dev):
    """``_paged_pools``' layout as an int8 cache: rows quantized from f32
    by the model's cache writer (int8 and one f32 absmax scale per row),
    scratch page 0 holding 127s and -127s at huge scales."""
    k, v, tab = _paged_pools(rng, last, n_kv, dh, page, n_tab,
                             torch.float32, dev)
    kq, ks = _quantize_int8(k, -1)
    vq, vs = _quantize_int8(v, -1)
    return kq, vq, ks, vs, tab


@pytest.mark.cuda
@pytest.mark.parametrize("page", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_kernels_on_card(dtype, dh, page):
    """The int8 instances of B1 and B2 (int8 pools, f32 row scales, f32 or
    bf16 queries) against their plain versions run in f32, at every head
    dim and page: positions on and beside 64-key tiles and one far past
    the rest, windows of 1, 7 and 33 tokens, GQA rep 4; per-element
    tolerance (``_paged_tol``); a second call bit-identical and a window of
    one equal to the decode step bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt, dev = getattr(torch, dtype), torch.device("cuda")
    n_kv, n_heads = 2, 8
    last = np.array([63, 64, 127, 128, 700], np.int32)
    rng = np.random.default_rng(dh * 1000 + page)
    n_tab = int(last.max()) // page + 2
    kq, vq, ks, vs, tab = _int8_pools(rng, last, n_kv, dh, page, n_tab, dev)
    sm = 1.0 / np.sqrt(dh)
    q = torch.from_numpy(rng.standard_normal(
        (len(last), n_heads, dh)).astype(np.float32)).to(dev).to(dt)
    pos = torch.from_numpy(last).to(dev)
    pools = (kq, vq, tab)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, *pools, pos, sm, ks, vs)
    again = pa.paged_decode_attention(q, *pools, pos, sm, ks, vs)
    assert pa.paged_decode_attention.launches == before + 2
    ref = pa._paged_attention_reference(q.float(), *pools, pos, sm, ks, vs)
    win1 = pa.paged_window_attention(q[:, None], *pools, pos[:, None], sm,
                                     ks, vs)[:, 0]
    torch.cuda.synchronize()
    assert got.dtype == dt and _paged_within(got, ref, dt)
    assert torch.equal(got, again) and torch.equal(win1, got)
    for c in (7, 33):
        wpos = np.maximum(0, last[:, None] - np.arange(c - 1, -1, -1)[None])
        wpos = torch.from_numpy(wpos.astype(np.int32)).to(dev)
        qw = torch.from_numpy(rng.standard_normal(
            (len(last), c, n_heads, dh)).astype(np.float32)).to(dev).to(dt)
        got_w = pa.paged_window_attention(qw, *pools, wpos, sm, ks, vs)
        again_w = pa.paged_window_attention(qw, *pools, wpos, sm, ks, vs)
        ref_w = pa._paged_window_reference(qw.float(), *pools, wpos, sm, ks,
                                           vs)
        torch.cuda.synchronize()
        assert _paged_within(got_w, ref_w, dt), c
        assert torch.equal(got_w, again_w), c


#: verify-window lanes: window start per live slot (windows crossing a
#: page, 14 and 61 with page 16, and a 64-key tile, 61; one far along,
#: 1021); three idle lanes, free slots as the engine makes them, at
#: position 0
VERIFY_START = np.array([14, 61, 200, 1021, 0, 37, 0, 0], np.int32)
VERIFY_LIVE = np.array([1, 1, 1, 1, 0, 1, 0, 0], bool)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_paged_window_at_verify_shapes_on_card(pool, s):
    """B2 as speculative verify calls it: 8 slots, s = speculate_k, 32
    query / 8 kv heads, head dim 128, page 16, bf16 queries over a bf16
    or an int8 pool. A live slot's window covers pos..pos+s-1 and its
    last page is the one it was just given; an idle lane (a free slot)
    repeats position 0 s times over a table row of scratch page 0. Each
    element within ``_paged_tol`` of the plain version, a second call
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev, dt = torch.device("cuda"), torch.bfloat16
    n_kv, n_heads, dh, page = 8, 32, 128, 16
    rng = np.random.default_rng(7 * s + (pool == "int8"))
    offs = np.arange(s, dtype=np.int32)[None, :]
    wpos = np.where(VERIFY_LIVE[:, None], VERIFY_START[:, None] + offs,
                    VERIFY_START[:, None]).astype(np.int32)
    last = wpos[:, -1]
    n_tab = int(last.max()) // page + 1
    if pool == "int8":
        kq, vq, ks, vs, tab = _int8_pools(rng, last, n_kv, dh, page, n_tab,
                                          dev)
        pools, scales = (kq, vq), (ks, vs)
    else:
        k, v, tab = _paged_pools(rng, last, n_kv, dh, page, n_tab, dt, dev)
        pools, scales = (k, v), ()
    tab[torch.from_numpy(~VERIFY_LIVE).to(dev)] = 0
    q = torch.from_numpy(rng.standard_normal(
        (len(last), s, n_heads, dh)).astype(np.float32)).to(dev).to(dt)
    tpos = torch.from_numpy(wpos).to(dev)
    sm = 1.0 / np.sqrt(dh)
    before = pa.paged_window_attention.launches
    got = pa.paged_window_attention(q, *pools, tab, tpos, sm, *scales)
    again = pa.paged_window_attention(q, *pools, tab, tpos, sm, *scales)
    assert pa.paged_window_attention.launches == before + 2
    ref_pools = pools if scales else tuple(p.float() for p in pools)
    ref = pa._paged_window_reference(q.float(), *ref_pools, tab, tpos, sm,
                                     *scales)
    torch.cuda.synchronize()
    assert _paged_within(got, ref, dt)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_int8_paged_kernels_refuse_bad_operands_on_card():
    """No fallback: an int8 pool without scales, scales of another type,
    a pool whose rows are not contiguous, or a pool that does not start
    16-byte aligned raise; nothing launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    last = np.array([5, 40], np.int32)
    kq, vq, ks, vs, tab = _int8_pools(rng, last, 2, 64, 16, 4, dev)
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16, device=dev)
    pos = torch.from_numpy(last).to(dev)
    before = pa.paged_decode_attention.launches
    bad = [((kq, vq), {}),  # int8 rows read as bf16: no scales
           ((kq, vq), {"k_scale": ks.double(), "v_scale": vs.double()}),
           ((kq.transpose(0, 1).contiguous().transpose(0, 1), vq),
            {"k_scale": ks, "v_scale": vs}),
           ((kq.flatten()[1:1 + kq.numel() - 64 * 16 * 2].view(
               -1, 16, 2, 64), vq[:-1]),
            {"k_scale": ks[:-1], "v_scale": vs[:-1]})]
    for (k, v), kw in bad:
        with pytest.raises((TypeError, ValueError)):
            pa.paged_decode_attention(q, k, v, tab, pos, 0.125, **kw)
    assert pa.paged_decode_attention.launches == before


def _flash_tol(dtype, ref):
    """Per-element tolerance: f32: 1e-5 + 1e-5·|ref| (sums in another
    order); bf16: one rounding of the output to bf16 (at most 2^-8 of the
    element's magnitude) plus 1e-3 for the f32 sums. Each element is held
    to its own magnitude, so a key that many rows see (kv_len 1: key 0
    sums every row of dO into dv) does not loosen the check on the rest."""
    if dtype == torch.float32:
        return 1e-5 + 1e-5 * ref.abs()
    return 1e-3 + 2.0 ** -8 * ref.abs()


def _within(got, ref, dtype):
    return bool(torch.all((got.float() - ref).abs() <= _flash_tol(dtype,
                                                                  ref)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 8), ("float32", 16),
                                     ("float32", 32), ("float32", 64),
                                     ("float32", 128), ("bfloat16", 16),
                                     ("bfloat16", 128), ("float32", 12),
                                     ("float32", 24), ("float32", 48),
                                     ("float32", 96), ("float32", 192),
                                     ("bfloat16", 48), ("bfloat16", 192)])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_kernels_match_plain_versions_on_card(dtype, d, causal):
    """B3, B5 and B6 against their plain versions run in f32 on the same
    inputs: ragged s (200, not a multiple of the 64-row tiles), kv_lens
    with a 0 (the LSE_MASKED row: zeros out, zero gradients) and a 1.
    B5/B6 get the plain forward's lse and delta, so each kernel is held
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    dt = getattr(torch, dtype)
    b, h, s = 4, 3, 200
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, h, s, d)).astype(np.float32)).to(dev).to(dt) for _ in range(4))
    lens = torch.tensor([200, 0, 1, 77], dtype=torch.int32, device=dev)
    sm = 1.0 / np.sqrt(d)
    f32 = [t.float() for t in (q, k, v, do)]
    ref_o, ref_lse = fa._flash_fwd_reference(*f32[:3], lens, sm, causal)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, lens, sm, causal)
    assert fa.flash_attention_fwd.launches == before + 1
    torch.cuda.synchronize()
    assert _within(out, ref_o, dt)
    assert torch.all(lse[1] == fa.LSE_MASKED) and torch.all(out[1] == 0)
    live = ref_lse < 1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-4
    out2, none = fa.flash_attention_fwd(q, k, v, lens, sm, causal,
                                        with_lse=False)
    assert none is None and torch.equal(out2, out)

    delta = fa._delta(f32[3], ref_o)
    ref_dq = fa._flash_bwd_dq_reference(*f32, ref_lse, delta, lens, sm,
                                        causal)
    ref_dk, ref_dv = fa._flash_bwd_dkv_reference(*f32, ref_lse, delta,
                                                 lens, sm, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, lens, sm,
                                   causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, lens,
                                        sm, causal)
    torch.cuda.synchronize()
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        assert got.dtype == dt
        err = (got.float() - ref).abs().max().item()
        assert _within(got, ref, dt), (name, err)
        assert torch.all(got[1] == 0), name


@pytest.mark.cuda
def test_flash_attention_autograd_on_card():
    """The autograd path on the card runs B3 once and B5/B6 once each,
    and its gradients equal the plain version's autograd (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (2, 4, 130, 32)).astype(np.float32)).to(dev) for _ in range(4))
    lens = torch.tensor([130, 60], dtype=torch.int32, device=dev)
    counts = [fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=True, kv_lens=lens).backward(g)
    assert [fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches] == [c + 1 for c in counts]
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    fa._attention_reference(*refs, 1.0 / np.sqrt(32), True,
                            lens).backward(g)
    for a, r in zip(leaves, refs):
        assert _within(a.grad, r.grad, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_h,causal", [(2, False), (4, True),
                                            (12, False)])
def test_head_tiled_forward_on_card(dtype, block_h, causal):
    """B4 against its plain version (B3's, run in f32) and against B3
    itself: it runs B3's tile body per head in B3's order, so out and LSE
    are bit-identical to B3's. Ragged s (150) and kv_lens with a 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    dt = getattr(torch, dtype)
    b, h, s, d = 3, 12, 150, 64
    rng = np.random.default_rng(13)
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, h, s, d)).astype(np.float32)).to(dev).to(dt) for _ in range(3))
    lens = torch.tensor([150, 0, 61], dtype=torch.int32, device=dev)
    sm = 1.0 / np.sqrt(d)
    before = (fa.flash_attention_fwd_mh.launches,
              fa.flash_attention_fwd.launches)
    out, lse = fa.flash_attention_fwd_mh(q, k, v, lens, sm, causal, block_h)
    assert (fa.flash_attention_fwd_mh.launches,
            fa.flash_attention_fwd.launches) == (before[0] + 1, before[1])
    out3, lse3 = fa.flash_attention_fwd(q, k, v, lens, sm, causal)
    ref_o, ref_lse = fa._flash_fwd_reference(q.float(), k.float(),
                                             v.float(), lens, sm, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out3) and torch.equal(lse, lse3)
    assert _within(out, ref_o, dt)
    assert torch.all(out[1] == 0) and torch.all(lse[1] == fa.LSE_MASKED)
    out2, none = fa.flash_attention_fwd_mh(q, k, v, lens, sm, causal,
                                           block_h, with_lse=False)
    assert none is None and torch.equal(out2, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 768, 96), (130, 75, 33),
                                   (777, 768, 768), (64 * 196, 768, 768)])
def test_matmul_bias_on_card(dtype, m, k, n):
    """B7 against its plain version run in f32 on the same inputs, ragged
    against the tiles (bf16 128 x 192 x 64, f32 64 x 64 x 32): per
    element, f32 1e-5 + 1e-5·|ref| (sums in another order), bf16 one
    rounding of the output (2^-8 of its magnitude) plus 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import patch_embed as pe

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(m + n)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(
        np.float32)).to(dev).to(dt)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(
        np.float32)).to(dev).to(dt)
    b = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(dev).to(dt)
    before = pe.matmul_bias.launches
    got = pe.matmul_bias(x, w, b)
    assert pe.matmul_bias.launches == before + 1
    ref = pe._matmul_bias_reference(x.float(), w.float(), b.float())
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (m, n)
    assert _within(got, ref, dt)
    with pytest.raises(TypeError):
        pe.matmul_bias(x, w.float() if dt != torch.float32 else
                       w.to(torch.bfloat16), b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset", [
    (127, 768, 768, 0), (128, 768, 768, 0), (129, 768, 768, 0),
    (64 * 196, 768, 768, 0), (129, 75, 33, 0), (200, 76, 36, 0),
    (64, 768, 100, 0), (130, 768, 768, 1)],
    ids=["m127", "m128", "m129", "vit", "k75-n33", "k76-n36", "n100",
         "offset-view"])
def test_matmul_bias_bf16_plans_on_card(m, k, n, offset):
    """B7's bf16 tensor-core body at and around its 128-row tile, at
    ViT's shape, and on rows that are not 16-byte aligned (k or n not a
    multiple of 8, or x starting 2 bytes into its storage: the
    element-copy variant): each element within 1e-3 + 2^-8·|plain| of
    the plain version run in f32, and a second call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import patch_embed as pe

    rng = np.random.default_rng(m + k + n)
    dev = torch.device("cuda")
    flat = torch.from_numpy(rng.uniform(-1, 1, m * k + offset).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    x = flat[offset:].view(m, k)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    aligned = k % 8 == 0 and n % 8 == 0 and offset == 0
    got = pe.matmul_bias(x, w, b)
    again = pe.matmul_bias(x, w, b)
    ref = pe._matmul_bias_reference(x.float(), w.float(), b.float())
    torch.cuda.synchronize()
    assert pe._matmul_plan(m, n, k, torch.bfloat16, x.data_ptr() % 16 == 0
                           ).copy_bytes == (16 if aligned else 2)
    assert _within(got, ref, torch.bfloat16)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 24, 32, 48, 64, 96, 128, 192])
@pytest.mark.parametrize("s", [197, 200])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_forward_bf16_every_head_dim_on_card(d, s, causal):
    """B3's bf16 tensor-core body at every compiled head dim: s 197
    (ViT's: a last tile of 5 rows and keys) and 200, kv_lens 0 (zeros
    and LSE_MASKED, exactly), 1, a partial tile (77) and all; out per
    element within 1e-3 + 2^-8·|plain| of the plain version run in f32,
    the live LSE within 1e-4; a second call, and the call without LSE,
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    b, h = 4, 3
    rng = np.random.default_rng(d + s)
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, h, s, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
        for _ in range(3))
    lens = torch.tensor([s, 0, 1, 77], dtype=torch.int32, device=dev)
    sm = 1.0 / np.sqrt(d)
    out, lse = fa.flash_attention_fwd(q, k, v, lens, sm, causal)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, lens, sm, causal)
    out3, _ = fa.flash_attention_fwd(q, k, v, lens, sm, causal,
                                     with_lse=False)
    ref_o, ref_lse = fa._flash_fwd_reference(q.float(), k.float(),
                                             v.float(), lens, sm, causal)
    torch.cuda.synchronize()
    assert _within(out, ref_o, torch.bfloat16)
    live = ref_lse < 1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-4
    assert torch.all(out[1] == 0) and torch.all(lse[1] == fa.LSE_MASKED)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert torch.equal(out3, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_h", [2, 3, 4, 6, 12])
def test_head_tiled_forward_bit_identical_to_b3_on_card(block_h, dtype):
    """B4 at every block_h that divides 12 heads equals B3 bit for bit
    (out and LSE), causal and not, at ViT's s 197 and d 64 with kv_lens
    0 and a partial tile; a second B4 call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    dt = getattr(torch, dtype)
    b, h, s, d = 3, 12, 197, 64
    rng = np.random.default_rng(block_h)
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, h, s, d)).astype(np.float32)).to(dev).to(dt) for _ in range(3))
    lens = torch.tensor([197, 0, 100], dtype=torch.int32, device=dev)
    for causal in (False, True):
        out4, lse4 = fa.flash_attention_fwd_mh(q, k, v, lens, 0.125, causal,
                                               block_h)
        again, _ = fa.flash_attention_fwd_mh(q, k, v, lens, 0.125, causal,
                                             block_h)
        out3, lse3 = fa.flash_attention_fwd(q, k, v, lens, 0.125, causal)
        torch.cuda.synchronize()
        assert torch.equal(out4, out3) and torch.equal(lse4, lse3), causal
        assert torch.equal(again, out4), causal


@pytest.mark.cuda
def test_compiled_flash_plan_matches_the_host_plan_on_card():
    """The plan the built library reports for every head dim and dtype
    (``rt_flash_fwd_plan``) is ``_flash_plan``'s, and the backward's
    (``rt_flash_bwd_plan``) is ``_flash_bwd_plan``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    for d in fa.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            assert fa._compiled_plan(d, dt) == fa._flash_plan(d, dt), (d, dt)
            assert fa._compiled_bwd_plan(d, dt) == \
                fa._flash_bwd_plan(d, dt), (d, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 24, 32, 48, 64, 96, 128, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_every_head_dim_on_card(d, dtype, causal):
    """B5 and B6 at every compiled head dim (bf16 on the tensor-core
    bodies, f32 on the FMA ones): s_q 150 (not a multiple of the 64-row
    tiles), s_kv 150 causal and 131 not, kv_lens 0, 1, 63, 64, 65 and
    all; each element of dq, dk and dv within its tolerance of the plain
    version run in f32 on the same lse and delta, the rows and keys no
    query sees exactly zero, and a second call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_tpu_torch.ops import attention as fa

    dt = getattr(torch, dtype)
    h, s_q = 2, 150
    s_kv = s_q if causal else 131
    lens_np = np.array([0, 1, 63, 64, 65, s_kv], np.int32)
    b = len(lens_np)
    rng = np.random.default_rng(d + 7 * causal)
    dev = torch.device("cuda")

    def rand(s):
        return torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
            np.float32)).to(dev).to(dt)

    q, do = rand(s_q), rand(s_q)
    k, v = rand(s_kv), rand(s_kv)
    lens = torch.from_numpy(lens_np).to(dev)
    sm = 1.0 / np.sqrt(d)
    f32 = [t.float() for t in (q, k, v, do)]
    ref_o, lse = fa._flash_fwd_reference(*f32[:3], lens, sm, causal)
    delta = fa._delta(f32[3], ref_o)
    ref_dq = fa._flash_bwd_dq_reference(*f32, lse, delta, lens, sm, causal)
    ref_dk, ref_dv = fa._flash_bwd_dkv_reference(*f32, lse, delta, lens, sm,
                                                 causal)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, lens, sm, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, lens, sm,
                                        causal)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, lens, sm,
                                    causal)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, lens, sm,
                                          causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 2,
                                                     before[1] + 2)
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        assert got.dtype == dt
        err = (got.float() - ref).abs().max().item()
        assert _within(got, ref, dt), (name, err)
        assert torch.all(got[0] == 0), name  # kv_len 0
    assert torch.all(dk[:, :, 65:][2:5] == 0) and torch.all(dv[1, :, 1:] == 0)
    assert torch.equal(dq2, dq) and torch.equal(dk2, dk) and \
        torch.equal(dv2, dv)
