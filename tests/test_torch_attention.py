"""Port parity: ``rafiki_tpu_torch.ops.attention`` against the JAX module.

On the CPU the port's ``flash_attention`` runs its plain versions (the
forward, B3's, and the backward, B5's and B6's) through the same
``torch.autograd.Function`` that launches the kernels on a card. The JAX
side runs its Pallas kernels in the interpreter (``interpret=True``), as
``tests/test_ops.py`` does. Inputs are drawn with numpy from a seed and
handed to both.

Tolerances: f32 at rtol 1e-5 with an absolute floor of 1e-5 (the two
sides sum in another order; near-zero gradient entries need the floor).
bf16 inputs and outputs at 2^-7 of the largest reference magnitude plus
1e-3: each side rounds its f32 result to bf16 once, and a rounding that
falls the other way moves an entry by one bf16 step, at most 2^-8 of its
magnitude, on either side.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import attention as jattn
from rafiki_tpu_torch.ops import _build
from rafiki_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

# (b, h, s, d, causal, kv_lens, dtype); b*h <= 4 and s <= 160 keep the
# Pallas interpreter quick. 100 and 160 are not multiples of the kernels'
# 128 tiles; a 0 in kv_lens is a row with no visible key.
CASES = {
    "causal-lens0-f32": (2, 2, 160, 16, True, [160, 0], "float32"),
    "full-lens-f32": (2, 2, 100, 32, False, [37, 100], "float32"),
    "causal-nolens-f32": (1, 4, 100, 8, True, None, "float32"),
    "causal-lens-bf16": (2, 2, 160, 16, True, [150, 1], "bfloat16"),
    # the ViT / BERT paths: non-causal, padded keys (with a 0), head dims
    # of their knob grids
    "full-lens0-d12-f32": (2, 2, 100, 12, False, [100, 0], "float32"),
    "full-nolens-d48-f32": (1, 2, 70, 48, False, None, "float32"),
    "full-lens-d24-bf16": (2, 2, 130, 24, False, [3, 130], "bfloat16"),
}


def _inputs(b, h, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v, and the output cotangent
    if dtype == "bfloat16":  # both sides see the same bf16 values
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype, grad=False):
    return torch.from_numpy(a).to(getattr(torch, dtype)) \
        .requires_grad_(grad)


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        tol = 1e-3 + 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, what


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_forward_lse_and_grads_match_pallas_interpret(case):
    b, h, s, d, causal, lens, dtype = CASES[case]
    q, k, v, g = _inputs(b, h, s, d, dtype)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv, jg = (_jax(a, dtype) for a in (q, k, v, g))
    scale = 1.0 / np.sqrt(d)

    def jfwd(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     interpret=True, kv_lens=jl)

    want, vjp = jax.vjp(jfwd, jq, jk, jv)
    want_grads = vjp(jg)
    _, lse_pad = jattn._flash_attention_fwd_impl(
        jq, jk, jv, jl, scale, causal, 128, 128, True, with_lse=True)
    want_lse = np.asarray(lse_pad)[:, :s, 0].reshape(b, h, s)

    tq, tk, tv = (_torch(a, dtype, grad=True) for a in (q, k, v))
    tlens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = tattn.flash_attention(tq, tk, tv, causal=causal, kv_lens=tlens)
    assert got.dtype == tq.dtype
    got.backward(_torch(g, dtype))
    _close(got.detach().float(), want, dtype, "out")
    _, got_lse = tattn.flash_attention_fwd(
        tq.detach(), tk.detach(), tv.detach(),
        tattn._prep_lens(tlens, b, s, tq.device), scale, causal)
    _close(got_lse, want_lse, "float32", "lse")
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        assert t.grad.dtype == t.dtype
        _close(t.grad.float(), w, dtype, f"d{name}")
    if lens is not None and 0 in lens:  # the LSE_MASKED rows
        row = lens.index(0)
        assert np.all(np.asarray(got_lse[row]) == tattn.LSE_MASKED)
        assert torch.all(got[row] == 0)
        for t in (tq, tk, tv):
            assert torch.all(t.grad[row] == 0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_reference_matches_jax_reference(causal):
    q, k, v, _ = _inputs(3, 2, 40, 16, "float32", seed=1)
    lens = [40, 0, 9]
    want = jattn._attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, causal,
        jnp.asarray(lens, jnp.int32))
    got = tattn._attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.3,
        causal, torch.tensor(lens))
    _close(got, want, "float32", "reference")


def test_plain_backward_matches_autograd_of_the_reference():
    """``_flash_bwd_reference`` from the forward's residuals equals
    autograd through the masked softmax (f32, rtol 1e-5)."""
    q, k, v, g = _inputs(2, 2, 50, 8, "float32", seed=2)
    lens = torch.tensor([50, 13], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn._attention_reference(tq, tk, tv, 0.5, True, lens)
    out.backward(torch.from_numpy(g))
    o, lse = tattn._flash_fwd_reference(tq.detach(), tk.detach(),
                                        tv.detach(), lens, 0.5, True)
    dq, dk, dv = tattn._flash_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), o, lse, torch.from_numpy(g),
        lens, 0.5, True)
    for got, t in zip((dq, dk, dv), (tq, tk, tv)):
        _close(got, t.grad, "float32", "plain bwd")


def test_no_grad_forward_skips_the_lse_and_cpu_never_counts_launches():
    q, k, v, _ = _inputs(1, 2, 20, 8, "float32", seed=3)
    before = (tattn.flash_attention_fwd.launches,
              tattn.flash_attention_bwd_dq.launches,
              tattn.flash_attention_bwd_dkv.launches)
    with torch.no_grad():
        out = tattn.flash_attention(*(torch.from_numpy(a)
                                      for a in (q, k, v)), causal=True)
    assert out.shape == (1, 2, 20, 8)
    lens = torch.tensor([20], dtype=torch.int32)
    o, lse = tattn.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), lens, 0.5, True,
        with_lse=False)
    assert lse is None and o.shape == out.shape
    assert (tattn.flash_attention_fwd.launches,
            tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == before


def test_unported_and_bad_arguments_raise():
    """Bad arguments raise; ``block_h`` keeps JAX's checks: below 1, or an
    explicit value that does not divide the heads, is a ValueError."""
    x = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="block_h"):
        tattn.flash_attention(x, x, x, block_h=3)
    with pytest.raises(ValueError, match="block_h"):
        tattn.flash_attention(x, x, x, block_h=0)
    with pytest.raises(ValueError):
        tattn.flash_attention(x, torch.zeros(1, 2, 8, 16),
                              torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError):
        tattn.flash_attention(x, x, x, kv_lens=[1, 2])


# ---- the head-tiled forward (B4) and the block_h default

@pytest.fixture()
def mh_calls(monkeypatch):
    """Record every ``flash_attention_fwd_mh`` call's block_h (the B4
    route), passing the call through."""
    calls = []
    real = tattn.flash_attention_fwd_mh

    def recorder(*a, **k):
        calls.append(a[6])
        return real(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_fwd_mh", recorder)
    return calls


@pytest.mark.parametrize("block_h,causal,lens", [
    (2, False, [100, 0]), (4, True, None), (4, False, [17, 100])],
    ids=["h2-full-lens0", "h4-causal", "h4-full-lens"])
def test_block_h_matches_pallas_mh_interpret(mh_calls, block_h, causal,
                                             lens):
    """``block_h > 1`` takes the B4 route: out and the q/k/v gradients
    (B5/B6 on B4's LSE) against the JAX multi-head kernel in the
    interpreter, f32 rtol 1e-5."""
    b, h, s, d = 2, 4, 100, 16
    q, k, v, g = _inputs(b, h, s, d, "float32", seed=4)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def jfwd(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     interpret=True, kv_lens=jl,
                                     block_h=block_h)

    want, vjp = jax.vjp(jfwd, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [_torch(a, "float32", grad=True) for a in (q, k, v)]
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = tattn.flash_attention(*leaves, causal=causal, kv_lens=tl,
                                block_h=block_h)
    got.backward(torch.from_numpy(g))
    assert mh_calls == [block_h]
    _close(got.detach(), want, "float32", "out")
    for name, t, w in zip("qkv", leaves, want_grads):
        _close(t.grad, w, "float32", f"d{name}")
    with torch.no_grad():  # the evaluation forward takes B4 too
        tattn.flash_attention(*(t.detach() for t in leaves), causal=causal,
                              kv_lens=tl, block_h=block_h)
    assert mh_calls == [block_h, block_h]


def test_block_h_env_default_applies(monkeypatch, mh_calls):
    """``ATTN_BLOCK_H`` (``RAFIKI_ATTN_BLOCK_H``) reaches callers that pass
    no block_h; block_h=1 explicitly keeps B3."""
    monkeypatch.setattr(tattn, "ATTN_BLOCK_H", 2)
    q = torch.from_numpy(_inputs(1, 4, 32, 16, "float32", seed=7)[0])
    out = tattn.flash_attention(q, q, q)
    assert mh_calls == [2]
    ref = tattn._attention_reference(q, q, q, 0.25, False)
    _close(out, ref, "float32", "out")
    tattn.flash_attention(q, q, q, block_h=1)
    assert mh_calls == [2]


def test_block_h_env_default_falls_back_on_indivisible(monkeypatch,
                                                       mh_calls, caplog):
    """An env default that does not divide this call's head count falls
    back to block_h=1 with one warning per shape, not one per call; an
    explicit indivisible block_h raises (above)."""
    import logging

    monkeypatch.setattr(tattn, "ATTN_BLOCK_H", 3)
    monkeypatch.setattr(tattn, "_ENV_BLOCK_H_WARNED", set())
    q = torch.from_numpy(_inputs(1, 4, 32, 16, "float32", seed=9)[0])
    ref = tattn._attention_reference(q, q, q, 0.25, False)
    with caplog.at_level(logging.WARNING,
                         logger="rafiki_tpu_torch.ops.attention"):
        out = tattn.flash_attention(q, q, q)
        out2 = tattn.flash_attention(q, q, q)
    assert mh_calls == []
    _close(out, ref, "float32", "out")
    _close(out2, ref, "float32", "out2")
    warned = [r for r in caplog.records
              if "RAFIKI_ATTN_BLOCK_H" in r.getMessage()]
    assert len(warned) == 1


def test_block_h_wrapper_checks_and_cpu_launch_count():
    q = torch.from_numpy(_inputs(1, 4, 20, 8, "float32", seed=3)[0])
    lens = torch.tensor([20], dtype=torch.int32)
    before = tattn.flash_attention_fwd_mh.launches
    out, lse = tattn.flash_attention_fwd_mh(q, q, q, lens, 0.5, True, 2)
    want = tattn.flash_attention_fwd(q, q, q, lens, 0.5, True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert tattn.flash_attention_fwd_mh.launches == before
    for bad in (0, 3):
        with pytest.raises(ValueError, match="block_h"):
            tattn.flash_attention_fwd_mh(q, q, q, lens, 0.5, True, bad)


# ---- the kernel path: CUDA tensors launch or raise, never the plain path

@pytest.fixture()
def kernel_path(monkeypatch):
    """Route CPU tensors down the kernel path (as a CUDA tensor would
    go), with every plain version booby-trapped."""
    def plain_ran(*a, **k):
        raise AssertionError("a plain version ran on the kernel path")

    monkeypatch.setattr(tattn, "_runs_kernel", lambda t: True)
    for name in ("_flash_fwd_reference", "_flash_bwd_dq_reference",
                 "_flash_bwd_dkv_reference", "_attention_reference"):
        monkeypatch.setattr(tattn, name, plain_ran)
    tattn._library.cache_clear()
    yield
    tattn._library.cache_clear()


def _wrapper_calls():
    x = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8)
    lens = torch.full((1,), 8, dtype=torch.int32)
    return {
        "flash_attention_fwd": lambda: tattn.flash_attention_fwd(
            x, x, x, lens, 0.25, True),
        "flash_attention_bwd_dq": lambda: tattn.flash_attention_bwd_dq(
            x, x, x, x, lse, lse, lens, 0.25, True),
        "flash_attention_bwd_dkv": lambda: tattn.flash_attention_bwd_dkv(
            x, x, x, x, lse, lse, lens, 0.25, True),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_raise_without_the_library(kernel_path, monkeypatch,
                                                   name):
    """No nvcc (or a failed build): the wrapper raises; the launch
    counter does not move."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "lib_path",
                        lambda lib: Path("/nonexistent") / f"lib{lib}.so")
    fn = getattr(tattn, name)
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        _wrapper_calls()[name]()
    assert fn.launches == before


class _FakeLib:
    """Accepts the ctypes declarations; any call would be a bug."""

    def __getattr__(self, name):
        return _FakeFn()


class _FakeFn:
    def __call__(self, *a):
        raise AssertionError("a kernel was launched on CPU operands")


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_reject_non_cuda_tensors(kernel_path, monkeypatch,
                                                 name):
    monkeypatch.setattr(_build, "library", lambda lib: _FakeLib())
    with pytest.raises(ValueError, match="CUDA tensor"):
        _wrapper_calls()[name]()


# ---- the forward's plan and the bf16 body's numerics

@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
def test_flash_plan_per_head_dim(d):
    """bf16 runs the wgmma body at every head dim: one warpgroup of 128
    threads, the head dim padded with zero columns to whole 64-column
    blocks of 128-byte rows (the 128-byte swizzle's), copies of 16 bytes
    where a row is whole 16-byte chunks (8 for d = 12's 24-byte rows), a Q
    tile and 3 K/V stages up to d = 64, 2 above, plus 1024 bytes to align
    the swizzle atoms, inside a block's shared memory. f32 keeps the FMA
    body of 256 threads."""
    plan = tattn._flash_plan(d, torch.bfloat16)
    assert (plan.body, plan.threads) == ("wgmma", 128)
    assert plan.head_dim % 64 == 0 and d <= plan.head_dim < d + 64
    assert (2 * d) % plan.copy_bytes == 0
    assert plan.copy_bytes == (8 if d == 12 else 16)
    assert plan.stages == (3 if d <= 64 else 2)
    assert plan.smem_bytes == (1 + 2 * plan.stages) * 64 * plan.head_dim \
        * 2 + 1024 <= 232448
    f32 = tattn._flash_plan(d, torch.float32)
    assert (f32.body, f32.head_dim, f32.threads) == ("fma", d, 256)
    assert f32.smem_bytes <= 232448


def test_flash_plan_refuses_what_is_not_compiled():
    with pytest.raises(ValueError, match="head dim"):
        tattn._flash_plan(40, torch.bfloat16)
    with pytest.raises(TypeError):
        tattn._flash_plan(64, torch.float16)


def _few_key_inputs(b, h, s, d, seed):
    """bf16 q, k, v whose first keys' values cancel (v1 = -v0, v2 =
    -v0/2, |v| about 4): a row that sees 1..3 keys outputs a small
    difference of large weighted values, where an error in the weights
    shows in full."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(4 * rng.standard_normal((b, h, s, d)).astype(
        np.float32))
    v[:, :, 1] = -v[:, :, 0]
    v[:, :, 2] = -0.5 * v[:, :, 0]
    return q, k, v.to(torch.bfloat16)


def _over_tol(got, ref):
    """Largest |got - ref| over its element's bf16 tolerance, 1e-3 +
    2^-8·|ref| (chip_smoke.py's FLASH_TOL, as the card holds the
    kernels)."""
    return ((got.float() - ref).abs() / (1e-3 + 2.0 ** -8 * ref.abs())) \
        .max().item()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mma_model_meets_the_tolerance_on_few_key_rows(causal):
    """The bf16 body's numerics (P as hi + lo bf16 terms) hold every
    element within the card's per-element tolerance of the plain forward
    on rows of 1, 2 and 3 keys whose values cancel, and the LSE within
    1e-4; one bf16 rounding of P does not (as in the paged kernels'
    split model)."""
    q, k, v = _few_key_inputs(4, 2, 130, 16, seed=20)
    lens = torch.tensor([2, 3, 1, 130], dtype=torch.int32)
    sm = 0.25
    ref_o, ref_lse = tattn._flash_fwd_reference(q.float(), k.float(),
                                                v.float(), lens, sm, causal)
    out, lse = tattn._flash_mma_reference(q, k, v, lens, sm, causal)
    assert out.dtype == torch.bfloat16
    assert _over_tol(out, ref_o) <= 1.0
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    one, _ = tattn._flash_mma_reference(q, k, v, lens, sm, causal,
                                        p_terms=1)
    assert _over_tol(one, ref_o) > 1.0


@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mma_model_matches_the_plain_forward(d, causal):
    """At every compiled head dim: ragged s (197, ViT's, with a last tile
    of 5 rows and keys), kv_lens with a 0 (exact zeros and LSE_MASKED), a
    1 and a partial tile; the model within the bf16 tolerance of the
    plain forward, its LSE within 1e-4."""
    b, h, s = 4, 2, 197
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor([197, 0, 1, 77], dtype=torch.int32)
    sm = 1.0 / np.sqrt(d)
    ref_o, ref_lse = tattn._flash_fwd_reference(q.float(), k.float(),
                                                v.float(), lens, sm, causal)
    out, lse = tattn._flash_mma_reference(q, k, v, lens, sm, causal)
    assert _over_tol(out, ref_o) <= 1.0
    live = ref_lse < 1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-4
    assert torch.all(out[1] == 0) and torch.all(lse[1] == tattn.LSE_MASKED)


# ---- the backward's plan and the bf16 bodies' numerics

@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
def test_flash_bwd_plan_per_head_dim(d):
    """bf16: B5 runs the wgmma body at every head dim and B6 up to d = 128
    (above, dK's and dV's accumulators leave no registers for S and dP),
    both with the forward's padded tiles, copies and ring depth: B5's
    shared memory Q, dO and the K/V ring, B6's K, V and the Q/dO ring with
    the rows' f32 lse and delta, each + 1024 bytes, inside a block. f32
    (and bf16 B6 at d = 192) keeps the FMA bodies of 256 threads."""
    fwd = tattn._flash_plan(d, torch.bfloat16)
    plan = tattn._flash_bwd_plan(d, torch.bfloat16)
    tiles = (2 + 2 * fwd.stages) * 64 * fwd.head_dim * 2
    assert plan.dq == fwd._replace(smem_bytes=tiles + 1024)
    if d <= 128:
        assert plan.dkv == fwd._replace(
            smem_bytes=tiles + fwd.stages * 2 * 64 * 4 + 1024)
    else:
        assert (plan.dkv.body, plan.dkv.head_dim, plan.dkv.copy_bytes,
                plan.dkv.threads) == ("fma", d, 2, 256)
    f32 = tattn._flash_bwd_plan(d, torch.float32)
    for p in (*plan, *f32):
        assert p.smem_bytes <= 232448
    for p in f32:
        assert (p.body, p.head_dim, p.copy_bytes, p.threads) == \
            ("fma", d, 4, 256)
    assert f32.dkv.smem_bytes == (2 * 64 * d + 2 * 64 * (d + 4)
                                  + 2 * 64 * 65 + 128) * 4
    with pytest.raises(ValueError, match="head dim"):
        tattn._flash_bwd_plan(40, torch.bfloat16)


def _bwd_case(q, k, v, do, lens, sm, causal):
    """The plain backward in f32 on the plain forward's lse and delta, as
    the card's tests feed the kernels."""
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = tattn._flash_fwd_reference(*f32[:3], lens, sm, causal)
    delta = tattn._delta(f32[3], out)
    dq = tattn._flash_bwd_dq_reference(*f32, lse, delta, lens, sm, causal)
    dk, dv = tattn._flash_bwd_dkv_reference(*f32, lse, delta, lens, sm,
                                            causal)
    return lse, delta, (dq, dk, dv)


@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bwd_mma_model_matches_the_plain_backward(d, causal):
    """The bf16 backward's numerics (P and dS as hi + lo bf16 terms) at
    every compiled head dim: s 130 (a last tile of 2 rows and keys),
    kv_lens 0 (exact zero gradients), 1, 77 (not a multiple of 64) and
    all; dq, dk and dv each within 1e-3 + 2^-8·|plain| of the plain
    backward run in f32."""
    b, h, s = 4, 2, 130
    rng = np.random.default_rng(d + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    lens = torch.tensor([130, 0, 1, 77], dtype=torch.int32)
    sm = 1.0 / np.sqrt(d)
    lse, delta, refs = _bwd_case(q, k, v, do, lens, sm, causal)
    got = tattn._flash_bwd_mma_reference(q, k, v, do, lse, delta, lens, sm,
                                         causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert g.dtype == torch.bfloat16
        assert _over_tol(g, r) <= 1.0, name
        assert torch.all(g[1] == 0), name


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bwd_mma_model_needs_two_terms_of_p_and_ds(causal):
    """What decides the precision: rows of 1..3 keys, the first three keys
    identical (a row that sees only them has dq = 0 up to rounding: its
    dS sums to zero), and a long example. Two terms of each meet the
    tolerance; one rounding of dS fails on the few-key rows' dq (26x the
    tolerance), one rounding of P on dv."""
    rng = np.random.default_rng(21)
    b, h, s, d = 4, 2, 130, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                    .astype(np.float32)) for _ in range(4))
    k[:, :, 1] = k[:, :, 0]
    k[:, :, 2] = k[:, :, 0]
    k, v = 2 * k, 2 * v
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    lens = torch.tensor([3, 2, 1, 130], dtype=torch.int32)
    lse, delta, (rdq, rdk, rdv) = _bwd_case(q, k, v, do, lens, 0.25, causal)

    def model(p_terms, ds_terms):
        return tattn._flash_bwd_mma_reference(q, k, v, do, lse, delta, lens,
                                              0.25, causal, p_terms,
                                              ds_terms)

    dq, dk, dv = model(2, 2)
    assert max(_over_tol(dq, rdq), _over_tol(dk, rdk),
               _over_tol(dv, rdv)) <= 1.0
    dq1, _, _ = model(2, 1)
    assert _over_tol(dq1[:3], rdq[:3]) > 10.0
    _, _, dv1 = model(1, 2)
    assert _over_tol(dv1, rdv) > 1.0
