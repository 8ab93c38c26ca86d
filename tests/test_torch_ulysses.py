"""Port parity for Ulysses attention (``rafiki_tpu_torch/ops/ulysses.py``)
against ``rafiki_tpu/ops/ulysses.py`` on the CPU.

JAX runs on the 8 fake CPU devices of ``tests/conftest.py`` (its flash
attention takes the XLA path there); the port runs the plain B3/B5/B6
on CPU tensors, one tensor per mesh position, around its two
all-to-alls. Inputs are seeded numpy, f32. Both GQA branches are held:
``small_swap`` (the kv heads divide the axis: the un-repeated K/V are
swapped, then repeated) and the repeat before the swap. Outputs and
gradients (autograd against ``jax.vjp`` with one seeded cotangent) are
held to the f32 kernel tolerance, 1e-5 + 1e-5·|JAX| per element; JAX's
``ValueError`` texts word for word.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from rafiki_tpu.ops.ulysses import ulysses_attention as julysses
from rafiki_tpu_torch.ops import attention as fa
from rafiki_tpu_torch.ops import ulysses as uly
from rafiki_tpu_torch.parallel import collectives as col
from rafiki_tpu_torch.parallel import sharding as ps

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def _inputs(seed, b=4, h=8, h_kv=2, s=32, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, h_kv, s, d),
                               (b, h_kv, s, d), (b, h, s, d)))


def _meshes(shape, names):
    n = int(np.prod(shape))
    jmesh = JMesh(np.array(jax.devices()[:n], dtype=object).reshape(shape),
                  names)
    return jmesh, ps.Mesh(np.array(["cpu"] * n, dtype=object).reshape(
        shape).tolist(), names)


# (name, mesh shape, axis names, head_axis, kv heads, small_swap)
CASES = [
    ("sp2-small-swap", (4, 2), ("data", "sp"), None, 2, True),
    ("sp4-repeat-first", (2, 4), ("data", "sp"), None, 2, False),
    ("sp8-mha", (1, 8), ("data", "sp"), None, 8, False),
    ("sp2-tp2-small-swap", (2, 2, 2), ("data", "sp", "model"), "model", 4,
     True),
    ("sp4-tp2-repeat-first", (1, 4, 2), ("data", "sp", "model"), "model",
     2, False),
]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ulysses_matches_jax(case, causal, monkeypatch):
    _, shape, names, head_axis, h_kv, small_swap = case
    jmesh, mesh = _meshes(shape, names)
    q, k, v, g = _inputs(11, h_kv=h_kv)

    @jax.jit
    def jax_uly(a, b, c, ct):
        out, vjp = jax.vjp(lambda a, b, c: julysses(
            a, b, c, jmesh, "sp", causal=causal, batch_axis="data",
            head_axis=head_axis), a, b, c)
        return out, vjp(ct)

    out, jgrads = jax_uly(q, k, v, g)
    # the branch: what rides the swap is the kv heads un-repeated
    swapped = []
    a2a = col.all_to_all

    def spy(xs, devs, split_dim, concat_dim):
        swapped.append(xs[0].shape[1])
        return a2a(xs, devs, split_dim, concat_dim)

    monkeypatch.setattr(uly, "all_to_all", spy)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = uly.ulysses_attention(tq, tk, tv, mesh, "sp", causal=causal,
                                batch_axis="data", head_axis=head_axis)
    _close(got, out)
    for a, b in zip(torch.autograd.grad(got, (tq, tk, tv),
                                        torch.tensor(g)), jgrads):
        _close(a, b)
    # the forward's three swaps, one call per sp group: q's heads, then
    # K's and V's as they ride (un-repeated with the small swap)
    tp = mesh.axis_size("model")
    groups = mesh.size // mesh.shape["sp"]
    kv_rides = (h_kv if small_swap else 8) // tp
    assert swapped[:3 * groups] == [8 // tp] * groups + \
        [kv_rides] * (2 * groups), swapped


def test_ulysses_per_position_launches_one_flash_call_each():
    """Per-position lists in and out; each position runs one full-sequence
    flash attention over its h / P heads."""
    mesh = ps.make_sp_mesh(["cpu"] * 4, 4)
    q, k, v, _ = _inputs(12, b=1)
    parts = [col.to_positions(torch.tensor(x), mesh, (None, None, "sp"))
             for x in (q, k, v)]
    seen = []
    flash = uly.flash_attention

    def spy(a, b, c, **kw):
        seen.append(tuple(a.shape))
        return flash(a, b, c, **kw)

    uly.flash_attention = spy
    try:
        outs = uly.ulysses_attention(*parts, mesh, "sp", causal=True)
    finally:
        uly.flash_attention = flash
    assert seen == [(1, 2, 32, 16)] * 4
    whole = fa._attention_reference(
        torch.tensor(q), torch.tensor(k).repeat_interleave(4, 1),
        torch.tensor(v).repeat_interleave(4, 1), 0.25, True)
    _close(torch.cat(outs, 2), whole.numpy())


@pytest.mark.parametrize("shape,names,h,h_kv,head_axis", [
    ((1, 2, 2), ("data", "sp", "model"), 6, 3, "model"),
    ((2, 4), ("data", "sp"), 6, 2, None),
    ((1, 4, 2), ("data", "sp", "model"), 4, 2, "model"),
], ids=["tp-heads", "sp-heads", "tp-sp-heads"])
def test_ulysses_errors_match_jax(shape, names, h, h_kv, head_axis):
    jmesh, mesh = _meshes(shape, names)
    q, k, v, _ = _inputs(13, h=h, h_kv=h_kv)
    with pytest.raises(ValueError) as want:
        julysses(q, k, v, jmesh, "sp", head_axis=head_axis)
    with pytest.raises(ValueError) as got:
        uly.ulysses_attention(*(torch.tensor(x) for x in (q, k, v)), mesh,
                              "sp", head_axis=head_axis)
    assert str(got.value) == str(want.value)
