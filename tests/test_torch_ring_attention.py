"""Port parity for the blockwise flash entry points and ring attention
(``rafiki_tpu_torch/ops/attention.py`` ``flash_attention_lse``,
``flash_attention_block_bwd``; ``rafiki_tpu_torch/ops/ring_attention.py``)
against ``rafiki_tpu/ops/attention.py`` and
``rafiki_tpu/ops/ring_attention.py`` on the CPU.

JAX runs on the 8 fake CPU devices of ``tests/conftest.py`` (its flash
entry points take their XLA twins there); the port runs the plain
B3/B5/B6 on CPU tensors, one tensor per mesh position. Inputs are seeded
numpy, f32, with Llama's GQA group of 4 (8 query heads over 2 kv heads).
Outputs, LSEs and gradients (through autograd against ``jax.vjp`` with
one seeded cotangent) are held to the f32 kernel tolerance, 1e-5 +
1e-5·|JAX| per element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from rafiki_tpu.ops import attention as jfa
from rafiki_tpu.ops.ring_attention import ring_attention as jring
from rafiki_tpu_torch.ops import attention as fa
from rafiki_tpu_torch.ops.ring_attention import ring_attention
from rafiki_tpu_torch.parallel import collectives as col
from rafiki_tpu_torch.parallel import sharding as ps

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _inputs(seed, b=4, h=8, h_kv=2, s=32, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    g = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.tensor(x, requires_grad=True) for x in xs]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_lse_matches_jax(causal):
    q, k, v, g = _inputs(1, b=2, h=4, h_kv=4, s=24)
    g_lse = np.random.default_rng(2).standard_normal(
        (2, 4, 24)).astype(np.float32)
    scale = 0.3
    (jo, jl), vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_lse(
        a, b, c, scale, causal), q, k, v)
    jgrads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = _t(q, k, v)
    o, lse = fa.flash_attention_lse(tq, tk, tv, scale, causal)
    _close(o, jo)
    _close(lse, jl)
    grads = torch.autograd.grad((o, lse), (tq, tk, tv),
                                (torch.tensor(g), torch.tensor(g_lse)))
    for a, b in zip(grads, jgrads):
        _close(a, b)
    # without a gradient to take: the same (out, lse), no autograd node
    with torch.no_grad():
        o2, lse2 = fa.flash_attention_lse(tq, tk, tv, scale, causal)
    assert torch.equal(o2, o.detach()) and torch.equal(lse2, lse.detach())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_block_bwd_matches_jax(causal):
    """One block's grads against the global output and LSE of a longer
    key set: JAX's block backward, f32 out."""
    q, k, v, g = _inputs(3, b=2, h=4, h_kv=4, s=16)
    rng = np.random.default_rng(4)
    o = rng.standard_normal(q.shape).astype(np.float32)
    lse = (rng.standard_normal(q.shape[:3]) + 3.0).astype(np.float32)
    want = jfa.flash_attention_block_bwd(q, k, v, o, lse, g, 0.25, causal)
    got = fa.flash_attention_block_bwd(*(torch.tensor(x) for x in
                                         (q, k, v, o, lse, g)), 0.25,
                                       causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b)


# (name, mesh shape, axis names, batch_axis, head_axis)
MESHES = [
    ("sp2", (4, 2), ("data", "sp"), "data", None),
    ("sp4", (2, 4), ("data", "sp"), "data", None),
    ("sp8", (1, 8), ("data", "sp"), "data", None),
    ("sp2-tp2", (2, 2, 2), ("data", "sp", "model"), "data", "model"),
    ("sp4-tp2", (1, 4, 2), ("data", "sp", "model"), "data", "model"),
]


def _meshes(shape, names):
    n = int(np.prod(shape))
    jmesh = JMesh(np.array(jax.devices()[:n], dtype=object).reshape(shape),
                  names)
    return jmesh, ps.Mesh(np.array(["cpu"] * n, dtype=object).reshape(
        shape).tolist(), names)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mesh_case", MESHES, ids=[m[0] for m in MESHES])
def test_ring_attention_matches_jax(mesh_case, causal):
    _, shape, names, batch_axis, head_axis = mesh_case
    jmesh, mesh = _meshes(shape, names)
    q, k, v, g = _inputs(5)

    @jax.jit
    def jax_ring(a, b, c, ct):
        out, vjp = jax.vjp(lambda a, b, c: jring(
            a, b, c, jmesh, "sp", causal=causal, batch_axis=batch_axis,
            head_axis=head_axis), a, b, c)
        return out, vjp(ct)

    out, jgrads = jax_ring(q, k, v, g)
    tq, tk, tv = _t(q, k, v)
    got = ring_attention(tq, tk, tv, mesh, "sp", causal=causal,
                         batch_axis=batch_axis, head_axis=head_axis)
    _close(got, out)
    for a, b in zip(torch.autograd.grad(got, (tq, tk, tv),
                                        torch.tensor(g)), jgrads):
        _close(a, b)


def test_ring_attention_per_position_and_launches(monkeypatch):
    """The per-position form: one tensor per position in, one out; the
    ring takes P(P+1)/2 blocks of P² under causality (a future block
    launches nothing) and P² without, in the forward and the backward;
    only the kv-head tensors rotate."""
    mesh = ps.make_sp_mesh(["cpu"] * 4, 4)
    q, k, v, g = _inputs(6, b=1)
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    shapes = []
    fwd, dq, dkv = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkv)

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            shapes.append(tuple(a[1].shape))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", count("dq", dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", count("dkv", dkv))
    for causal, blocks in ((True, 10), (False, 16)):
        calls.update(fwd=0, dq=0, dkv=0)
        parts = [col.to_positions(torch.tensor(x, requires_grad=True), mesh,
                                  (None, None, "sp")) for x in (q, k, v)]
        parts = [[t.detach().requires_grad_(True) for t in ps_] for ps_ in
                 parts]
        outs = ring_attention(*parts, mesh, "sp", causal=causal)
        assert len(outs) == 4 and outs[0].shape == (1, 8, 8, 16)
        whole = fa._attention_reference(
            torch.tensor(q), torch.tensor(k).repeat_interleave(4, 1),
            torch.tensor(v).repeat_interleave(4, 1), 0.25, causal)
        _close(torch.cat(outs, 2), whole.numpy())
        torch.autograd.grad(outs, [t for p in parts for t in p],
                            [torch.ones_like(o) for o in outs])
        assert calls == {"fwd": blocks, "dq": blocks, "dkv": blocks}
    # the resident blocks are the 2 kv heads repeated to 8
    assert set(shapes) == {(1, 8, 8, 16)}


def test_ring_attention_errors_match_jax():
    jmesh, mesh = _meshes((1, 2, 2), ("data", "sp", "model"))
    q, k, v, _ = _inputs(7, h=6, h_kv=3)
    with pytest.raises(ValueError) as want:
        jring(q, k, v, jmesh, "sp", head_axis="model")
    with pytest.raises(ValueError) as got:
        ring_attention(*_t(q, k, v), mesh, "sp", head_axis="model")
    assert str(got.value) == str(want.value)
    q, k, v, _ = _inputs(7, h=6, h_kv=4)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ring_attention(*_t(q, k, v), mesh, "sp")


def test_ppermute_and_all_to_all_gradients():
    """The ring's hop and Ulysses' swap as autograd functions: a rotation
    whose gradient is the reverse rotation, an all-to-all whose gradient
    is the inverse all-to-all (f64, against the unsharded computation
    they stand for)."""
    devs = [torch.device("cpu")] * 4
    xs = [torch.randn(2, 8, 3, dtype=torch.float64, requires_grad=True)
          for _ in range(4)]
    ys = col.ppermute(xs, devs, 1)
    assert all(y.data_ptr() == xs[(k - 1) % 4].data_ptr()
               for k, y in enumerate(ys))  # a relabelling: no copy
    ws = [torch.randn(2, 8, 3, dtype=torch.float64) for _ in range(4)]
    grads = torch.autograd.grad(ys, xs, ws)
    for k in range(4):
        assert torch.equal(grads[k], ws[(k + 1) % 4])
    zs = col.all_to_all(xs, devs, 1, 2)
    assert zs[1].shape == (2, 2, 12)
    for k in range(4):  # chunk k of every member, in member order
        assert torch.equal(zs[k], torch.cat(
            [x[:, 2 * k:2 * k + 2] for x in xs], 2))
    grads = torch.autograd.grad(zs, xs, ws[:4] and [w.reshape(2, 2, 12)
                                                   for w in ws])
    back = col.all_to_all([w.reshape(2, 2, 12) for w in ws], devs, 2, 1)
    for a, b in zip(grads, back):
        assert torch.equal(a, b)
