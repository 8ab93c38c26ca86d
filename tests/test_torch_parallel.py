"""Port parity for the sharding vocabulary and the collectives
(``rafiki_tpu_torch/parallel/sharding.py``, ``collectives.py``, ``mesh.py``)
against ``rafiki_tpu/parallel/sharding.py`` on the CPU.

JAX runs on the 8 fake CPU devices of ``tests/conftest.py``; the port
puts every shard of its meshes on ``cpu`` (one process drives a mesh, and
a device may repeat in it). Specs are compared exactly; the
data-parallel gradient keeps JAX's tolerance (rtol 2e-5, atol 2e-6); a
collective's forward equals the unsharded computation it stands for bit
for bit, and its gradient within 1e-12 (f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.llama_lora import TP_RULES as JTP_RULES
from rafiki_tpu.parallel import sharding as js
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.parallel import collectives as col
from rafiki_tpu_torch.parallel import sharding as ps
from rafiki_tpu_torch.parallel.mesh import DeviceSpec, SubMesh

torch.set_num_threads(1)

KNOBS = {"max_epochs": 1, "vocab_size": 1 << 10, "hidden_dim": 64,
         "depth": 2, "n_heads": 4, "kv_ratio": 2, "lora_rank": 4,
         "max_len": 32, "model_parallel": 2, "learning_rate": 1e-2,
         "batch_size": 8, "bf16": False}


def _jax_specs(tree, mesh, **kw):
    flat = jax.tree_util.tree_flatten_with_path(
        js.param_shardings(tree, mesh, **kw),
        is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {"/".join(str(k.key) for k in kp): tuple(s.spec)
            for kp, s in flat}


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("min_size", [2 ** 12, 0], ids=["fsdp4k", "fsdp0"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2)],
                         ids=["1x2", "2x2", "4x2"])
def test_llama_specs_equal_jax(shape, min_size, moe):
    knobs = {**KNOBS, "moe_experts": moe}
    module = JLlamaLoRA(**knobs)._module()
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32)))["params"]
    jmesh = js.make_mesh(jax.devices()[:shape[0] * shape[1]],
                         model=shape[1])
    want = _jax_specs(abstract, jmesh, tp_rules=JTP_RULES, fsdp=True,
                      min_size=min_size)
    pmesh = ps.make_mesh(["cpu"] * (shape[0] * shape[1]), model=shape[1])
    shapes = ll.LlamaLoRA(device="cpu", **knobs)._param_shapes()
    got = ps.param_shardings(shapes, pmesh, tp_rules=ll.TP_RULES,
                             fsdp=True, min_size=min_size)
    assert ll.TP_RULES == JTP_RULES
    assert list(ll.TP_RULES) == list(JTP_RULES)  # first match wins
    assert got == want
    # and the shard shapes JAX's estimate reads
    for path, leaf in ps.leaf_paths(shapes):
        p = "/".join(path)
        jshape = NamedSharding(jmesh, P(*want[p])).shard_shape(leaf.shape)
        assert ps.shard_shape(leaf.shape, got[p], pmesh) == jshape, p


def test_spec_helpers_equal_jax():
    jmesh = js.make_mesh(jax.devices()[:8], model=2)
    pmesh = ps.make_mesh(["cpu"] * 8, model=2)
    rules = {"q_proj": -1, "up": -1, "o_proj": 0, "down": 0}
    params = {"attn": {"q_proj": np.zeros((256, 512)),
                       "o_proj": np.zeros((512, 256))},
              "mlp": {"up": np.zeros((256, 1024)),
                      "down": np.zeros((1024, 256)),
                      "odd": np.zeros((3, 5))},
              "norm": {"scale": np.zeros((256,))}}
    for kw in ({"tp_rules": rules, "fsdp": True, "min_size": 1024},
               {"tp_rules": rules}, {"fsdp": True, "min_size": 0}, {}):
        assert ps.param_shardings(params, pmesh, **kw) == \
            _jax_specs(params, jmesh, **kw), kw
    for a, b in ((("data",), (None, "model")), ((), ("model",)),
                 ((None, "model"), ("data",))):
        assert ps.combine_specs(a, b) == tuple(js.combine_specs(P(*a),
                                                                P(*b)))
    with pytest.raises(ValueError, match="conflicting"):
        ps.combine_specs(("data",), ("model",))
    assert ps.fsdp_param_spec("x", (8, 8), pmesh, min_size=0,
                              base=("model",)) == \
        tuple(js.fsdp_param_spec("x", (8, 8), jmesh, min_size=0,
                                 base=P("model")))


def test_make_mesh_errors_and_layout():
    for kw, msg in (({"model": 3}, "not divisible by model=3"),
                    ({"data": 3, "model": 2},
                     r"data\*model = 6 != 4 devices")):
        with pytest.raises(ValueError, match=msg):
            js.make_mesh(jax.devices()[:4], **kw)
        with pytest.raises(ValueError, match=msg):
            ps.make_mesh(["cpu"] * 4, **kw)
    m = ps.make_mesh(["cpu"] * 8, model=2)
    jm = js.make_mesh(jax.devices()[:8], model=2)
    assert m.shape == dict(jm.shape) and m.axis_names == jm.axis_names
    assert m.positions()[:3] == [(0, 0), (0, 1), (1, 0)]
    # a device may repeat; a mesh of mixed device types raises
    with pytest.raises(ValueError, match="one type"):
        ps.make_mesh(["cpu", "cuda:0"], model=2)
    sub = SubMesh(0, [DeviceSpec(0, platform="cpu")] * 4)
    assert sub.mesh(model=2).shape == {"data": 2, "model": 2}
    assert sub.mesh({"data": 1, "model": 4}).shape == {"data": 1,
                                                       "model": 4}
    with pytest.raises(ValueError, match="do not cover"):
        sub.mesh({"data": 3})
    # any named axes, as JAX's SubMesh.mesh takes them
    sp = sub.mesh({"data": 1, "sp": 2, "model": 2})
    assert sp.axis_names == ("data", "sp", "model")
    assert sp.shape == {"data": 1, "sp": 2, "model": 2}


@pytest.mark.parametrize("n,mp,want", [(8, 2, (4, 2)), (4, 4, (1, 4)),
                                       (6, 4, (3, 2)), (3, 4, (3, 1)),
                                       (1, 2, (1, 1)), (2, 1, (2, 1))])
def test_mesh_halving_rule_equals_jax(n, mp, want):
    knobs = {**KNOBS, "model_parallel": mp}
    jmesh = JLlamaLoRA(**knobs)._mesh(jax.devices()[:n])
    pmesh = ll.LlamaLoRA(device="cpu", **knobs)._mesh(["cpu"] * n)
    assert (pmesh.shape["data"], pmesh.shape["model"]) == want == \
        (jmesh.shape["data"], jmesh.shape["model"])


def test_pad_batch_to_axis_equals_jax():
    jmesh = js.make_mesh(jax.devices()[:8], model=2)
    pmesh = ps.make_mesh(["cpu"] * 8, model=2)
    for b in (1, 3, 4, 5, 8):
        x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
        want = np.asarray(js.pad_batch_to_axis(jnp.asarray(x), jmesh))
        np.testing.assert_array_equal(ps.pad_batch_to_axis(x, pmesh), want)
        np.testing.assert_array_equal(
            ps.pad_batch_to_axis(torch.from_numpy(x), pmesh,
                                 "model").numpy(),
            np.asarray(js.pad_batch_to_axis(jnp.asarray(x), jmesh,
                                            "model")))


def test_data_parallel_train_step_on_mesh():
    """JAX's ``test_data_parallel_train_step_on_mesh`` on the port's
    mesh: the batch split over 8 data positions, the weight replicated,
    the loss all-reduced; the summed replica gradients equal the
    single-device gradient and JAX's sharded one."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 4)).astype(np.float32)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(32,))

    def jloss(w, xb, yb):
        logp = jax.nn.log_softmax(xb @ w)
        return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], 1))

    jmesh = js.make_mesh(jax.devices()[:8])
    jgrad = jax.jit(jax.grad(jloss), in_shardings=(
        NamedSharding(jmesh, P()), js.batch_sharding(jmesh),
        NamedSharding(jmesh, P("data"))),
        out_shardings=NamedSharding(jmesh, P()))(
        js.replicate_tree(w, jmesh), js.shard_batch(x, jmesh),
        jax.device_put(y, NamedSharding(jmesh, P("data"))))

    mesh = ps.make_mesh(["cpu"] * 8)
    rows = ps.shard_batch({"x": x, "y": y}, mesh)
    wl = ps.replicate_tree(w, mesh)
    ws = [t.requires_grad_(True) for t in wl.shards]
    parts = [-(torch.log_softmax(r["x"] @ wi, -1).gather(
        1, r["y"][:, None].long()).sum()) / 32 for r, wi in zip(rows, ws)]
    loss = col.all_reduce(parts, mesh.flat_devices())[0]
    grads = torch.autograd.grad(loss, ws)
    summed = col.all_reduce(list(grads), mesh.flat_devices())
    tw = torch.from_numpy(w).requires_grad_(True)
    local = torch.autograd.grad(-(torch.log_softmax(
        torch.from_numpy(x) @ tw, -1).gather(
            1, torch.from_numpy(y)[:, None]).mean()), tw)[0]
    for g in summed:
        np.testing.assert_allclose(g.numpy(), local.numpy(), rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(
        w, jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


def _parts(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float64))
            .requires_grad_(True) for _ in range(n)]


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu"]],
                         ids=["4", "2"])
def test_collectives_equal_the_unsharded_computation(devices):
    """Each collective's outputs and the gradients of a weighted sum of
    them equal the same computation on whole tensors; members on one
    device share one result."""
    n = len(devices)
    devs = [torch.device(d) for d in devices]
    cot = [torch.from_numpy(np.random.default_rng(9 + k).normal(
        size=(3, 4 * n))) for k in range(n)]

    # all_reduce: every member holds the sum
    xs = _parts(n, (3, 4 * n), 0)
    out = col.all_reduce(xs, devs)
    assert all(o is out[0] for o in out)  # one device: one result
    want = sum(x.detach() for x in xs)
    assert torch.equal(out[0], want)
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)),
                            xs)
    for gg in g:  # the all-reduce of the cotangents
        assert torch.allclose(gg, sum(cot), rtol=0, atol=1e-12)

    # all_gather: every member holds the concatenation
    xs = _parts(n, (3, 4), 1)
    out = col.all_gather(xs, devs, 1)
    assert torch.equal(out[0], torch.cat([x.detach() for x in xs], 1))
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)),
                            xs)
    total = sum(cot)
    for k, gg in enumerate(g):  # the reduce-scatter of the cotangents
        assert torch.allclose(gg, total[:, 4 * k:4 * (k + 1)], rtol=0,
                              atol=1e-12)

    # reduce_scatter: member k holds chunk k of the sum
    xs = _parts(n, (3, 4 * n), 2)
    out = col.reduce_scatter(xs, devs, 1)
    whole = sum(x.detach() for x in xs)
    for k, o in enumerate(out):
        assert torch.equal(o, whole[:, 4 * k:4 * (k + 1)])
    small = [c[:, :4] for c in cot]
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, small)),
                            xs)
    for gg in g:  # the all-gather of the cotangents
        assert torch.equal(gg, torch.cat(small, 1))
    with pytest.raises(ValueError, match="does not divide"):
        col.reduce_scatter(_parts(n, (3, 4 * n + 1), 3), devs, 1)


def test_owners_share_along_named_axes_on_one_device():
    """Positions that differ only along the shared axes and sit on one
    device own one tensor; ``on_axis`` runs once for groups whose
    members have the same owners."""
    mesh = ps.make_sp_mesh(["cpu"] * 8, 2, model=2)  # (data 2, sp 2, model 2)
    assert col.owners(mesh) == list(range(8))
    assert col.owners(mesh, ("sp",)) == [0, 1, 0, 1, 4, 5, 4, 5]
    leaf = col.ShardedLeaf.from_full(torch.arange(8.0).reshape(2, 4), mesh,
                                     ("data", "model"), share=("sp",))
    assert leaf.owner == [0, 1, 0, 1, 4, 5, 4, 5]
    assert leaf.owned() == [0, 1, 4, 5]
    assert all(leaf.shards[p] is leaf.shards[o]
               for p, o in enumerate(leaf.owner))
    calls = []

    def op(xs, devs, dim):
        calls.append(len(xs))
        return col.all_gather(xs, devs, dim)

    out = col.on_axis(mesh, "data", op, leaf.shards, 0, owner=leaf.owner)
    assert calls == [2, 2]  # one per model position, not per (sp, model)
    assert out[0] is out[2] and out[1] is out[3]
    assert torch.equal(out[0], torch.tensor([[0.0, 1.0], [4.0, 5.0]]))
    col.on_axis(mesh, "data", op, leaf.shards, 0)
    assert calls == [2] * 6


def test_sharded_leaf_round_trip_and_replicas():
    mesh = ps.make_mesh(["cpu"] * 4, model=2)
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec, n_slices in (((), 1), (("data",), 2), ((None, "model"), 2),
                           (("data", "model"), 4), (("model", "data"), 4)):
        leaf = col.ShardedLeaf.from_full(full, mesh, spec)
        assert torch.equal(leaf.full(), full)
        assert sum(leaf.replica_id(p) == 0 for p in range(4)) == n_slices
    bf = col.ShardedLeaf.from_full(full, mesh, ("data",),
                                   dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf.full(dtype=torch.float32), full)
