"""Port parity for ``LlamaLoRA``'s ``sequence_parallel`` (the (data, sp)
and (data, sp, model) meshes, ring and Ulysses attention, the sharded
streamed loss; ``rafiki_tpu_torch/models/llama_mesh.py``) against JAX's
mesh loop, in f32 on the CPU.

JAX trains on its 8 fake CPU devices (``TrainContext(devices=...)`` of
the mesh's size), the port on a mesh whose every shard is ``cpu``. Both
start from one init blob; ``lora_scale`` is 1, where the two loops agree
(ROADMAP Queue C 23).

Tolerances: per-epoch losses within 1e-5 relative, trained leaves within
1e-4 absolute (blockwise softmax merges, all-to-all'd heads and the
sums over ``sp`` replicas add in another order than one device does),
as ``test_torch_llama_tp.py``; the streamed loss's value and count
within 1e-6 relative and its gradients within 1e-5 absolute (f32); the
checkpoints bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models import llama_lora as jll
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.store.sharded_ckpt import ShardedCheckpointer as JCkpt
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.parallel import sharding as ps
from rafiki_tpu_torch.parallel.collectives import to_positions
from rafiki_tpu_torch.store.sharded_ckpt import ShardedCheckpointer

torch.set_num_threads(1)

KNOBS = {"max_epochs": 2, "vocab_size": 1 << 10, "hidden_dim": 64,
         "depth": 2, "n_heads": 4, "kv_ratio": 2, "lora_rank": 4,
         "max_len": 32, "learning_rate": 1e-2, "batch_size": 8,
         "bf16": False, "quick_train": True, "share_params": False,
         "lora_scale": 1.0}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama_sp")
    train = str(d / "train.jsonl")
    # one batch of 8: an epoch is one step, two epochs two steps
    generate_text_classification_dataset(train, 8, seed=0)
    return train


def _init_blob(knobs, seed=0):
    module = JLlamaLoRA(**knobs)._module()
    params = module.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 32), jnp.int32))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "meta": {"id2tok": {}}}


def _both(corpus, knobs, n, ctx_extra=None):
    blob = _init_blob(knobs)
    jm, pm = JLlamaLoRA(**knobs), ll.LlamaLoRA(device="cpu", **knobs)
    jm.load_parameters(blob)
    pm.load_parameters(blob)
    jctx = JTrainContext(devices=jax.devices()[:n])
    pctx = TrainContext(devices=["cpu"] * n, **(ctx_extra or {}))
    jm.train(corpus, jctx)
    pm.train(corpus, pctx)
    return jm, pm, jctx, pctx


# (extra knobs, mesh shape); the dispatch as JAX's _DecoderAttention
# picks it: ring where n_heads / model_parallel does not divide over sp
CASES = {
    # 4 heads / sp 4: Ulysses; 2 kv heads do not divide 4: K/V repeated
    # before the swap; the streamed loss over 8-token slices, chunk 3
    "2x4-ulysses-chunk": ({"sequence_parallel": 4, "loss_chunk": 3},
                          (2, 4)),
    "1x8-ring": ({"sequence_parallel": 8}, (1, 8)),
    "2x2x2-ulysses-tp": ({"sequence_parallel": 2, "model_parallel": 2},
                         (2, 2, 2)),
    "1x4x2-ring-tp": ({"sequence_parallel": 4, "model_parallel": 2},
                      (1, 4, 2)),
    "1x2x2-moe-top2": ({"sequence_parallel": 2, "model_parallel": 2,
                        "moe_experts": 2, "moe_top_k": 2,
                        "learning_rate": 1e-3}, (1, 2, 2)),
    # 2 kv heads over sp 2: the small swap; accumulation, full remat
    "2x2-accum-full": ({"sequence_parallel": 2, "grad_accum": 2,
                        "remat_policy": "full"}, (2, 2)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_sp_train_matches_jax(corpus, case):
    extra, shape = CASES[case]
    knobs = {**KNOBS, **extra}
    jm, pm, jctx, pctx = _both(corpus, knobs, int(np.prod(shape)))
    want, got = jctx.logger.get_values("loss"), pctx.logger.get_values(
        "loss")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert pctx.logger.get_values("tokens") == \
        jctx.logger.get_values("tokens")
    jp, pp = _flat(jm.dump_parameters()["params"]), _flat(
        pm.dump_parameters()["params"])
    assert jp.keys() == pp.keys()
    for key in jp:
        np.testing.assert_allclose(pp[key], jp[key], rtol=0, atol=1e-4,
                                   err_msg=key)


def test_sp_dispatch_and_mesh_layout():
    """The mesh JAX's train builds, position for position, and the
    attention each case's shards take."""
    from jax.sharding import Mesh as JMesh

    for sp, mp in ((4, 1), (2, 2), (8, 1), (4, 2)):
        knobs = {**KNOBS, "sequence_parallel": sp, "model_parallel": mp}
        mesh = ll.LlamaLoRA(device="cpu", **knobs)._mesh(["cpu"] * 8)
        names = ("data", "sp", "model") if mp > 1 else ("data", "sp")
        jmesh = JMesh(np.array(jax.devices()[:8], dtype=object).reshape(
            (-1, sp, mp) if mp > 1 else (-1, sp)), names)
        assert mesh.axis_names == jmesh.axis_names
        assert mesh.shape == dict(jmesh.shape)
        flat = list(jmesh.devices.reshape(-1))
        for p in range(8):
            assert mesh.coords(p) == tuple(
                int(c) for c in np.argwhere(jmesh.devices == flat[p])[0])


def test_chunked_lm_loss_terms_sp_matches_jax():
    from jax.sharding import Mesh as JMesh

    rng = np.random.default_rng(0)
    b, seq, d, vocab = 4, 16, 8, 32
    hidden = rng.standard_normal((b, seq, d)).astype(np.float32)
    kernel = (rng.standard_normal((d, vocab)) * 0.3).astype(np.float32)
    ids = rng.integers(0, vocab, (b, seq)).astype(np.int32)
    lens = np.array([16, 9, 2, 0], np.int32)
    mask = np.array([1, 1, 0, 1], np.float32)
    jmesh = JMesh(np.array(jax.devices()[:8], dtype=object).reshape(2, 4),
                  ("data", "sp"))

    def jloss(h, w):
        return jll.chunked_lm_loss_terms_sp(
            h, w, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(mask),
            3, jmesh, "data", "sp")

    @jax.jit
    def jterms(h, w):
        (tot, cnt), vjp = jax.vjp(jloss, h, w)
        return tot, cnt, vjp((jnp.ones_like(tot), jnp.zeros_like(cnt)))

    jtot, jcnt, (jgh, jgw) = jterms(hidden, kernel)
    mesh = ps.make_sp_mesh(["cpu"] * 8, 4)
    h = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(kernel, requires_grad=True)
    tot, cnt = ll.chunked_lm_loss_terms_sp(
        h, w, torch.as_tensor(ids).long(), torch.as_tensor(lens),
        torch.as_tensor(mask), 3, mesh, "data", "sp")
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-6)
    assert float(cnt) == float(jcnt)
    gh, gw = torch.autograd.grad(tot, (h, w))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-5)
    # per-position slices in, the same terms out; JAX's error text
    parts = [t.detach() for t in to_positions(h, mesh, ("data", "sp"))]
    tot2, _ = ll.chunked_lm_loss_terms_sp(
        parts, w.detach(), torch.as_tensor(ids).long(),
        torch.as_tensor(lens), torch.as_tensor(mask), 3, mesh, "data", "sp")
    assert float(tot2) == float(tot.detach())
    odd = ps.make_sp_mesh(["cpu"] * 3, 3)
    with pytest.raises(ValueError, match="must divide the sp axis"):
        ll.chunked_lm_loss_terms_sp(h, w, torch.as_tensor(ids).long(),
                                    torch.as_tensor(lens), None, 3, odd,
                                    "data", "sp")


# JAX's five refusals of a sequence-parallel trial, in its order
ERRORS = [
    ({"sequence_parallel": 2, "pipeline_stages": 2}, 4),
    ({"sequence_parallel": 2, "moe_experts": 2}, 4),
    ({"sequence_parallel": 2, "model_parallel": 2, "loss_chunk": 8}, 4),
    ({"sequence_parallel": 2, "model_parallel": 2}, 6),
    ({"sequence_parallel": 3}, 3),
    ({"sequence_parallel": 2, "model_parallel": 4}, 8),
]


@pytest.mark.parametrize("extra,n", ERRORS,
                         ids=["pipeline", "moe", "chunk-tp", "devices",
                              "max_len", "heads"])
def test_sp_knob_errors_word_for_word(corpus, extra, n):
    knobs = {**KNOBS, **extra}
    with pytest.raises(ValueError) as want:
        JLlamaLoRA(**knobs).train(corpus, JTrainContext(
            devices=jax.devices()[:n]))
    with pytest.raises(ValueError) as got:
        ll.LlamaLoRA(device="cpu", **knobs).train(
            corpus, TrainContext(devices=["cpu"] * n))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra", [
    {"sequence_parallel": 2}, {"sequence_parallel": 4, "loss_chunk": 8},
    {"sequence_parallel": 2, "model_parallel": 2},
    {"sequence_parallel": 2, "model_parallel": 2, "moe_experts": 4,
     "adapters_only": True},
    {"sequence_parallel": 4, "grad_accum": 2, "lora_rank": 8}],
    ids=["sp2", "sp4-chunk", "sp2-tp2", "sp2-tp2-moe-adapters",
         "sp4-accum"])
def test_sp_device_budget_params_and_opt_equal_jax(extra):
    knobs = {**KNOBS, **extra}
    sp = extra["sequence_parallel"] * extra.get("model_parallel", 1)
    for n in (sp, 2 * sp, 8):
        if n % sp:
            continue
        want = JLlamaLoRA(**knobs).estimate_device_budget(n)
        got = ll.LlamaLoRA(device="cpu", **knobs).estimate_device_budget(n)
        assert (got["params"], got["opt"]) == (want["params"],
                                               want["opt"]), n
        accumulating = knobs.get("grad_accum", 1) > 1
        assert got["total"] == got["params"] + got["opt"] + max(
            got["activations"] + got["transient"] + got.get("working", 0)
            + (got["grads"] if accumulating else 0), 3 * got["grads"])


def test_sp_colocated_estimate_shares_an_sp_group():
    """An ``sp`` group on one card holds one copy of the leaves, their
    moments and gradients, and every position's activations."""
    knobs = {**KNOBS, "sequence_parallel": 4}
    est = ll.LlamaLoRA(device="cpu", **knobs).estimate_device_budget(4)
    got = ll.colocated_train_bytes(est, 1, 1, sp=4)
    assert got == est["params"] + est["opt"] + max(
        4 * est["activations"] + est["transient"] + est["working"],
        3 * est["grads"])
    m = ll.LlamaLoRA(device="cpu", **knobs)
    m.load_parameters(_init_blob(knobs))
    from rafiki_tpu_torch.models.llama_mesh import MeshLlama, shard_tree

    mesh = m._mesh(["cpu"] * 4)
    leaves = shard_tree(m._params, mesh, None, ["lm_head.kernel"],
                        torch.float32)
    for leaf in leaves.values():  # one tensor for the four positions
        assert leaf.owner == [0] * 4 and leaf.owned() == [0]
        assert len({id(t) for t in leaf.shards}) == 1
    assert isinstance(MeshLlama, type)


def test_sp_checkpoint_both_ways_bit_for_bit(corpus, tmp_path):
    """A sequence-parallel trial's live tree saves sharded with
    ``param_shardings``' specs (Queue C 24); JAX restores it into its
    own placement bit for bit, and the port restores a directory JAX
    wrote from the same values into a (data, sp, model) mesh."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding

    from rafiki_tpu.parallel.sharding import param_shardings

    from rafiki_tpu_torch.models.llama_mesh import mesh_specs
    from rafiki_tpu_torch.parallel.collectives import ShardedLeaf
    from rafiki_tpu_torch.parallel.sharding import leaf_paths

    knobs = {**KNOBS, "max_epochs": 1, "sequence_parallel": 2}
    caught = {}

    def checkpoint(make_blob, frac_done=None, tree=None):
        caught.update(tree=tree, blob=make_blob())

    pm = ll.LlamaLoRA(device="cpu", **knobs)
    pm.load_parameters(_init_blob(knobs))
    pm.train(corpus, TrainContext(devices=["cpu"] * 4,
                                  checkpoint=checkpoint))
    params = caught["blob"]["params"]
    jmesh = JMesh(np.array(jax.devices()[:4], dtype=object).reshape(2, 2),
                  ("data", "sp"))
    shard = param_shardings(params, jmesh, tp_rules=None, fsdp=True,
                            min_size=2 ** 12)
    jtree = {"params": jax.tree_util.tree_map(
        jax.device_put, params, shard,
        is_leaf=lambda x: isinstance(x, NamedSharding))}
    ck = ShardedCheckpointer(str(tmp_path / "p"))
    assert ck._plan(caught["tree"]) == JCkpt(str(tmp_path / "j"))._plan(
        jtree)
    ck.save("t", caught["tree"])
    dumped = _flat(params)
    back = _flat(JCkpt(str(tmp_path / "p")).restore("t", jtree)["params"])
    for key in dumped:
        np.testing.assert_array_equal(np.asarray(back[key]), dumped[key],
                                      err_msg=key)
    # JAX's directory into the port's (data, sp, model) mesh
    JCkpt(str(tmp_path / "j")).save("t", jtree)
    mesh = ps.make_sp_mesh(["cpu"] * 8, 2, 2)
    shapes = pm._param_shapes()
    specs = mesh_specs(shapes, mesh, ll.TP_RULES)
    tmpl = {}
    for path, leaf in leaf_paths(shapes):
        node = tmpl
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = ShardedLeaf(leaf.shape, specs[".".join(path)],
                                     mesh, [None] * 8)
    out = ShardedCheckpointer(str(tmp_path / "j")).restore(
        "t", {"params": tmpl})["params"]
    for path, leaf in leaf_paths(out):
        np.testing.assert_array_equal(leaf.full().numpy(),
                                      dumped["/".join(path)])


def test_sp_trial_resumes_warm_through_sharded_ref(corpus, tmp_path):
    """A sequence-parallel trial's checkpoint lands sharded on a file
    store, and a trial warm-started from its ``sharded_ref`` starts from
    exactly the saved leaves: its losses equal those of a trial loaded
    with the same leaves as a blob."""
    from rafiki_tpu_torch.store.param_store import ParamStore

    knobs = {**KNOBS, "max_epochs": 1, "sequence_parallel": 2,
             "model_parallel": 2}
    store = ParamStore.from_uri(f"file://{tmp_path}/ps")
    caught = {}

    def checkpoint(make_blob, frac_done=None, tree=None):
        assert store.save_sharded_async("ckpt", tree)
        caught["blob"] = make_blob()

    first = ll.LlamaLoRA(device="cpu", **knobs)
    first.load_parameters(_init_blob(knobs))
    first.train(corpus, TrainContext(devices=["cpu"] * 4,
                                     checkpoint=checkpoint))
    store.sharded_checkpointer().wait()
    assert store.exists_sharded("ckpt") and not store.exists("ckpt")
    losses = []
    for warm in (True, False):
        m = ll.LlamaLoRA(device="cpu", **{**knobs, "share_params": warm})
        if not warm:
            m.load_parameters(caught["blob"])
        ctx = TrainContext(devices=["cpu"] * 4, shared_params=(
            store.sharded_ref("ckpt") if warm else None))
        m.train(corpus, ctx)
        losses.append(ctx.logger.get_values("loss"))
    assert losses[0] == losses[1]
