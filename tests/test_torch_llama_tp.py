"""Port parity for ``LlamaLoRA``'s mesh loop (``model_parallel > 1``:
``TP_RULES`` over ``model``, fsdp and the batch over ``data``, expert
sharding; ``rafiki_tpu_torch/models/llama_mesh.py``) against JAX's mesh
loop, in f32 on the CPU.

JAX trains on its 8 fake CPU devices (``TrainContext(devices=...)`` of
the mesh's size), the port on a mesh whose every shard is ``cpu``
(``TrainContext(devices=["cpu"] * n)``). Both start from one init blob;
``lora_scale`` is 1, where the two loops agree (JAX's mesh loop never
reads it: ROADMAP Queue C 23, held by
``test_torch_llama_train_knobs.py::test_lora_scale_applies_where_jax_drops_it``).

Tolerances: per-epoch losses within 1e-5 relative, trained leaves within
1e-4 absolute (the partial sums of a row-parallel product and of the
vocab-split log-sum-exp add in another order than one product does;
the largest difference seen is 6e-5), the frozen leaves bit for bit.
The pretrained case holds its trained leaves to 1e-3, as
``test_torch_convert.py`` does for the same import: from that base a
near-zero gradient's sign can flip with the order of a sum, and Adam
steps such an element by about the learning rate either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rafiki_tpu_torch.advisor as PA
from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models import convert as jconv
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.store.sharded_ckpt import ShardedCheckpointer as JCkpt
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.store.params import llama_params_from_jax
from rafiki_tpu_torch.store.sharded_ckpt import ShardedCheckpointer
from rafiki_tpu_torch.worker.train import TrainWorker

torch.set_num_threads(1)

KNOBS = {"max_epochs": 2, "vocab_size": 1 << 10, "hidden_dim": 64,
         "depth": 2, "n_heads": 4, "kv_ratio": 2, "lora_rank": 4,
         "max_len": 32, "model_parallel": 2, "learning_rate": 1e-2,
         "batch_size": 8, "bf16": False, "quick_train": True,
         "share_params": False, "lora_scale": 1.0}


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
    d = tmp_path_factory.mktemp("llama_tp")
    train = str(d / "train.jsonl")
    generate_text_classification_dataset(train, 48, seed=0)
    return train


def _init_blob(knobs, seed=0):
    module = JLlamaLoRA(**knobs)._module()
    params = module.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 32), jnp.int32))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "meta": {"id2tok": {}}}


def _both(corpus, knobs, shape, blob=None, patch=None):
    n = shape[0] * shape[1]
    jm = JLlamaLoRA(**knobs)
    pm = ll.LlamaLoRA(device="cpu", **knobs)
    if blob is not None:
        jm.load_parameters(blob)
        pm.load_parameters(blob)
    if patch is not None:
        patch(pm)
    jctx = JTrainContext(devices=jax.devices()[:n])
    pctx = TrainContext(devices=["cpu"] * n)
    jm.train(corpus, jctx)
    pm.train(corpus, pctx)
    return jm, pm, jctx, pctx


CASES = {
    "1x2": ({}, (1, 2)),
    "2x2": ({}, (2, 2)),
    # one KV head over four shards: K and V gathered whole
    "1x4-kv-gathered-adapters": ({
        "model_parallel": 4, "kv_ratio": 4, "adapters_only": True},
        (1, 4)),
    "2x2-moe-top2-full": ({"moe_experts": 2, "moe_top_k": 2,
                           "learning_rate": 1e-3, "remat_policy": "full"},
                          (2, 2)),
    "2x2-accum-chunk-policy": ({"grad_accum": 2, "loss_chunk": 12,
                                "remat_policy": "policy"}, (2, 2)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_mesh_train_matches_jax(corpus, case):
    extra, shape = CASES[case]
    knobs = {**KNOBS, **extra}
    jm, pm, jctx, pctx = _both(corpus, knobs, shape, _init_blob(knobs))
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


def test_mesh_train_from_a_pretrained_base_matches_jax(corpus, tmp_path):
    """``pretrained_path`` under a mesh: the base leaves come from the
    checkpoint, the adapters keep the init (JAX's PRNGKey(0) on both
    sides); the frozen leaves bit for bit."""
    base = _init_blob(KNOBS, seed=3)["params"]
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    jconv.export_llama_safetensors(base, str(ckpt / "model.safetensors"))
    knobs = {**KNOBS, "pretrained_path": str(ckpt)}
    init = _init_blob(knobs)["params"]

    def with_jax_init(pm):
        build = pm._module

        def module(quantized=False):
            m = build(quantized)
            m.load_state_dict(llama_params_from_jax(init, m.dtype))
            return m

        pm._module = module

    jm, pm, jctx, pctx = _both(corpus, knobs, (2, 2), patch=with_jax_init)
    np.testing.assert_allclose(pctx.logger.get_values("loss"),
                               jctx.logger.get_values("loss"), rtol=1e-5)
    jp, pp, bp = (_flat(t) for t in (jm._params, pm._params, base))
    for key in pp:
        if ll._trains(key.replace("/", ".")):
            np.testing.assert_allclose(pp[key], np.asarray(jp[key]),
                                       rtol=0, atol=1e-3, err_msg=key)
        else:  # frozen: the checkpoint's tensor, bit for bit
            np.testing.assert_array_equal(pp[key], bp[key], err_msg=key)


@pytest.mark.parametrize("extra", [{}, {"moe_experts": 4},
                                   {"model_parallel": 4,
                                    "adapters_only": True},
                                   {"grad_accum": 2, "lora_rank": 8}],
                         ids=["dense", "moe", "mp4-adapters", "accum-r8"])
def test_device_budget_params_and_opt_equal_jax(extra):
    knobs = {**KNOBS, **extra}
    for n in (1, 2, 4, 8):
        want = JLlamaLoRA(**knobs).estimate_device_budget(n)
        got = ll.LlamaLoRA(device="cpu", **knobs).estimate_device_budget(n)
        assert (got["params"], got["opt"]) == (want["params"],
                                               want["opt"]), n
        # the peak rule of the one-card estimate, the loss backward's
        # working buffers in the backward's term
        accumulating = knobs.get("grad_accum", 1) > 1
        assert got["total"] == got["params"] + got["opt"] + max(
            got["activations"] + got["transient"] + got["working"]
            + (got["grads"] if accumulating else 0), 3 * got["grads"])
        assert ll.colocated_train_bytes(got, 1, 1, accumulating) == \
            got["total"]


def test_mesh_checkpoint_tree_has_jaxs_manifest(corpus, tmp_path):
    """The live tree a mesh trial hands ``ctx.checkpoint`` plans the
    manifest JAX writes for the same tree placed by its mesh loop's
    ``param_shardings``, and restores to the dumped blob's values. (The
    tree JAX's own loop hands over after a step carries the output
    shardings XLA chose, which split the norm scales that
    ``param_shardings`` replicates.)"""
    from jax.sharding import NamedSharding

    from rafiki_tpu.models.llama_lora import TP_RULES
    from rafiki_tpu.parallel.sharding import make_mesh, param_shardings

    knobs = {**KNOBS, "max_epochs": 1}
    caught = {}

    def checkpoint(make_blob, frac_done=None, tree=None):
        caught.update(tree=tree, blob=make_blob())

    pm = ll.LlamaLoRA(device="cpu", **knobs)
    pm.load_parameters(_init_blob(knobs))
    pm.train(corpus, TrainContext(devices=["cpu"] * 4,
                                  checkpoint=checkpoint))
    mesh = make_mesh(jax.devices()[:4], model=2)
    params = caught["blob"]["params"]
    shard = param_shardings(params, mesh, tp_rules=TP_RULES, fsdp=True,
                            min_size=2 ** 12)
    jtree = {"params": jax.tree_util.tree_map(
        jax.device_put, params, shard,
        is_leaf=lambda x: isinstance(x, NamedSharding))}
    assert ShardedCheckpointer(str(tmp_path / "p"))._plan(
        caught["tree"]) == JCkpt(str(tmp_path / "j"))._plan(jtree)
    ck = ShardedCheckpointer(str(tmp_path / "p"))
    ck.save("t", caught["tree"])
    restored = _flat(ck.restore("t", {"params": pm._param_shapes()})[
        "params"])
    dumped = _flat(params)
    for key in dumped:
        np.testing.assert_array_equal(restored[key], dumped[key],
                                      err_msg=key)
    # and JAX restores it into its own placement, bit for bit
    back = _flat(JCkpt(str(tmp_path / "p")).restore("t", jtree)["params"])
    for key in dumped:
        np.testing.assert_array_equal(np.asarray(back[key]), dumped[key],
                                      err_msg=key)


@pytest.mark.parametrize("mp", [2, 1], ids=["mesh", "one-card"])
def test_sharded_resume_equals_blob_resume(corpus, tmp_path, mp):
    """JAX's ``test_trial_resume_sharded_matches_blob`` with a trial
    through the port's train worker: preempted after its first
    checkpoint, resumed warm, the same score whether the checkpoint was a
    blob (``mem://``) or sharded (``file://``). At ``model_parallel`` 1
    the trial runs the one-card loop, which checkpoints sharded on a file
    store too and resumes warm from it (JAX's functional loop starts
    cold there: ROADMAP Queue C 25)."""
    # in the knobs' domains: 6 epochs cut to 2 by quick_train
    pins = {**KNOBS, "max_epochs": 6, "vocab_size": 1 << 14,
            "quick_train": True, "remat_policy": "none",
            "model_parallel": mp}

    class Flaky(ll.LlamaLoRA):
        def train(self, dataset_path, ctx=None):
            inner = ctx.checkpoint

            def checkpoint(make_blob, frac_done=None, tree=None):
                inner(make_blob, frac_done=frac_done, tree=tree)
                raise OSError("simulated preemption")

            ctx.checkpoint = checkpoint
            super().train(dataset_path, ctx)

    def run(store, name):
        meta = MetaStore(str(tmp_path / f"{name}.db"))
        job = meta.create_train_job("u0", "app", 1, "LANGUAGE_MODELING",
                                    {"TRIAL_COUNT": 1}, "tr", "va")
        sub = meta.create_sub_train_job(job["id"], "m0")["id"]

        def worker(cls, wid, trials):
            return TrainWorker(
                cls, PA.make_advisor(cls.get_knob_config(), "random",
                                     total_trials=trials, seed=0),
                corpus, corpus, param_store=store, meta_store=meta,
                sub_train_job_id=sub, model_id="m0", worker_id=wid,
                knob_overrides=pins, checkpoint_interval_s=1e-9,
                device="cpu")

        worker(Flaky, "w0", 1).run(max_trials=1)
        trials = meta.get_trials_of_sub_train_job(sub)
        assert [t["error_class"] for t in trials] == ["preemption"], \
            trials[0]["error"]
        sharded = store.exists_sharded(f"ckpt-{trials[0]['id']}")
        w2 = worker(ll.LlamaLoRA, "w1", 0)
        w2.orphan_stale_s = 0.0
        assert w2.resume_orphaned_trials() == 1
        done = [t for t in meta.get_trials_of_sub_train_job(sub)
                if t["status"] == "COMPLETED"]
        assert len(done) == 1
        return done[0]["score"], sharded

    blob_score, blob_sharded = run(ParamStore.from_uri("mem://"), "blob")
    store = ParamStore.from_uri(f"file://{tmp_path}/ps")
    score, sharded = run(store, "sharded")
    assert not blob_sharded and sharded  # each took its own path
    assert score == blob_score
