"""Port parity for sharded checkpoints (``rafiki_tpu_torch/store/
sharded_ckpt.py``, the sharded methods of ``store/param_store.py`` and the
train worker's sharded save and warm start) against
``rafiki_tpu/store/sharded_ckpt.py``.

A case for each of JAX's ten tests in ``tests/test_sharded_ckpt.py``, on
the port's meshes (every shard on ``cpu``), then the two packages on one
directory: JAX writes and the port restores into another mesh, the port
writes and JAX restores into another mesh, bit for bit, and for the same
tree and mesh the two write the same manifest and the same files.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from rafiki_tpu.store.sharded_ckpt import ShardedCheckpointer as JCkpt
import rafiki_tpu_torch.advisor as PA
from rafiki_tpu_torch.model.base import TrainContext, validate_template_knobs
from rafiki_tpu_torch.model.knob import FixedKnob, PolicyKnob
from rafiki_tpu_torch.parallel.collectives import ShardedLeaf
from rafiki_tpu_torch.parallel.sharding import make_mesh
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.store.sharded_ckpt import (ShardedCheckpointer,
                                                 ShardedCheckpointRef)
from rafiki_tpu_torch.worker.train import TrainWorker

torch.set_num_threads(1)


def _mesh(shape=(4, 2)):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), model=shape[1])


W = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
E = np.arange(128, dtype=np.float32).reshape(16, 8)
R = np.ones((8,), np.float32)
HOST = np.arange(6, dtype=np.int32)


def _tree(mesh):
    """JAX's mixed tree: 2-D sharded, 1-D sharded, replicated, host."""
    return {"a": {"w": ShardedLeaf.from_full(torch.from_numpy(W), mesh,
                                             ("data", "model")),
                  "e": ShardedLeaf.from_full(torch.from_numpy(E), mesh,
                                             ("data",))},
            "r": ShardedLeaf.from_full(torch.from_numpy(R), mesh, ()),
            "host": HOST.copy()}


def _jtree(shape=(4, 2)):
    devs = np.array(jax.devices()[:shape[0] * shape[1]],
                    dtype=object).reshape(shape)
    mesh = JMesh(devs, ("data", "model"))
    return {"a": {"w": jax.device_put(jnp.asarray(W),
                                      NamedSharding(mesh, P("data",
                                                            "model"))),
                  "e": jax.device_put(jnp.asarray(E),
                                      NamedSharding(mesh, P("data")))},
            "r": jax.device_put(jnp.asarray(R), NamedSharding(mesh, P())),
            "host": HOST.copy()}


def _values(tree):
    return {"w": tree["a"]["w"], "e": tree["a"]["e"], "r": tree["r"],
            "host": tree["host"]}


def _as_np(x):
    if isinstance(x, ShardedLeaf):
        return x.full().numpy()
    return np.asarray(x)


def _assert_tree(out):
    for key, want in (("w", W), ("e", E), ("r", R), ("host", HOST)):
        got = _as_np(_values(out)[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_roundtrip_same_topology(tmp_path):
    mesh = _mesh()
    tree = _tree(mesh)
    ck = ShardedCheckpointer(str(tmp_path))
    ck.save("t0", tree)
    out = ck.restore("t0", tree)
    _assert_tree(out)
    # sharded leaves restore INTO their specs, each shard its own slice
    w = out["a"]["w"]
    assert w.spec == ("data", "model") and w.mesh is mesh
    for p, t in enumerate(w.shards):
        assert torch.equal(t, tree["a"]["w"].shards[p])
    # the big leaf is one file per shard, not one blob
    assert len([f for f in os.listdir(ck._dir("t0"))
                if f.startswith("L")]) > 4


def test_per_process_write_bound(tmp_path):
    """The disjoint-writer rule: 4 simulated processes owning 2 of the 8
    positions each write under a quarter of the tree; the union
    reassembles exactly."""
    mesh = _mesh()
    tree = _tree(mesh)
    full_bytes = W.nbytes + E.nbytes + R.nbytes + HOST.nbytes
    ck = ShardedCheckpointer(str(tmp_path))
    written = []
    for proc in range(4):
        mine = {2 * proc, 2 * proc + 1}

        def owns(shard, mine=mine):
            return shard.replica_id == 0 and shard.position in mine

        written.append(ck.save("t0", tree, owns=owns, process_index=proc))
    for w in written[1:]:  # process 0 also writes the replicated + host
        assert 0 < w < full_bytes / 4, (w, full_bytes)
    _assert_tree(ck.restore("t0", tree))


def test_cross_topology_restore(tmp_path):
    """Saved on (4, 2), restored onto (2, 4) and as host arrays: shard
    files are assembled by overlap."""
    tree = _tree(_mesh((4, 2)))
    ck = ShardedCheckpointer(str(tmp_path))
    ck.save("t0", tree)
    tmpl_b = _tree(_mesh((2, 4)))
    out_b = ck.restore("t0", tmpl_b)
    _assert_tree(out_b)
    assert out_b["a"]["w"].mesh is tmpl_b["a"]["w"].mesh
    host_tmpl = {"a": {"w": W, "e": E}, "r": R, "host": HOST}
    out_h = ck.restore("t0", host_tmpl)
    assert isinstance(out_h["a"]["w"], np.ndarray)
    _assert_tree(out_h)


def test_async_save_and_error_surfacing(tmp_path):
    tree = _tree(_mesh())
    ck = ShardedCheckpointer(str(tmp_path))
    ck.save_async("t0", tree)
    # the shards were copied before save_async returned: a step that
    # updates them in place now does not reach the files
    for t in tree["a"]["w"].shards:
        t.add_(1.0)
    ck.wait()
    np.testing.assert_array_equal(
        _as_np(ck.restore("t0", tree)["a"]["w"]), W)
    ck.save_async("t1", tree)
    ref = ShardedCheckpointRef(ck, "t1")
    ck.wait()
    assert ref.exists()


def test_param_store_integration(tmp_path):
    store = ParamStore.from_uri(f"file://{tmp_path}/params")
    tree = _tree(_mesh())
    assert store.save_sharded_async("ckpt-x", tree) is True
    ref = store.sharded_ref("ckpt-x")
    assert ref is not None and store.exists_sharded("ckpt-x")
    _assert_tree(ref.restore(tree))
    assert store.copy_sharded("ckpt-x", "ckpt-y")
    assert store.exists_sharded("ckpt-y")
    store.delete("ckpt-x")  # the blob's delete drops the directory too
    assert not store.exists_sharded("ckpt-x")
    assert store.sharded_checkpointer().root == \
        str(tmp_path / "params" / "sharded")
    mem = ParamStore.from_uri("mem://")
    assert mem.save_sharded_async("k", tree) is False
    assert mem.sharded_ref("k") is None


def test_partial_checkpoint_is_loud(tmp_path):
    tree = _tree(_mesh())
    ck = ShardedCheckpointer(str(tmp_path))
    ck.save("t0", tree)
    d = ck._dir("t0")
    victim = next(f for f in sorted(os.listdir(d)) if f.startswith("L0000"))
    os.unlink(os.path.join(d, victim))
    with pytest.raises((ValueError, FileNotFoundError)):
        ck.restore("t0", tree)


class _ShardedToy:
    """JAX's ``ShardedToy``: w += 1 per epoch over a sharded leaf; the
    checkpoints pass the live tree, so a file-backed store saves it
    sharded."""

    FAIL_AT = None
    MESH = _mesh((8, 1))

    @staticmethod
    def get_knob_config():
        return {"max_epochs": FixedKnob(5),
                "share_params": PolicyKnob("SHARE_PARAMS")}

    @classmethod
    def validate_knobs(cls, knobs):
        validate_template_knobs(cls, knobs)

    def __init__(self, device=None, **knobs):
        self.knobs = dict(knobs)
        self._w = None

    def train(self, dataset_path, ctx=None):
        ctx = ctx or TrainContext()
        w = ShardedLeaf.from_full(torch.zeros(16, 8), self.MESH, ("data",))
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            if hasattr(ctx.shared_params, "restore"):
                w = ctx.shared_params.restore({"w": w})["w"]
            else:
                w = ShardedLeaf.from_full(torch.as_tensor(
                    np.array(ctx.shared_params["w"])), self.MESH,
                    ("data",))
        epochs = max(1, round(5 * float(ctx.budget_scale)))
        for epoch in range(epochs):
            for t in w.shards:
                t.add_(1.0)
            self._w = w
            if ctx.checkpoint is not None:
                ctx.checkpoint(self.dump_parameters,
                               frac_done=(epoch + 1) / epochs,
                               tree={"w": w})
            if self.FAIL_AT is not None and epoch >= self.FAIL_AT:
                raise OSError("simulated preemption")

    def evaluate(self, dataset_path):
        return float(self._w.full().mean())

    def predict(self, queries):
        return [0 for _ in queries]

    def dump_parameters(self):
        return {"w": self._w.full().numpy()}

    def load_parameters(self, params):
        self._w = ShardedLeaf.from_full(torch.as_tensor(np.array(params["w"])),
                                        self.MESH, ("data",))


class _Flaky(_ShardedToy):
    FAIL_AT = 2


def test_trial_resume_sharded_matches_blob(tmp_path):
    """A preempted trial that checkpoints sharded resumes to the same
    result as the whole-blob path, through the port's train worker."""

    def run_scenario(store, name):
        meta = MetaStore(str(tmp_path / f"{name}.db"))
        job = meta.create_train_job("u0", "app", 1, "IMAGE_CLASSIFICATION",
                                    {"TRIAL_COUNT": 1}, "tr", "va")
        sub = meta.create_sub_train_job(job["id"], "m0")["id"]

        def worker(model_class, wid, trials):
            return TrainWorker(
                model_class, PA.make_advisor(model_class.get_knob_config(),
                                             "random", total_trials=trials),
                "u", "u", param_store=store, meta_store=meta,
                sub_train_job_id=sub, model_id="m0", worker_id=wid,
                checkpoint_interval_s=1e-9, device="cpu")

        worker(_Flaky, "w0", 1).run(max_trials=1)
        w2 = worker(_ShardedToy, "w1", 0)
        w2.orphan_stale_s = 0.0
        assert w2.resume_orphaned_trials() == 1
        done = [t for t in meta.get_trials_of_sub_train_job(sub)
                if t["status"] == "COMPLETED"]
        assert len(done) == 1
        return done[0]["score"]

    blob_score = run_scenario(ParamStore.from_uri("mem://"), "blob")
    sharded = ParamStore.from_uri(f"file://{tmp_path}/ps")
    assert run_scenario(sharded, "sharded") == blob_score == 5.0
    assert os.path.isdir(sharded.sharded_checkpointer().root)


def test_manifests_identical_across_processes(tmp_path):
    tree = _tree(_mesh())
    ck = ShardedCheckpointer(str(tmp_path))
    plans = [ck._plan(tree) for _ in range(3)]
    assert plans[0] == plans[1] == plans[2]
    w_entry = next(e for e in plans[0]["leaves"] if e["path"] == ["a", "w"])
    assert len(w_entry["shards"]) == 8
    assert len({s["file"] for s in w_entry["shards"]}) == 8


def test_ref_matches_probe(tmp_path):
    tree = _tree(_mesh())
    ck = ShardedCheckpointer(str(tmp_path))
    ck.save("t0", tree)
    ref = ShardedCheckpointRef(ck, "t0")
    assert ref.matches(tree)
    wrong = dict(tree)
    wrong["a"] = {"w": np.zeros((4, 4), np.float32), "e": tree["a"]["e"]}
    assert not ref.matches(wrong)
    assert not ShardedCheckpointRef(ck, "absent").matches(tree)


def test_stale_async_error_does_not_escape_probes(tmp_path):
    ck = ShardedCheckpointer(str(tmp_path))
    ck._pending_error = OSError("disk full (parked)")
    assert ck.exists("whatever") is False
    ck.delete("whatever")
    assert ck.copy("a", "b") is False
    store = ParamStore.from_uri(f"file://{tmp_path}/ps")
    store.sharded_checkpointer()._pending_error = OSError("parked")
    assert store.exists_sharded("x") is False
    assert store.sharded_ref("x") is None
    store.delete("x")
    ck._pending_error = OSError("disk full again")
    with pytest.raises(OSError):
        ck.wait()


# ---- the two packages on one directory ----

def test_jax_writes_port_restores_into_another_mesh(tmp_path):
    JCkpt(str(tmp_path)).save("t0", _jtree((4, 2)))
    ck = ShardedCheckpointer(str(tmp_path))
    out = ck.restore("t0", _tree(_mesh((2, 2))))
    _assert_tree(out)
    assert out["a"]["w"].mesh.shape == {"data": 2, "model": 2}
    _assert_tree(ck.restore("t0", {"a": {"w": W, "e": E}, "r": R,
                                   "host": HOST}))


def test_port_writes_jax_restores_into_another_mesh(tmp_path):
    ShardedCheckpointer(str(tmp_path)).save("t0", _tree(_mesh((2, 2))))
    out = JCkpt(str(tmp_path)).restore("t0", _jtree((2, 4)))
    for key, want in (("w", W), ("e", E), ("r", R), ("host", HOST)):
        got = np.asarray(_values(out)[key])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert out["a"]["w"].sharding.mesh.shape["model"] == 4


def test_bf16_leaves_cross_packages(tmp_path):
    """A bf16 leaf is its bits under ml_dtypes' name, both ways."""
    full = torch.linspace(-3, 3, 16 * 8).reshape(16, 8).to(torch.bfloat16)
    mesh = _mesh((2, 1))
    ShardedCheckpointer(str(tmp_path)).save(
        "p", {"x": ShardedLeaf.from_full(full, mesh, ("data",))})
    devs = np.array(jax.devices()[:2], dtype=object).reshape(2, 1)
    jmesh = JMesh(devs, ("data", "model"))
    jx = jax.device_put(jnp.zeros((16, 8), jnp.bfloat16),
                        NamedSharding(jmesh, P("data")))
    got = JCkpt(str(tmp_path)).restore("p", {"x": jx})["x"]
    np.testing.assert_array_equal(np.asarray(got).view(np.int16),
                                  full.view(torch.int16).numpy())
    JCkpt(str(tmp_path)).save("j", {"x": got})
    back = ShardedCheckpointer(str(tmp_path)).restore(
        "j", {"x": ShardedLeaf.from_full(torch.zeros(16, 8), mesh,
                                         ("data",))})["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.full(), full)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 1)],
                         ids=["4x2", "2x2", "1x1"])
def test_same_tree_same_manifest_and_files(tmp_path, shape):
    JCkpt(str(tmp_path / "jax")).save("t", _jtree(shape))
    ShardedCheckpointer(str(tmp_path / "port")).save("t",
                                                     _tree(_mesh(shape)))
    dj, dp = tmp_path / "jax" / "t", tmp_path / "port" / "t"
    assert (dj / "manifest.json").read_bytes() == \
        (dp / "manifest.json").read_bytes()
    assert json.loads((dp / "manifest.json").read_text())["format"] == \
        "rafiki-sharded-ckpt-v1"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    for f in os.listdir(dj):
        assert (dj / f).read_bytes() == (dp / f).read_bytes(), f
