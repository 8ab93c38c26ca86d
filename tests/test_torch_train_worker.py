"""Port parity: ``rafiki_tpu_torch.worker.train`` and ``model/dev.py``
against the JAX train worker and ``tune_model``, on the CPU.

- The preemption contract of ``tests/test_preemption.py`` (checkpoints,
  the atomic claim, warm resume of the remaining budget, the resume cap,
  the end-of-run linger, fenced completion), each scenario run on the
  port's and the JAX worker with the same deterministic stub template:
  the trial rows (trial_no, status, score, worker, error class, budget)
  must be equal.
- A tiny ViT tuning job (random advisor, seed 0, 3 trials, shapes
  pinned, every trial started from one shared init blob): the same knobs
  in the same order, the same warm starts, scores within the tolerance
  of ``tests/test_torch_vit.py`` (abs 1e-5); the best trial, taken from
  the meta store as a deploy takes it, served by a port
  ``InferenceWorker`` on the CPU, equal to ``predict``.
- ``tune_model`` against JAX's on the same seed, ``classify_trial_error``
  over JAX's cases plus CUDA's out-of-memory error, train admission, the
  gang refusals and fallbacks, the profiler trace and ``main``.
"""

import json
import logging
import os
import re
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rafiki_tpu.advisor as JA
import rafiki_tpu_torch.advisor as PA
from rafiki_tpu.data import generate_image_classification_dataset
from rafiki_tpu.model import knob as jk
from rafiki_tpu.model.base import BaseModel as JBaseModel
from rafiki_tpu.model.base import TrainContext as JTrainContext
from rafiki_tpu.model.dev import tune_model as jtune_model
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.vit import ViT as JViT
from rafiki_tpu.models.vit import ViTBase16 as JViTBase16
from rafiki_tpu.store.meta_store import MetaStore as JMetaStore
from rafiki_tpu.store.param_store import ParamStore as JParamStore
from rafiki_tpu.worker import train as jtrain
from rafiki_tpu_torch.model import knob as pk
from rafiki_tpu_torch.model.base import TrainContext, validate_template_knobs
from rafiki_tpu_torch.model.dev import tune_model
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.models.vit import ViTBase16
from rafiki_tpu_torch.serving import queues
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.worker import train as ptrain
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_decode_engine import KNOBS as LM_KNOBS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


# ---- the stub template, on either side

class _ToyLogic:
    """5-"epoch" counter model: w += 1 per epoch, checkpointing each one;
    ``evaluate`` returns w, so a warm resume shows as a larger w."""

    FAIL_AT = None
    DETERMINISTIC = False

    def train(self, dataset_path, ctx=None):
        ctx = ctx or self.CTX()
        if self.DETERMINISTIC:
            raise ValueError("bad knob combination")
        self._w = np.zeros(())
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            self._w = np.asarray(ctx.shared_params["w"])
        epochs = max(1, round(5 * float(ctx.budget_scale)))
        for epoch in range(epochs):
            self._w = self._w + 1.0
            if ctx.checkpoint is not None:
                ctx.checkpoint(self.dump_parameters,
                               frac_done=(epoch + 1) / epochs)
            if self.FAIL_AT is not None and epoch >= self.FAIL_AT:
                raise RuntimeError("simulated preemption")

    def evaluate(self, dataset_path):
        return float(self._w)

    def predict(self, queries):
        return [0 for _ in queries]

    def dump_parameters(self):
        return {"w": np.asarray(self._w)}

    def load_parameters(self, params):
        self._w = np.asarray(params["w"])


class _Side:
    """One package's worker pieces and stub templates."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.knob = jk if jax_side else pk
        self.MetaStore = JMetaStore if jax_side else MetaStore
        self.ParamStore = JParamStore if jax_side else ParamStore
        self.advisor = JA if jax_side else PA
        self.worker_mod = jtrain if jax_side else ptrain
        knob = self.knob

        def config():
            return {"max_epochs": knob.FixedKnob(5),
                    "share_params": knob.PolicyKnob("SHARE_PARAMS")}

        if jax_side:
            class Toy(_ToyLogic, JBaseModel):
                TASKS = ("IMAGE_CLASSIFICATION",)
                CTX = JTrainContext
                get_knob_config = staticmethod(config)

                def __init__(self, **knobs):
                    super().__init__(**knobs)
                    self._w = None
        else:
            class Toy(_ToyLogic):
                CTX = TrainContext
                get_knob_config = staticmethod(config)

                @classmethod
                def validate_knobs(cls, knobs):
                    validate_template_knobs(cls, knobs)

                def __init__(self, device=None, **knobs):
                    self.knobs = dict(knobs)
                    self._w = None

        self.Toy = Toy
        self.Flaky = type("FlakyToy", (Toy,), {"FAIL_AT": 2})
        self.AlwaysFail = type("AlwaysFail", (Toy,), {"FAIL_AT": 0})
        self.Buggy = type("Buggy", (Toy,), {"DETERMINISTIC": True})

    def stores(self, tmp_path):
        meta = self.MetaStore(str(tmp_path / f"{self.name}.db"))
        job = meta.create_train_job("u0", "app", 1, "IMAGE_CLASSIFICATION",
                                    {"TRIAL_COUNT": 1}, "tr", "va")
        sub = meta.create_sub_train_job(job["id"], "m0")
        return meta, self.ParamStore.from_uri("mem://"), sub["id"]

    def worker(self, model_class, meta, store, sub, wid, trials, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.worker_mod.TrainWorker(
            model_class=model_class,
            advisor=self.advisor.make_advisor(model_class.get_knob_config(),
                                              "random", total_trials=trials),
            train_dataset_path="unused", val_dataset_path="unused",
            param_store=store, meta_store=meta, sub_train_job_id=sub,
            model_id="m0", worker_id=wid,
            checkpoint_interval_s=1e-9, **kw)  # checkpoint every epoch


def _rows(meta, sub):
    return sorted((t["trial_no"], t["status"], t["score"], t["worker_id"],
                   t["error_class"], t["budget_scale"], t["params_saved"])
                  for t in meta.get_trials_of_sub_train_job(sub))


# ---- the preemption scenarios (tests/test_preemption.py), both sides

def sc_preempted_trial_leaves_checkpoint(s, meta, store, sub):
    s.worker(s.Flaky, meta, store, sub, "w0", 1).run(max_trials=1)
    t = meta.get_trials_of_sub_train_job(sub)[0]
    return float(np.asarray(store.load(f"ckpt-{t['id']}")["w"]))


def sc_resume_finishes_orphan_warm(s, meta, store, sub):
    s.worker(s.Flaky, meta, store, sub, "w0", 1).run(max_trials=1)
    old = meta.get_trials_of_sub_train_job(sub)[0]
    n = s.worker(s.Toy, meta, store, sub, "w1", 0).resume_orphaned_trials()
    done = [t for t in meta.get_trials_of_sub_train_job(sub)
            if t["status"] == "COMPLETED"][0]
    return (n, "resumed by w1" in meta.get_trial(old["id"])["error"],
            store.load(f"ckpt-{old['id']}") is None,
            store.load(f"ckpt-{done['id']}") is None,
            store.load(done["id"]) is not None)


def sc_completed_trials_never_resumed(s, meta, store, sub):
    s.worker(s.Toy, meta, store, sub, "w0", 1).run(max_trials=1)
    return s.worker(s.Toy, meta, store, sub, "w1", 0) \
        .resume_orphaned_trials()


def sc_deterministic_failure_never_resumed(s, meta, store, sub):
    s.worker(s.Buggy, meta, store, sub, "w0", 1).run(max_trials=1)
    t = meta.get_trials_of_sub_train_job(sub)[0]
    n = s.worker(s.Toy, meta, store, sub, "w1", 0).resume_orphaned_trials()
    return n, meta.claim_trial_for_resume(t["id"], "w1")


def sc_preemption_class_errored_is_resumed(s, meta, store, sub):
    s.worker(s.Flaky, meta, store, sub, "w0", 1).run(max_trials=1)
    return s.worker(s.Toy, meta, store, sub, "w1", 0) \
        .resume_orphaned_trials()


def sc_worker_never_resumes_own_failure(s, meta, store, sub):
    return s.worker(s.Flaky, meta, store, sub, "w0", 2).run(max_trials=2)


def sc_resume_cap_bounds_pingpong(s, meta, store, sub):
    s.worker(s.Flaky, meta, store, sub, "w0", 1).run(max_trials=1)
    w2 = s.worker(s.Flaky, meta, store, sub, "w1", 0)
    w2.max_resumes = 1
    return w2.resume_orphaned_trials(), w2.resume_orphaned_trials()


def sc_live_peer_trial_is_not_hijacked(s, meta, store, sub):
    t = meta.create_trial(sub, 0, model_id="m0", worker_id="wA",
                          knobs={"max_epochs": 5, "share_params": False})
    meta.heartbeat_trial(t["id"])
    store.save(f"ckpt-{t['id']}", {"w": np.asarray(2.0)})
    n = s.worker(s.Toy, meta, store, sub, "wB", 0).resume_orphaned_trials()
    return n, meta.claim_trial_for_resume(t["id"], "wB", stale_after_s=60.0)


def sc_stale_running_trial_is_resumed(s, meta, store, sub):
    t = meta.create_trial(sub, 0, model_id="m0", worker_id="wA",
                          knobs={"max_epochs": 5, "share_params": False})
    meta.update_trial(t["id"], heartbeat_at=0.0)
    store.save(f"ckpt-{t['id']}", {"w": np.asarray(3.0)})
    store.save(f"ckpt-{t['id']}-meta", {"frac_done": 3 / 5})
    return s.worker(s.Toy, meta, store, sub, "wB", 0) \
        .resume_orphaned_trials()


def sc_checkpointless_zombie_gets_cold_rerun(s, meta, store, sub):
    t = meta.create_trial(sub, 0, model_id="m0", worker_id="wA",
                          knobs={"max_epochs": 5, "share_params": False})
    meta.update_trial(t["id"], heartbeat_at=0.0)
    return s.worker(s.Toy, meta, store, sub, "wB", 0) \
        .resume_orphaned_trials()


def sc_failed_resume_chains_warm_state(s, meta, store, sub):
    s.worker(s.Flaky, meta, store, sub, "w0", 1).run(max_trials=1)
    old = meta.get_trials_of_sub_train_job(sub)[0]
    n2 = s.worker(s.AlwaysFail, meta, store, sub, "w1", 0) \
        .resume_orphaned_trials()
    err = [t for t in meta.get_trials_of_sub_train_job(sub)
           if t["status"] == "ERRORED" and t["worker_id"] == "w1"][0]
    chained = (float(np.asarray(store.load(f"ckpt-{err['id']}")["w"])),
               store.load(f"ckpt-{err['id']}-meta")["frac_done"],
               store.load(f"ckpt-{old['id']}") is not None)
    n3 = s.worker(s.Toy, meta, store, sub, "w2", 0).resume_orphaned_trials()
    return n2, chained, n3


def sc_end_of_run_linger_catches_fresh_orphan(s, meta, store, sub):
    t = meta.create_trial(sub, 0, model_id="m0", worker_id="wA",
                          knobs={"max_epochs": 5, "share_params": False})
    meta.heartbeat_trial(t["id"])
    store.save(f"ckpt-{t['id']}", {"w": np.asarray(3.0)})
    store.save(f"ckpt-{t['id']}-meta", {"frac_done": 3 / 5})
    w2 = s.worker(s.Toy, meta, store, sub, "wB", 0)
    w2.orphan_stale_s = 1.5
    w2.heartbeat_interval_s = 0.3
    return w2.run(max_trials=None)


def sc_restarted_worker_reclaims_own_orphan(s, meta, store, sub):
    s.worker(s.Flaky, meta, store, sub, "w0", 1).run(max_trials=1)
    return s.worker(s.Toy, meta, store, sub, "w0", 0) \
        .resume_orphaned_trials()


def sc_fenced_completion_after_claim(s, meta, store, sub):
    t = meta.create_trial(sub, 0, model_id="m0", worker_id="wA", knobs={})
    meta.update_trial(t["id"], heartbeat_at=0.0)
    return (meta.claim_trial_for_resume(t["id"], "wB"),
            meta.mark_trial_completed(t["id"], 0.9, params_saved=True),
            meta.mark_trial_errored(t["id"], "late error"))


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}

#: the score each scenario's COMPLETED rows must show (the
#: un-preempted total: warm resumes train only the remaining budget)
WANT_SCORE = 5.0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_preemption_scenario_matches_jax(scenario, tmp_path):
    out = {}
    for name in ("jax", "port"):
        side = _Side(name)
        (tmp_path / name).mkdir()
        meta, store, sub = side.stores(tmp_path / name)
        result = SCENARIOS[scenario](side, meta, store, sub)
        out[name] = (result, _rows(meta, sub))
    assert out["port"] == out["jax"]
    for row in out["port"][1]:
        if row[1] == "COMPLETED" and row[3] != "wA":
            assert row[2] == WANT_SCORE


def test_linger_exits_early_when_peer_finishes(tmp_path):
    import time

    side = _Side("port")
    meta, store, sub = side.stores(tmp_path)
    t = meta.create_trial(sub, 0, model_id="m0", worker_id="wA",
                          knobs={"max_epochs": 5, "share_params": False})
    meta.heartbeat_trial(t["id"])

    def finish_soon():
        time.sleep(0.6)
        meta.mark_trial_completed(t["id"], 1.0, params_saved=False)

    threading.Thread(target=finish_soon, daemon=True).start()
    w2 = side.worker(side.Toy, meta, store, sub, "wB", 0)
    w2.orphan_stale_s = 30.0
    t0 = time.monotonic()
    assert w2.run(max_trials=None) == 0
    assert time.monotonic() - t0 < 10.0
    assert meta.get_trial(t["id"])["status"] == "COMPLETED"


def test_classify_trial_error_matches_jax():
    cases = [OSError("connection reset"), MemoryError(), EOFError(),
             RuntimeError("UNAVAILABLE: device lost"),
             RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
             RuntimeError("worker preempted by scheduler"),
             ValueError("bad knob"), KeyError("params"),
             ZeroDivisionError(), FileNotFoundError("x.npz"),
             PermissionError("denied"), IsADirectoryError("d"),
             NotImplementedError("not ported")]
    for e in cases:
        assert ptrain.classify_trial_error(e) == \
            jtrain.classify_trial_error(e), e
    # the class JAX gives XLA's RESOURCE_EXHAUSTED
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert ptrain.classify_trial_error(oom) == "preemption"


def test_throughput_record_and_peak_table(monkeypatch):
    assert ptrain._count_blob_params(
        {"a": np.zeros((2, 3)), "b": [np.zeros(4), {"c": np.zeros(())}],
         "d": "x"}) == jtrain._count_blob_params(
        {"a": np.zeros((2, 3)), "b": [np.zeros(4), {"c": np.zeros(())}],
         "d": "x"}) == 11
    assert ptrain._device_peak_flops("cpu") == 0.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert ptrain._device_peak_flops("cuda") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Other Card")
    assert ptrain._device_peak_flops("cuda") == 0.0
    monkeypatch.setenv("RAFIKI_DEVICE_PEAK_FLOPS", "1e12")
    assert ptrain._device_peak_flops("cpu") == 1e12


# ---- a tiny ViT tuning job on both sides, then the winner served

VIT_PINS = {"patch_size": 4, "hidden_dim": 96, "depth": 2, "n_heads": 4,
            "batch_size": 16, "bf16": False}
IMAGE = (16, 16, 3)
N_CLASSES = 10


def _vit_init_blob():
    module = JViT(patch_size=4, hidden_dim=96, depth=2, n_heads=4,
                  mlp_dim=384, n_classes=N_CLASSES, dtype=jnp.float32)
    params = module.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, *IMAGE), jnp.float32))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "meta": {"n_classes": N_CLASSES, "image_shape": list(IMAGE),
                     "prep_version": 2}}


def _from_init(base, blob):
    """``base`` whose fresh trials start from ``blob`` (a warm start
    still wins when the proposal asks for one)."""
    class FromInit(base):
        def train(self, dataset_path, ctx=None):
            if self._params is None:
                self.load_parameters(blob)
            return super().train(dataset_path, ctx)

    FromInit.__name__ = base.__name__
    return FromInit


@pytest.fixture(scope="module")
def vit_jobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vit_tune")
    tr, va = str(d / "train.npz"), str(d / "val.npz")
    generate_image_classification_dataset(tr, 48, image_size=16,
                                          n_channels=3, seed=0)
    ds = generate_image_classification_dataset(va, 24, image_size=16,
                                               n_channels=3, seed=1)
    blob = _vit_init_blob()
    out = {"val": va, "images": ds.images, "labels": ds.labels}
    for name, template in (("jax", JViTBase16), ("port", ViTBase16)):
        side = _Side(name)
        (d / name).mkdir()
        meta = side.MetaStore(str(d / name / "meta.db"))
        job = meta.create_train_job("u0", "vit", 1, "IMAGE_CLASSIFICATION",
                                    {"TRIAL_COUNT": 3}, "tr", "va")
        sub = meta.create_sub_train_job(job["id"], "m0")["id"]
        store = side.ParamStore.from_uri(f"file://{d / name / 'params'}")
        kw = {"device": "cpu"} if name == "port" else {}
        worker = side.worker_mod.TrainWorker(
            _from_init(template, blob),
            side.advisor.make_advisor(template.get_knob_config(), "random",
                                      total_trials=3, seed=0),
            tr, va, param_store=store, meta_store=meta,
            sub_train_job_id=sub, model_id="m0", worker_id="w0",
            knob_overrides=VIT_PINS, **kw)
        assert worker.run() == 3
        out[name] = {"meta": meta, "store": store, "sub": sub,
                     "job": job["id"], "worker": worker}
    return out


def _trial_view(meta, sub):
    return [(t["trial_no"], t["knobs"], t["status"], t["budget_scale"],
             t["shape_signature"], t["params_saved"])
            for t in meta.get_trials_of_sub_train_job(sub)]


def test_vit_tuning_job_matches_jax(vit_jobs):
    j, p = vit_jobs["jax"], vit_jobs["port"]
    want = _trial_view(j["meta"], j["sub"])
    assert _trial_view(p["meta"], p["sub"]) == want
    assert [r[2] for r in want] == ["COMPLETED"] * 3
    assert any(r[1]["share_params"] for r in want)  # a warm start ran
    for jt, pt in zip(j["meta"].get_trials_of_sub_train_job(j["sub"]),
                      p["meta"].get_trials_of_sub_train_job(p["sub"])):
        assert pt["score"] == pytest.approx(jt["score"], abs=1e-5)
        jl = [r["data"] for r in j["meta"].get_trial_logs(jt["id"])]
        pl = [r["data"] for r in p["meta"].get_trial_logs(pt["id"])]
        # the same records, in the same order: the plot, one loss per
        # epoch, the throughput record
        assert [sorted(x) for x in pl] == [sorted(x) for x in jl]
        losses = [(x["loss"], y["loss"]) for x, y in zip(pl, jl)
                  if "loss" in x]
        assert len(losses) == 5
        np.testing.assert_allclose(*zip(*losses), rtol=1e-4)
    assert p["worker"].stats["trials_completed"] == 3
    assert p["worker"].metrics.snapshot()["trial_seconds_count"] == 3


def test_best_trial_served_by_the_port_worker_equals_predict(vit_jobs):
    p = vit_jobs["port"]
    best = p["meta"].get_best_trials_of_train_job(p["job"], 1)[0]
    want = vit_jobs["jax"]["meta"].get_best_trials_of_train_job(
        vit_jobs["jax"]["job"], 1)[0]
    assert best["trial_no"] == want["trial_no"]
    hub = queues.InProcQueueHub()
    worker = InferenceWorker(ViTBase16, best["id"], best["knobs"],
                             p["store"], hub, "v0", device="cpu")
    images = vit_jobs["images"]
    msgs = [{"id": f"m{i}", "queries": images[8 * i:8 * (i + 1)]}
            for i in range(3)]
    for m in msgs:
        hub.push_query("v0", queues.pack_message(m))
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    loop.start()
    try:
        replies = [queues.unpack_message(hub.pop_prediction(m["id"], 60.0))
                   for m in msgs]
    finally:
        worker.stop()
        loop.join()
    got = np.concatenate([np.asarray(r["predictions"], np.float32)
                          for r in replies])
    direct = ViTBase16(device="cpu", **best["knobs"])
    direct.load_parameters(p["store"].load(best["id"]))
    np.testing.assert_array_equal(
        got, np.asarray(direct.predict(list(images)), np.float32))
    acc = float(np.mean(np.argmax(got, -1) == vit_jobs["labels"]))
    assert acc == pytest.approx(best["score"], abs=1e-6)


# ---- tune_model, admission, gang, profiler, main

def _tune_toy(side):
    knob = side.knob

    class TuneToy(side.Toy):
        @staticmethod
        def get_knob_config():
            return {"max_epochs": knob.FixedKnob(5),
                    "lr": knob.FloatKnob(0.01, 1.0, is_exp=True),
                    "quick_train": knob.PolicyKnob("QUICK_TRAIN"),
                    "share_params": knob.PolicyKnob("SHARE_PARAMS")}

        def evaluate(self, dataset_path):
            return -abs(float(self._w) * self.knobs["lr"] - 1.3)

    return TuneToy


def test_tune_model_matches_jax(tmp_path):
    results = {}
    for name in ("jax", "port"):
        toy = _tune_toy(_Side(name))
        kw = {"device": "cpu"} if name == "port" else {}
        fn = jtune_model if name == "jax" else tune_model
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn(toy, "unused", "unused", total_trials=9, seed=4,
                   knob_overrides={"max_epochs": 5}, **kw)
        results[name] = r
    j, p = results["jax"], results["port"]
    assert p.best_knobs == j.best_knobs and p.best_score == j.best_score
    assert [(t.knobs, t.score) for t in p.trials] == \
        [(t.knobs, t.score) for t in j.trials]
    assert {k: float(v) for k, v in p.best_params.items()} == \
        {k: float(v) for k, v in j.best_params.items()}
    for fn, kw in ((jtune_model, {}), (tune_model, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"\['lrr'\] match no knob"):
            fn(_tune_toy(_Side("port" if kw else "jax")), "u", "u",
               knob_overrides={"lrr": 1}, **kw)


def test_tune_model_profile_dir_writes_a_trace(tmp_path):
    toy = _tune_toy(_Side("port"))
    tune_model(toy, "u", "u", total_trials=2, advisor_type="random",
               profile_dir=str(tmp_path), device="cpu")
    traces = sorted(p.relative_to(tmp_path).as_posix()
                    for p in tmp_path.rglob("trace.json"))
    assert traces == ["local-0/trace.json", "local-1/trace.json"]


def test_worker_profile_dir_writes_a_trace(tmp_path):
    side = _Side("port")
    meta, store, sub = side.stores(tmp_path)
    w = side.worker(side.Toy, meta, store, sub, "w0", 1,
                    profile_dir=str(tmp_path / "prof"))
    w.run(max_trials=1)
    tid = meta.get_trials_of_sub_train_job(sub)[0]["id"]
    trace = tmp_path / "prof" / tid / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]


class _NoProposals:
    """An advisor that records its calls and has nothing to propose."""

    def __init__(self):
        self.calls = 0

    def propose(self):
        self.calls += 1
        return PA.Proposal.invalid()

    def propose_batch(self, k):
        self.calls += 1
        return []


def test_gang_size_refused_for_llama_and_ignored_for_vit(caplog):
    """Once the port refused a Llama gang by name; now both workers
    drive a gang engine for it (one batched pull of the advisor, no
    trial), and a gang's estimate is K lanes of one trial's state and
    activations over one base. ViT has no gang spec in either package:
    sequential trials, with JAX's warning."""
    for mod, template, kw in ((jtrain, JLlamaLoRA, {}),
                              (ptrain, LlamaLoRA, {"device": "cpu"})):
        adv = _NoProposals()
        w = mod.TrainWorker(template, adv, "u", "u", **kw)
        assert w.run_gang(2) == 0
        assert adv.calls == 1 and w.gang_engine.n_buckets == 0
    one = LlamaLoRA(device="cpu", **LM_KNOBS).estimate_device_budget(1)
    gang = LlamaLoRA(device="cpu", **LM_KNOBS).estimate_device_budget(
        1, gang_size=4)
    for key in ("grads", "opt", "activations"):
        assert gang[key] == 4 * one[key], key
    logs = {}
    for name, mod, template in (("jax", jtrain, JViTBase16),
                                ("port", ptrain, ViTBase16)):
        caplog.clear()
        kw = {"device": "cpu"} if name == "port" else {}
        adv = _NoProposals()
        with caplog.at_level(logging.WARNING):
            assert mod.TrainWorker(template, adv, "u", "u",
                                   **kw).run_gang(2) == 0
        assert adv.calls == 1
        logs[name] = [r.getMessage() for r in caplog.records
                      if "gang" in r.getMessage()]
    assert logs["port"] == logs["jax"] == [
        "ViTBase16 has no gang spec; gang_size=2 ignored, running "
        "sequential trials"]
    toy = _tune_toy(_Side("port"))
    with pytest.warns(UserWarning, match="no gang spec"):
        tune_model(toy, "u", "u", total_trials=1, advisor_type="random",
                   gang_size=2, device="cpu")


def test_train_admission_refuses_over_the_device_limit(tmp_path,
                                                       monkeypatch):
    pins = {"model_parallel": 1, "remat_policy": "none", "hidden_dim": 64,
            "depth": 2, "max_len": 32, "batch_size": 8}
    budget = LlamaLoRA(device="cpu", **dict(LM_KNOBS, **pins))
    knobs = dict(LM_KNOBS, **pins)
    est = budget.estimate_device_budget(1)
    # the step's peak: the backward's or the update's, not every term
    assert est["total"] == est["params"] + est["opt"] + max(
        est["activations"] + est["transient"], 3 * est["grads"])
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", "1000")
    meta = MetaStore(str(tmp_path / "m.db"))
    sub = meta.create_sub_train_job("j", "m0")["id"]
    w = ptrain.TrainWorker(
        LlamaLoRA, PA.make_advisor(LlamaLoRA.get_knob_config(), "random",
                                   total_trials=1),
        "unused.jsonl", "unused.jsonl", meta_store=meta,
        sub_train_job_id=sub, knob_overrides=pins, device="cpu")
    w.run(max_trials=1)
    t = meta.get_trials_of_sub_train_job(sub)[0]
    assert t["status"] == "ERRORED" and \
        t["error_class"] == "deterministic"
    assert "admission control" in t["error"]
    # knobs the train path refuses raise the same error in the estimate
    for bad in ({"pipeline_stages": 2},):
        m = LlamaLoRA(device="cpu", **dict(knobs, **bad))
        with pytest.raises(NotImplementedError) as want:
            m._check_trainable_knobs()
        with pytest.raises(NotImplementedError,
                           match=re.escape(str(want.value))):
            m.estimate_device_budget(1)
    # model_parallel trains on a mesh: on one device its (1, 1) mesh's
    # budget, which holds the one-card step's leaves
    m = LlamaLoRA(device="cpu", **dict(knobs, model_parallel=2))
    mesh_est = m.estimate_device_budget(1)
    assert (mesh_est["params"], mesh_est["opt"]) == (est["params"],
                                                     est["opt"])
    # sequence_parallel trains on a (data, sp) mesh: each position holds
    # every leaf (no spec names sp) and a slice of the sequence
    m = LlamaLoRA(device="cpu", **dict(knobs, sequence_parallel=2))
    sp_est = m.estimate_device_budget(2)
    assert (sp_est["params"], sp_est["opt"]) == (est["params"],
                                                 est["opt"])
    assert sp_est["activations"] < est["activations"]


def test_train_admission_keeps_a_reserve_at_the_limit(monkeypatch):
    """The estimate is the allocator's peak; the card's total also holds
    the CUDA context and the allocator's slack. So a trial (and a gang)
    is admitted where its estimate plus ``train_reserve`` fits the limit
    and refused a byte below, where the bare estimate would fit."""
    from rafiki_tpu_torch.worker.admission import (TRAIN_RESERVE_BYTES,
                                                   train_reserve)

    knobs = dict(LM_KNOBS, model_parallel=1, remat_policy="none",
                 hidden_dim=64, depth=2, max_len=32, batch_size=8)
    model = LlamaLoRA(device="cpu", **knobs)
    w = ptrain.TrainWorker(LlamaLoRA, None, "u", "u", device="cpu",
                           knob_overrides=knobs)
    for k in (0, 2):
        est = model.estimate_device_budget(1, gang_size=k)["total"]
        reserve = train_reserve(est)
        assert reserve >= TRAIN_RESERVE_BYTES
        for limit, admitted in ((est + reserve, True),
                                (est + reserve - 1, False),
                                (est, False)):
            monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", str(limit))
            if k:
                refusal = w._gang_admission(knobs, k)
                assert (refusal is None) == admitted, (limit, refusal)
            elif admitted:
                w._admission_check(model)
            else:
                with pytest.raises(ValueError, match="reserve"):
                    w._admission_check(model)


@pytest.mark.parametrize("extra", [
    {"bf16": True, "kv_ratio": 2},
    {"bf16": True, "kv_ratio": 1, "adapters_only": True},
    {"bf16": False, "kv_ratio": 4},
], ids=["bf16", "bf16-adapters-only", "f32"])
def test_train_budget_covers_what_the_step_saves(extra):
    """The train estimate's ``activations`` and ``transient`` (the LM
    head's compute-dtype cast) hold every non-parameter tensor one train
    step saves for its backward, plus the loss's two f32 cotangents; and
    over-count the saved bytes by at most 10 %."""
    from rafiki_tpu_torch.models import llama_lora as pll

    knobs = dict(LM_KNOBS, model_parallel=1, remat_policy="none",
                 hidden_dim=64, depth=2, max_len=32, n_heads=4,
                 batch_size=8, lora_rank=4, **extra)
    m = LlamaLoRA(device="cpu", **knobs)
    model = m._module()
    trainable = pll.make_trainable(model, pll.lora_trainable_names(
        model, bool(knobs.get("adapters_only"))))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 500, (8, 32)))
    lens = torch.full((8,), 32, dtype=torch.int32)
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        pll.lm_objective(model, trainable, 1.0,
                         {"ids": ids, "lens": lens})
    for p in model.parameters():
        saved.pop(p.untyped_storage().data_ptr(), None)
    got = sum(saved.values())
    cotangents = 2 * 4 * 8 * 32 * m.tokenizer.vocab_size
    est = m.estimate_device_budget(1)
    act = est["activations"] + est["transient"]
    assert got + cotangents <= act <= 1.1 * got + cotangents, \
        (got, cotangents, act)


TOY_MODULE = '''
import numpy as np
from rafiki_tpu_torch.model.knob import FixedKnob, FloatKnob, PolicyKnob
from rafiki_tpu_torch.model.base import TrainContext, validate_template_knobs


class ScriptToy:
    @staticmethod
    def get_knob_config():
        return {"max_epochs": FixedKnob(3),
                "lr": FloatKnob(0.01, 1.0, is_exp=True),
                "quick_train": PolicyKnob("QUICK_TRAIN"),
                "share_params": PolicyKnob("SHARE_PARAMS")}

    @classmethod
    def validate_knobs(cls, knobs):
        validate_template_knobs(cls, knobs)

    def __init__(self, device=None, **knobs):
        self.knobs, self._w = dict(knobs), 0.0

    def train(self, dataset_path, ctx=None):
        ctx = ctx or TrainContext()
        for epoch in range(max(1, round(3 * ctx.budget_scale))):
            self._w += self.knobs["lr"]
            ctx.logger.log(epoch=epoch, loss=1.0 / (1 + self._w))

    def evaluate(self, dataset_path):
        return float(self._w)

    def predict(self, queries):
        return [self._w for _ in queries]

    def dump_parameters(self):
        return {"w": np.asarray(self._w)}

    def load_parameters(self, params):
        self._w = float(params["w"])
'''


def _main_config(tmp_path, url, **extra):
    (tmp_path / "toy.py").write_text(TOY_MODULE)
    meta = MetaStore(str(tmp_path / "meta.db"))
    sub = meta.create_sub_train_job("job", "m0")["id"]
    cfg = {"advisor_url": url, "model_file": str(tmp_path / "toy.py"),
           "model_class": "ScriptToy", "train_dataset": "unused",
           "val_dataset": "unused",
           "param_store_uri": f"file://{tmp_path / 'params'}",
           "meta_store_path": str(tmp_path / "meta.db"),
           "sub_train_job_id": sub, "worker_id": "tw0", "device": "cpu",
           **extra}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path), meta, sub


def test_main_refuses_the_obs_sidecar(tmp_path, monkeypatch):
    """``main`` serves the obs sidecar now (it used to refuse it): on the
    port ``obs_port`` names, or on an ephemeral one written to
    ``obs_port_file``, up while the worker runs; the file goes with the
    worker."""
    import socket
    import urllib.request

    from rafiki_tpu_torch.utils.http import json_request

    seen = []

    def run(self):
        port = self._obs_server.port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        seen.append((port, json_request(
            "GET", f"http://127.0.0.1:{port}/health"),
            "trials_completed 0" in text))
        return 0

    monkeypatch.setattr(ptrain.TrainWorker, "run", run)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        free = sock.getsockname()[1]
    port_file = tmp_path / "p.txt"
    for key, value in (("obs_port", free),
                       ("obs_port_file", str(port_file))):
        path, _, _ = _main_config(tmp_path, "http://127.0.0.1:1",
                                  **{key: value})
        if key == "obs_port_file":
            monkeypatch.setattr(ptrain.TrainWorker, "run", lambda self: (
                run(self), seen.append(int(port_file.read_text())))[0])
        assert ptrain.main(["--config", path]) == 0
    assert seen[0] == (free, {"ok": True}, True)
    assert seen[1][1:] == ({"ok": True}, True) and seen[2] == seen[1][0]
    assert not port_file.exists()


def test_main_runs_the_allocator_with_the_train_settings(tmp_path,
                                                         monkeypatch):
    """``main`` gives the caching allocator the train settings
    (expandable segments) before the worker touches the card; a setting
    the environment already holds wins."""
    from rafiki_tpu_torch.worker.admission import TRAIN_ALLOC_CONF

    assert TRAIN_ALLOC_CONF == "expandable_segments:True"
    monkeypatch.setattr(ptrain.TrainWorker, "run", lambda self: 0)
    path, _, _ = _main_config(tmp_path, "http://127.0.0.1:1")
    for preset, want in ((None, TRAIN_ALLOC_CONF),
                         ("expandable_segments:False",
                          "expandable_segments:False")):
        if preset is None:
            monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
        else:
            monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", preset)
        assert ptrain.main(["--config", path]) == 0
        assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == want


@pytest.mark.slow
def test_main_in_a_subprocess_against_the_jax_advisor_service(tmp_path):
    from rafiki_tpu.advisor.service import AdvisorService

    exec_ns = {}
    exec(compile(TOY_MODULE, "toy", "exec"), exec_ns)
    config = jk.knob_config_from_json(pk.knob_config_to_json(
        exec_ns["ScriptToy"].get_knob_config()))
    service = AdvisorService(JA.make_advisor(config, "auto", total_trials=4,
                                             seed=0))
    host, port = service.start()
    try:
        path, meta, sub = _main_config(tmp_path, f"http://{host}:{port}")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run(
            [sys.executable, "-m", "rafiki_tpu_torch.worker.train",
             "--config", path], capture_output=True, text=True, env=env,
            timeout=300, cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr
        lines = proc.stdout.strip().splitlines()
        assert lines == ["train worker tw0 training on cpu",
                         "train worker tw0 done: 4 trials"]
        rows = meta.get_trials_of_sub_train_job(sub)
        assert [r["status"] for r in rows] == ["COMPLETED"] * 4
        assert service.advisor.finished
        assert len(service.advisor.results) == 4
        store = ParamStore.from_uri(f"file://{tmp_path / 'params'}")
        assert all(store.exists(r["id"]) for r in rows)
    finally:
        service.stop()
