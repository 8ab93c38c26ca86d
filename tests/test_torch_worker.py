"""The port's inference worker against the JAX worker, on the CPU.

Both workers serve the same param-store blob behind the unchanged JAX
``Predictor`` and ``InProcQueueHub``: the JAX-trained ``trained_lm``
through the continuous-batching decode loop (paged and contiguous KV),
and a small ViT through the micro-batcher. Texts must be identical
(greedy decoding, f32), ViT probabilities within the f32 tolerance of the
ViT tests (rtol 1e-4, atol 1e-5). Also held here: the error replies and
that the worker serves on after them, expiry and drain, the engine's
span events against the JAX engine's, ``estimate_serving_device_bytes``
against JAX's term by term (its ``params`` against the bytes the port's
serving model holds), admission, and the options that refuse to boot.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.vit import ViT as JViT
from rafiki_tpu.models.vit import ViTBase16 as JViTBase16
from rafiki_tpu.serving.predictor import Predictor
from rafiki_tpu.serving.queues import InProcQueueHub as JHub
from rafiki_tpu.serving.queues import pack_message as jpack
from rafiki_tpu.serving.queues import unpack_message as junpack
from rafiki_tpu.store.param_store import ParamStore as JParamStore
from rafiki_tpu.worker.inference import InferenceWorker as JWorker
from rafiki_tpu_torch.models.llama_lora import Llama, LlamaLoRA
from rafiki_tpu_torch.models.vit import ViTBase16
from rafiki_tpu_torch.serving import decode_engine as de
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.store.params import params_to_jax
from rafiki_tpu_torch.worker import inference as wi
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_decode_engine import KNOBS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = ["tok1 tok2 tok3", "tok4 tok5", "tok2 tok9 tok7 tok1",
           "w3 w1"]


@pytest.fixture(scope="module")
def lm_blob(trained_lm):
    """``trained_lm`` as the flax-msgpack bytes the JAX store writes."""
    store = JParamStore.from_uri("mem://")
    store.save("t0", trained_lm.dump_parameters())
    return store.backend.get("t0")


def _port_store(blob, key="t0"):
    store = ParamStore.from_uri("mem://")
    store.backend.put(key, blob)
    return store


def _jax_store(blob, key="t0"):
    store = JParamStore.from_uri("mem://")
    store.backend.put(key, blob)
    return store


class _Serving:
    """One worker serving on its own thread behind a Predictor."""

    def __init__(self, worker):
        self.worker = worker
        self.hub = worker.hub
        self.thread = threading.Thread(
            target=worker.run, kwargs={"poll_timeout": 0.05}, daemon=True)
        self.thread.start()
        self.pred = Predictor(self.hub, [worker.worker_id],
                              gather_timeout=120.0)

    def close(self):
        self.worker.stop()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _lm_worker(cls, store, layout, wid="w0", **kw):
    opts = dict(decode_loop=True, max_slots=4, max_new_tokens=6)
    if layout == "paged8":
        opts["kv_page_size"] = 8
    opts.update(kw)
    if cls is InferenceWorker:
        opts.setdefault("device", "cpu")
    return cls(LlamaLoRA if cls is InferenceWorker else JLlamaLoRA, "t0",
               KNOBS, store, JHub(), wid, **opts)


def _stream(pred, queries):
    events = list(pred.predict_stream(queries, timeout=60.0))
    acc = {}
    for ev in events[:-1]:
        assert set(ev) == {"delta"}, ev
        for qi, d in ev["delta"].items():
            acc[qi] = acc.get(qi, "") + d
    final = events[-1]
    assert final.get("done") and "error" not in final, final
    return acc, final["predictions"]


def _serve_lm(cls, blob, layout):
    store = _port_store(blob) if cls is InferenceWorker else _jax_store(blob)
    s = _Serving(_lm_worker(cls, store, layout))
    try:
        preds, info = s.pred.predict(PROMPTS, timeout=60.0)
        assert info["workers_answered"] == 1, info
        acc, final = _stream(s.pred, PROMPTS[:2])
        return preds, acc, final, s.worker
    finally:
        s.close()


@pytest.mark.parametrize("layout", ["paged8", "contiguous"])
def test_lm_worker_texts_equal_the_jax_worker(lm_blob, layout):
    """predict and predict_stream through the Predictor: the port worker
    gives the JAX worker's texts; each stream's deltas concatenate to its
    final text (the no-fault leg of the failover test, with a port
    worker)."""
    want = _serve_lm(JWorker, lm_blob, layout)
    got_preds, got_acc, got_final, worker = _serve_lm(InferenceWorker,
                                                      lm_blob, layout)
    want_preds, want_acc, want_final, _ = want
    assert got_preds == want_preds and len(got_preds) == len(PROMPTS)
    assert got_final == want_final
    assert got_acc == {str(i): t for i, t in enumerate(got_final)}
    assert got_acc == want_acc
    stats = worker.hub.get_worker_stats(worker.worker_id)
    n = len(PROMPTS) + 2
    assert stats["engine_requests_done"] == n
    assert stats["ttft_p95_s"] > 0 and stats["queue_p95_s"] >= 0
    assert stats["slo_interactive_ttft_p95_s"] > 0
    assert stats["draining"] is False and stats["role"] == "unified"
    assert worker.metrics.snapshot()["ttft_seconds_count"] == n


# ---- ViT through the micro-batcher

VIT_KNOBS = {"patch_size": 4, "hidden_dim": 48, "depth": 2, "n_heads": 4,
             "batch_size": 16, "max_epochs": 1, "learning_rate": 1e-3,
             "weight_decay": 1e-4, "warmup_frac": 0.1, "bf16": False,
             "remat": False, "quick_train": False, "share_params": False}
IMAGE = (16, 16, 3)


@pytest.fixture(scope="module")
def vit_blob():
    module = JViT(patch_size=4, hidden_dim=48, depth=2, n_heads=4,
                  mlp_dim=192, n_classes=10)
    params = module.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, *IMAGE), jnp.float32))["params"]
    store = JParamStore.from_uri("mem://")
    store.save("v0", {"params": jax.tree_util.tree_map(np.asarray, params),
                      "meta": {"n_classes": 10, "image_shape": list(IMAGE),
                               "prep_version": 2}})
    return store.backend.get("v0")


def test_vit_worker_matches_the_jax_worker(vit_blob):
    images = list(np.random.default_rng(3).integers(
        0, 256, (6, *IMAGE), dtype=np.uint8))
    out = {}
    for cls, tmpl, store in (
            (JWorker, JViTBase16, _jax_store(vit_blob, "v0")),
            (InferenceWorker, ViTBase16, _port_store(vit_blob, "v0"))):
        kw = {"device": "cpu"} if cls is InferenceWorker else {}
        s = _Serving(cls(tmpl, "v0", VIT_KNOBS, store, JHub(), "v", **kw))
        try:
            preds, info = s.pred.predict(images, timeout=60.0)
            assert info["workers_answered"] == 1, info
            out[cls] = np.asarray(preds)
        finally:
            s.close()
    assert out[InferenceWorker].shape == (6, 10)
    np.testing.assert_allclose(out[InferenceWorker], out[JWorker],
                               rtol=1e-4, atol=1e-5)


def test_vit_micro_batcher_merges_queued_messages(vit_blob):
    """Messages queued before the loop runs are served by ONE predict
    over their union, and each reply holds its own message's rows."""
    hub = JHub()
    w = InferenceWorker(ViTBase16, "v0", VIT_KNOBS,
                        _port_store(vit_blob, "v0"), hub, "v",
                        device="cpu")
    rng = np.random.default_rng(4)
    msgs = [rng.integers(0, 256, (n, *IMAGE), dtype=np.uint8)
            for n in (1, 3, 2)]
    calls = []
    predict = w.model.predict
    w.model.predict = lambda qs: calls.append(len(qs)) or predict(qs)
    for i, m in enumerate(msgs):
        hub.push_query("v", jpack({"id": f"q{i}", "queries": m}))
    w.run(poll_timeout=0.05, max_iterations=1)
    assert calls == [6]
    for i, m in enumerate(msgs):
        reply = junpack(hub.pop_prediction(f"q{i}", 1.0))
        np.testing.assert_allclose(reply["predictions"],
                                   w.model.predict(list(m)), rtol=1e-6)


# ---- error paths, expiry, drain

@pytest.fixture()
def lm_worker(lm_blob):
    """A paged port worker whose pool holds 3 usable pages of 8."""
    s = _Serving(_lm_worker(InferenceWorker, _port_store(lm_blob),
                            "paged8", kv_pages=4))
    yield s
    s.close()


@pytest.mark.parametrize("sampling,prompt,error", [
    ({"temperature": 0.7}, "tok1 tok2", "sampling (temperature > 0)"),
    ({"adapter_id": 1}, "tok1 tok2", "adapter_id 1"),
    ({"max_new": 6}, " ".join(f"t{i}" for i in range(30)), "KV pages"),
], ids=["temperature", "adapter_id", "too_many_pages"])
def test_unserved_requests_get_an_error_reply_and_the_worker_serves_on(
        lm_worker, sampling, prompt, error):
    preds, info = lm_worker.pred.predict([prompt], timeout=30.0,
                                         sampling=sampling)
    assert preds == [] and any(error in e for e in info["errors"]), info
    preds, info = lm_worker.pred.predict(["tok1 tok2"], timeout=30.0)
    assert len(preds) == 1 and not info.get("errors"), info


def test_malformed_sampling_degrades_to_greedy(lm_worker):
    want, _ = lm_worker.pred.predict(["tok1 tok2"], timeout=30.0)
    got, info = lm_worker.pred.predict(
        ["tok1 tok2"], timeout=30.0,
        sampling={"temperature": "hot", "top_k": "x", "seed": float("inf"),
                  "top_p": None})
    assert got == want and len(got) == 1, info
    # the predictor's trace id joins the worker's spans for the request
    spans = [sp["name"] for sp in
             lm_worker.worker.traces.get(info["trace_id"])["spans"]]
    assert spans == ["queued", "admitted", "prefill", "first_token",
                     "done"], spans


def test_forced_prefix_gets_an_error_reply(lm_worker):
    hub = lm_worker.hub
    hub.push_query("w0", jpack({"id": "fp", "queries": ["tok1"],
                                "forced_prefix": {"0": "tok2"}}))
    reply = junpack(hub.pop_prediction("fp", 30.0))
    assert "forced_prefix" in reply["error"] and reply["predictions"] == []
    preds, _ = lm_worker.pred.predict(["tok1 tok2"], timeout=30.0)
    assert len(preds) == 1


def test_expired_queries_are_rejected_not_served(lm_worker):
    hub = lm_worker.hub
    hub.push_query("w0", jpack({"id": "old", "queries": ["tok1"],
                                "deadline_ts": time.time() - 60.0}))
    reply = junpack(hub.pop_prediction("old", 30.0))
    assert reply["expired"] and reply["predictions"] == []
    assert lm_worker.worker.stats["dropped_expired"] == 1


@pytest.mark.parametrize("decode_loop", [True, False],
                         ids=["decode_loop", "micro_batch"])
def test_drain_control_finishes_in_flight_and_rejects_new(lm_blob,
                                                          decode_loop):
    """A message queued before the drain is answered, one queued after it
    gets a ``draining`` rejection, and the loop exits. The micro-batcher
    pops one message an iteration here: messages popped in one batch with
    the drain would be in flight, and served."""
    hub = JHub()
    w = _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8",
                   decode_loop=decode_loop, max_batch_msgs=1)
    w.hub = hub
    hub.push_query("w0", jpack({"id": "a", "queries": ["tok1 tok2"]}))
    hub.push_query("w0", jpack({"control": "drain"}))
    hub.push_query("w0", jpack({"id": "b", "queries": ["tok3"]}))
    th = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.05})
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()  # the loop exits once drained
    a = junpack(hub.pop_prediction("a", 1.0))
    b = junpack(hub.pop_prediction("b", 1.0))
    assert len(a["predictions"]) == 1 and not a.get("error")
    assert b["draining"] and b["error"] == "worker draining"
    stats = hub.get_worker_stats("w0")
    assert stats["draining"] is True and stats["drain_rejected"] == 1


# ---- the engine's span events against the JAX engine's

SPAN_KNOBS = dict(KNOBS, max_len=48)


def test_engine_span_events_equal_the_jax_engine(tmp_path):
    """Same blob, same requests: per request, the port engine emits the
    JAX engine's lifecycle events with the same attributes (a 40-token
    generation crosses one decode mark)."""
    gen = torch.Generator().manual_seed(0)
    net = Llama(vocab_size=KNOBS["vocab_size"], max_len=48,
                hidden_dim=32, depth=2, n_heads=4, n_kv_heads=2,
                mlp_dim=128, lora_rank=4, device="cpu", generator=gen)
    blob = {"params": params_to_jax(net.state_dict()),
            "meta": {"id2tok": {}}}
    reqs = [("a", "tok1 tok2 tok3", 40), ("b", "tok4", 5),
            ("c", "tok5 tok6", 8)]
    seqs = {}
    for name, tmpl, kw in (("jax", JLlamaLoRA, {}),
                           ("port", LlamaLoRA, {"device": "cpu"})):
        m = tmpl(**SPAN_KNOBS, **kw)
        m.load_parameters(blob)
        eng = m.make_decode_engine(max_slots=2, max_new_tokens=40,
                                   steps_per_sync=4, kv_page_size=8)
        events = []
        eng.span_sink = lambda ev, rid, attrs: events.append(
            (ev, rid, dict(attrs)))
        for rid, text, n in reqs:
            eng.submit(rid, text, max_new=n)
        done = {}
        for _ in range(200):
            eng.step()
            done.update(eng.poll())
            if len(done) == len(reqs):
                break
        seqs[name] = ({rid: [(ev, a) for ev, r, a in events if r == rid]
                       for rid, _, _ in reqs}, done)
    assert seqs["port"] == seqs["jax"]
    kinds = [ev for ev, _ in seqs["port"][0]["a"]]
    assert kinds == ["admitted", "prefill", "first_token", "decode_mark",
                     "done"]


# ---- the serving budget: JAX's terms, and the port's own params term

def _held_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("q8", [False, True], ids=["w32", "w8"])
@pytest.mark.parametrize("kv8", [False, True], ids=["kv", "kv8"])
@pytest.mark.parametrize("layout", [(0, 0), (8, 0), (4, 9)],
                         ids=["contiguous", "paged8", "paged4x9"])
def test_estimate_serving_device_bytes_equals_jax(trained_lm, bf16, q8, kv8,
                                                  layout):
    """Every term but ``params`` equals JAX's; ``params`` is the bytes of
    the weights the port's serving model holds (JAX counts its f32 tree,
    which it keeps on the device; the port keeps it on the host)."""
    page, pages = layout
    knobs = dict(KNOBS, bf16=bf16, quantize_int8=q8, kv_cache_int8=kv8)
    dump = trained_lm.dump_parameters()
    for loaded in (True, False):
        jm, pm = JLlamaLoRA(**knobs), LlamaLoRA(device="cpu", **knobs)
        if loaded:
            jm.load_parameters(dump)
            pm.load_parameters(dump)
            held = _held_bytes(pm._serving_module_params())
        else:
            held = _held_bytes(pm._module(quantized=q8))
        for extra in (0, 2):
            for host in ((0, 6) if page else (0,)):
                kw = dict(max_slots=3, n_extra_adapters=extra,
                          kv_page_size=page, kv_pages=pages,
                          host_kv_pages=host)
                want = jm.estimate_serving_device_bytes(**kw)
                got = pm.estimate_serving_device_bytes(**kw)
                assert got["params"] == held, (loaded, kw)
                assert {k: v for k, v in got.items()
                        if k not in ("params", "total")} == \
                    {k: v for k, v in want.items()
                     if k not in ("params", "total")}, (loaded, kw)
                assert got["total"] == sum(
                    v for k, v in got.items()
                    if k not in ("total", "host_kv_cache"))
    jd, pd = JLlamaLoRA(**knobs), LlamaLoRA(device="cpu", **knobs)
    got = pm.estimate_serving_device_bytes(draft=pd)["draft"]
    assert got == _held_bytes(pd._module(quantized=q8)) + \
        jm.estimate_serving_device_bytes(draft=jd)["draft"] - \
        jd.estimate_serving_device_bytes()["params"]


def test_estimate_refuses_what_the_engine_refuses():
    pm = LlamaLoRA(device="cpu", **KNOBS)
    with pytest.raises(ValueError, match="host_kv_pages"):
        pm.estimate_serving_device_bytes(host_kv_pages=4)
    with pytest.raises(ValueError, match="divide"):
        pm.estimate_serving_device_bytes(kv_page_size=5)
    with pytest.raises(ValueError, match="kv_pages >= 2"):
        pm.estimate_serving_device_bytes(kv_page_size=8, kv_pages=1)


# ---- boot: admission, loud failures, options not ported

def test_admission_refuses_a_deployment_over_the_device_limit(
        lm_blob, monkeypatch):
    budget = LlamaLoRA(device="cpu", **KNOBS)
    budget.load_parameters(_port_store(lm_blob).load("t0"))
    total = budget.estimate_serving_device_bytes(
        max_slots=4, kv_page_size=8)["total"]
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", str(total - 1))
    with pytest.raises(ValueError, match="serving admission control"):
        _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8")
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", str(total))
    w = _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8")
    assert w.engine is not None


def test_admission_admits_when_the_estimator_raises(lm_blob, monkeypatch,
                                                    caplog):
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", "1")

    def broken(self, **kw):
        raise RuntimeError("estimator bug")

    monkeypatch.setattr(LlamaLoRA, "estimate_serving_device_bytes", broken)
    w = _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8")
    assert w.engine is not None
    assert "admission check skipped" in caplog.text


@pytest.mark.parametrize("kw,name", [
    ({"role": "prefill"}, "worker role 'prefill'"),
    ({"role": "decode"}, "worker role 'decode'"),
    ({"host_kv_pages": 4}, "host_kv_pages"),
    ({"extra_adapter_trials": ["t1"]}, "extra_adapter_trials"),
    ({"draft_trial_id": "t1", "speculate_k": 3}, "draft_trial_id"),
    ({"pool_id": "p", "system_prefix": "be brief"}, "pool_id"),
    ({"system_prefix": "be brief"}, "system_prefix"),
    ({"speculate_k": 3}, "speculate_k"),
    ({"chaos": object()}, "fault injection"),
    ({"paged_kernel": False}, "paged_kernel=False"),
], ids=["prefill", "decode", "host_kv_pages", "extra_adapters", "draft",
        "pool_prefix", "system_prefix", "speculate_k", "chaos",
        "paged_kernel_false"])
def test_options_not_ported_refuse_to_boot(lm_blob, kw, name):
    with pytest.raises(NotImplementedError, match=name.replace("(", r"\(")):
        _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8", **kw)


def test_armed_chaos_env_refuses_to_boot(lm_blob, monkeypatch):
    monkeypatch.setenv("RAFIKI_CHAOS", "kill_after_tokens=3")
    with pytest.raises(NotImplementedError, match="RAFIKI_CHAOS"):
        _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8")


def test_paged_kernel_true_or_auto_serves_paged(lm_blob):
    for pk in (None, True):
        w = _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8",
                       paged_kernel=pk)
        assert w.engine.engine.paged
    assert wi._tristate("auto") is None and wi._tristate("off") is False


def test_boot_fails_loudly(lm_blob, vit_blob, monkeypatch):
    """A warmup failure propagates; decode_loop without an engine raises
    instead of degrading; no card without device="cpu" raises."""
    def broken_step(self):
        raise RuntimeError("device path broken")

    with monkeypatch.context() as mp:
        mp.setattr(de.DecodeEngine, "step", broken_step)
        with pytest.raises(RuntimeError, match="device path broken"):
            _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8")
    with monkeypatch.context() as mp:
        mp.setattr(ViTBase16, "warmup", lambda self: broken_step(self))
        with pytest.raises(RuntimeError, match="device path broken"):
            InferenceWorker(ViTBase16, "v0", VIT_KNOBS,
                            _port_store(vit_blob, "v0"), JHub(), "v",
                            device="cpu")
    with pytest.raises(RuntimeError, match="no make_decode_engine"):
        InferenceWorker(ViTBase16, "v0", VIT_KNOBS,
                        _port_store(vit_blob, "v0"), JHub(), "v",
                        decode_loop=True, device="cpu")
    with pytest.raises(KeyError, match="no parameters"):
        _lm_worker(InferenceWorker, ParamStore.from_uri("mem://"), "paged8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceWorker(LlamaLoRA, "t0", KNOBS, _port_store(lm_blob),
                        JHub(), "w0", decode_loop=True)


def test_safe_sampling_and_expiry_helpers():
    assert wi._safe_sampling({"temperature": float("nan"), "top_k": "3",
                              "eos_id": -1, "adapter_id": -2,
                              "max_new": 0}) == {
        "temperature": 0.0, "top_k": 3, "top_p": 1.0, "seed": 0,
        "adapter_id": -2}
    assert wi._safe_sampling(None)["temperature"] == 0.0
    est = wi.ClockSkewEstimator()
    now = time.time()
    assert not wi._expired({"ttl_s": 1.0, "sent_ts": now}, skew_est=est)
    assert wi._expired({"deadline_ts": now - 10.0})
    assert not wi._expired({"deadline_ts": now - 1.0})  # skew pad 3 s


# ---- the process entry point against the JAX package's kv server

@pytest.mark.slow
def test_main_serves_through_the_kv_hub(lm_blob, tmp_path):
    from rafiki_tpu.native import KVServer
    from rafiki_tpu.serving.queues import KVQueueHub as JKVHub

    want = _serve_lm(JWorker, lm_blob, "paged8")[0]
    with KVServer() as server:
        # the JAX store writes the blob to the kv server; the port
        # worker's kv:// store reads it
        uri = f"kv://{server.host}:{server.port}"
        JParamStore.from_uri(uri).backend.put("t0", lm_blob)
        cfg = {"model_file": str(ROOT / "rafiki_tpu_torch" / "models"
                                 / "llama_lora.py"),
               "model_class": "LlamaLoRA", "trial_id": "t0",
               "knobs": KNOBS, "param_store_uri": uri,
               "kv_host": server.host, "kv_port": server.port,
               "worker_id": "pw", "decode_loop": True, "max_slots": 4,
               "max_new_tokens": 6, "kv_page_size": 8, "device": "cpu"}
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(cfg))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.Popen(
            [sys.executable, "-m", "rafiki_tpu_torch.worker.inference",
             "--config", str(path)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            hub = JKVHub(server.host, server.port)
            preds, info = Predictor(hub, ["pw"], gather_timeout=120.0) \
                .predict(PROMPTS, timeout=120.0)
            assert preds == want, (info, proc.poll())
            hub.push_query("pw", jpack({"control": "drain"}))
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, out
            assert "drained cleanly" in out
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
