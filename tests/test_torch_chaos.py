"""Port parity: fault injection (``rafiki_tpu_torch.chaos``) and the
chaos-reaching cases of ``tests/test_chaos.py``.

- ``ChaosConfig.parse`` / ``from_env`` accept and refuse the same specs
  as JAX's, with the same message; for the same config and seed, JAX's
  and the port's ``ChaosInjector`` make the same drop, corrupt, delay,
  connection-drop, KV-shipment and kill decisions on one seeded traffic
  order, with the same counters; the port's ``ChaosHub`` wraps every
  verb the JAX one wraps.
- A corrupted reply in the unary gather is one replica's bad answer.
- A port worker chaos-killed mid-stream (``kill_after_tokens``) fails its
  stream over to a healthy port worker behind the port's Predictor,
  token-exact against a no-fault run. The stream silence window is 8 s:
  a healthy worker on a loaded host never goes that long without a
  token, so the one failover is the injected death's.
- The control plane over the port's ``chaos`` process stubs: a rolling
  restart over two ``dummy_service`` children, and ``control_driver``
  killed with SIGKILL and reconciled by a second driver.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from rafiki_tpu import chaos as jchaos
from rafiki_tpu.serving.queues import InProcQueueHub as JHub
from rafiki_tpu_torch import chaos as pchaos
from rafiki_tpu_torch.chaos import ChaosConfig, ChaosHub, ChaosInjector
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving.breaker import OPEN
from rafiki_tpu_torch.serving.predictor import Predictor
from rafiki_tpu_torch.serving.queues import (InProcQueueHub, QueueHub,
                                             pack_message, unpack_message)
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_decode_engine import KNOBS
from test_torch_worker import _port_store, lm_blob  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DUMMY = "rafiki_tpu_torch.chaos.dummy_service"

SPECS = [
    "kill_after_tokens=8, drop_reply_p=0.25; seed=7",
    "delay_queue_s=0.01", "", "  ", "seed=3", "kill_after_tokens=0",
    "drop_hub_conn_p=0.5,drop_kv_page_p=0.1,delay_kv_transfer_s=0.2",
    "kill_admin_after_s=1.5;kill_kvd_after_s=2", "corrupt_payload_p=1",
    "drop_replyp=0.5", "kill_after_tokens", "kill_after_tokens=x",
    "kill_after_tokens=2.5", "seed=1,,drop_reply_p=0.5,",
]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_config_parse_and_env_equal_jax(spec):
    def run(mod):
        try:
            cfg = mod.ChaosConfig.parse(spec)
        except ValueError as e:
            return "refused", str(e)
        env = mod.ChaosConfig.from_env({"RAFIKI_CHAOS": spec})
        return (cfg.__dict__, cfg.armed,
                None if env is None else env.__dict__)

    assert run(pchaos) == run(jchaos)


def test_chaos_config_parse_and_env():
    cfg = ChaosConfig.parse("kill_after_tokens=8, drop_reply_p=0.25; "
                            "seed=7")
    assert cfg.kill_after_tokens == 8 and cfg.drop_reply_p == 0.25
    assert cfg.seed == 7 and cfg.armed
    with pytest.raises(ValueError):
        ChaosConfig.parse("drop_replyp=0.5")
    assert ChaosConfig.from_env({"RAFIKI_CHAOS": ""}) is None
    assert ChaosConfig.from_env({}) is None
    got = ChaosConfig.from_env({"RAFIKI_CHAOS": "delay_queue_s=0.01"})
    assert got is not None and got.delay_queue_s == 0.01


@pytest.mark.parametrize("seed", range(4))
def test_injector_decisions_equal_jax(seed):
    """One seeded traffic order through both injectors: every reply,
    connection, shipment and kill decision, the corrupted bytes, and the
    counters equal."""
    rng = random.Random(100 + seed)
    kw = dict(drop_reply_p=rng.choice([0.0, 0.3]),
              corrupt_payload_p=rng.choice([0.0, 0.4, 1.0]),
              drop_hub_conn_p=rng.choice([0.0, 0.2]),
              drop_kv_page_p=rng.choice([0.0, 0.5]),
              kill_after_tokens=rng.choice([0, 5, 40]), seed=seed)
    injs = [mod.ChaosInjector(mod.ChaosConfig(**kw))
            for mod in (jchaos, pchaos)]
    ops = [(rng.choice(["reply", "conn", "kv", "kill", "delay"]),
            bytes(rng.randrange(256) for _ in range(rng.randrange(0, 9))),
            rng.randrange(0, 60)) for _ in range(300)]
    outs = []
    for inj in injs:
        seq = []
        for op, data, tokens in ops:
            if op == "reply":
                seq.append(inj.mangle_reply(data))
            elif op == "conn":
                seq.append(inj.should_drop_conn())
            elif op == "kv":
                seq.append(inj.mangle_kv_ship(data))
            elif op == "kill":
                seq.append(inj.should_kill(tokens))
            else:
                inj.maybe_delay()
        outs.append((seq, dict(inj.counters)))
    assert outs[0] == outs[1]


def test_chaos_injector_deterministic_and_hub_faults():
    def run(seed):
        inj = ChaosInjector(ChaosConfig(drop_reply_p=0.5, seed=seed))
        hub = ChaosHub(InProcQueueHub(), inj)
        outcomes = []
        for i in range(32):
            hub.push_prediction("q", b"x%d" % i)
            outcomes.append(hub.pop_prediction("q", 0.0) is not None)
        return outcomes, int(inj.counters["replies_dropped"])

    a, dropped_a = run(3)
    b, dropped_b = run(3)
    c, _ = run(4)
    assert a == b and a != c
    assert 0 < dropped_a < 32 and dropped_a == dropped_b
    inj = ChaosInjector(ChaosConfig(corrupt_payload_p=1.0, seed=1))
    hub = ChaosHub(InProcQueueHub(), inj)
    hub.push_prediction("q", b"\x00\x00")
    got = hub.pop_prediction("q", 0.0)
    assert got is not None and got != b"\x00\x00"
    assert int(inj.counters["payloads_corrupted"]) == 1
    inj = ChaosInjector(ChaosConfig(kill_after_tokens=3))
    assert not inj.should_kill(2)
    assert inj.should_kill(3) and inj.should_kill(99)
    assert int(inj.counters["kills"]) == 1  # latched, counted once


def test_chaos_hub_wraps_every_verb_as_jax_does():
    """Every QueueHub verb passes through the wrapper (a forgotten one
    would fall through to the base class and raise), the same set as
    JAX's, and a connection drop reaches the inner hub's
    ``drop_conn``."""
    verbs = {n for n in vars(QueueHub) if not n.startswith("_")}
    own = {n for n in vars(ChaosHub) if not n.startswith("_")}
    assert verbs <= own
    assert own == {n for n in vars(jchaos.ChaosHub)
                   if not n.startswith("_")}
    dropped = []

    class Inner(InProcQueueHub):
        def drop_conn(self):
            dropped.append(1)

    inj = ChaosInjector(ChaosConfig(drop_hub_conn_p=1.0))
    hub = ChaosHub(Inner(), inj)
    hub.push_query("w", b"q")
    assert hub.pop_query("w", 0.0) == b"q"
    hub.put_worker_stats("w", {"a": 1})
    assert hub.get_worker_stats("w") == {"a": 1}
    hub.put_pool_members("p", {"workers": ["w"], "version": 1.0})
    assert hub.get_pool_members("p")["workers"] == ["w"]
    hub.put_blob("k", b"v")
    assert hub.get_blob("k") == b"v"
    hub.push_kv("w", b"kv")
    assert hub.kv_depth("w") == 1 and hub.pop_kv("w", 0.0) == b"kv"
    assert hub.query_depth("w") == 0
    hub.arm_reply_ttl("q1", 1.0)
    hub.discard_prediction_queue("q1")
    assert len(dropped) == int(inj.counters["hub_conn_drops"]) == 14


def test_corrupted_reply_skipped_in_unary_gather():
    hub = InProcQueueHub()
    pred = Predictor(hub, ["w0", "w1"], gather_timeout=5.0)

    def worker(wid, corrupt):
        raw = hub.pop_query(wid, 5.0)
        msg = unpack_message(raw)
        data = pack_message({"id": msg["id"], "worker_id": wid,
                             "predictions": [[1.0]]})
        if corrupt:
            data = b"\xc1" + data  # 0xc1: a byte msgpack never uses
        hub.push_prediction(msg["id"], data)

    ts = [threading.Thread(target=worker, args=("w0", True), daemon=True),
          threading.Thread(target=worker, args=("w1", False),
                           daemon=True)]
    for t in ts:
        t.start()
    preds, info = pred.predict([[0.0]], timeout=5.0)
    assert info["workers_answered"] == 1
    assert preds == [[1.0]]
    assert any("undecodable" in e for e in info["errors"])
    for t in ts:
        t.join(timeout=5)


# ------------------------------------------------ streaming failover

SILENCE_S = 8.0


def _boot(store, hub, wid, **kw):
    w = InferenceWorker(LlamaLoRA, "t0", KNOBS, store, hub, wid,
                        decode_loop=True, max_slots=4, max_new_tokens=6,
                        device="cpu", **kw)
    t = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.05},
                         daemon=True)
    t.start()
    return w, t


def _collect(events_iter):
    events = list(events_iter)
    acc = ""
    for ev in events[:-1]:
        assert set(ev) == {"delta"}, ev
        acc += "".join(ev["delta"].values())
    return events, acc


def test_stream_failover_token_exact_on_worker_kill(lm_blob):  # noqa: F811
    """The worker the router places the stream on is chaos-killed after
    3 generated tokens (``steps_per_sync=1``, so deltas stream out before
    the death): the stream fails over to the healthy worker, which
    re-ingests the delivered text as a forced prefix, and completes equal
    to a no-fault run. The killed loop returns without a final publish;
    its breaker is open and its injector counted one kill."""
    prompt = "tok1 tok2 tok3"
    hub = InProcQueueHub()
    ref, ref_t = _boot(_port_store(lm_blob), hub, "ref")
    try:
        events, acc = _collect(Predictor(
            hub, ["ref"], gather_timeout=120.0).predict_stream(
                [prompt], timeout=60.0))
        expected = events[-1]["predictions"]
        assert acc == expected[0]
    finally:
        ref.stop()
        ref_t.join(timeout=10)

    hub = InProcQueueHub()
    pred = Predictor(hub, ["w0", "w1"], gather_timeout=120.0,
                     stream_silence_timeout_s=SILENCE_S,
                     breaker_fail_threshold=1)
    victim = pred.router.owner(pred.router.affinity_key([prompt]))
    healthy = "w1" if victim == "w0" else "w0"
    store = _port_store(lm_blob)
    chaos = ChaosInjector(ChaosConfig(kill_after_tokens=3))
    wv, tv = _boot(store, hub, victim, steps_per_sync=1, chaos=chaos)
    wh, th = _boot(store, hub, healthy)
    assert isinstance(wv.hub, ChaosHub) and wh.hub is hub
    try:
        events, acc = _collect(pred.predict_stream([prompt], timeout=60.0))
        final = events[-1]
        assert final.get("done") and "error" not in final, final
        assert final["predictions"] == expected
        assert acc == expected[0], (acc, expected)
        assert final["info"]["failovers"] == 1
        assert wv.chaos_killed
        tv.join(timeout=10)
        assert not tv.is_alive()
        assert int(pred._c_failover.value) == 1
        assert pred.breakers.state(victim) == OPEN
        assert int(chaos.counters["kills"]) == 1
        assert "chaos_kills 1" in wv.metrics.render_prometheus()
    finally:
        wh.stop()
        th.join(timeout=10)


# ------------------------------- the control plane over the stubs

def test_rolling_restart_drains_and_replaces_workers(tmp_path):
    """``rolling_restart`` over two drainable ``dummy_service`` children:
    each is drained through its obs sidecar, exits 0 and is replaced one
    at a time; slots are conserved and the counter advances."""
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.constants import ServiceType
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec
    from rafiki_tpu_torch.store.meta_store import MetaStore

    meta = MetaStore(str(tmp_path / "meta.db"))
    user = meta.create_user("op@x", "pw", "ADMIN")
    tj = meta.create_train_job(user["id"], "app", 1, "LANGUAGE_MODELING",
                               {"TRIAL_COUNT": 1}, "d1", "d2")
    ij = meta.create_inference_job(user["id"], tj["id"])
    meta.update_inference_job(ij["id"], status="RUNNING")
    mgr = ServicesManager(meta, str(tmp_path / "wd"), slot_size=1,
                          platform="cpu",
                          devices=[DeviceSpec(id=0), DeviceSpec(id=1)])
    try:
        old = []
        for i in range(2):
            wid = f"dw-{i}"
            old.append(mgr._spawn(
                DUMMY, {"worker_id": wid, "drain_linger_s": 0.2,
                        "obs_port_file": str(tmp_path / "wd"
                                             / f"{wid}.obs_port")},
                ServiceType.INFERENCE_WORKER,
                slot=mgr.allocator.acquire(), inference_job_id=ij["id"]))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                (tmp_path / "wd" / f"dw-{i}.obs_port").exists()
                for i in range(2)):
            time.sleep(0.05)
        out = mgr.rolling_restart(ij["id"], drain_timeout=30.0)
        assert len(out["restarted"]) == 2
        assert all(r["drained"] for r in out["restarted"])
        live = [s for s in mgr.services.values()
                if s.service_type == ServiceType.INFERENCE_WORKER]
        assert len(live) == 2 and all(s.alive() for s in live)
        assert not ({s.service_id for s in old}
                    & {s.service_id for s in live})
        assert all(s.proc.returncode == 0 for s in old)
        assert mgr.respawn_stats()["rolling_restarts_done"] == 2
        assert mgr.allocator.free_count() == 0
        with pytest.raises(KeyError):
            mgr.rolling_restart("no-such-job")
    finally:
        mgr.stop_all()


def test_control_driver_kill9_and_reconcile(tmp_path):
    """A real control-plane process (``control_driver``, two dummy
    workers on the port's kvd) is killed with SIGKILL; a second driver
    in ``reconcile`` mode takes the expired lease over and adopts the
    same worker pids and the same kvd, and the workdir audit finds no
    drift."""
    from rafiki_tpu_torch.admin.doctor import audit_workdir

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))

    def start(mode, ready):
        cfg = {"workdir": str(tmp_path),
               "db_path": str(tmp_path / "meta.db"), "n_services": 2,
               "ready_file": str(tmp_path / ready), "mode": mode,
               "lease_ttl_s": 2.0}
        cfg_path = tmp_path / f"{ready}.cfg.json"
        cfg_path.write_text(json.dumps(cfg))
        return subprocess.Popen(
            [sys.executable, "-m", "rafiki_tpu_torch.chaos.control_driver",
             "--config", str(cfg_path)], env=env)

    def wait_ready(name, proc, timeout=90.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (tmp_path / name).exists():
                return json.loads((tmp_path / name).read_text())
            assert proc.poll() is None, "driver died"
            time.sleep(0.1)
        raise TimeoutError(name)

    p1 = start("boot", "r1.json")
    try:
        r1 = wait_ready("r1.json", p1)
    finally:
        os.kill(p1.pid, signal.SIGKILL)
        p1.wait()
    p2 = start("reconcile", "r2.json")
    try:
        r2 = wait_ready("r2.json", p2)
        assert r2["adopted_pids"] == r1["spawned_pids"]
        assert r2["kv_port"] == r1["kv_port"]
        assert r2["took_over"] and r2["lease_generation"] == 2
        assert r2["services_adopted"] == 2 and r2["kv_adopted"] == 1
        rep = audit_workdir(str(tmp_path))
        assert rep["ok"], rep["drift"]
    finally:
        p2.terminate()
        assert p2.wait(timeout=60) == 0
    for pid in r1["spawned_pids"]:  # the second driver stopped them
        assert not _pid_alive(pid)


def _pid_alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


# ------------------------- a JAX hub under the port's wrapper

def test_port_chaos_hub_over_the_jax_hub():
    """The port's wrapper is hub-agnostic: over a JAX in-process hub
    (the wire the two packages share) its seeded drops equal the JAX
    wrapper's over the same hub."""
    outs = []
    for mod in (jchaos, pchaos):
        inj = mod.ChaosInjector(mod.ChaosConfig(drop_reply_p=0.5,
                                                corrupt_payload_p=0.3,
                                                seed=11))
        hub = mod.ChaosHub(JHub(), inj)
        got = []
        for i in range(40):
            hub.push_prediction("q", b"payload-%d" % i)
            got.append(hub.pop_prediction("q", 0.0))
        outs.append((got, dict(inj.counters)))
    assert outs[0] == outs[1]
