"""Port parity: horizontal scale-out, the autoscaler and the scale-out
drill harness, against ``tests/test_scaleout.py`` case for case.

- The autoscale policy: seeded sequences of per-worker stats (stall
  counts, page ratios, missing workers, pool changes) go to JAX's and the
  port's ``AutoscalePolicy`` under one fake clock; the decisions and
  every ``status()`` must be equal, and ``AutoscaleConfig.from_budget``
  accepts and refuses the same budgets with the same message.
- The router, the breaker board and the Predictor's live membership, as
  the JAX file drives them, on the port's classes.
- The control plane over real processes: the port's ``ServicesManager``
  over the port's kvd grows a pool of ``rafiki_tpu_torch.chaos.
  dummy_service`` workers on stalls and drains it back on idle, scales it
  by hand, refuses to scale an ensemble, and the SDK speaks the routes;
  two slots over one card re-reserve both on reconcile, and a worker's
  admission plans against what the card has left.
- A toy model's pool through a two-slot CPU stack (the rehearsal of the
  card's phase 32 (a)): scaled to two, restarted and scaled back to one
  under closed-loop clients with no failed request and no 503.
- The acceptance drill on the port's capacity-model harness, split in
  two: the deterministic properties (every stream token-exact across an
  autoscale-up, a drain-based scale-down and a rolling restart; the
  affinity hit rate over 0.9) and the timing bounds (three workers at
  >= 2.5x one worker's streamed tokens/s at a p95 TTFT no worse), the JAX
  bounds unchanged.
- The SLO overload drill of ``tests/test_slo.py`` on the port's
  ``SloLoadHarness``.
"""

import random
import threading
import time
from pathlib import Path

import pytest
import torch

from rafiki_tpu.admin import autoscaler as jas
from rafiki_tpu_torch.admin import autoscaler as pas
from rafiki_tpu_torch.chaos.scaleout import (ScaleoutHarness,
                                             shared_prefix_prompts)
from rafiki_tpu_torch.serving.breaker import CLOSED, OPEN, BreakerBoard
from rafiki_tpu_torch.serving.predictor import Predictor
from rafiki_tpu_torch.serving.queues import (InProcQueueHub, pack_message,
                                             unpack_message)
from rafiki_tpu_torch.serving.router import Router

torch.set_num_threads(1)

DUMMY = "rafiki_tpu_torch.chaos.dummy_service"


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ---------------------------------------------------- autoscaler parity

def _stats(rng, wids, stalls, regime, missing_p):
    """One seeded round of per-worker stats: cumulative stall counters
    that grow (``stall``), hold with near-empty page pools (``idle``) or
    either (``mixed``); page gauges under both spellings; a missing
    worker now and then."""
    out = {}
    for w in wids:
        if rng.random() < missing_p:
            out[w] = None
            continue
        if regime == "stall" or (regime == "mixed" and rng.random() < 0.5):
            stalls[w] = stalls.get(w, 0) + rng.randrange(1, 5)
        total = rng.choice([16, 32, 64])
        used = (rng.randrange(0, total // 4) if regime == "idle"
                else rng.randrange(0, total + 1))
        if rng.random() < 0.5:
            out[w] = {"engine_admission_stalls": stalls.get(w, 0),
                      "engine_kv_pages_used": used,
                      "engine_kv_pages_total": total}
        else:
            out[w] = {"admission_stalls": stalls.get(w, 0),
                      "kv_pages_used": used, "kv_pages_total": total,
                      "role": "unified"}
    return out


@pytest.mark.parametrize("seed", range(6))
def test_policy_decisions_and_status_equal_jax(seed):
    """Seeded rounds through both policies under one fake clock: the
    same decision and the same ``status()`` after every observation,
    across stretches of stalls, idle and mixed signals, missing stats,
    pool changes (joins, leaves, a same-id rejoin), external actions and
    cooldowns."""
    rng = random.Random(seed)
    clk = _Clock()
    kw = dict(min_workers=1, max_workers=rng.choice([2, 3, 4]),
              cooldown_s=rng.choice([0.5, 5.0, 30.0]),
              grow_stall_ticks=rng.choice([1, 2, 3]),
              shrink_idle_ticks=rng.choice([2, 5]),
              shrink_pages_ratio=rng.choice([0.5, 0.9]))
    jp = jas.AutoscalePolicy(jas.AutoscaleConfig(**kw), now=clk)
    pp = pas.AutoscalePolicy(pas.AutoscaleConfig(**kw), now=clk)
    pool, nxt, stalls = ["w0"], 1, {}
    decisions = []
    regime = "stall"
    for i in range(600):
        if i % 12 == 0:
            regime = rng.choice(["stall", "idle", "mixed"])
        ev = rng.random()
        if ev < 0.03 and len(pool) < kw["max_workers"]:
            pool.append(f"w{nxt}")
            nxt += 1
        elif 0.03 <= ev < 0.06 and len(pool) > 1:
            gone = pool.pop(rng.randrange(len(pool)))
            if rng.random() < 0.5:
                pool.append(gone)  # a same-id rejoin (a respawn)
                stalls.pop(gone, None)
        elif 0.06 <= ev < 0.07:
            jp.note_action()
            pp.note_action()
        clk.t += rng.choice([0.5, 1.0, 3.0, 12.0])
        stats = _stats(rng, pool, stalls, regime,
                       missing_p=rng.choice([0.0, 0.0, 0.1]))
        got = pp.observe(stats)
        assert got == jp.observe(stats)
        assert pp.status() == jp.status()
        decisions.append(got)
    # the sequences exercise every decision
    assert {"up", "down", None} <= set(decisions)


def test_policy_grow_shrink_cooldown_equal_jax():
    """``tests/test_scaleout.py``'s policy script through both
    policies: the same decision at every step."""
    outs = []
    for mod in (jas, pas):
        clk = _Clock()
        p = mod.AutoscalePolicy(mod.AutoscaleConfig(
            min_workers=1, max_workers=3, cooldown_s=10.0,
            grow_stall_ticks=2, shrink_idle_ticks=3,
            shrink_pages_ratio=0.5), now=clk)

        def stats(stalls, used=1, total=32):
            return {"w0": {"engine_admission_stalls": stalls,
                           "engine_kv_pages_used": used,
                           "engine_kv_pages_total": total}}

        seq = [p.observe(stats(0)), p.observe(stats(2)),
               p.observe(stats(5))]
        clk.t += 1.0
        seq.append(p.observe(stats(9)))
        clk.t += 10.0
        seq += [p.observe(stats(9)) for _ in range(5)]
        two = {"w0": stats(9)["w0"],
               "w1": {"engine_admission_stalls": 0,
                      "engine_kv_pages_used": 1,
                      "engine_kv_pages_total": 32}}
        clk.t += 20.0
        seq += [p.observe(two) for _ in range(3)]
        clk.t += 20.0
        seq += [p.observe({"w0": two["w0"], "w1": None})
                for _ in range(6)]
        clk.t += 20.0
        hot = {"w0": {"engine_admission_stalls": 9,
                      "engine_kv_pages_used": 30,
                      "engine_kv_pages_total": 32}, "w1": two["w1"]}
        seq += [p.observe(hot) for _ in range(6)]
        outs.append((seq, p.status()))
    assert outs[0] == outs[1]
    seq = outs[1][0]
    assert seq[:4] == [None, None, "up", None]
    assert seq[9:12] == [None, None, "down"]
    assert set(seq[12:]) == {None}


BUDGETS = [
    ({}, 2), ({"AUTOSCALE": 0}, 1), ({"AUTOSCALE": False}, 3),
    ({"AUTOSCALE": 1, "MIN_WORKERS": 1, "MAX_WORKERS": 4,
      "AUTOSCALE_COOLDOWN_S": 5}, 2),
    ({"AUTOSCALE": True, "MAX_WORKERS": "3"}, 1),
    ({"AUTOSCALE": 1, "MAX_WORKERS": 2, "AUTOSCALE_COOLDOWN_S": 0.05}, 2),
    ({"MAX_WORKERS": 3}, 1), ({"MIN_WORKERS": 1}, 1),
    ({"AUTOSCALE_COOLDOWN_S": 2, "MIN_WORKERS": 1}, 1),
    ({"AUTOSCALE": 1}, 2),
    ({"AUTOSCALE": 1, "MIN_WORKERS": 2, "MAX_WORKERS": 3}, 1),
    ({"AUTOSCALE": 1, "MIN_WORKERS": 0}, 1),
    ({"AUTOSCALE": 1, "MIN_WORKERS": 3, "MAX_WORKERS": 2}, 2),
    ({"AUTOSCALE": 1, "MAX_WORKERS": 2, "AUTOSCALE_COOLDOWN_S": 0}, 1),
    ({"AUTOSCALE": 1, "MAX_WORKERS": 2, "AUTOSCALE_COOLDOWN_S": -1}, 1),
    ({"AUTOSCALE": 1, "MAX_WORKERS": 2}, 3),
    ({"AUTOSCALE": 1, "MAX_WORKERS": "x"}, 1),
]


@pytest.mark.parametrize("budget,initial", BUDGETS)
def test_from_budget_accepts_and_refuses_as_jax_does(budget, initial):
    def run(mod):
        try:
            cfg = mod.AutoscaleConfig.from_budget(budget, initial)
        except ValueError as e:
            return "refused", str(e)
        return "ok", None if cfg is None else (
            cfg.min_workers, cfg.max_workers, cfg.cooldown_s,
            cfg.grow_stall_ticks, cfg.shrink_idle_ticks,
            cfg.shrink_pages_ratio)

    assert run(pas) == run(jas)


def test_autoscale_config_from_budget_validation():
    cfg = pas.AutoscaleConfig.from_budget(
        {"AUTOSCALE": 1, "MIN_WORKERS": 1, "MAX_WORKERS": 4,
         "AUTOSCALE_COOLDOWN_S": 5}, 2)
    assert (cfg.min_workers, cfg.max_workers, cfg.cooldown_s) == (1, 4,
                                                                  5.0)
    assert pas.AutoscaleConfig.from_budget({}, 2) is None
    for budget, initial in (({"MAX_WORKERS": 3}, 1), ({"AUTOSCALE": 1}, 2),
                            ({"AUTOSCALE": 1, "MIN_WORKERS": 2,
                              "MAX_WORKERS": 3}, 1),
                            ({"AUTOSCALE": 1, "MIN_WORKERS": 0}, 1),
                            ({"AUTOSCALE": 1, "MAX_WORKERS": 2,
                              "AUTOSCALE_COOLDOWN_S": 0}, 1)):
        with pytest.raises(ValueError):
            pas.AutoscaleConfig.from_budget(budget, initial)


# ------------------------------------------------------------- router

def _router(wids, **kw):
    board = BreakerBoard(wids, fail_threshold=1, cooldown_s=60.0)
    return Router(wids, board, **kw), board


def test_hrw_owner_is_stable_and_remaps_minimally():
    r, _ = _router(["w0", "w1", "w2"])
    keys = [f"prefix-{i}" for i in range(300)]
    before = {k: r.owner(k) for k in keys}
    for w in ("w0", "w1", "w2"):
        assert sum(1 for v in before.values() if v == w) > 30
    r.remove_worker("w1")
    for k in keys:
        if before[k] != "w1":
            assert r.owner(k) == before[k], k
    r.add_worker("w1")
    assert {k: r.owner(k) for k in keys} == before
    r.add_worker("w3")
    for k in keys:
        assert r.owner(k) in (before[k], "w3"), k


def test_select_affinity_hit_and_exclude_successor():
    r, _ = _router(["w0", "w1", "w2"])
    key = "shared-system-prefix"
    owner = r.owner(key)
    assert r.select(key) == owner
    assert int(r.counters["router_affinity_hits"]) == 1
    assert {r.select(key) for _ in range(10)} == {owner}
    successor = r.owner(key, exclude=(owner,))
    assert r.select(key, exclude=(owner,)) == successor != owner


def test_select_load_redirect_on_saturation_and_least_loaded():
    r, _ = _router(["w0", "w1", "w2"])
    key = "shared-prefix"
    owner = r.owner(key)
    w_busy, w_idle = [w for w in ("w0", "w1", "w2") if w != owner]
    r.observe(owner, {"engine_kv_pages_used": 97,
                      "engine_kv_pages_total": 100})
    assert r.saturated(owner)
    r.observe_queue_depth(w_busy, 5)
    r.observe(w_busy, {"engine_kv_pages_used": 50,
                       "engine_kv_pages_total": 100})
    assert r.select(key) == w_idle
    assert int(r.counters["router_affinity_redirects"]) == 1
    assert int(r.counters["router_least_loaded_picks"]) == 1
    assert 0.0 <= r.affinity_hit_rate() < 1.0
    clk = [100.0]
    r2, _ = _router(["a", "b"])
    r2._now = lambda: clk[0]
    r2.observe("a", {"engine_admission_stalls": 3})
    assert not r2.saturated("a")
    r2.observe("a", {"engine_admission_stalls": 5})
    assert r2.saturated("a")
    clk[0] += Router.STALL_HOLD_S + 0.1
    assert not r2.saturated("a")


def test_select_gates_on_breakers_and_probes_one():
    r, board = _router(["w0", "w1"])
    board.record_failure("w0")
    assert board.state("w0") == OPEN
    for _ in range(8):
        assert r.select("any-key") == "w1"
    board.set_draining("w1", True)
    assert r.select("any-key") is None
    assert int(r.counters["router_no_candidate"]) >= 1
    board.set_draining("w1", False)
    assert r.select("any-key") == "w1"
    clk = _Clock()
    board2 = BreakerBoard(["a", "b"], fail_threshold=1, cooldown_s=1.0,
                          now=clk)
    r2 = Router(["a", "b"], board2)
    board2.record_failure("a")
    board2.record_failure("b")
    assert r2.select("k") is None
    clk.t += 1.01
    probe = r2.select("k")
    assert probe in ("a", "b")
    assert int(r2.counters["router_probe_picks"]) == 1
    second = r2.select("k")
    assert second in ("a", "b") and second != probe


def test_router_chaos_membership_and_breaker_flaps_seeded():
    """The JAX file's seeded churn on the port's router, beside the JAX
    router fed the same events: the same owner map after every event,
    and the port never hands out an excluded, departed, draining or
    open-without-a-due-probe worker."""
    from rafiki_tpu.serving.breaker import BreakerBoard as JBoard
    from rafiki_tpu.serving.router import Router as JRouter

    rng = random.Random(7)
    clk = _Clock()
    board = BreakerBoard([], fail_threshold=1, cooldown_s=5.0, now=clk)
    r = Router([], board, now=clk)
    jboard = JBoard([], fail_threshold=1, cooldown_s=5.0, now=clk)
    jr = JRouter([], jboard, now=clk)
    keys = [f"k{i}" for i in range(60)]
    pool, next_id = [], 0
    for _ in range(300):
        ev = rng.choice(["join", "leave", "trip", "recover", "drain",
                         "undrain", "tick"])
        if ev == "join" or not pool:
            wid = f"w{next_id}"
            next_id += 1
            for b, rr in ((board, r), (jboard, jr)):
                b.add_worker(wid)
                rr.add_worker(wid)
            pool.append(wid)
        elif ev == "leave" and len(pool) > 1:
            wid = rng.choice(pool)
            owned = {k for k in keys if r.owner(k) == wid}
            before = {k: r.owner(k) for k in keys}
            for b, rr in ((board, r), (jboard, jr)):
                b.remove_worker(wid)
                rr.remove_worker(wid)
            pool.remove(wid)
            for k in keys:
                if k not in owned:
                    assert r.owner(k) == before[k]
            board.record_failure(wid)
            board.record_success(wid)
            assert wid not in board.snapshot()
        elif ev in ("trip", "recover", "drain", "undrain"):
            wid = rng.choice(pool)
            for b in (board, jboard):
                if ev == "trip":
                    b.record_failure(wid)
                elif ev == "recover":
                    b.record_success(wid)
                else:
                    b.set_draining(wid, ev == "drain")
        else:
            clk.t += rng.random() * 3.0
        assert {k: r.owner(k) for k in keys} == \
            {k: jr.owner(k) for k in keys}
        for k in rng.sample(keys, 10):
            exclude = set(rng.sample(pool, min(len(pool) - 1,
                                               rng.randrange(2))))
            snap = board.snapshot()
            pick = r.select(k, exclude=exclude)
            if pick is None:
                continue
            assert pick in pool and pick not in exclude
            st = snap.get(pick)
            assert st is not None and not st["draining"]
            assert st["state"] == CLOSED or \
                board.state(pick) == "half_open"


def test_breaker_board_membership():
    b = BreakerBoard(["w0"], fail_threshold=1)
    b.add_worker("w1")
    assert b.targets() == ["w0", "w1"]
    b.remove_worker("w0")
    assert b.targets() == ["w1"]
    assert b.state("w0") == CLOSED
    assert not b.allow("w0")
    b.record_failure("w0")
    b.set_draining("w0", True)
    b.record_stale("w0")
    assert "w0" not in b.snapshot()
    assert b.retry_after_s() == 0.0
    b.add_worker("w0")
    assert b.state("w0") == CLOSED and b.allow("w0")


# --------------------------------------- predictor live membership

def _unary_worker(hub, wid, stop):
    def loop():
        while not stop.is_set():
            raw = hub.pop_query(wid, 0.1)
            if raw is None:
                continue
            m = unpack_message(raw)
            if "id" not in m:
                continue
            hub.push_prediction(m["id"], pack_message(
                {"id": m["id"], "worker_id": wid,
                 "predictions": [[1.0]] * len(m["queries"])}))

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return th


def test_predictor_add_remove_worker_unary():
    hub = InProcQueueHub()
    stop = threading.Event()
    ths = [_unary_worker(hub, w, stop) for w in ("w0", "w1")]
    pred = Predictor(hub, ["w0"], gather_timeout=10.0)
    try:
        _, info = pred.predict([[0.0]], timeout=10.0)
        assert info["workers_asked"] == 1
        pred.add_worker("w1")
        _, info = pred.predict([[0.0]], timeout=10.0)
        assert info["workers_asked"] == 2 and \
            info["workers_answered"] == 2
        pred.remove_worker("w0")
        preds, info = pred.predict([[0.0]], timeout=10.0)
        assert info["workers_asked"] == 1 and preds == [[1.0]]
        assert sorted(pred.breakers.snapshot()) == ["w1"]
        assert pred.router.members() == ["w1"]
        assert "w0" not in pred._worker_seen
    finally:
        stop.set()
        for th in ths:
            th.join(timeout=5)


def test_predictor_membership_follows_hub_publish():
    hub = InProcQueueHub()
    pred = Predictor(hub, ["w0"], gather_timeout=5.0, pool_id="job1")
    hub.put_pool_members("job1", {"workers": ["w0", "w1"],
                                  "version": 100.0})
    pred._refresh_membership(force=True)
    assert pred.router.members() == ["w0", "w1"]
    hub.put_pool_members("job1", {"workers": ["w0"], "version": 50.0})
    pred._refresh_membership(force=True)
    assert pred.router.members() == ["w0", "w1"]
    hub.put_pool_members("job1", {"workers": [], "version": 200.0})
    pred._refresh_membership(force=True)
    assert pred.router.members() == ["w0", "w1"]
    hub.put_pool_members("job1", {"workers": ["w1", "w2"],
                                  "version": 300.0})
    pred._refresh_membership(force=True)
    assert pred.router.members() == ["w1", "w2"]
    assert sorted(pred.breakers.snapshot()) == ["w1", "w2"]


def test_remove_worker_with_inflight_stream_fails_over():
    """Removing a worker that holds an in-flight stream fails the stream
    over token-exact through the forced prefix (the port harness's real
    workers and Predictor)."""
    h = ScaleoutHarness(2, max_slots=4, max_new=40,
                        base_step_s=0.005, per_req_step_s=0.005,
                        stream_silence_timeout_s=10.0)
    try:
        prompt = shared_prefix_prompts(1, 1)[0]
        victim = h.pred.router.owner(h.pred.router.affinity_key([prompt]))
        out = {}
        th = threading.Thread(
            target=lambda: out.update(h.run_stream(prompt, timeout=60.0)),
            daemon=True)
        th.start()
        deadline = time.monotonic() + 10
        w, _ = h.workers[victim]
        while time.monotonic() < deadline and not int(
                w.engine.stats.get("tokens_generated", 0) or 0):
            time.sleep(0.01)
        assert int(w.engine.stats.get("tokens_generated", 0) or 0)
        h.pred.remove_worker(victim)
        th.join(timeout=60)
        assert not th.is_alive()
        assert out["ok"], out
        assert out["failovers"] >= 1
        assert victim not in h.pred.router.members()
    finally:
        h.stop()


def test_a_stream_on_a_dead_unpublished_worker_fails_over_unprompted():
    """A stream whose worker dies and is then dropped from the published
    membership fails over on its own loop's membership read (reason
    ``worker removed``), token-exact, with no other request to refresh
    the Predictor's membership and long before its 10 s silence window
    would (reason ``reply silence``)."""
    h = ScaleoutHarness(2, max_slots=4, max_new=40,
                        base_step_s=0.02, per_req_step_s=0.005,
                        stream_silence_timeout_s=10.0)
    try:
        prompt = shared_prefix_prompts(1, 1)[0]
        victim = h.pred.router.owner(h.pred.router.affinity_key([prompt]))
        out = {}
        th = threading.Thread(
            target=lambda: out.update(h.run_stream(prompt, timeout=60.0)),
            daemon=True)
        th.start()
        deadline = time.monotonic() + 10
        w, wth = h.workers.pop(victim)
        while time.monotonic() < deadline and not int(
                w.engine.stats.get("tokens_generated", 0) or 0):
            time.sleep(0.005)
        w.stop()  # the worker dies mid-stream: no more events
        wth.join(timeout=10)
        h.publish()  # the control plane drops it from the pool
        th.join(timeout=60)
        assert not th.is_alive()
        assert out["ok"], out
        assert out["failovers"] >= 1
        lost = [sp for rec in h.pred.traces.recent(8)
                for sp in rec["spans"] if sp["name"] == "worker_lost"]
        assert [sp["reason"] for sp in lost] == ["worker removed"]
    finally:
        h.stop()


# ------------------------------- the control plane over real processes

def _manager(tmp_path, budget, n_slots=3, same_card=False):
    """A MetaStore, a CPU ServicesManager over ``n_slots`` slots (all
    naming device 0 with ``same_card``) with its kvd, and a RUNNING
    inference job of ``budget``."""
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec
    from rafiki_tpu_torch.store.meta_store import MetaStore

    meta = MetaStore(str(tmp_path / "meta.db"))
    user = meta.create_user("op@x", "pw", "ADMIN")
    tj = meta.create_train_job(user["id"], "app", 1, "LANGUAGE_MODELING",
                               {"TRIAL_COUNT": 1}, "d1", "d2")
    ij = meta.create_inference_job(user["id"], tj["id"], budget=budget)
    meta.update_inference_job(ij["id"], status="RUNNING")
    devices = [DeviceSpec(id=0 if same_card else i) for i in range(n_slots)]
    mgr = ServicesManager(meta, str(tmp_path / "wd"), slot_size=1,
                          platform="cpu", devices=devices)
    return meta, mgr, ij["id"]


def _spawn_dummy(mgr, tmp_path, job_id, wid):
    from rafiki_tpu_torch.constants import ServiceType

    port_file = tmp_path / "wd" / f"{wid}.obs_port"
    svc = mgr._spawn(DUMMY, {"worker_id": wid, "drain_linger_s": 0.1,
                             "obs_port_file": str(port_file)},
                     ServiceType.INFERENCE_WORKER,
                     slot=mgr.allocator.acquire(),
                     inference_job_id=job_id)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not port_file.exists():
        time.sleep(0.05)
    assert port_file.exists(), "the dummy worker never reported its port"
    return svc


@pytest.fixture()
def inference_job_manager(tmp_path):
    meta, mgr, job_id = _manager(
        tmp_path, {"AUTOSCALE": 1, "MIN_WORKERS": 1, "MAX_WORKERS": 3,
                   "AUTOSCALE_COOLDOWN_S": 0.05})
    mgr.start_data_plane()
    wid = f"iw-{job_id[:8]}-0"
    _spawn_dummy(mgr, tmp_path, job_id, wid)
    try:
        yield mgr, job_id, wid
    finally:
        mgr.stop_all()


def _publish_worker_stats(mgr, wid, stalls, used=1, total=32):
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    KVQueueHub(mgr.kv_host, mgr.kv_port).put_worker_stats(
        wid, {"engine_admission_stalls": stalls,
              "engine_kv_pages_used": used,
              "engine_kv_pages_total": total, "uptime_s": 1.0})


def test_autoscaler_grows_and_shrinks_over_processes(
        inference_job_manager):
    """Sustained stalls spawn a real extra worker process from the job's
    template, which joins the published pool only once its obs port
    reports; idle signals drain it back out, membership first; slots are
    conserved."""
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    mgr, job_id, w0 = inference_job_manager
    hub = KVQueueHub(mgr.kv_host, mgr.kv_port)
    st = mgr._ensure_scaleout(job_id)  # the rebuild path (adoption)
    assert st is not None and st["policy"] is not None
    assert st["pool"] == [w0]
    mgr._publish_pool(job_id)
    assert hub.get_pool_members(job_id)["workers"] == [w0]

    _publish_worker_stats(mgr, w0, stalls=0)
    assert mgr.autoscale_tick(force=True) == []
    _publish_worker_stats(mgr, w0, stalls=4)
    mgr.autoscale_tick(force=True)
    _publish_worker_stats(mgr, w0, stalls=9)
    actions = mgr.autoscale_tick(force=True)
    assert [a["action"] for a in actions] == ["up"], actions
    new_wid = actions[0]["worker"]
    assert new_wid != w0
    assert int(mgr.scaling["autoscale_ups"]) == 1
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        mgr.autoscale_tick(force=True)
        if hub.get_pool_members(job_id)["workers"] == [w0, new_wid]:
            break
        time.sleep(0.05)
    assert hub.get_pool_members(job_id)["workers"] == [w0, new_wid]
    assert mgr.scaleout_status(job_id)["pool"] == [w0, new_wid]

    for _ in range(8):
        _publish_worker_stats(mgr, w0, stalls=9, used=2)
        _publish_worker_stats(mgr, new_wid, stalls=0, used=1)
        actions = mgr.autoscale_tick(force=True)
        if actions:
            break
        time.sleep(0.02)
    assert [a["action"] for a in actions] == ["down"], actions
    assert actions[0]["worker"] == new_wid
    assert hub.get_pool_members(job_id)["workers"] == [w0]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        mgr.poll()
        mgr.autoscale_tick(force=True)
        if mgr.scaleout_status(job_id)["victim"] is None:
            break
        time.sleep(0.05)
    assert mgr.scaleout_status(job_id)["victim"] is None
    assert mgr.scaleout_status(job_id)["pool"] == [w0]
    assert int(mgr.scaling["autoscale_downs"]) == 1
    assert mgr.allocator.free_count() == 2


def test_manual_scale_inference_job(inference_job_manager):
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    mgr, job_id, w0 = inference_job_manager
    hub = KVQueueHub(mgr.kv_host, mgr.kv_port)
    out = mgr.scale_inference_job(job_id, 3, drain_timeout=30.0)
    assert len(out["scaled_up"]) == 2 and out["scaled_down"] == []
    assert len(out["pool"]) == 3
    assert hub.get_pool_members(job_id)["workers"] == out["pool"]
    assert mgr.allocator.free_count() == 0
    out = mgr.scale_inference_job(job_id, 1, drain_timeout=30.0)
    assert len(out["scaled_down"]) == 2
    assert out["pool"] == [w0]
    assert hub.get_pool_members(job_id)["workers"] == [w0]
    assert mgr.allocator.free_count() == 2
    with pytest.raises(ValueError):
        mgr.scale_inference_job(job_id, 0)
    with pytest.raises(KeyError):
        mgr.scale_inference_job("no-such-job", 2)


def test_rolling_restart_takes_each_worker_out_of_the_pool_first(
        inference_job_manager):
    """A rolling restart of a two-worker pool drains each worker only
    after the published membership has dropped it (its sibling takes the
    traffic), and its replacement rejoins at its place before the next
    worker leaves; a one-worker pool keeps its only member published."""
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    mgr, job_id, w0 = inference_job_manager
    hub = KVQueueHub(mgr.kv_host, mgr.kv_port)
    seen = []
    drain = mgr._request_drain

    def spy(cfg):
        seen.append((cfg["worker_id"],
                     hub.get_pool_members(job_id)["workers"]))
        return drain(cfg)

    mgr._request_drain = spy
    mgr._ensure_scaleout(job_id)
    mgr._publish_pool(job_id)
    mgr.rolling_restart(job_id, drain_timeout=30.0)
    assert seen == [(w0, [w0])]
    w1 = mgr.scale_inference_job(job_id, 2,
                                 drain_timeout=30.0)["scaled_up"][0]
    seen.clear()
    out = mgr.rolling_restart(job_id, drain_timeout=30.0)
    assert [r["drained"] for r in out["restarted"]] == [True, True]
    assert seen == [(w0, [w1]), (w1, [w0])]
    assert hub.get_pool_members(job_id)["workers"] == [w0, w1]
    assert mgr.scaleout_status(job_id)["pool"] == [w0, w1]
    assert mgr.allocator.free_count() == 1


def test_a_crashed_pool_member_leaves_the_pool_until_it_boots(
        inference_job_manager):
    """A pool member killed with SIGKILL leaves the published membership
    at the monitor's next poll, while its sibling stays (the predictor
    fails its streams over and routes nothing new there); its respawn
    rejoins once it has written its obs port, as a scale-up does."""
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    mgr, job_id, w0 = inference_job_manager
    hub = KVQueueHub(mgr.kv_host, mgr.kv_port)
    w1 = mgr.scale_inference_job(job_id, 2,
                                 drain_timeout=30.0)["scaled_up"][0]
    victim = mgr.services[mgr._worker_sid(job_id, w1)]
    victim.proc.kill()
    victim.proc.wait(timeout=30)
    mgr.poll()
    assert hub.get_pool_members(job_id)["workers"] == [w0]
    status = mgr.scaleout_status(job_id)
    assert status["pool"] == [w0] and status["warming"] == [w1]
    assert mgr.respawn_stats()["respawns_done"] == 1
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            hub.get_pool_members(job_id)["workers"] != [w0, w1]:
        mgr.autoscale_tick(force=True)
        time.sleep(0.05)
    assert hub.get_pool_members(job_id)["workers"] == [w0, w1]
    assert mgr.scaleout_status(job_id)["warming"] == []
    # the last member is never unpublished: a one-worker pool's crash
    # leaves the membership as it was
    mgr.scale_inference_job(job_id, 1, drain_timeout=30.0)
    w0_svc = mgr.services[mgr._worker_sid(job_id, w0)]
    w0_svc.proc.kill()
    w0_svc.proc.wait(timeout=30)
    mgr.poll()
    assert hub.get_pool_members(job_id)["workers"] == [w0]
    assert mgr.scaleout_status(job_id)["pool"] == [w0]


def test_ensemble_pool_refuses_scaling(tmp_path):
    from rafiki_tpu_torch.constants import ServiceType

    _meta, mgr, job_id = _manager(
        tmp_path, {"AUTOSCALE": 1, "MAX_WORKERS": 4}, n_slots=2)
    try:
        for i, trial in enumerate(("trial-A", "trial-B")):
            mgr._respawn_specs[f"sid{i}"] = {
                "module": DUMMY,
                "config": {"worker_id": f"iw-{job_id[:8]}-{i}",
                           "trial_id": trial},
                "service_type": ServiceType.INFERENCE_WORKER,
                "needs_slot": True,
                "meta_kwargs": {"inference_job_id": job_id}}
        st = mgr._ensure_scaleout(job_id)
        assert st is not None and st["policy"] is None  # disabled
        with pytest.raises(RuntimeError, match="DISTINCT trials"):
            mgr.scale_inference_job(job_id, 3)
    finally:
        mgr.stop_all()


def test_sdk_scale_and_autoscaler_endpoints():
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.utils.http import JsonHttpService

    calls = []

    def scale(m, body, _h):
        calls.append(("scale", m["id"], body))
        return 200, {"job_id": m["id"], "pool": ["a", "b"],
                     "scaled_up": ["b"], "scaled_down": []}

    def autoscaler(m, _b, _h):
        calls.append(("get", m["id"], None))
        return 200, {"enabled": True, "pool": ["a", "b"],
                     "min_workers": 1, "max_workers": 4}

    http = JsonHttpService()
    http.route("POST", "/inference_jobs/<id>/scale", scale)
    http.route("GET", "/inference_jobs/<id>/autoscaler", autoscaler)
    host, port = http.start()
    try:
        client = Client(admin_url=f"http://{host}:{port}", timeout=10.0)
        out = client.scale_inference_job("j1", 2, drain_timeout=5.0)
        assert out["pool"] == ["a", "b"]
        assert calls[0] == ("scale", "j1",
                            {"workers": 2, "drain_timeout": 5.0})
        out = client.get_inference_job_autoscaler("j1")
        assert out["enabled"] and out["max_workers"] == 4
    finally:
        http.stop()


def test_two_slots_on_one_card_scale_and_readopt(tmp_path):
    """Two slots over one card (``devices=[spec] * 2``, as the card's
    two-worker pool runs): both workers get that card's
    ``CUDA_VISIBLE_DEVICES``, a manual scale fills the second slot, and
    a restarted admin's reconcile adopts both workers, re-reserving both
    slots, and keeps scaling the pool from the adopted specs."""
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec, slot_env_vars

    meta, mgr, job_id = _manager(
        tmp_path, {"AUTOSCALE": 1, "MAX_WORKERS": 2}, n_slots=2,
        same_card=True)
    mgr2 = None
    try:
        assert [slot_env_vars("cuda", s) for s in mgr.allocator._slots] \
            == [{"CUDA_VISIBLE_DEVICES": "0"}] * 2
        mgr.acquire_lease(ttl_s=1.0)
        mgr.start_data_plane()
        w0 = f"iw-{job_id[:8]}-0"
        _spawn_dummy(mgr, tmp_path, job_id, w0)
        mgr._ensure_scaleout(job_id)
        out = mgr.scale_inference_job(job_id, 2, drain_timeout=30.0)
        assert out["pool"] == [w0, f"iw-{job_id[:8]}-1"]
        assert mgr.allocator.free_count() == 0
        rows = [r for r in meta.get_services()
                if r["service_type"] == "INFERENCE_WORKER"]
        assert sorted(r["devices"] for r in rows) == ["[0]", "[0]"]
        # the admin dies without stopping its children
        mgr.release_lease()
        mgr2 = ServicesManager(meta, str(tmp_path / "wd"), slot_size=1,
                               platform="cpu",
                               devices=[DeviceSpec(id=0)] * 2)
        mgr2.acquire_lease(ttl_s=1.0)
        rec = mgr2.reconcile()
        assert rec["services_adopted"] == 2  # both workers
        assert rec["kv_adopted"] == 1 and rec["services_crashed"] == 0
        assert mgr2.allocator.free_count() == 0
        assert mgr2.scaleout_status(job_id)["pool"] == []  # not yet built
        out = mgr2.scale_inference_job(job_id, 1, drain_timeout=30.0)
        assert out["pool"] == [w0]
        assert mgr2.allocator.free_count() == 1
        assert mgr2.scaleout_status(job_id)["enabled"]
    finally:
        if mgr2 is not None:
            mgr2.stop_all()
        mgr.fenced = True  # its children belong to mgr2 now
        mgr.stop_all()


def test_slots_sharing_a_card_plan_against_their_share(monkeypatch):
    """Two slots on one card: each worker's env carries its share of the
    card's memory as ``RAFIKI_DEVICE_HBM_BYTES``, which its admission
    limit reads (not the card's whole memory, which each of two workers
    would plan against); a card of its own keeps the card's total, and a
    CPU stack's virtual slots carry no limit."""
    from rafiki_tpu_torch.parallel.mesh import (DeviceSpec,
                                                SubMeshAllocator,
                                                slot_env_vars)
    from rafiki_tpu_torch.worker.admission import resolve_device_limit

    card = DeviceSpec(id=0, memory_bytes=80 * 2**30, platform="cuda")
    other = DeviceSpec(id=1, memory_bytes=80 * 2**30, platform="cuda")
    shared = SubMeshAllocator([card] * 2, 1)
    envs = [slot_env_vars("cuda", s) for s in shared._slots]
    assert envs == [{"CUDA_VISIBLE_DEVICES": "0",
                     "RAFIKI_DEVICE_HBM_BYTES": str(40 * 2**30)}] * 2
    mixed = SubMeshAllocator([card, card, card, other], 1)
    assert [slot_env_vars("cuda", s).get("RAFIKI_DEVICE_HBM_BYTES")
            for s in mixed._slots] == [str(80 * 2**30 // 3)] * 3 + [None]
    assert [slot_env_vars("cpu", s) for s in shared._slots] \
        == [{"CUDA_VISIBLE_DEVICES": ""}] * 2
    # an unknown card size gives no share: the worker reads the card
    assert slot_env_vars("cuda", SubMeshAllocator(
        [DeviceSpec(id=0)] * 2, 1)._slots[0]) == {"CUDA_VISIBLE_DEVICES": "0"}

    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (30 * 2**30, 80 * 2**30))
    monkeypatch.delenv("RAFIKI_DEVICE_HBM_BYTES", raising=False)
    assert resolve_device_limit(torch.device("cuda")) == 80 * 2**30
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES",
                       envs[0]["RAFIKI_DEVICE_HBM_BYTES"])
    assert resolve_device_limit(torch.device("cuda")) == 40 * 2**30


# ----------------------------------------------- the acceptance drill

DRILL_KW = dict(max_slots=8, max_new=20, base_step_s=0.001,
                per_req_step_s=0.002, stream_silence_timeout_s=10.0)


def test_scaleout_drill_zero_token_loss_and_affinity():
    """The drill's deterministic half: every stream token-exact against
    its expected completion across an autoscale-up, a drain-based
    scale-down and a rolling restart performed mid-load, and a prefix
    affinity hit rate over 0.9 under shared-prefix traffic. (The stream
    silence window is 10 s: a healthy worker on a loaded host never goes
    that long without a token.)"""
    h3 = ScaleoutHarness(3, **DRILL_KW)
    try:
        prompts = shared_prefix_prompts(6, 3)
        res = h3.run_load(prompts, n_clients=18, streams_per_client=2,
                          timeout=120.0)
        snap = h3.pred.router.snapshot()
    finally:
        h3.stop()
    assert res["ok"], res["failures"][:2]
    assert snap["affinity_hit_rate"] > 0.9, snap

    hc = ScaleoutHarness(2, **DRILL_KW)
    try:
        prompts = shared_prefix_prompts(4, 3)
        events = []

        def cycle():
            wid = hc.add_worker()
            events.append(("up", wid))
            time.sleep(0.3)
            victim = [w for w in hc.workers if w != wid][0]
            hc.drain_worker(victim)
            events.append(("down", victim))
            time.sleep(0.2)
            hc.rolling_restart()
            events.append(("rolling_restart", tuple(hc.workers)))

        cyc = hc.run_load(prompts, n_clients=8, streams_per_client=6,
                          timeout=120.0, on_half_done=cycle)
        assert len(events) == 3, events
        assert cyc["ok"], cyc["failures"][:2]
        assert cyc["streams"] == 48
    finally:
        hc.stop()


#: the timing half's stub engines step 4x slower than the drill's, so
#: the simulated device time, not the harness's own Python (workers,
#: Predictor and 18 clients as threads of one process, on a host shared
#: with the rest of the suite), bounds the tokens/s the ratio compares
TIMING_KW = dict(DRILL_KW, base_step_s=0.004, per_req_step_s=0.008)


def test_scaleout_drill_throughput_and_ttft_bounds():
    """The drill's timing half, with the JAX bounds: three workers
    sustain >= 2.5x one worker's streamed tokens/s at a p95 TTFT no
    worse, prefix families spread two per worker by the real HRW map."""
    h1 = ScaleoutHarness(1, **TIMING_KW)
    try:
        single = h1.run_load(shared_prefix_prompts(6, 3), n_clients=18,
                             streams_per_client=2, timeout=120.0)
    finally:
        h1.stop()
    assert single["ok"], single["failures"][:2]
    h3 = ScaleoutHarness(3, **TIMING_KW)
    try:
        groups = {w: [] for w in h3.workers}
        g = 0
        while any(len(v) < 2 for v in groups.values()) and g < 500:
            fam = f"fam{g:03d}-" * 12
            owner = h3.pred.router.owner(fam[:64])
            if len(groups[owner]) < 2:
                groups[owner].append(fam)
            g += 1
        assert all(len(v) == 2 for v in groups.values())
        prompts3 = [f"{p} user question {j}" for fam in groups.values()
                    for p in fam for j in range(3)]
        scaled = h3.run_load(prompts3, n_clients=18, streams_per_client=2,
                             timeout=120.0)
    finally:
        h3.stop()
    assert scaled["ok"], scaled["failures"][:2]
    ratio = scaled["tokens_per_s"] / max(single["tokens_per_s"], 1e-9)
    assert ratio >= 2.5, (ratio, single["tokens_per_s"],
                          scaled["tokens_per_s"])
    assert scaled["ttft_p95_s"] <= single["ttft_p95_s"], (
        scaled["ttft_p95_s"], single["ttft_p95_s"])


# ------------------------------------------------ the SLO overload drill

def test_slo_overload_acceptance_drill():
    """``tests/test_slo.py``'s drill on the port's ``SloLoadHarness``:
    under deterministic mixed traffic on one replica, interactive TTFT
    p95 holds within 1.5x its unloaded value (or the step quantum),
    preempted streams resume token-exact, background is shed with a
    structured ``retry_after_s`` once its cap is hit, and best-effort
    work still completes."""
    from rafiki_tpu_torch.chaos.sloload import SloLoadHarness

    KW = dict(max_slots=4, max_new=12, base_step_s=0.002,
              per_req_step_s=0.005, stream_silence_timeout_s=10.0,
              pool_id="slodrill")
    IA = {"clients": 8, "streams": 3, "max_new": 4, "think_s": 0.15}
    step_s = KW["base_step_s"] + KW["per_req_step_s"] * KW["max_slots"]
    h = SloLoadHarness(1, shed_depths={"background": 2, "batch": 64},
                       **KW)
    try:
        base = h.run_mixed({"interactive": dict(IA)}, timeout=60.0)
        base.pop("_wall_s")
        p95_unloaded = base["interactive"]["ttft_p95_s"]
        assert base["interactive"]["ok"]
        mixed = h.run_mixed({
            "interactive": dict(IA),
            "batch": {"clients": 2, "streams": 2, "max_new": 12},
            "background": {"clients": 8, "streams": 3, "max_new": 12,
                           "think_s": 0.05}},
            timeout=120.0)
        mixed.pop("_wall_s")
        stats = list(h.engine_stats().values())[0]
        pub = h.hub.get_worker_stats(next(iter(h.workers)))
        assert pub["slo_interactive_ttft_p95_s"] > 0
        assert "slo_background_e2e_p95_s" in pub
    finally:
        h.stop()
    ia, bg = mixed["interactive"], mixed["background"]
    assert ia["ok"] and mixed["batch"]["ok"] and bg["ok"], (
        ia["failures"], mixed["batch"]["failures"], bg["failures"])
    assert ia["shed"] == 0
    bound = max(1.5 * p95_unloaded, p95_unloaded + 2 * step_s, 0.02)
    assert ia["ttft_p95_s"] <= bound, (
        f"interactive p95 {ia['ttft_p95_s']:.4f}s vs unloaded "
        f"{p95_unloaded:.4f}s (bound {bound:.4f}s)")
    assert stats["preemptions"] >= 1
    assert bg["served"] >= 1, "background fully starved"
    assert mixed["batch"]["served"] >= 1
    assert bg["shed"] >= 1
    assert bg["shed_with_retry_hint"] == bg["shed"]


# ------------------------- a two-worker pool through the port's stack

def test_a_toy_pool_scales_and_restarts_through_the_stack(tmp_path):
    """The CPU rehearsal of the card's two-slot pool: a CPU stack over
    two slots of one device, a toy model's trial (its parameters put in
    the stack's param store under a trial row) deployed with one
    replica. The predictor is told the job's pool id and the manager
    publishes the pool; ``Client.scale_inference_job(job, 2)`` grows it
    once the new worker's obs port reports; under closed-loop clients a
    rolling restart of the two-worker pool and the scale back to one
    answer every request (no failure, no 503, none near the predictor's
    30 s gather deadline: no request was routed to a worker that had
    left), and the freed slot comes back."""
    import numpy as np

    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.app import AdminApp
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec
    from rafiki_tpu_torch.serving.queues import KVQueueHub
    from rafiki_tpu_torch.store.meta_store import MetaStore
    from rafiki_tpu_torch.store.param_store import ParamStore
    from rafiki_tpu_torch.utils.http import HttpStatusError

    from test_torch_admin import TOY_MODULE

    meta = MetaStore(str(tmp_path / "meta.db"))
    mgr = ServicesManager(meta, str(tmp_path / "stack"), platform="cpu",
                          devices=[DeviceSpec(id=0)] * 2)
    mgr.start_data_plane()
    admin = Admin(meta, mgr)
    admin.start_monitor(interval_s=0.2)
    app = AdminApp(admin)
    host, port = app.start()
    client = Client(f"http://{host}:{port}", timeout=120.0)
    try:
        client.login("superadmin@rafiki", "rafiki")
        m = client.create_model_raw("toy", "IMAGE_CLASSIFICATION",
                                    "StackToy", TOY_MODULE.encode())
        tj = meta.create_train_job("u", "toy", 1, "IMAGE_CLASSIFICATION",
                                   {}, "a", "b")
        sub = meta.create_sub_train_job(tj["id"], m["id"])
        trial = meta.create_trial(sub["id"], 0, m["id"],
                                  {"max_epochs": 3, "lr": 0.5})
        ParamStore.from_uri(mgr.param_store_uri).save(
            trial["id"], {"w": np.asarray(0.25)})
        meta.mark_trial_completed(trial["id"], 0.25, True)
        ij = client.create_inference_job(tj["id"], max_workers=1)
        job_id, url = ij["id"], ij["predictor_url"]
        w0 = f"iw-{job_id[:8]}-0"
        pred_row = next(r for r in meta.get_services("RUNNING")
                        if r["service_type"] == "PREDICTOR")
        assert pred_row["spawn_spec"]["config"]["pool_id"] == job_id
        hub = KVQueueHub(mgr.kv_host, mgr.kv_port)
        assert hub.get_pool_members(job_id)["workers"] == [w0]
        assert client.predict(url, [[1.0]]) == [[0.25, 1.0]]

        out = client.scale_inference_job(job_id, 2, drain_timeout=30.0)
        w1 = f"iw-{job_id[:8]}-1"
        assert out["scaled_up"] == [w1] and out["pool"] == [w0, w1]
        assert hub.get_pool_members(job_id)["workers"] == [w0, w1]
        assert mgr.allocator.free_count() == 0
        assert Path(mgr.workdir / f"{w1}.obs_port").exists()
        rows = [r for r in meta.get_services("RUNNING")
                if r["service_type"] == "INFERENCE_WORKER"]
        assert sorted(r["devices"] for r in rows) == ["[0]", "[0]"]

        stop = threading.Event()
        answers, failures, latencies = [], [], []

        def loop(c):
            cli = Client(timeout=120.0)
            j = 0
            while not stop.is_set():
                j += 1
                t0 = time.monotonic()
                try:
                    got = cli.predict(url, [[float(j)]], retry_on_503=False)
                    latencies.append(time.monotonic() - t0)
                    answers.append(got == [[0.25, float(j)]])
                except HttpStatusError as e:
                    failures.append((e.status, str(e)[:200]))
                except Exception as e:  # counted: the gate below
                    failures.append((0, repr(e)[:200]))
                stop.wait(0.01)

        threads = [threading.Thread(target=loop, args=(c,), daemon=True)
                   for c in range(3)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.5)
            res = client.rolling_restart_inference_job(job_id,
                                                       drain_timeout=30.0)
            assert len(res["restarted"]) == 2
            assert all(r["drained"] for r in res["restarted"])
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not all(
                    (mgr.workdir / f"{w}.obs_port").exists()
                    for w in (w0, w1)):
                time.sleep(0.05)
            time.sleep(1.0)
            out = client.scale_inference_job(job_id, 1, drain_timeout=30.0)
            assert out["scaled_down"] == [w1] and out["pool"] == [w0]
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=150)
        assert not failures, failures[:3]
        assert answers and all(answers)
        assert max(latencies) < 20.0, sorted(latencies)[-3:]
        assert hub.get_pool_members(job_id)["workers"] == [w0]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and mgr.allocator.free_count() \
                != 1:
            time.sleep(0.05)
        assert mgr.allocator.free_count() == 1
        assert int(mgr.scaling["autoscale_ups"]) == 1
        assert int(mgr.scaling["autoscale_downs"]) == 1
        client.stop_inference_job(job_id)
        assert mgr.allocator.free_count() == 2
    finally:
        app.stop()
