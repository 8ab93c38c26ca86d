"""The port's Predictor, breaker board, router and brownout ladder against
the JAX package's.

Each side runs its own ``Predictor`` over its own ``InProcQueueHub``
with the same scripted fake workers (threads that pop the query queue
and answer from a script), and the two must give the same replies and
decisions: ``ensemble_predictions``, ``predict`` replies and gather
timeouts, error and drain replies, expired rejections, adaptive-gather
budgets and their anti-death-spiral, shed verdicts, breaker trips, router
picks, brownout steps, streams with their failover, the HTTP front's
status mapping and the ``stats()`` keys. The hubs' whole surface is held
to the JAX hubs' as well, in process and over a kvd. The cases follow
the predictor's cases in ``tests/test_worker_serving.py`` and
``tests/test_slo.py``; every wait is generous and no case passes or fails
on a sub-second bar.
"""

import threading
import time
import types

import numpy as np
import pytest

from rafiki_tpu.client import Client as JClient
from rafiki_tpu.serving import breaker as jbreaker
from rafiki_tpu.serving import predictor as jpred
from rafiki_tpu.serving import queues as jqueues
from rafiki_tpu.serving import router as jrouter
from rafiki_tpu.serving import slo as jslo
from rafiki_tpu.utils.http import HttpStatusError as JHttpStatusError
from rafiki_tpu_torch.client import Client as PClient
from rafiki_tpu_torch.serving import breaker as pbreaker
from rafiki_tpu_torch.serving import predictor as ppred
from rafiki_tpu_torch.serving import queues as pqueues
from rafiki_tpu_torch.serving import router as prouter
from rafiki_tpu_torch.serving import slo as pslo
from rafiki_tpu_torch.utils.http import HttpStatusError as PHttpStatusError

SIDES = {
    "jax": types.SimpleNamespace(pred=jpred, q=jqueues, breaker=jbreaker,
                                 router=jrouter, slo=jslo),
    "port": types.SimpleNamespace(pred=ppred, q=pqueues, breaker=pbreaker,
                                  router=prouter, slo=pslo),
}


def both(fn):
    """``fn(side)`` on each side; returns (port, jax)."""
    return fn(SIDES["port"]), fn(SIDES["jax"])


class FakeWorkers:
    """Threads that answer a hub's queries from a script:
    ``script[wid](msg) -> list of reply dicts`` (pushed in order), or
    None to stay silent."""

    def __init__(self, side, hub, script):
        self.side, self.hub, self.script = side, hub, script
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(w,),
                                         daemon=True) for w in script]
        for t in self.threads:
            t.start()

    def _run(self, wid):
        q = self.side.q
        while not self.stop.is_set():
            raw = self.hub.pop_query(wid, 0.1)
            if raw is None:
                continue
            msg = q.unpack_message(raw)
            for reply in self.script[wid](msg) or []:
                self.hub.push_prediction(msg["id"], q.pack_message(
                    {"id": msg["id"], "worker_id": wid, **reply}))

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=30)


def _info(info):
    """The deterministic part of a predict info dict."""
    return {k: v for k, v in info.items()
            if k not in ("latency_s", "trace_id")}


ENSEMBLE_CASES = [
    [],
    [[[0.1, 0.9], [0.5, 0.5]], [[0.3, 0.7], [0.2, 0.8]]],
    [["cat", "dog"], ["cat", "cat"], ["dog", "cat"]],
    [["a"], ["b"]],  # tie: first seen
    [[None, [1.0]], [[0.5], None]],
    [[[1.0, 2.0]], [[1.0]]],  # ragged: majority vote over reprs
    [[3], [3], [4]],
    [[{"x": 1}], [{"x": 1}], [{"y": 2}]],
]


@pytest.mark.parametrize("per_worker", ENSEMBLE_CASES)
def test_ensemble_predictions_equal_jax(per_worker):
    got, want = both(lambda s: s.pred.ensemble_predictions(per_worker))
    assert got == want


def test_nearest_rank_equal_jax():
    vals = sorted(np.random.default_rng(0).random(37).tolist())
    for p in (0.0, 0.05, 0.5, 0.95, 0.99, 1.0):
        got, want = both(lambda s: s.pred.nearest_rank(vals, p))
        assert got == want
    assert ppred.nearest_rank([], 0.5) == 0.0


def _probs(msg, k=0):
    n = len(msg["queries"])
    return [{"predictions": [[0.25 * (k + 1), 1 - 0.25 * (k + 1)]] * n}]


def test_predict_replies_and_ensemble_equal_jax():
    def run(side):
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["w0", "w1"], gather_timeout=60.0)
        fw = FakeWorkers(side, hub, {"w0": lambda m: _probs(m, 0),
                                     "w1": lambda m: _probs(m, 1)})
        try:
            preds, info = pred.predict([[0.0, 1.0], [2.0, 3.0]])
        finally:
            fw.close()
        return preds, _info(info), sorted(k for k in hub._queues
                                          if k.startswith("p:"))

    got, want = both(run)
    assert got == want
    assert got[0] == [[0.375, 0.625]] * 2 and got[1]["workers_answered"] == 2
    assert got[2] == []  # the reply queue is discarded after the gather


def test_gather_timeout_counts_a_breaker_miss_equal_jax():
    """A silent worker costs the request its gather budget, the answer of
    the other replica is served alone, and the miss feeds its breaker
    (the budget is over ``BREAKER_MIN_TIMEOUT_S``)."""
    def run(side):
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["w0", "ghost"],
                                   gather_timeout=60.0,
                                   breaker_fail_threshold=2)
        fw = FakeWorkers(side, hub, {"w0": lambda m: _probs(m)})
        try:
            out = []
            for _ in range(2):
                preds, info = pred.predict([[1.0]], timeout=1.5)
                out.append((preds, _info(info)))
            # the ghost's breaker is open now: it is skipped at scatter
            preds, info = pred.predict([[1.0]], timeout=30.0)
            out.append((preds, _info(info)))
        finally:
            fw.close()
        snap = pred.breakers.snapshot()
        return out, {w: snap[w]["state"] for w in snap}, \
            pred.breakers.counters.snapshot()

    got, want = both(run)
    assert got == want
    assert got[0][2][1]["workers_skipped"] == 1
    assert got[1]["ghost"] == "open"


def test_no_worker_answers_maps_to_504_equal_jax():
    def run(side):
        hub = side.q.InProcQueueHub()
        svc = side.pred.PredictorService(
            side.pred.Predictor(hub, ["ghost"], gather_timeout=1.2))
        code, payload = svc._predict(None, {"queries": [[1.0]]}, {})
        return code, payload["error"], _info(payload["info"])

    got, want = both(run)
    assert got == want and got[0] == 504


def test_error_and_drain_replies_equal_jax():
    """Error replies are not answers; a fleet answering only with drain
    rejections fast-fails with a retry hint (a 503 at the front)."""
    def run(side):
        out = []
        for script in (
                {"w0": lambda m: [{"error": "boom", "predictions": []}],
                 "w1": lambda m: _probs(m)},
                {"w0": lambda m: [{"error": "worker draining",
                                   "draining": True, "predictions": []}]}):
            hub = side.q.InProcQueueHub()
            pred = side.pred.Predictor(hub, sorted(script),
                                       gather_timeout=60.0)
            svc = side.pred.PredictorService(pred)
            fw = FakeWorkers(side, hub, script)
            try:
                code, payload = svc._predict(None, {"queries": [[1.0]]},
                                             {})
            finally:
                fw.close()
            payload = dict(payload)
            payload["info"] = _info(payload["info"])
            out.append((code, payload, pred.breakers.any_draining()))
        return out

    got, want = both(run)
    assert got == want
    assert got[0][0] == 200 and got[1][0] == 503
    assert got[1][2] is True  # the drained worker is excluded


def test_expired_rejection_is_a_skipped_vote_equal_jax():
    def run(side):
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["wa"], gather_timeout=60.0)
        fw = FakeWorkers(side, hub, {"wa": lambda m: [
            {"predictions": [], "expired": True,
             "error": "query expired in transit"}]})
        try:
            t0 = time.monotonic()
            preds, info = pred.predict(["x"], timeout=60.0)
            elapsed = time.monotonic() - t0
        finally:
            fw.close()
        return preds, _info(info), elapsed < 30.0

    got, want = both(run)
    assert got == want
    assert got[0] == [] and got[2]  # answered fast, not at the budget


def _adaptive(side, **kw):
    hub = side.q.InProcQueueHub()
    pred = side.pred.Predictor(hub, ["w0"], gather_timeout=2.0,
                               adaptive_gather=True, **kw)
    return hub, pred


def test_adaptive_gather_budget_equal_jax():
    lat = np.random.default_rng(3).gamma(2.0, 0.02, 300).tolist()

    def run(side):
        _, pred = _adaptive(side, target_answer_frac=0.9, gather_margin=1.2,
                            min_gather_timeout=0.01)
        out = [pred._gather_deadline_s()]  # warmup: the static budget
        pred._reply_lat.extend(lat[:1])
        out.append(pred._gather_deadline_s())
        pred._reply_lat.extend(lat)
        out.append(pred._gather_deadline_s())
        pred._reply_lat.extend([5.0] * 2048)  # capped at the timeout
        out.append(pred._gather_deadline_s())
        return out, pred.stats()["gather_deadline_s"]

    got, want = both(run)
    assert got == want
    assert got[0][0] == 2.0 and got[0][-1] == 2.0 and got[0][2] < 0.2


def test_adaptive_gather_escalates_then_flushes_equal_jax():
    """Zero-answer gathers under the learned budget add escalating
    penalty samples, and the third straight miss flushes the window back
    to the static budget (the anti-death-spiral)."""
    def run(side):
        _, pred = _adaptive(side, target_answer_frac=0.9,
                            gather_margin=1.2, min_gather_timeout=0.05)
        pred._reply_lat.extend([0.01] * 100)
        out = []
        for _ in range(3):
            budget = pred._gather_deadline_s()
            preds, info = pred.predict([[0.0]])
            out.append((round(budget, 6), preds, info["workers_answered"],
                        len(pred._reply_lat), pred._gather_misses))
        out.append(pred._gather_deadline_s())
        return out

    got, want = both(run)
    assert got == want
    assert got[-1] == 2.0  # flushed: back to the static budget


def _loaded(side, cls="background", backlog=50, **kw):
    hub = side.q.InProcQueueHub()
    pred = side.pred.Predictor(hub, ["w0"], **kw)
    pred.LOAD_REFRESH_EVERY_S = 0.0
    hub.put_worker_stats("w0", {"uptime_s": 1.0, "stale_after_s": 60.0,
                                f"queued_{cls}": backlog})
    return hub, pred


SHED_CASES = [("background", 50, {}), ("batch", 70, {}),
              ("batch", 40, {}), ("background", 0, {"stage": 3}),
              ("batch", 40, {"stage": 1}),
              ("background", 10, {"depths": {"background": 4}})]


@pytest.mark.parametrize("cls,backlog,opt", SHED_CASES)
def test_shed_verdicts_equal_jax(cls, backlog, opt):
    def run(side):
        _, pred = _loaded(side, cls, backlog,
                          slo_shed_depths=opt.get("depths"))
        if "stage" in opt:
            pred.brownout.stage = opt["stage"]
        verdicts = [pred.shed_verdict(c)
                    for c in ("interactive", "batch", "background", None)]
        pred.breakers.record_stale("w0")  # a dead worker's backlog
        verdicts.append(pred.shed_verdict(cls))
        s = pred.stats()["slo"]
        return verdicts, s

    got, want = both(run)
    assert got == want


def test_shed_and_slo_errors_at_the_http_front_equal_jax():
    def run(side):
        _, pred = _loaded(side)
        svc = side.pred.PredictorService(pred)
        out = []
        bodies = [{"queries": ["x"], "slo": "background"},
                  {"queries": ["x"], "slo": "turbo"},
                  {"queries": []}, {"queries": ["x"], "timeout": 0},
                  {"queries": ["x"], "timeout": True},
                  {"queries": ["x"], "timeout": 1e15}]
        for handler, extra in ((svc._predict, []),
                               (svc._predict_stream,
                                [{"queries": ["x"], "resume": "no"}])):
            for body in bodies + extra:
                code, payload = handler(None, body, {})
                if isinstance(payload, dict):
                    payload = {k: v for k, v in payload.items()
                               if k != "info"}
                out.append((code, payload))
        return out

    got, want = both(run)
    assert got == want
    assert [c for c, _ in got[:2]] == [503, 400]


def test_breaker_board_transitions_equal_jax():
    """One script of outcomes, on an injected clock: states, targets,
    probes, retry hints and counters after every step."""
    script = [("fail", "a"), ("fail", "a"), ("fail", "a"), ("tick", 1.0),
              ("targets",), ("tick", 1.5), ("targets",), ("fail", "a"),
              ("tick", 3.9), ("targets",), ("tick", 0.2), ("targets",),
              ("ok", "a"), ("stale", "b"), ("drain", "c", True),
              ("targets",), ("drain", "c", False), ("add", "d"),
              ("remove", "b"), ("fail", "b"), ("targets",)]

    def run(side):
        clock = [100.0]
        board = side.breaker.BreakerBoard(
            ["a", "b", "c"], fail_threshold=3, cooldown_s=2.0,
            now=lambda: clock[0])
        out = []
        for step in script:
            op = step[0]
            if op == "fail":
                board.record_failure(step[1])
            elif op == "ok":
                board.record_success(step[1])
            elif op == "stale":
                board.record_stale(step[1])
            elif op == "drain":
                board.set_draining(step[1], step[2])
            elif op == "add":
                board.add_worker(step[1])
            elif op == "remove":
                board.remove_worker(step[1])
            elif op == "tick":
                clock[0] += step[1]
            elif op == "targets":
                out.append(("targets", board.targets()))
            out.append((board.snapshot(), round(board.retry_after_s(), 6),
                        board.n_open(), board.any_draining()))
        return out, board.counters.snapshot()

    got, want = both(run)
    assert got == want
    assert got[1]["breaker_trips"] >= 2 and got[1]["breaker_probes"] >= 1


def test_router_picks_equal_jax():
    workers = [f"w{i}" for i in range(5)]
    keys = [f"system prompt {i % 7} / user turn {i}" for i in range(40)]
    loads = {"w0": {"engine_kv_pages_used": 95, "engine_kv_pages_total": 100},
             "w1": {"engine_admission_stalls": 3, "queue_p95_s": 0.4},
             "w2": {"engine_kv_pages_used": 10, "engine_kv_pages_total": 100,
                    "queued_batch": 4},
             "w3": {"role": "prefill"}, "w4": {"ttft_p95_s": 0.2}}

    def run(side):
        clock = [50.0]
        board = side.breaker.BreakerBoard(workers, now=lambda: clock[0])
        r = side.router.Router(workers, board, prefix_chars=16,
                               now=lambda: clock[0])
        picks = [r.select(r.affinity_key([k])) for k in keys]
        for wid, st in loads.items():
            r.observe(wid, st)
            r.observe_queue_depth(wid, int(wid[1]))
        r.observe("w1", {"engine_admission_stalls": 9})  # stalls grow
        picks += [r.select(r.affinity_key([k])) for k in keys]
        picks.append(r.select(None))
        picks.append(r.select_prefill())
        for _ in range(3):
            board.record_failure("w4")
        picks += [r.select(r.affinity_key([k]), exclude=("w2",))
                  for k in keys[:10]]
        r.remove_worker("w2")
        r.add_worker("w5")
        picks += [r.select(r.affinity_key([k])) for k in keys]
        return (picks, r.snapshot(), r.total_queue_depth(),
                r.class_backlog("batch"),
                round(r.affinity_hit_rate(), 9))

    got, want = both(run)
    assert got == want
    assert len(set(got[0])) > 2


def test_brownout_ladder_steps_equal_jax():
    rng = np.random.default_rng(1)
    obs = (rng.choice([0.05, 0.12, 0.2, None, 0.3], 80)).tolist()

    def run(side):
        b = side.slo.BrownoutController(target_p95_s=0.1)
        stages = [b.observe(v) for v in obs]
        caps = [(c, b.shed_cap(c, 9), b.clamp_max_new(c, 64, 8))
                for c in ("interactive", "batch", "background")]
        off = side.slo.BrownoutController(0.0)
        return stages, caps, b.snapshot(), off.observe(5.0)

    got, want = both(run)
    assert got == want
    assert max(got[0]) >= 1 and pslo.BROWNOUT_STAGES == jslo.BROWNOUT_STAGES


def test_brownout_ladder_on_live_and_stale_p95_equal_jax():
    def run(side):
        out = []
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["w0"], brownout_target_p95_s=0.1,
                                   brownout_clamp_max_new=4)
        pred.LOAD_REFRESH_EVERY_S = 0.0
        for i, p95 in enumerate([1.0] * 7 + [0.01] * 7):
            hub.put_worker_stats("w0", {
                "uptime_s": 1.0 + i, "stale_after_s": 60.0,
                "slo_interactive_ttft_p95_s": p95})
            pred._refresh_load_signals()
            out.append(pred.brownout.stage)
        pred.brownout.stage = 2
        out.append([pred._brownout_sampling(c, {"max_new": 64})
                    for c in ("interactive", "batch", "background")])
        out.append(pred._brownout_sampling("background", None))
        return out

    got, want = both(run)
    assert got == want
    assert max(got[:14]) == 2 and got[13] == 0


def test_stream_deltas_and_final_equal_jax():
    def worker(m):
        return [{"delta": {"0": "hel"}}, {"delta": {"0": "lo"}},
                {"predictions": ["hello world"]}]

    def run(side):
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["wa"])
        fw = FakeWorkers(side, hub, {"wa": worker})
        try:
            events = list(pred.predict_stream(["hi"], timeout=60.0))
        finally:
            fw.close()
        final = dict(events[-1])
        final["info"] = {k: v for k, v in final["info"].items()
                         if k not in ("latency_s", "trace_id")}
        return events[:-1], final

    got, want = both(run)
    assert got == want
    assert got[0][-1] == {"delta": {"0": " world"}}


def test_stream_fails_over_on_expired_rejection_equal_jax():
    def run(side):
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["wa", "wb"],
                                   stream_silence_timeout_s=120.0)
        first, lock = {}, threading.Lock()

        def role(wid):
            def answer(m):
                with lock:
                    am_first = not first
                    first.setdefault("wid", wid)
                if am_first:
                    return [{"predictions": [], "expired": True,
                             "error": "query expired"}]
                return [{"delta": {"0": "hello"}},
                        {"predictions": ["hello"]}]
            return answer

        fw = FakeWorkers(side, hub, {"wa": role("wa"), "wb": role("wb")})
        try:
            events = list(pred.predict_stream(["hi"], timeout=100.0))
        finally:
            fw.close()
        return (events[-1]["predictions"], events[-1]["info"]["failovers"],
                int(pred._c_failover.value), events[:-1])

    got, want = both(run)
    assert got == want
    assert got[:2] == (["hello"], 1)


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()
                if k not in ("breakers", "workers")}
    return type(d).__name__


def test_stats_keys_equal_jax():
    def run(side):
        hub = side.q.InProcQueueHub()
        pred = side.pred.Predictor(hub, ["w0"], gather_timeout=60.0)
        hub.put_worker_stats("w0", {"uptime_s": 1.0, "stale_after_s": 60.0})
        fw = FakeWorkers(side, hub, {"w0": lambda m: _probs(m)})
        try:
            pred.predict([[1.0]])
        finally:
            fw.close()
        s = pred.stats()
        return (_key_tree(s), sorted(s["workers"]["w0"]),
                sorted(s["breakers"]["w0"]),
                sorted(pred.metrics.snapshot()))

    got, want = both(run)
    assert got == want


@pytest.mark.parametrize("client", ["port", "jax"])
def test_predict_over_http_with_either_client(client):
    """The port's PredictorService behind a real socket: the port
    ``Client`` and the JAX one read the same predictions, and both type a
    breaker fast-fail 503 the same way."""
    hub = pqueues.InProcQueueHub()
    pred = ppred.Predictor(hub, ["w0"], gather_timeout=60.0)
    svc = ppred.PredictorService(pred)
    host, port = svc.start()
    fw = FakeWorkers(SIDES["port"], hub, {"w0": lambda m: _probs(m, 2)})
    cli, err = ((PClient(), PHttpStatusError) if client == "port"
                else (JClient(), JHttpStatusError))
    try:
        url = f"http://{host}:{port}"
        preds = cli.predict(url, [np.zeros((2, 2)), np.ones((2, 2))])
        assert preds == [[0.75, 0.25]] * 2
        for _ in range(3):
            pred.breakers.record_failure("w0")
        with pytest.raises(err) as ei:
            cli.predict(url, [[1.0]], retry_on_503=False)
        assert ei.value.status == 503 and ei.value.shed is False
        assert ei.value.retry_after_s is not None
    finally:
        fw.close()
        svc.stop()


# ---- the hubs' whole surface, against the JAX hubs

def _hub_transcript(hub, q):
    out = []
    hub.push_query("w0", b"m1")
    hub.push_query("w0", b"m2")
    out += [hub.query_depth("w0"), hub.pop_query("w0", 5.0),
            hub.query_depth("w0"), hub.pop_query("w0", 5.0),
            hub.pop_query("w0", 0.05), hub.query_depth("nobody")]
    hub.arm_reply_ttl("q1", 600.0)
    hub.push_prediction("q1", b"r1")
    out.append(hub.pop_prediction("q1", 5.0))
    hub.push_prediction("q1", b"late")
    hub.discard_prediction_queue("q1")
    out.append(hub.pop_prediction("q1", 0.05))
    hub.put_worker_stats("w0", {"uptime_s": 1.5, "nested": {"a": 1}})
    out += [hub.get_worker_stats("w0"), hub.get_worker_stats("nobody")]
    hub.put_pool_members("job", {"workers": ["w0", "w1"], "version": 2.5})
    out += [hub.get_pool_members("job"), hub.get_pool_members("none")]
    hub.push_kv("w1", b"kv-blob")
    out += [hub.kv_depth("w1"), hub.pop_kv("w1", 5.0), hub.kv_depth("w1")]
    hub.put_blob("prefix:job:0", b"\x00snap")
    out += [hub.get_blob("prefix:job:0"), hub.get_blob("nope")]
    out.append(q.unpack_message(q.pack_message(
        {"id": "x", "queries": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ))["queries"].tolist())
    return out


def test_inproc_hub_surface_equal_jax():
    got, want = both(lambda s: _hub_transcript(s.q.InProcQueueHub(), s.q))
    assert got == want


def test_kv_hub_surface_equal_jax():
    from rafiki_tpu_torch.native.client import KVClient, KVServer

    with KVServer() as s:
        out = []
        for side in (SIDES["port"], SIDES["jax"]):
            KVClient(s.host, s.port).flushall()
            hub = side.q.KVQueueHub(s.host, s.port)
            out.append(_hub_transcript(hub, side.q))
            # both write the same keys: a JAX predictor reads what a
            # port worker published, and the reverse
            out.append(KVClient(s.host, s.port).keys("*"))
    assert out[0] == out[2] and out[1] == out[3]
    assert pqueues.KVQueueHub.REPLY_TTL_S == jqueues.KVQueueHub.REPLY_TTL_S
    assert pqueues.EXPIRY_SKEW_TOLERANCE_S == \
        jqueues.EXPIRY_SKEW_TOLERANCE_S
