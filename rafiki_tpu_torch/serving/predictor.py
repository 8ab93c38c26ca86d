"""Predictor: the public inference endpoint with top-N ensembling.

The port's own copy of ``rafiki_tpu/serving/predictor.py``
(``nearest_rank``, ``ensemble_predictions``, ``Predictor`` with
``predict``, ``predict_stream``, the shed gate, adaptive gather, the
breaker board, the router and the brownout ladder, ``PredictorService``
and ``main``). ``POST /predict`` assigns each request a query id,
scatters it onto every inference worker's queue, gathers the replicas'
predictions with a timeout, and ensembles: probability averaging for
classification vectors, majority vote otherwise. Partial gathers still
answer (whatever arrived by the deadline is ensembled); zero arrivals is
a 504. The module is host-side: it imports no ``torch`` itself (the
queue codec it shares with the workers does).

One difference from JAX: a stream's event loop reads the published pool
membership itself (rate-limited as every reader is), so a stream on a
worker the control plane took out fails over at once even when no other
request comes to read the membership; JAX's waits for one, or for the
silence window.
"""

from __future__ import annotations

import collections
import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rafiki_tpu_torch.native.client import CLIENT_STATS
from rafiki_tpu_torch.obs.http import mount_obs_routes
from rafiki_tpu_torch.obs.metrics import MetricsRegistry, StatsMap
from rafiki_tpu_torch.obs.trace import (TraceBuffer, mint_trace_id,
                                        sanitize_trace_id)
from rafiki_tpu_torch.serving.breaker import OPEN, BreakerBoard
from rafiki_tpu_torch.serving.queues import (EXPIRY_SKEW_TOLERANCE_S,
                                             KVQueueHub, QueueHub,
                                             pack_message, unpack_message)
from rafiki_tpu_torch.serving.router import Router
from rafiki_tpu_torch.serving.slo import BrownoutController, normalize_slo
from rafiki_tpu_torch.utils.http import (STREAM_BUDGET_S, JsonHttpService,
                                         StreamResponse)


def nearest_rank(sorted_vals: Sequence[float], p: float) -> float:
    """Nearest-rank quantile over pre-sorted values: ``ceil(p·n)-1``,
    so p95 of 20 samples is the 19th-smallest, not the max. Shared by
    the /health percentiles and the adaptive-gather controller (they
    must agree). Empty input → 0.0."""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    return sorted_vals[max(0, min(n - 1, math.ceil(p * n) - 1))]


def ensemble_predictions(per_worker: List[List[Any]]) -> List[Any]:
    """Combine replicas' per-query predictions.

    Numeric same-length vectors (class probabilities) are averaged;
    anything else falls back to majority vote (ties → first seen).
    """
    if not per_worker:
        return []
    n_queries = len(per_worker[0])
    out: List[Any] = []
    for q in range(n_queries):
        votes = [w[q] for w in per_worker if q < len(w) and w[q] is not None]
        if not votes:
            out.append(None)
            continue
        try:
            arrs = [np.asarray(v, dtype=np.float64) for v in votes]
            if all(a.shape == arrs[0].shape and a.ndim >= 1 for a in arrs):
                out.append(np.mean(arrs, axis=0).tolist())
                continue
        except (TypeError, ValueError):
            pass
        keys = [repr(v) for v in votes]
        best = max(set(keys), key=lambda k: (keys.count(k), -keys.index(k)))
        out.append(votes[keys.index(best)])
    return out


class Predictor:
    """Scatter/gather over inference workers + ensemble."""

    #: bounded reservoir of recent request latencies; big enough for
    #: stable p50/p95/p99, small enough to sort on every stats() call
    LATENCY_WINDOW = 2048
    #: default whole-stream deadline for predict_stream — generations
    #: run for minutes; gather_timeout is a unary-RPC bound. Shared
    #: with the client SDK via utils.http (it sizes per-event socket
    #: timeouts to this budget).
    STREAM_TIMEOUT = STREAM_BUDGET_S

    #: default fleet queue-backlog caps per best-effort class: beyond
    #: these the shed gate 503s the class with a structured
    #: ``retry_after_s`` instead of letting it deepen the overload.
    #: Interactive is never depth-shed (its protection is admission
    #: priority + preemption, not refusal).
    DEFAULT_SHED_DEPTHS = {"batch": 64, "background": 16}

    #: a gather miss only counts toward a worker's circuit breaker when
    #: the budget it missed was at least this long: misses under an
    #: aggressively learned adaptive budget (or a tiny explicit client
    #: timeout) mean "slower than the controller wants", not "dead" —
    #: shedding those is the adaptive controller's job, and letting
    #: them trip breakers would turn a fleet-wide slowdown into a
    #: fast-fail outage
    BREAKER_MIN_TIMEOUT_S = 1.0

    def __init__(self, hub: QueueHub, worker_ids: Sequence[str],
                 gather_timeout: float = 10.0,
                 adaptive_gather: bool = False,
                 target_answer_frac: float = 0.95,
                 gather_margin: float = 1.5,
                 min_gather_timeout: float = 0.05,
                 breaker_fail_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 stream_silence_timeout_s: float = 30.0,
                 max_stream_failovers: int = 2,
                 pool_id: str = "",
                 affinity_prefix_chars: int = Router.DEFAULT_PREFIX_CHARS,
                 default_slo: str = "",
                 slo_shed_depths: Optional[Dict[str, int]] = None,
                 brownout_target_p95_s: float = 0.0,
                 brownout_clamp_max_new: int = 16,
                 kv_ship_min_tokens: int = 4) -> None:
        """``adaptive_gather`` enables the serving latency/accuracy
        controller (the reference paper's batching/wait tradeoff,
        SURVEY.md §3.3 note): instead of always waiting
        ``gather_timeout`` for stragglers, the gather deadline tracks
        the observed per-reply latency distribution — the
        ``target_answer_frac`` quantile times ``gather_margin``,
        clamped to [``min_gather_timeout``, ``gather_timeout``]. A
        persistently slow replica stops taxing every request's p50
        (its answers are dropped from the ensemble: slightly less
        accuracy, much less latency), while a healthy fleet keeps full
        ensembles because the quantile tracks its real speed. Explicit
        per-request ``timeout`` always wins.

        **SLO / overload controls**: ``default_slo`` classes requests
        that carry no ``slo`` of their own; ``slo_shed_depths`` caps
        the fleet queue backlog per best-effort class (batch /
        background — interactive is never depth-shed), beyond which
        requests get a structured shed 503 with ``retry_after_s``
        BEFORE they deepen the overload; ``brownout_target_p95_s``
        (> 0 enables the ladder) is the interactive-TTFT-p95 target
        the hysteresis brownout ladder defends — stage 1 halves the
        best-effort caps, stage 2 additionally clamps background
        ``max_new`` to ``brownout_clamp_max_new``, stage 3 pauses
        background entirely. See docs/operations.md "Overload &
        brownout".

        ``kv_ship_min_tokens`` gates the disaggregated prefill leg:
        prompts shorter than this many whitespace tokens prefill
        locally on the decode worker (a short prefill costs less than
        the shipment wait + page install it would replace); longer
        prompts route through a prefill-role worker when the pool has
        one. See docs/operations.md "Disaggregated serving"."""
        self.hub = hub
        self.worker_ids = list(worker_ids)
        self.gather_timeout = gather_timeout
        #: per-worker circuit breakers: fed by gather answer/miss
        #: outcomes, the monotonic staleness signal, and drain
        #: announcements; consulted at every scatter (open workers are
        #: skipped, shrinking the gather quorum; all-open fast-fails)
        self.breakers = BreakerBoard(
            self.worker_ids, fail_threshold=breaker_fail_threshold,
            cooldown_s=breaker_cooldown_s)
        #: single-worker stream placement: prefix-affinity (HRW) with
        #: load-aware fallback over the live pool, breaker-gated —
        #: replaces the old round-robin cursor even for one worker
        self.router = Router(self.worker_ids, self.breakers,
                             prefix_chars=affinity_prefix_chars)
        #: hub key this job's pool membership is published under (the
        #: inference job id); empty = static membership (direct
        #: add_worker/remove_worker calls only)
        self.pool_id = str(pool_id or "")
        self._pool_version = 0.0
        self._last_pool_refresh = 0.0
        self._last_load_refresh = 0.0
        #: mid-stream reply-silence watchdog: no delta/final from the
        #: stream's worker for this long triggers failover to a healthy
        #: replica (NOT the whole-stream timeout — a dead worker must
        #: not cost the client the full stream budget). Generous by
        #: default: a long prefill queued behind busy slots is silence
        self.stream_silence_timeout_s = float(stream_silence_timeout_s)
        self.max_stream_failovers = max(0, int(max_stream_failovers))
        self.kv_ship_min_tokens = max(0, int(kv_ship_min_tokens))
        #: SLO plane: per-job default class, best-effort shed caps,
        #: and the brownout ladder fed by the live interactive p95
        #: (workers publish slo_interactive_ttft_p95_s; the ladder
        #: steps on the fleet max so one hot replica counts)
        self.default_slo = normalize_slo(default_slo)
        self.shed_depths = dict(self.DEFAULT_SHED_DEPTHS)
        for k, v in (slo_shed_depths or {}).items():
            self.shed_depths[normalize_slo(k)] = max(0, int(v))
        self.brownout = BrownoutController(
            target_p95_s=brownout_target_p95_s)
        self.brownout_clamp_max_new = max(1,
                                          int(brownout_clamp_max_new))
        self.adaptive_gather = bool(adaptive_gather)
        self.target_answer_frac = min(1.0, max(0.0, target_answer_frac))
        self.gather_margin = max(1.0, gather_margin)
        self.min_gather_timeout = max(0.0, min_gather_timeout)
        #: observed scatter→reply latencies per ANSWER (not request):
        #: the controller's signal
        self._reply_lat: "collections.deque[float]" = collections.deque(
            maxlen=self.LATENCY_WINDOW)
        #: the obs plane: request counters + fixed-bucket latency
        #: histograms (scraped via /metrics) and the per-request trace
        #: ring (/debug/requests). The bounded reservoir below stays —
        #: it feeds the adaptive-gather CONTROLLER, which wants exact
        #: recent samples, not bucket counts.
        self.metrics = MetricsRegistry()
        self.traces = TraceBuffer(512)
        self._c_requests = self.metrics.counter(
            "requests_served", "predict/predict_stream calls answered")
        self._c_queries = self.metrics.counter(
            "queries_served", "individual queries answered")
        self._h_e2e = self.metrics.histogram(
            "request_seconds", "end-to-end request latency (seconds)")
        self._h_reply = self.metrics.histogram(
            "gather_reply_seconds",
            "scatter-to-reply latency per worker answer (seconds)")
        self.metrics.gauge(
            "gather_deadline_s",
            "adaptive-gather controller's live budget (seconds)",
            fn=self._gather_deadline_s)
        # fault-tolerance plane: breaker trips/recoveries (board
        # counters), open-worker gauge, fast-fail + failover counters
        self.metrics.register_stats(self.breakers.counters)
        self.metrics.gauge(
            "breaker_open_workers",
            "workers currently excluded from scatter "
            "(open/half-open/draining)", fn=self.breakers.n_open)
        self._c_fast_fail = self.metrics.counter(
            "requests_fast_failed",
            "requests 503'd with every breaker open")
        # data-plane survival: the shared kv-client reconnect counters
        # (hub_reconnects_total / hub_rpc_retries_total) plus a down
        # flag — set when a hub op exhausts its reconnect window,
        # cleared by the next op that reaches the kvd. Drives /health,
        # /metrics, and the dashboard's data-plane banner.
        self.metrics.register_stats(CLIENT_STATS)
        self._c_dp_failures = self.metrics.counter(
            "data_plane_failures",
            "requests failed with the kvd unreachable past the "
            "reconnect window (structured 503 / resumable event)")
        self._dp_down_at: Optional[float] = None
        self.metrics.gauge(
            "data_plane_down",
            "1 while the last hub op found the kvd unreachable "
            "(predictor fast-fails 503 until it returns)",
            fn=lambda: 0 if self._dp_down_at is None else 1)
        self._c_failover = self.metrics.counter(
            "stream_failovers",
            "mid-stream failovers to another worker")
        self._c_resumable = self.metrics.counter(
            "stream_resumable_errors",
            "streams ended with a resumable error event")
        # SLO plane: shed decisions per class + the live brownout stage
        self._shed_counts = StatsMap({"requests_shed_batch": 0,
                                      "requests_shed_background": 0})
        self.metrics.register_stats(self._shed_counts)
        self._c_shed = self.metrics.counter(
            "requests_shed",
            "best-effort requests 503'd by the SLO shed gate "
            "(structured retry_after_s — backpressure, not failure)")
        self.metrics.gauge(
            "brownout_stage",
            "live brownout ladder stage (0 normal, 1 capped, "
            "2 clamped, 3 background paused)",
            fn=lambda: self.brownout.stage)
        # scale-out plane: router decision counters + live pool gauges
        self.metrics.register_stats(self.router.counters)
        self.metrics.gauge(
            "router_pool_size",
            "workers in this job's routing pool (live membership)",
            fn=lambda: len(self.router))
        self.metrics.gauge(
            "router_affinity_hit_rate",
            "fraction of keyed placements that landed on their HRW "
            "owner (prefix-cache hit proxy)",
            fn=self.router.affinity_hit_rate)
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=self.LATENCY_WINDOW)
        #: per-worker publish watermarks for staleness detection:
        #: worker_id -> (last seen uptime_s, local monotonic at change).
        #: Monotonic on BOTH sides — wall-clock steps can't grey out a
        #: healthy fleet (the published_at failure mode)
        self._worker_seen: Dict[str, Tuple[float, float]] = {}
        #: consecutive zero-answer adaptive gathers — drives the
        #: escalating recovery below (a single penalty sample per miss
        #: needs ~0.05·WINDOW misses to move the p95 past a window of
        #: stale fast samples; a fleet-wide slowdown must relearn in a
        #: few requests, not ~100)
        self._gather_misses = 0
        self._last_drain_refresh = 0.0
        self._lock = threading.Lock()

    #: floor between drain-exclusion refreshes on the scatter path —
    #: per-request hub reads would tax the healthy hot path for a
    #: condition that only exists around rolling restarts
    DRAIN_REFRESH_EVERY_S = 1.0

    def _refresh_excluded_workers(self, force: bool = False) -> None:
        """Re-read hub stats for workers the board currently excludes
        as draining. The draining flag is normally cleared when a
        /health render annotates the respawned worker's fresh stats —
        but a predictor used purely through predict()/predict_stream
        never renders /health, and without this re-check a rolling
        restart would leave drained-then-respawned workers excluded
        forever (a shrunken quorum while siblings stay healthy, a
        permanent fast-fail with none). Rate-limited unless ``force``
        (the about-to-fast-fail path, where one extra hub read beats a
        wrong 503)."""
        now = time.monotonic()
        if not force and now - self._last_drain_refresh < \
                self.DRAIN_REFRESH_EVERY_S:
            return
        # lock-free rate-limiter stamp: threads racing the
        # check-then-set at worst both refresh (one redundant hub
        # read), never corrupt state
        self._last_drain_refresh = now
        for wid, st in self.breakers.snapshot().items():
            if not st.get("draining"):
                continue
            try:
                s = self.hub.get_worker_stats(wid)
            except Exception:  # a hub
                continue       # hiccup just delays the re-admission
            if s is not None:
                self._annotate_staleness(wid, s)

    #: floor between hub membership reads on the request path — a
    #: scale event lands within this; per-request reads would tax every
    #: request for a change that happens a few times an hour
    POOL_REFRESH_EVERY_S = 2.0
    #: floor between load-signal refreshes feeding the router (worker
    #: stats + queue depths); workers republish at a similar cadence
    LOAD_REFRESH_EVERY_S = 1.0

    # ---- dynamic pool membership (scale-out) ----
    def add_worker(self, wid: str) -> None:
        """Admit a new pool member live: breaker (CLOSED) first so the
        id is scatter-eligible the instant the router can pick it, then
        the router table (HRW claims only the keys it now owns)."""
        with self._lock:
            if wid in self.worker_ids:
                return
            # membership mutations all hold _lock; the lock-free
            # readers are single GIL-atomic len()/list() snapshots in
            # advisory payload fields, where one-refresh staleness is
            # part of the contract (see _refresh_membership)
            self.worker_ids.append(wid)
        self.breakers.add_worker(wid)
        self.router.add_worker(wid)

    def remove_worker(self, wid: str) -> None:
        """Remove a departed member: breaker state goes first (unary
        scatter stops immediately, and a straggling gather outcome
        can't resurrect the id), then the router table (streams stop
        placing there; HRW remaps only this worker's keys), then the
        staleness watermark. An in-flight stream on the removed worker
        notices on its next loop tick and fails over with its
        delivered text as the forced prefix — removal is never a
        dropped stream."""
        self.breakers.remove_worker(wid)
        self.router.remove_worker(wid)
        with self._lock:
            if wid in self.worker_ids:
                self.worker_ids.remove(wid)
            self._worker_seen.pop(wid, None)

    def _refresh_membership(self, force: bool = False) -> None:
        """Apply the control plane's published pool membership (see
        ``QueueHub.put_pool_members``). Rate-limited; ``force`` on the
        about-to-fail paths. Only newer versions apply, and an empty
        worker list is ignored — a publisher bug must not unroute the
        whole fleet."""
        if not self.pool_id:
            return
        now = time.monotonic()
        if not force and now - self._last_pool_refresh < \
                self.POOL_REFRESH_EVERY_S:
            return
        # lock-free rate-limiter stamp, same contract as
        # _last_drain_refresh above
        self._last_pool_refresh = now
        try:
            pool = self.hub.get_pool_members(self.pool_id)
        except Exception:  # a hub hiccup
            return         # just delays the membership diff
        if not isinstance(pool, dict):
            return
        workers = [str(w) for w in (pool.get("workers") or []) if w]
        if not workers:
            return
        try:
            version = float(pool.get("version") or 0.0)
        except (TypeError, ValueError):
            version = 0.0
        if version and version <= self._pool_version:
            return  # already applied (or an out-of-order straggler)
        # monotone float under max(): two racing refreshers at worst
        # re-apply the same membership diff, which is idempotent
        self._pool_version = max(
            self._pool_version, version)
        with self._lock:
            have = list(self.worker_ids)
        for wid in workers:
            if wid not in have:
                self.add_worker(wid)
        want = set(workers)
        for wid in have:
            if wid not in want:
                self.remove_worker(wid)

    def _refresh_load_signals(self) -> None:
        """Feed the router's load view (and the staleness/drain
        breaker signals — one read serves both) from the hub's
        published worker stats + queue depths. Rate-limited."""
        now = time.monotonic()
        with self._lock:
            # atomic check-then-set: this refresh now TICKS the
            # brownout ladder's dwell counters, and two request
            # threads racing the unguarded watermark would double-tick
            # a transition ("dwell consecutive observations" is the
            # hysteresis contract)
            if now - self._last_load_refresh < \
                    self.LOAD_REFRESH_EVERY_S:
                return
            self._last_load_refresh = now
            members = list(self.worker_ids)
        p95s: List[float] = []
        for wid in members:
            try:
                s = self.hub.get_worker_stats(wid)
                depth = self.hub.query_depth(wid)
            except Exception:  # load
                continue       # signals are advisory; stale beats dead
            if s is not None:
                annotated = self._annotate_staleness(wid, s)
                self.router.observe(wid, s)
                v = s.get("slo_interactive_ttft_p95_s")
                if not annotated.get("stale") and \
                        isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    # a dead/stuck worker's LAST published p95 must
                    # not pin the ladder: stale stats are liveness
                    # fiction, not a latency signal
                    p95s.append(float(v))
            self.router.observe_queue_depth(wid, depth)
        # brownout ladder tick: the fleet MAX interactive p95 (one hot
        # replica is an SLO breach; averaging would hide it). Rides
        # this rate-limited refresh so the ladder's dwell counts are
        # roughly seconds, and an idle/recovered fleet (no samples)
        # walks back down.
        self.brownout.observe(max(p95s) if p95s else None)

    def _gather_deadline_s(self) -> float:
        """The adaptive controller's current gather budget."""
        if not self.adaptive_gather:
            return self.gather_timeout
        with self._lock:
            lat = sorted(self._reply_lat)
            n_workers = len(self.worker_ids)
        if len(lat) < 2 * n_workers:
            return self.gather_timeout  # warmup: no signal yet
        return max(self.min_gather_timeout,
                   min(self.gather_timeout,
                       nearest_rank(lat, self.target_answer_frac)
                       * self.gather_margin))

    # ---- SLO shed gate (predictor-side overload backpressure) ----
    def shed_verdict(self, slo: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
        """Should a ``slo``-class request be shed RIGHT NOW? None =
        admit; otherwise the structured shed payload (a 503 at the
        HTTP front). Best-effort classes are refused with a
        ``retry_after_s`` once the fleet queue backlog exceeds their
        (brownout-adjusted) cap — BEFORE they deepen the overload —
        and background is refused outright at brownout stage 3.
        Interactive is never shed here: its protection is engine-side
        priority + preemption, not refusal. Shedding is backpressure,
        not failure — the reply names the class, the live stage, and
        when retrying can help."""
        cls = normalize_slo(slo, default=self.default_slo)
        # refresh BEFORE the interactive early-return: this
        # (rate-limited) call is what ticks the brownout ladder, and
        # a fleet serving only interactive traffic must still walk
        # the ladder back down after an overload ends — de-escalation
        # cannot wait for the next best-effort arrival
        self._refresh_load_signals()
        if cls == "interactive":
            return None
        stage = self.brownout.stage
        cap = self.brownout.shed_cap(cls, self.shed_depths.get(cls, 0))
        # fleet backlog FOR THIS CLASS: unpopped hub messages plus the
        # engines' published class-queue depths (workers pop the hub
        # eagerly, so overload backlog sits in the engine queues)
        depth = (self.router.total_queue_depth()
                 + self.router.class_backlog(cls))
        if cls == "background" and stage >= 3:
            reason = "background paused (brownout stage 3)"
        elif cap >= 0 and depth > cap:
            reason = (f"{cls} backlog {depth} over cap {cap}"
                      + (f" (brownout stage {stage})" if stage else ""))
        else:
            return None
        retry = round(min(30.0, 1.0 + 0.1 * max(0, depth - max(cap, 0))),
                      3)
        self._c_shed.inc()
        self._shed_counts.inc(f"requests_shed_{cls}")
        return {"shed": True, "slo": cls, "error": f"shed: {reason}",
                "retry_after_s": retry, "brownout_stage": stage}

    def _brownout_sampling(self, cls: str,
                           sampling: Optional[Dict]) -> Optional[Dict]:
        """Stage >= 2: clamp background ``max_new`` so long best-effort
        generations release their slots/pages sooner (the 'clamped'
        rung of the ladder). Other classes/stages pass through
        untouched."""
        if cls == "interactive":
            return sampling
        mn = (sampling or {}).get("max_new")
        c = self.brownout.clamp_max_new(cls, mn,
                                        self.brownout_clamp_max_new)
        if c is not None and c != mn:
            sampling = dict(sampling or {})
            sampling["max_new"] = c
        return sampling

    def predict(self, queries: Sequence[Any],
                timeout: Optional[float] = None,
                sampling: Optional[Dict] = None,
                trace_id: Optional[str] = None,
                slo: Optional[str] = None
                ) -> Tuple[List[Any], Dict]:
        """Returns (ensembled predictions, info dict). ``sampling``
        (generation jobs only) rides with the message to the decode
        loop: {temperature, top_k, top_p, seed, eos_id, max_new,
        adapter_id} — seeded draws are reproducible per
        (seed, position) regardless of serving load; max_new is
        clamped by the worker's configured cap.

        ``trace_id``: honored when well-formed (the HTTP front passes
        an inbound ``X-Rafiki-Trace-Id``), else minted here; it rides
        in the scatter payload so worker-side span records join this
        predictor's across ``/debug/requests``, and comes back in
        ``info["trace_id"]``.

        ``slo`` (``interactive``/``batch``/``background``; default =
        the job's ``default_slo``): the request's admission class. It
        rides the scatter payload to the engine's class-aware queue,
        and best-effort classes may be SHED here (structured 503 with
        ``retry_after_s`` via ``info["shed"]``) when the backlog cap
        or brownout ladder says admitting would hurt interactive
        traffic."""
        t0 = time.monotonic()
        cls = normalize_slo(slo, default=self.default_slo)
        tid = sanitize_trace_id(trace_id) or mint_trace_id()
        # the down-gate runs FIRST: everything below (the shed gate's
        # load refresh included) touches the hub, and a known-down
        # plane must cost one 0.25s-bounded probe, not a reconnect
        # window per hub op
        gate = self._data_plane_gate(tid)
        if gate is not None:
            self._c_requests.inc()
            return [], {"workers_answered": 0, "workers_asked": 0,
                        "workers_skipped": len(self.worker_ids),
                        "latency_s": time.monotonic() - t0,
                        "errors": [gate["error"]],
                        "trace_id": tid, **gate}
        shed = self.shed_verdict(cls)
        if shed is not None:
            self._c_requests.inc()
            self.traces.start(tid, request_id="", span="shed",
                              slo=cls,
                              retry_after_s=shed["retry_after_s"])
            return [], {"workers_answered": 0, "workers_asked": 0,
                        "workers_skipped": len(self.worker_ids),
                        "latency_s": time.monotonic() - t0,
                        "errors": [shed["error"]], "fast_fail": True,
                        "trace_id": tid, **shed}
        sampling = self._brownout_sampling(cls, sampling)
        adaptive = timeout is None and self.adaptive_gather
        timeout = self._gather_deadline_s() if timeout is None else timeout
        qid = uuid.uuid4().hex
        self.traces.start(tid, request_id=qid, span="received",
                          n_queries=len(queries),
                          timeout_s=round(float(timeout), 4))
        # live membership first: a scaled pool must be scattered to
        # (and a removed worker not) without a predictor rebuild
        self._refresh_membership()
        # breaker gating: open workers are skipped at scatter time —
        # their share of the gather quorum shrinks accordingly. All
        # open: fast-fail with a structured 503 + retry_after_s instead
        # of burning the whole gather budget on a dead fleet.
        if self.breakers.any_draining():
            # drained workers re-admit themselves through their fresh
            # published stats (rate-limited; a partial fleet must not
            # serve a shrunken quorum forever after a rolling restart)
            self._refresh_excluded_workers()
        targets = self.breakers.targets()
        if not targets:
            self._refresh_membership(force=True)
            self._refresh_excluded_workers(force=True)
            targets = self.breakers.targets()
        if not targets:
            self._c_fast_fail.inc()
            self._c_requests.inc()
            retry = round(self.breakers.retry_after_s(), 3)
            self.traces.add_span(tid, "fast_fail",
                                 retry_after_s=retry)
            return [], {"workers_answered": 0, "workers_asked": 0,
                        "workers_skipped": len(self.worker_ids),
                        "latency_s": time.monotonic() - t0,
                        "errors": ["no worker available "
                                   "(all circuit breakers open)"],
                        "fast_fail": True, "retry_after_s": retry,
                        "trace_id": tid}
        deadline = t0 + timeout
        # the wall-clock deadline rides with the query: a worker that
        # pops it too late drops it instead of computing an answer
        # nobody will read (and recreating a discarded reply queue).
        # ttl_s/sent_ts are the relative twin — workers prefer them,
        # judged against their own skew estimate (see worker._expired)
        payload = {"id": qid, "queries": _stack(queries),
                   "deadline_ts": time.time() + timeout,  # legacy-worker fallback; ttl_s+sent_ts below is the sanctioned path
                   "ttl_s": float(timeout), "sent_ts": time.time(),
                   "trace_id": tid, "slo": cls}
        if sampling:
            payload["sampling"] = dict(sampling)
        msg = pack_message(payload)
        # condemn the reply queue up front: a worker inside its expiry
        # skew tolerance may answer after our discard below, recreating
        # the queue in the kv store — the pre-armed TTL collects it
        try:
            self.hub.arm_reply_ttl(
                qid, timeout + EXPIRY_SKEW_TOLERANCE_S + 30.0)
        except Exception:  # the
            pass           # TTL is defense-in-depth
        per_worker: List[List[Any]] = []
        errors: List[str] = []
        answered: set = set()
        n_draining = 0
        try:
            for wid in targets:
                self.hub.push_query(wid, msg)
        except ConnectionError as e:
            # the kvd is unreachable past the client's reconnect
            # window: fast-fail with a structured shed-style 503
            # instead of hanging the caller into a gather timeout
            verdict = self._data_plane_lost(tid, e)
            self._c_requests.inc()
            return [], {"workers_answered": 0, "workers_asked": 0,
                        "workers_skipped": len(self.worker_ids),
                        "latency_s": time.monotonic() - t0,
                        "errors": [verdict["error"]],
                        "trace_id": tid, **verdict}
        self.traces.add_span(tid, "scattered", workers=len(targets))
        try:
            for _ in targets:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                reply_bytes = self.hub.pop_prediction(qid, remaining)
                if reply_bytes is None:
                    break
                try:
                    reply = unpack_message(reply_bytes)
                    if not isinstance(reply, dict):
                        raise ValueError("reply is not a mapping")
                except Exception:  # a
                    # corrupted reply (torn write, chaos injection) is
                    # one replica's bad answer, not a request failure:
                    # skip it and keep gathering the others
                    errors.append("undecodable reply payload")
                    continue
                wid_r = str(reply.get("worker_id") or "")
                if wid_r:
                    # any decodable reply — answer OR structured error
                    # — proves the worker is alive and responsive
                    answered.add(wid_r)
                    self.breakers.record_success(wid_r)
                if reply.get("error"):
                    # error replies are NOT controller answers: a
                    # fast-failing replica must not drag the learned
                    # budget down to its ~ms error latency (healthy-
                    # but-slower replicas would get shed while requests
                    # 504 on a 'fully answering' fleet)
                    errors.append(str(reply["error"]))
                    if reply.get("draining") and wid_r:
                        # voluntary drain (rolling restart): stop
                        # scattering to it until its stats say otherwise
                        n_draining += 1
                        self.breakers.set_draining(wid_r, True)
                    continue
                reply_lat = time.monotonic() - t0
                with self._lock:  # controller signal: scatter→ANSWER
                    self._reply_lat.append(reply_lat)
                self._h_reply.observe(reply_lat)
                self.traces.add_span(tid, "reply", worker=wid_r)
                per_worker.append(list(reply["predictions"]))
        except ConnectionError as e:
            # mid-gather data-plane loss (reconnect window exhausted):
            # same structured fast-fail — answers gathered so far are
            # a partial quorum nobody can complete
            verdict = self._data_plane_lost(tid, e)
            self._c_requests.inc()
            return [], {"workers_answered": len(per_worker),
                        "workers_asked": len(targets),
                        "workers_skipped":
                            len(self.worker_ids) - len(targets),
                        "latency_s": time.monotonic() - t0,
                        "errors": errors + [verdict["error"]],
                        "trace_id": tid, **verdict}
        finally:
            # drop the reply queue even on a gather error: late answers
            # must not accumulate in the hub/kv store forever
            try:
                self.hub.discard_prediction_queue(qid)
            except Exception:
                pass           # cleanup is best-effort
        self._data_plane_ok()  # the gather reached the kvd: clear the
        #                        down flag (banner + 503 gate)
        latency = time.monotonic() - t0
        self._c_queries.inc(len(queries))
        self._c_requests.inc()
        self._h_e2e.observe(latency)
        with self._lock:
            self._latencies.append(latency)
            if adaptive and not per_worker:
                # anti-death-spiral: a zero-ANSWER gather under the
                # ADAPTIVE budget means the whole fleet got slower (or
                # error-only) under the learned quantile — with no
                # answers recorded the budget would freeze low and
                # every request would 504 forever. Escalate: each
                # consecutive miss doubles the penalty weight (4x the
                # failed budget, capped at the static timeout), and
                # after 3 straight misses the reservoir is flushed —
                # the old latency distribution no longer describes the
                # fleet, and an empty window drops the controller back
                # to warmup (static budget) to relearn from scratch.
                penalty = min(self.gather_timeout,
                              max(timeout, 1e-3) * 4.0)
                if latency < timeout:
                    # the gather ended BEFORE the budget — every worker
                    # error-replied fast, so the fleet is RESPONSIVE (a
                    # bad request, not a slow fleet): keep the budget-
                    # raising penalty sample, but never let a
                    # misbehaving client escalate to the flush and wipe
                    # a healthy learned distribution. A fleet that ran
                    # the budget OUT (even with some fast errors mixed
                    # in) counts as a real miss below.
                    self._reply_lat.append(penalty)
                else:
                    self._gather_misses += 1
                    if self._gather_misses >= 3:
                        self._reply_lat.clear()
                        self._gather_misses = 0
                    else:
                        self._reply_lat.extend(
                            [penalty] * (1 << (self._gather_misses - 1)))
            elif adaptive:
                # only an answer under the ADAPTIVE budget proves the
                # learned budget works again — explicit-timeout traffic
                # answering must not starve the 3-miss flush
                self._gather_misses = 0
        # breaker feed: a scattered-to worker that never replied inside
        # the budget is a miss — but only when the budget was a real
        # liveness test (see BREAKER_MIN_TIMEOUT_S): misses under a
        # collapsed adaptive budget are the controller shedding
        # stragglers, not the fleet dying
        if timeout >= self.BREAKER_MIN_TIMEOUT_S:
            for wid in targets:
                if wid not in answered:
                    self.breakers.record_failure(wid)
        self.traces.add_span(tid, "done", answered=len(per_worker),
                             latency_s=round(latency, 4))
        info = {"workers_answered": len(per_worker),
                "workers_asked": len(targets),
                "workers_skipped": len(self.worker_ids) - len(targets),
                "latency_s": latency, "errors": errors,
                "trace_id": tid}
        if not per_worker and errors and n_draining == len(errors):
            # every reply was a drain rejection (rolling restart caught
            # mid-window): tell the client WHEN retrying helps instead
            # of a bare 504 — the HTTP front maps this to 503
            info["fast_fail"] = True
            info["retry_after_s"] = round(
                max(1.0, self.breakers.retry_after_s()), 3)
        return ensemble_predictions(per_worker), info

    def _pick_stream_worker(self, queries: Optional[Sequence[Any]] = None,
                            exclude=()) -> Optional[str]:
        """Route one stream through the affinity/load router:
        prefix-affinity (HRW over the live pool) with load-aware
        fallback, minus workers this stream already failed on. The
        open/draining gating — including the at-most-ONE half-open
        probe when no closed candidate exists — lives in
        :meth:`Router.select` now. None when no candidate exists (the
        resumable-error path)."""
        self._refresh_membership()
        if self.breakers.any_draining():
            self._refresh_excluded_workers()  # rate-limited
        self._refresh_load_signals()
        key = self.router.affinity_key(queries)
        wid = self.router.select(key, exclude=exclude)
        if wid is None:
            # drained workers re-admit themselves via fresh stats, and
            # a scale event may have landed since the last poll
            self._refresh_membership(force=True)
            self._refresh_excluded_workers(force=True)
            wid = self.router.select(key, exclude=exclude)
        return wid

    #: retry hint handed out with the data-plane-down 503: a supervised
    #: kvd respawn + WAL replay lands within ~1-2s, so the first
    #: honored retry is expected to succeed
    DATA_PLANE_RETRY_S = 2.0

    def _dp_verdict(self) -> Dict[str, Any]:
        """The one data-plane-down 503 payload (gated and mid-request
        paths must not diverge: clients type on ``data_plane_down``)."""
        return {"error": "data plane unreachable (kvd down?) — "
                         "retry after the hint",
                "data_plane_down": True, "fast_fail": True,
                "retry_after_s": self.DATA_PLANE_RETRY_S}

    def _data_plane_lost(self, tid: str, err: Exception
                         ) -> Dict[str, Any]:
        """Record a hub op that exhausted its reconnect window and
        build the structured shed-style verdict: the HTTP front maps
        it to a 503 with ``retry_after_s`` + ``data_plane_down`` so
        clients back off instead of hanging into a gather timeout."""
        import logging

        self._c_dp_failures.inc()
        with self._lock:
            self._dp_down_at = time.monotonic()
        logging.getLogger(__name__).warning(
            "data plane unreachable (%s): fast-failing with "
            "retry_after_s=%.1f", err, self.DATA_PLANE_RETRY_S)
        self.traces.add_span(tid, "data_plane_down",
                             retry_after_s=self.DATA_PLANE_RETRY_S)
        return self._dp_verdict()

    def _data_plane_ok(self) -> None:
        with self._lock:
            self._dp_down_at = None

    def _data_plane_gate(self, tid: str) -> Optional[Dict[str, Any]]:
        """Fast-fail gate for requests arriving while the plane is
        known-down: one cheap TCP liveness probe (0.25s bound; a dead
        port refuses in ~0) decides — up → clear the flag and serve,
        down → an INSTANT structured 503 instead of re-stalling every
        request in the client's reconnect window. None = proceed."""
        with self._lock:
            if self._dp_down_at is None:
                return None
        host = getattr(self.hub, "_host", None)
        port = int(getattr(self.hub, "_port", 0) or 0)
        if not host or port <= 0:
            return None  # socketless hub (in-proc): nothing to gate
        import socket

        try:
            socket.create_connection((host, port), timeout=0.25).close()
        except OSError:
            self._c_dp_failures.inc()
            if tid:  # the HTTP front's SSE pre-flight gates with no
                # trace record yet
                self.traces.add_span(tid, "data_plane_down",
                                     gated=True,
                                     retry_after_s=self.DATA_PLANE_RETRY_S)
            return self._dp_verdict()
        self._data_plane_ok()  # the plane answered: serve normally
        return None

    def data_plane_health(self) -> Dict[str, Any]:
        """The /health ``data_plane`` block (feeds the dashboard
        banner)."""
        with self._lock:
            down_at = self._dp_down_at
        return {"down": down_at is not None,
                "down_for_s": (0.0 if down_at is None
                               else round(time.monotonic() - down_at,
                                          2)),
                "failures": int(self._c_dp_failures.value)}

    def _resumable_final(self, acc: Dict[int, str], n_queries: int,
                         error: str, qid: str, tid: str) -> Dict:
        """The structured terminal event for a stream that could not be
        failed over: the client SDK holds (qid + accumulated text) and
        can auto-resume by re-requesting with ``resume`` once
        ``retry_after_s`` elapses."""
        self._c_resumable.inc()
        return {"done": True, "error": error, "resumable": True,
                "qid": qid, "trace_id": tid,
                "retry_after_s": round(
                    max(0.05, self.breakers.retry_after_s()), 3),
                "partial": [acc.get(i) for i in range(n_queries)]}

    def predict_stream(self, queries: Sequence[Any],
                       timeout: Optional[float] = None,
                       sampling: Optional[Dict] = None,
                       trace_id: Optional[str] = None,
                       resume_partial: Optional[Sequence[Any]] = None,
                       slo: Optional[str] = None):
        """Streaming generation: yield per-query text deltas as the
        decode loop produces them, then a final event.

        Events, in order: zero or more ``{"delta": {qi: text}}`` (append
        ``text`` to query ``qi``'s output), at most one ``{"replace":
        {qi: text}}`` (the authoritative final text diverged from the
        streamed prefix — replace, don't append), then exactly one of
        ``{"done": True, "predictions": [...], "info"}`` or ``{"done":
        True, "error": ...}``. Every stream ends with a done event,
        including on hub failures mid-stream. Unlike :meth:`predict`,
        the request goes to ONE worker, placed by the affinity/load
        :class:`Router` (shared prefixes colocate on the worker holding
        their KV snapshot, ties break to the least-loaded replica): an
        ensemble over replicas has no meaningful token stream —
        mid-generation the replicas disagree, and averaging text deltas
        is nonsense. The
        reference has no streaming path at all (SURVEY.md §3.3 is
        strictly request/response); this is the continuous-batching
        engine's ``poll_partial`` surfaced end to end.

        ``timeout`` bounds the WHOLE stream; default
        ``STREAM_TIMEOUT`` (not ``gather_timeout``, which is sized for
        unary request/response — a generation legitimately runs for
        minutes).

        **Failover**: a dead/stale worker mid-stream (circuit-breaker
        trip or ``stream_silence_timeout_s`` of reply silence — never
        the whole-stream timeout) re-submits the request to a healthy
        worker with the already-emitted text as a forced prefix; the
        engine re-ingests it through chunked prefill and the stream
        resumes without duplicating or losing text. When no healthy
        worker exists the terminal event is a structured *resumable*
        error (``resumable`` + ``qid`` + ``partial`` +
        ``retry_after_s``) the client SDK can auto-resume via
        ``resume_partial`` — which is also the server side of a
        client-driven resume.

        ``slo``: admission class (see :meth:`predict`); a shed
        best-effort stream ends with a single
        ``{"done": True, "shed": True, "retry_after_s": ...}`` event
        (the HTTP front pre-flights the same verdict into a 503
        before the SSE response commits)."""
        t0 = time.monotonic()
        cls = normalize_slo(slo, default=self.default_slo)
        tid = sanitize_trace_id(trace_id) or mint_trace_id()
        # accumulated text per query index — the final predictions
        # message may carry tokens never sent as deltas (the request
        # finished mid-fused-step); the tail is emitted before "done".
        # A client resume seeds it with the partial text the previous
        # stream delivered (the failover machinery re-used end to end).
        acc: Dict[int, str] = {}
        if resume_partial:
            for i, p in enumerate(list(resume_partial)[:len(queries)]):
                if isinstance(p, str) and p:
                    acc[i] = p
        # the down-gate runs FIRST (the shed gate's load refresh
        # touches the hub): a known-down plane costs one 0.25s-bounded
        # probe, then an instant RESUMABLE terminal event carrying any
        # resume seed — the SDK honors retry_after_s and re-opens
        # against the respawned kvd
        gate = self._data_plane_gate(tid)
        if gate is not None:
            self._c_resumable.inc()
            yield {"done": True, "resumable": True, "qid": "",
                   "trace_id": tid,
                   "partial": [acc.get(i)
                               for i in range(len(queries))],
                   **gate}
            return
        shed = self.shed_verdict(cls)
        if shed is not None:
            yield {"done": True, **shed}
            return
        sampling = self._brownout_sampling(cls, sampling)
        timeout = self.STREAM_TIMEOUT if timeout is None else timeout
        deadline = t0 + timeout
        self.traces.start(tid, request_id="", span="received",
                          n_queries=len(queries), stream=True,
                          resumed=bool(acc))
        final: Optional[Dict[str, Any]] = None
        qid = ""
        tried: set = set()
        attempts = 0
        try:
            while final is None:  # one iteration per scatter attempt
                if attempts > self.max_stream_failovers:
                    final = self._resumable_final(
                        acc, len(queries),
                        "stream failover limit reached", qid, tid)
                    break
                wid = self._pick_stream_worker(queries, tried)
                if wid is None:
                    final = self._resumable_final(
                        acc, len(queries),
                        "no healthy worker available", qid, tid)
                    break
                if qid:  # leaving a previous attempt's reply queue
                    try:
                        self.hub.discard_prediction_queue(qid)
                    except Exception:
                        pass           # cleanup is best-effort
                attempts += 1
                qid = uuid.uuid4().hex
                remaining = deadline - time.monotonic()
                payload = {"id": qid, "queries": _stack(queries),
                           "stream": True,
                           "deadline_ts": time.time() + remaining,  # legacy-worker fallback; ttl_s+sent_ts is the sanctioned path
                           "ttl_s": float(remaining),
                           "sent_ts": time.time(), "trace_id": tid,
                           "slo": cls}
                if sampling:
                    payload["sampling"] = dict(sampling)
                fp = {str(i): t for i, t in acc.items() if t}
                if fp:
                    # the failover worker re-ingests the delivered text
                    # as a forced prompt prefix and continues the
                    # stream past it (TextDecodeEngine.submit)
                    payload["forced_prefix"] = fp
                elif all(isinstance(q, str) for q in queries) and \
                        any(len(q.split()) >= self.kv_ship_min_tokens
                            for q in queries):
                    # disaggregated prefill/decode: when the pool has a
                    # prefill-role worker, ship the prompt there FIRST
                    # (it chews chunked prefill and forwards the KV
                    # pages to `wid` over the hub) and mark the decode
                    # leg so `wid` holds admission briefly for the
                    # shipment — the decode worker's active streams
                    # never interleave with this prompt's prefill.
                    # Skipped on failover resumes (the forced prefix
                    # re-ingest covers a longer prompt than any
                    # shipment) and for non-text queries (no prompt to
                    # prefill). Every failure mode — prefill worker
                    # dead, shipment lost/late/mismatched — degrades
                    # to the decode worker's local re-prefill.
                    pw = self.router.select_prefill(exclude=tried)
                    if pw is not None:
                        payload["kv_from"] = pw
                        pre = {k: v for k, v in payload.items()
                               if k not in ("stream", "kv_from")}
                        pre["prefill_for"] = wid
                        try:
                            self.hub.push_query(pw, pack_message(pre))
                        except Exception:  # the leg is
                            # best-effort: a hub error here must not
                            # fail the request (the decode push below
                            # hasn't happened yet). Drop kv_from so
                            # the decode worker prefills immediately
                            # instead of waiting out kv_wait_s for a
                            # shipment that was never dispatched.
                            payload.pop("kv_from", None)
                            import logging

                            logging.getLogger(__name__).warning(
                                "prefill leg push to %s failed; "
                                "decode worker prefills locally", pw,
                                exc_info=True)
                        else:
                            self.traces.add_span(tid, "prefill_leg",
                                                 worker=pw, decode=wid)
                try:
                    self.hub.arm_reply_ttl(
                        qid, remaining + EXPIRY_SKEW_TOLERANCE_S + 30.0)
                except Exception:
                    pass           # the TTL is defense-in-depth
                self.hub.push_query(wid, pack_message(payload))
                self.traces.add_span(
                    tid, "scattered" if attempts == 1 else "failover",
                    worker=wid, request_id=qid)
                last_event = time.monotonic()
                failover_reason = ""
                saw_event = False  # any reply bytes from this worker
                while True:  # one attempt's event loop
                    now = time.monotonic()
                    remaining = deadline - now
                    if remaining <= 0:
                        final = {"done": True,
                                 "error": "stream timed out",
                                 "partial": [acc.get(i) for i in
                                             range(len(queries))]}
                        break
                    silence_left = (last_event
                                    + self.stream_silence_timeout_s
                                    - now)
                    if silence_left <= 0:
                        failover_reason = "reply silence"
                        break
                    if self.breakers.state(wid) == OPEN:
                        # concurrent traffic (or the staleness feed)
                        # already declared this worker dead — don't
                        # wait out our own silence window
                        failover_reason = "breaker open"
                        break
                    # rate-limited: a stream on a worker the control
                    # plane took out (a crash, a scale-down) learns it
                    # here even when no other request reads membership
                    self._refresh_membership()
                    if wid not in self.router:
                        # the pool scaled this worker out mid-stream
                        # (remove_worker / membership diff): fail over
                        # now with the delivered text as the forced
                        # prefix instead of riding a departing worker
                        failover_reason = "worker removed"
                        break
                    # bounded pop: wake at least once per second so a
                    # breaker trip is noticed promptly even while the
                    # silence budget is long
                    reply_bytes = self.hub.pop_prediction(
                        qid, min(remaining, silence_left, 1.0))
                    # the pop RETURNED (bytes or a clean timeout):
                    # the hub is reachable — clear the down flag the
                    # unary path clears at gather end (streams may be
                    # the only traffic)
                    self._data_plane_ok()
                    if reply_bytes is None:
                        continue  # re-check timeout/silence/breaker
                    saw_event = True
                    try:
                        reply = unpack_message(reply_bytes)
                        if not isinstance(reply, dict):
                            raise ValueError("reply is not a mapping")
                    except Exception:
                        # a corrupted payload from this worker is a
                        # failover trigger, not a dead stream
                        failover_reason = "undecodable reply"
                        break
                    if reply.get("error"):
                        if reply.get("draining"):
                            # voluntary drain rejection: route the
                            # stream elsewhere, no breaker penalty
                            self.breakers.set_draining(wid, True)
                            failover_reason = "worker draining"
                            break
                        if reply.get("expired"):
                            # the worker popped the query past its
                            # deadline and said so (structured, not a
                            # silent drop): fail over NOW — the
                            # remaining stream budget goes to a
                            # replica that can still answer, instead
                            # of waiting out the silence window
                            failover_reason = "expired at worker"
                            break
                        # same terminal contract as the timeout branch:
                        # the client learns what text is authoritative
                        final = {"done": True,
                                 "error": str(reply["error"]),
                                 "partial": [acc.get(i) for i in
                                             range(len(queries))]}
                        break
                    last_event = time.monotonic()
                    self.breakers.record_success(wid)
                    if "delta" in reply:
                        d = {int(k): str(v)
                             for k, v in dict(reply["delta"]).items()}
                        if not acc:  # first streamed token(s)
                            self.traces.add_span(tid, "first_delta")
                        for k, v in d.items():
                            acc[k] = acc.get(k, "") + v
                        yield {"delta": {str(k): v
                                         for k, v in d.items()}}
                        continue
                    preds = list(reply.get("predictions") or [])
                    tail: Dict[str, str] = {}
                    replace: Dict[str, str] = {}
                    for qi, full in enumerate(preds):
                        sent = acc.get(qi, "")
                        if not isinstance(full, str) or full == sent:
                            continue
                        if full.startswith(sent):
                            tail[str(qi)] = full[len(sent):]
                        else:  # streamed prefix diverged (shouldn't
                            # happen with append-only poll_partial;
                            # authoritative text wins, flagged as
                            # replace — NOT a delta a concatenating
                            # client would double-count)
                            replace[str(qi)] = full
                    if tail:
                        yield {"delta": tail}
                    if replace:
                        yield {"replace": replace}
                    latency = time.monotonic() - t0
                    final = {"done": True, "predictions": preds,
                             "info": {"worker_id":
                                      reply.get("worker_id"),
                                      "latency_s": latency,
                                      "failovers": attempts - 1,
                                      "trace_id": tid}}
                    self._c_queries.inc(len(queries))
                    self._c_requests.inc()
                    self._h_e2e.observe(latency)
                    self.traces.add_span(tid, "done",
                                         latency_s=round(latency, 4))
                    with self._lock:
                        self._latencies.append(latency)
                    break
                if final is None:
                    # this attempt's worker is gone: penalize it and
                    # re-submit with the delivered text as the prefix.
                    # Silence from a worker that never sent ANYTHING is
                    # ambiguous — a long prefill queued behind busy
                    # slots looks identical to death — so only a
                    # proven-then-silent worker feeds the breaker
                    # (saturation must not cascade into fast-fail 503s
                    # for unary traffic)
                    self._c_failover.inc()
                    if failover_reason not in (
                            "worker draining", "expired at worker") \
                            and saw_event:
                        # a drain rejection is voluntary and an
                        # expired rejection PROVES the worker alive
                        # and responsive — neither is breaker evidence
                        self.breakers.record_failure(wid)
                    tried.add(wid)
                    self.traces.add_span(tid, "worker_lost",
                                         worker=wid,
                                         reason=failover_reason)
        except ConnectionError as e:
            # the kvd went unreachable past the reconnect window
            # mid-stream: end with a RESUMABLE event carrying the
            # delivered text — the client SDK honors retry_after_s and
            # auto-resumes against the respawned (WAL-replayed) data
            # plane without re-paying delivered tokens
            verdict = self._data_plane_lost(tid, e)
            self._c_resumable.inc()
            final = {"done": True, "resumable": True,
                     "qid": qid, "trace_id": tid,
                     "partial": [acc.get(i)
                                 for i in range(len(queries))],
                     **verdict}
        except Exception as e:  # the SSE response is
            # already committed (200 + headers) when this generator
            # runs, so errors can't become an HTTP status: every
            # failure mode must surface as a terminal done event
            final = {"done": True, "error": f"{type(e).__name__}: {e}"}
        finally:
            if qid:
                try:
                    self.hub.discard_prediction_queue(qid)
                except Exception:
                    pass           # cleanup is best-effort
        yield final

    def stats(self) -> Dict[str, Any]:
        """Counters + latency percentiles over the recent-request window
        (the BASELINE p50 metric; surfaced in ``GET /health``)."""
        self._refresh_membership()
        with self._lock:
            lat = sorted(self._latencies)
        n_req = int(self._c_requests.value)
        n_q = int(self._c_queries.value)
        lat_sum = self._h_e2e.sum

        def pct(p: float) -> float:
            return nearest_rank(lat, p)

        workers: Dict[str, Any] = {}
        for wid in list(self.worker_ids):  # snapshot: membership may
            # change under a concurrent scale event
            try:
                s = self.hub.get_worker_stats(wid)
            except Exception:
                s = None       # health must not 500 on a hub hiccup
            if s is not None:
                workers[wid] = self._annotate_staleness(wid, s)
                self.router.observe(wid, s)  # /health readers keep the
                #                              load view fresh too
        return {"queries_served": n_q, "requests_served": n_req,
                "latency_sum_s": lat_sum, "latency_window_n": len(lat),
                "latency_p50_s": pct(0.50), "latency_p95_s": pct(0.95),
                "latency_p99_s": pct(0.99),
                # the same distribution from the FIXED-BUCKET histogram
                # (what /metrics exposes): coarser than the window
                # percentiles but covers the whole process lifetime —
                # the dashboard's e2e p50/p95 source
                "e2e_hist_p50_s": self._h_e2e.quantile(0.50),
                "e2e_hist_p95_s": self._h_e2e.quantile(0.95),
                "e2e_hist_count": self._h_e2e.count,
                # the latency/accuracy controller's live budget (equals
                # gather_timeout when adaptive gathering is off/warming)
                "gather_deadline_s": self._gather_deadline_s(),
                "adaptive_gather": self.adaptive_gather,
                # SLO / overload plane: class default, live backlog vs
                # the shed caps, shed decisions per class, and the
                # brownout ladder (docs/operations.md "Overload &
                # brownout")
                "slo": {"default": self.default_slo,
                        "shed_depths": dict(self.shed_depths),
                        "queue_depth": self.router.total_queue_depth(),
                        "requests_shed": int(self._c_shed.value),
                        **{k: int(v) for k, v in
                           self._shed_counts.snapshot().items()},
                        "brownout": self.brownout.snapshot()},
                # per-worker circuit-breaker state + fault counters
                # (trips/recoveries ride /metrics too)
                "breakers": self.breakers.snapshot(),
                # routing pool: membership, decision counters, affinity
                # hit rate, per-worker load view (docs/operations.md
                # "Scale-out & autoscaling")
                "router": self.router.snapshot(),
                "stream_failovers": int(self._c_failover.value),
                "requests_fast_failed": int(self._c_fast_fail.value),
                # data-plane survival: down flag + failure count (the
                # dashboard's data-plane banner reads this)
                "data_plane": self.data_plane_health(),
                # per-worker published counters (drop accounting, decode-
                # engine stats): a worker silently dropping expired
                # queries shows up HERE, not as mystery timeouts
                "workers": workers}

    def _annotate_staleness(self, wid: str, s: Dict[str, Any]
                            ) -> Dict[str, Any]:
        """Stamp ``stale`` onto a worker's published stats.

        Clock-step safe: the worker publishes a MONOTONIC ``uptime_s``
        and its own ``stale_after_s`` budget; this side tracks when the
        uptime last ADVANCED on its own monotonic clock. A worker whose
        uptime hasn't moved for longer than its budget is stale (dead,
        hung, or partitioned) — wall-clock ``published_at`` is kept in
        the payload for humans but no longer gates anything. Workers
        predating ``uptime_s`` fall back to the wall-clock test.

        The verdict also feeds the circuit-breaker board: a stale
        worker force-opens its breaker (the staleness signal is the
        liveness ground truth the gather-miss heuristic approximates),
        and the published ``draining`` flag sets/clears the board's
        drain exclusion — a respawned worker's fresh stats are what
        re-admit its id after a rolling restart."""
        s = dict(s)
        now = time.monotonic()
        up = s.get("uptime_s")
        budget = float(s.get("stale_after_s") or 60.0)
        if isinstance(up, (int, float)) and not isinstance(up, bool):
            with self._lock:
                last = self._worker_seen.get(wid)
                # any CHANGE refreshes the watermark: an advance is a
                # live publisher, and a DECREASE is a respawned worker
                # whose uptime restarted near 0 — without the `!=` a
                # healthy replacement would read stale until it outlived
                # its dead predecessor's uptime
                if last is None or up != last[0]:
                    self._worker_seen[wid] = (float(up), now)
                    s["stale"] = False
                else:
                    s["stale"] = (now - last[1]) > budget
        else:
            pub = s.get("published_at")
            s["stale"] = bool(
                isinstance(pub, (int, float))
                and time.time() - float(pub) > budget)  # fallback for workers predating the monotonic uptime_s pair
        if s["stale"]:
            self.breakers.record_stale(wid)
        if "draining" in s:
            self.breakers.set_draining(wid, bool(s["draining"]))
        return s


def _stack(queries: Sequence[Any]) -> Any:
    """Stack homogeneous array queries for compact transport; fall back to
    a list for ragged/object queries."""
    try:
        arrs = [np.asarray(q) for q in queries]
        # numeric/bool only: unicode/bytes/object arrays don't survive
        # the msgpack pytree codec (text queries ship as plain lists)
        if arrs and all(a.shape == arrs[0].shape and
                        a.dtype == arrs[0].dtype and
                        a.dtype.kind not in "USO" for a in arrs):
            return np.stack(arrs)
    except (TypeError, ValueError):
        pass
    return list(queries)


#: hard ceiling on client-supplied request timeouts: generous for any
#: legitimate generation (12x the default stream budget), small enough
#: that a stuck request eventually releases its handler thread + slot
MAX_REQUEST_TIMEOUT_S = 3600.0


class PredictorService:
    """HTTP front: POST /predict {queries} → {predictions}."""

    def __init__(self, predictor: Predictor, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.predictor = predictor
        self.http = JsonHttpService(host, port,
                                    registry=predictor.metrics)
        self.http.route("POST", "/predict", self._predict)
        self.http.route("POST", "/predict_stream", self._predict_stream)
        self.http.route("GET", "/health", self._health)
        # GET /metrics (Prometheus text) + GET /debug/requests?n=K
        mount_obs_routes(self.http, predictor.metrics, predictor.traces)

    @staticmethod
    def _trace_header(headers) -> Optional[str]:
        """The inbound ``X-Rafiki-Trace-Id``, case-insensitively (the
        stdlib handler hands headers through as sent)."""
        for k, v in (headers or {}).items():
            if k.lower() == "x-rafiki-trace-id":
                return v
        return None

    def start(self) -> Tuple[str, int]:
        return self.http.start()

    def stop(self) -> None:
        self.http.stop()

    @staticmethod
    def _parse_timeout(body) -> Tuple[bool, Any]:
        """(True, seconds-or-None) or (False, error). Absent/null means
        "server default"; an explicit non-numeric or non-positive value
        (e.g. 0) is a client error, not a silent fallback."""
        timeout = (body or {}).get("timeout")
        if timeout is None:
            return True, None
        if isinstance(timeout, bool):
            # bool subclasses int: {"timeout": true} would silently
            # become a 1-second deadline instead of a client error
            return False, "timeout must be a number"
        try:
            t = float(timeout)
        except (TypeError, ValueError):
            return False, "timeout must be a number"
        if not (t > 0.0) or not math.isfinite(t):
            # rejects 0, negatives, NaN, and Infinity — json.loads
            # accepts bare Infinity, and an inf deadline would pin a
            # handler thread (and a decode slot) forever
            return False, "timeout must be a finite number > 0"
        if t > MAX_REQUEST_TIMEOUT_S:
            # a huge FINITE deadline pins a handler thread (and a
            # decode slot) as effectively as inf would
            return False, (
                f"timeout must be <= {MAX_REQUEST_TIMEOUT_S:.0f}s")
        return True, t

    @staticmethod
    def _parse_slo(body) -> Tuple[bool, Any]:
        """(True, normalized-class-or-None) or (False, error). Absent/
        null means "job default"; an unknown class is a client error —
        silently serving a typo'd class as interactive would defeat
        the admission policy."""
        slo = (body or {}).get("slo")
        if slo is None:
            return True, None
        try:
            return True, normalize_slo(slo)
        except ValueError as e:
            return False, str(e)

    def _predict(self, _m, body, headers) -> Tuple[int, Any]:
        queries = (body or {}).get("queries")
        if not isinstance(queries, list) or not queries:
            return 400, {"error": "body must be {queries: [...]}"}
        ok, timeout = self._parse_timeout(body)
        if not ok:
            return 400, {"error": timeout}
        ok, slo = self._parse_slo(body)
        if not ok:
            return 400, {"error": slo}
        sampling = (body or {}).get("sampling")
        preds, info = self.predictor.predict(
            queries, timeout=timeout,
            sampling=sampling if isinstance(sampling, dict) else None,
            trace_id=self._trace_header(headers), slo=slo)
        if info["workers_answered"] == 0:
            if info.get("shed"):
                # structured SHED 503: overload backpressure on a
                # best-effort class — distinct from the breaker
                # fast-fail below (`shed: true` + brownout stage), so
                # clients can tell "come back later" from "fleet down"
                return 503, {"error": info["errors"][0]
                             if info.get("errors") else "shed",
                             "shed": True, "slo": info.get("slo"),
                             "brownout_stage":
                                 info.get("brownout_stage", 0),
                             "retry_after_s": info.get("retry_after_s",
                                                       1.0),
                             "info": info}
            if info.get("fast_fail"):
                # structured 503: every breaker open (or the whole
                # fleet draining, or the DATA PLANE down — flagged
                # top-level so HttpStatusError.data_plane_down types
                # it) — the client is told when retrying can possibly
                # help instead of burning its own timeout
                out = {"error": info["errors"][0]
                       if info.get("errors")
                       else "no worker available",
                       "retry_after_s": info.get("retry_after_s",
                                                 1.0),
                       "info": info}
                if info.get("data_plane_down"):
                    out["data_plane_down"] = True
                return 503, out
            return 504, {"error": "no worker answered in time",
                         "info": info}
        return 200, {"predictions": preds, "info": info}

    def _predict_stream(self, _m, body, headers) -> Tuple[int, Any]:
        """SSE: one ``data: <json>\\n\\n`` event per generator yield
        (token deltas, then the final done/error event)."""
        queries = (body or {}).get("queries")
        if not isinstance(queries, list) or not queries:
            return 400, {"error": "body must be {queries: [...]}"}
        ok, timeout = self._parse_timeout(body)
        if not ok:
            return 400, {"error": timeout}
        ok, slo = self._parse_slo(body)
        if not ok:
            return 400, {"error": slo}
        sampling = (body or {}).get("sampling")
        resume = (body or {}).get("resume")
        if resume is not None and not isinstance(resume, list):
            return 400, {"error": "resume must be a list of partial "
                                  "texts (one per query, null for "
                                  "none)"}
        gate = self.predictor._data_plane_gate("")
        if gate is not None:
            # pre-flight the down-gate into a REAL 503 (same reasoning
            # as the shed pre-flight below), typed for the SDK's
            # stream-open retry via data_plane_down
            return 503, {**gate, "info": {"data_plane_down": True}}
        shed = self.predictor.shed_verdict(slo)
        if shed is not None:
            # pre-flight the shed verdict into a REAL 503 — once the
            # SSE response commits (200 + headers) a shed could only
            # be a terminal event, invisible to plain HTTP clients
            return 503, {**shed, "info": {"shed": True}}
        events = self.predictor.predict_stream(
            queries, timeout=timeout,
            sampling=sampling if isinstance(sampling, dict) else None,
            trace_id=self._trace_header(headers),
            resume_partial=resume, slo=slo)

        def sse():
            import json as _json
            for ev in events:
                yield b"data: " + _json.dumps(ev).encode("utf-8") + b"\n\n"

        return 200, StreamResponse(sse())

    def _health(self, _m, _b, _h) -> Tuple[int, Any]:
        return 200, {"ok": True, **self.predictor.stats()}


def main(argv: Optional[list] = None) -> int:
    """Service entrypoint: ``python -m rafiki_tpu_torch.serving.predictor
    --config cfg.json`` (the JAX predictor's JSON). The services manager
    starts it with ``CUDA_VISIBLE_DEVICES=""``: the ensemble math is
    numpy and the process never touches a card."""
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="JSON: {worker_ids, kv_host, kv_port, host, "
                             "port, port_file, gather_timeout}")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    # shorter reconnect window than the worker default: the predictor
    # is the latency surface, and anything past a couple of seconds of
    # stalling belongs to the down-gate's instant 503, not a hang
    hub = KVQueueHub(cfg["kv_host"], int(cfg["kv_port"]),
                     retry_window_s=float(
                         cfg.get("hub_retry_window_s", 2.0)))
    predictor = Predictor(hub, cfg["worker_ids"],
                          gather_timeout=float(cfg.get("gather_timeout",
                                                       30.0)),
                          adaptive_gather=bool(
                              cfg.get("adaptive_gather")),
                          breaker_fail_threshold=int(
                              cfg.get("breaker_fail_threshold", 3)),
                          breaker_cooldown_s=float(
                              cfg.get("breaker_cooldown_s", 2.0)),
                          stream_silence_timeout_s=float(
                              cfg.get("stream_silence_timeout_s",
                                      30.0)),
                          max_stream_failovers=int(
                              cfg.get("max_stream_failovers", 2)),
                          # live pool membership key (the inference job
                          # id): the router follows autoscale events
                          # published by the control plane
                          pool_id=str(cfg.get("pool_id", "")),
                          affinity_prefix_chars=int(
                              cfg.get("affinity_prefix_chars",
                                      Router.DEFAULT_PREFIX_CHARS)),
                          # SLO / overload controls (admin budget keys
                          # SLO_DEFAULT / SLO_SHED_*_DEPTH /
                          # SLO_P95_TARGET_S / SLO_BACKGROUND_MAX_NEW)
                          default_slo=str(cfg.get("default_slo", "")),
                          slo_shed_depths=cfg.get("slo_shed_depths"),
                          brownout_target_p95_s=float(
                              cfg.get("brownout_target_p95_s", 0.0)),
                          brownout_clamp_max_new=int(
                              cfg.get("brownout_clamp_max_new", 16)))
    svc = PredictorService(predictor, cfg.get("host", "127.0.0.1"),
                           int(cfg.get("port", 0)))
    host, port = svc.start()
    if cfg.get("port_file"):
        with open(cfg["port_file"], "w") as f:
            f.write(str(port))
    print(f"predictor on {host}:{port}", flush=True)
    svc.http.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
