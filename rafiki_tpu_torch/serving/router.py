"""Affinity-aware, load-balanced request routing over a worker pool.

The port's own copy of ``rafiki_tpu/serving/router.py`` (``Router``).
The predictor's streaming path places each request on ONE worker:

- **Prefix-cache affinity.** The router hashes each request's affinity
  key (its leading ``prefix_chars`` characters) with rendezvous (HRW)
  hashing over the pool: identical prefixes always land on the same
  worker, and a membership change remaps only the keys owned by the
  departed or arriving worker.
- **Live load.** Workers publish ``kv_pages_used`` / ``kv_pages_total``,
  ``admission_stalls`` and TTFT/queue p95s. When the affinity target is
  open, draining or saturated, the router falls back to the
  least-loaded healthy worker, ranked on (stalling?, queue depth,
  page-pool ratio, queue-wait p95).

Health gating rides the predictor's :class:`BreakerBoard`: only CLOSED,
non-draining workers are normal candidates; with none, at most ONE due
open breaker is probed. Decision counters and the affinity hit rate ride
the predictor's ``/metrics``. One lock guards members and load
snapshots; the board has its own.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.serving.breaker import CLOSED, BreakerBoard


def _signal(stats: Mapping[str, Any], name: str) -> Optional[float]:
    """A numeric load signal from a published stats dict, accepting
    both the hub-publish spelling (``engine_kv_pages_used``) and the
    bare engine spelling (``kv_pages_used``)."""
    for key in (f"engine_{name}", name):
        v = stats.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


class _Load:
    """Latest observed load signals for one worker."""

    __slots__ = ("pages_ratio", "stalls_total", "stalled_until",
                 "queue_depth", "wait_p95_s", "class_backlog", "role",
                 "at")

    def __init__(self) -> None:
        #: disaggregated serving role the worker publishes
        #: ("unified" / "prefill" / "decode"); unknown until the first
        #: stats sample — treated as unified (serves everything)
        self.role = "unified"
        self.pages_ratio = 0.0    # kv_pages_used / kv_pages_total
        #: cumulative admission_stalls counter; None until the first
        #: sample — the first sight is a BASELINE, not growth (a fresh
        #: predictor must not read a long-lived worker's historical
        #: stall total as "stalling right now")
        self.stalls_total: Optional[float] = None
        self.stalled_until = 0.0  # recent stall growth holds 'saturated'
        self.queue_depth = 0      # unpopped messages on the query queue
        self.wait_p95_s = 0.0     # queue-wait p95 (fallback: TTFT p95)
        #: engine-side per-class admission backlog (the `queued_*`
        #: gauges): workers pop the hub eagerly, so the REAL backlog
        #: under overload sits in the engine's class queue, not the
        #: hub — the SLO shed gate reads it from here
        self.class_backlog: Dict[str, int] = {}
        self.at = 0.0


class Router:
    """Single-worker placement: HRW prefix affinity, load-aware
    fallback, breaker-gated health."""

    #: affinity target with its page pool this full is *saturated*:
    #: placing there trades a prefill for an admission stall
    SATURATION_PAGES_RATIO = 0.95
    #: a stall-counter increase marks the worker saturated this long
    #: (stalls are cumulative; the hold turns deltas into a level)
    STALL_HOLD_S = 5.0
    #: affinity-key granularity: requests sharing this many leading
    #: characters colocate (the shared-system-prefix scale; snapshot
    #: prefixes shorter than this still hit — their requests agree on
    #: far more than the key)
    DEFAULT_PREFIX_CHARS = 64

    def __init__(self, worker_ids: Sequence[str], board: BreakerBoard,
                 prefix_chars: int = DEFAULT_PREFIX_CHARS,
                 now: Callable[[], float] = time.monotonic) -> None:
        self._board = board
        self._now = now
        self.prefix_chars = max(1, int(prefix_chars))
        self._lock = threading.Lock()
        self._members: List[str] = list(dict.fromkeys(worker_ids))
        self._load: Dict[str, _Load] = {}
        #: routing decisions, registry-ready (the predictor merges
        #: these onto its /metrics)
        self.counters = StatsMap({
            "router_affinity_hits": 0,       # key's HRW owner chosen
            "router_affinity_redirects": 0,  # owner unusable → fallback
            "router_least_loaded_picks": 0,  # load-ranked fallback used
            "router_probe_picks": 0,         # no closed worker: this
            #                                  request is the half-open
            #                                  probe
            "router_no_candidate": 0,        # nothing selectable
            "router_prefill_picks": 0})      # prefill legs placed on a
        #                                      prefill-role worker

    # ---- membership ----
    def members(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def __contains__(self, wid: str) -> bool:
        with self._lock:
            return wid in self._members

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def add_worker(self, wid: str) -> None:
        with self._lock:
            if wid not in self._members:
                self._members.append(wid)

    def remove_worker(self, wid: str) -> None:
        with self._lock:
            if wid in self._members:
                self._members.remove(wid)
            self._load.pop(wid, None)

    # ---- affinity ----
    def affinity_key(self, queries: Optional[Sequence[Any]]
                     ) -> Optional[str]:
        """The request's affinity key: the leading ``prefix_chars``
        characters of its first text query. Non-text queries
        (classification vectors) have no prefix cache to hit — None,
        and the request is placed purely by load."""
        if not queries:
            return None
        q = queries[0]
        if not isinstance(q, str) or not q:
            return None
        return q[:self.prefix_chars]

    @staticmethod
    def _score(key: str, wid: str) -> int:
        """HRW weight of (key, worker): highest score owns the key.
        A worker leaving only remaps the keys *it* owned (everyone
        else's top pick is unchanged); a worker joining only claims
        the keys it now scores highest on."""
        h = hashlib.blake2b(f"{key}\x00{wid}".encode("utf-8", "replace"),
                            digest_size=8)
        return int.from_bytes(h.digest(), "big")

    def owner(self, key: str, exclude: Sequence[str] = ()) -> Optional[str]:
        """The key's HRW owner among current members minus ``exclude``
        (for a failover retry the natural successor owner — still the
        minimal remap)."""
        with self._lock:
            cands = [w for w in self._members if w not in exclude]
        if not cands:
            return None
        return max(cands, key=lambda w: self._score(key, w))

    # ---- load signals ----
    def observe(self, wid: str, stats: Mapping[str, Any]) -> None:
        """Fold a worker's published stats into its load snapshot (the
        predictor feeds these on its rate-limited refresh)."""
        now = self._now()
        used = _signal(stats, "kv_pages_used")
        total = _signal(stats, "kv_pages_total")
        stalls = _signal(stats, "admission_stalls")
        p95 = stats.get("queue_p95_s")
        if not isinstance(p95, (int, float)) or isinstance(p95, bool):
            p95 = stats.get("ttft_p95_s")
        with self._lock:
            ld = self._load.get(wid)
            if ld is None:
                ld = self._load[wid] = _Load()
            if used is not None and total:
                ld.pages_ratio = max(0.0, used / total)
            if stalls is not None:
                if ld.stalls_total is not None and \
                        stalls > ld.stalls_total:
                    # the counter moved since last look: admissions are
                    # stalling NOW — hold the saturation verdict
                    ld.stalled_until = now + self.STALL_HOLD_S
                ld.stalls_total = stalls
            if isinstance(p95, (int, float)) and not isinstance(p95, bool):
                ld.wait_p95_s = float(p95)
            role = stats.get("role")
            if isinstance(role, str) and role in ("unified", "prefill",
                                                  "decode"):
                ld.role = role
            for cls in ("interactive", "batch", "background"):
                q = _signal(stats, f"queued_{cls}")
                if q is not None:
                    ld.class_backlog[cls] = int(q)
            ld.at = now

    def observe_queue_depth(self, wid: str, depth: int) -> None:
        with self._lock:
            ld = self._load.get(wid)
            if ld is None:
                ld = self._load[wid] = _Load()
            ld.queue_depth = max(0, int(depth))

    def _backlog_members(self) -> List[str]:
        """Members whose backlog gauges are TRUSTWORTHY serving
        backlog: breaker CLOSED only. A dead/stale worker's breaker
        force-opens, and its last-published ``queued_*`` gauges
        describe a corpse — summing them would pin the shed gate shut
        on an idle fleet (the same corpse-pins-the-controller hazard
        as the brownout p95 feed). Prefill-role workers are excluded
        too: a disaggregated request already counts once on its decode
        worker, and summing the prefill leg's queues would double-
        count every shipment (shedding below the operator's depth cap
        while decode capacity sits idle)."""
        snap = self._board.snapshot()
        with self._lock:
            return [w for w in self._members
                    if (snap.get(w) or {}).get("state") == CLOSED
                    and (w not in self._load
                         or self._load[w].role != "prefill")]

    def total_queue_depth(self) -> int:
        """Unpopped query-queue messages summed over live (breaker-
        CLOSED) members — the predictor's SLO shed gate compares this
        against the per-class depth caps (a fleet-level backlog
        level, refreshed on the same rate-limited tick as the load
        view)."""
        members = self._backlog_members()
        with self._lock:
            return sum(self._load[w].queue_depth for w in members
                       if w in self._load)

    def class_backlog(self, slo: str) -> int:
        """Fleet-wide ENGINE admission backlog for one SLO class (the
        live members' published ``queued_<class>`` gauges summed).
        Workers pop the hub eagerly, so under overload the backlog
        lives in the engines' class queues — hub depth alone
        under-measures it."""
        members = self._backlog_members()
        with self._lock:
            return sum(self._load[w].class_backlog.get(slo, 0)
                       for w in members if w in self._load)

    def saturated(self, wid: str) -> bool:
        """True when placing a request on ``wid`` would likely stall at
        admission: page pool ~full, or its stall counter grew within
        the last ``STALL_HOLD_S``. Workers with no signals yet (fresh
        scale-up) read as unsaturated — new capacity should attract
        traffic."""
        now = self._now()
        with self._lock:
            ld = self._load.get(wid)
            if ld is None:
                return False
            return (ld.pages_ratio >= self.SATURATION_PAGES_RATIO
                    or now < ld.stalled_until)

    def _rank(self, wid: str, idx: int) -> Tuple:
        """Least-loaded ordering: stalling last, then queue depth,
        page-pool pressure, queue-wait p95; member index keeps ties
        deterministic."""
        now = self._now()
        with self._lock:
            ld = self._load.get(wid)
            if ld is None:
                return (0, 0, 0.0, 0.0, idx)
            return (1 if now < ld.stalled_until else 0, ld.queue_depth,
                    ld.pages_ratio, ld.wait_p95_s, idx)

    def role_of(self, wid: str) -> str:
        """The worker's published disaggregation role (``unified``
        until its first stats sample says otherwise)."""
        with self._lock:
            ld = self._load.get(wid)
            return ld.role if ld is not None else "unified"

    # ---- selection ----
    def select(self, key: Optional[str] = None,
               exclude: Sequence[str] = ()) -> Optional[str]:
        """Pick ONE worker for a request's DECODE leg.

        Order: the key's HRW owner when healthy and unsaturated
        (affinity hit) → least-loaded healthy worker (redirect /
        keyless placement) → at most one due half-open probe → None
        (no candidate; the caller's resumable-error path).

        ``prefill``-role workers are excluded: they exist to chew
        prompts and ship KV pages (:meth:`select_prefill`), and a
        stream placed there would decode on the wrong side of the
        split. The HRW hash ALSO skips them, so a worker flipping
        role only remaps its own keys — the affinity minimal-remap
        property survives disaggregation. When the pool is prefill-
        only (a misconfiguration), they serve anyway: degraded beats
        unservable."""
        with self._lock:
            members = list(self._members)
            serving = [w for w in members
                       if w not in exclude
                       and (w not in self._load
                            or self._load[w].role != "prefill")]
        cands = serving or [w for w in members if w not in exclude]
        if not cands:
            self.counters.inc("router_no_candidate")
            return None
        snap = self._board.snapshot()

        def _healthy(w: str) -> bool:
            st = snap.get(w)
            return (st is not None and st.get("state") == CLOSED
                    and not st.get("draining"))

        healthy = [w for w in cands if _healthy(w)]
        if healthy:
            if key is not None:
                target = max(cands, key=lambda w: self._score(key, w))
                if target in healthy and not self.saturated(target):
                    self.counters.inc("router_affinity_hits")
                    return target
                self.counters.inc("router_affinity_redirects")
            open_pool = [w for w in healthy if not self.saturated(w)]
            pool = open_pool or healthy  # all saturated: overload is
            #                              everywhere, pick the least bad
            pick = min(pool,
                       key=lambda w: self._rank(w, members.index(w)))
            self.counters.inc("router_least_loaded_picks")
            return pick
        for w in cands:
            if self._board.allow(w):
                # this request IS the half-open probe (allow() flips
                # exactly one due breaker per call)
                self.counters.inc("router_probe_picks")
                return w
        self.counters.inc("router_no_candidate")
        return None

    def select_prefill(self, exclude: Sequence[str] = ()
                       ) -> Optional[str]:
        """Pick the worker for a request's PREFILL leg: the
        least-loaded healthy ``prefill``-role member, or None when the
        pool has none (the caller serves unified — prefill runs on the
        decode worker exactly as before disaggregation). No probe
        fallback here: the prefill leg is an optimization, and probing
        a sick worker with it would spend the half-open budget on
        traffic whose failure is invisible (fire-and-forget)."""
        with self._lock:
            members = list(self._members)
            cands = [w for w in members
                     if w not in exclude and w in self._load
                     and self._load[w].role == "prefill"]
        if not cands:
            return None
        snap = self._board.snapshot()
        healthy = [w for w in cands
                   if (st := snap.get(w)) is not None
                   and st.get("state") == CLOSED
                   and not st.get("draining")]
        if not healthy:
            return None
        pick = min(healthy,
                   key=lambda w: self._rank(w, members.index(w)))
        self.counters.inc("router_prefill_picks")
        return pick

    # ---- read-out ----
    def affinity_hit_rate(self) -> float:
        """Fraction of keyed selections that landed on their HRW owner
        (the prefix-cache hit proxy the /metrics gauge exposes). 0.0
        before any keyed traffic."""
        hits = float(self.counters["router_affinity_hits"])
        misses = float(self.counters["router_affinity_redirects"])
        total = hits + misses
        return hits / total if total else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """Router state for /health: membership + decision counters +
        hit rate + per-worker load view."""
        now = self._now()
        with self._lock:
            load = {wid: {"pages_ratio": round(ld.pages_ratio, 4),
                          "queue_depth": ld.queue_depth,
                          "wait_p95_s": round(ld.wait_p95_s, 4),
                          "stalled": now < ld.stalled_until,
                          "role": ld.role}
                    for wid, ld in self._load.items()}
            members = list(self._members)
        return {"members": members,
                "affinity_hit_rate": round(self.affinity_hit_rate(), 4),
                **{k: int(v) for k, v in self.counters.snapshot().items()},
                "load": load}
