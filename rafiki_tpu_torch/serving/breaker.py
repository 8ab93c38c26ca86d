"""Per-worker circuit breakers for the serving request path.

The port's own copy of ``rafiki_tpu/serving/breaker.py`` (``CLOSED``,
``OPEN``, ``HALF_OPEN``, ``BreakerBoard``). The predictor's gather would
treat a dead worker exactly like a slow one, burning the whole gather
budget on every request; this board is the request-path failure
detector:

- one closed/open/half-open state machine per ``worker_id``, fed by
  gather answer/miss outcomes and by the monotonic ``uptime_s``
  staleness signal the workers publish;
- **open** workers are skipped at scatter time (the gather quorum
  shrinks accordingly);
- after a cooldown one request is let through as a **half-open probe**;
  its outcome closes the breaker or re-opens it with an exponentially
  backed-off cooldown;
- when every worker is open the predictor fast-fails with a structured
  503 + ``retry_after_s`` instead of burning the timeout.

Draining workers ride the same board: a ``draining`` flag excludes a
worker from scatter without counting as a failure.

Thread-safety: one lock for the whole board.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from rafiki_tpu_torch.obs.metrics import StatsMap

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Breaker:
    """State for one worker. Touched only under the board's lock."""

    __slots__ = ("state", "fails", "opened_at", "cooldown_s",
                 "probe_at", "draining")

    def __init__(self) -> None:
        self.state = CLOSED
        self.fails = 0          # consecutive misses while closed
        self.opened_at = 0.0    # board-clock time of the last trip
        self.cooldown_s = 0.0   # current open→probe wait
        self.probe_at = 0.0     # board-clock time the probe was issued
        self.draining = False


class BreakerBoard:
    """Circuit breakers for a (dynamic) fleet of worker ids.

    Membership follows the pool: :meth:`add_worker` admits a scale-up
    replica (CLOSED), :meth:`remove_worker` drops a departed one —
    outcome feeds for non-members are no-ops so an in-flight gather
    finishing after a scale-down cannot resurrect the id.

    ``fail_threshold`` consecutive misses trip a breaker open;
    ``cooldown_s`` later one probe is admitted (half-open), and each
    failed probe doubles the cooldown up to ``max_cooldown_s`` — a
    worker that stays dead costs one probe per cooldown, not a timeout
    per request. ``now`` is injectable for deterministic tests.
    """

    def __init__(self, worker_ids: Sequence[str],
                 fail_threshold: int = 3, cooldown_s: float = 2.0,
                 max_cooldown_s: float = 60.0,
                 now: Callable[[], float] = time.monotonic) -> None:
        self.fail_threshold = max(1, int(fail_threshold))
        self.cooldown_s = max(0.05, float(cooldown_s))
        self.max_cooldown_s = max(self.cooldown_s, float(max_cooldown_s))
        self._now = now
        self._lock = threading.Lock()
        self._b: Dict[str, _Breaker] = {w: _Breaker()
                                        for w in worker_ids}
        #: trip/recovery accounting, registry-ready (the predictor
        #: merges these onto its /metrics)
        self.counters = StatsMap({"breaker_trips": 0,
                                  "breaker_recoveries": 0,
                                  "breaker_probes": 0,
                                  "breaker_stale_trips": 0})

    def _get(self, wid: str) -> Optional[_Breaker]:
        """The worker's breaker, or None for a non-member. Unknown ids
        are NOT lazily created: after :meth:`remove_worker` a straggling
        outcome feed (an in-flight gather finishing) must not resurrect
        state for a worker the pool no longer contains — ``targets()``
        iterates this dict, so a resurrected entry would be scattered
        to forever."""
        return self._b.get(wid)

    # ---- dynamic membership (pool scale-out) ----
    def add_worker(self, wid: str) -> None:
        """Admit a new pool member; it starts CLOSED."""
        with self._lock:
            if wid not in self._b:
                self._b[wid] = _Breaker()

    def remove_worker(self, wid: str) -> None:
        """Drop a departed member's breaker state entirely (scale-down,
        not an outage: no trip is recorded)."""
        with self._lock:
            self._b.pop(wid, None)

    # ---- scatter-time gating ----
    def _due(self, b: _Breaker, now: float) -> bool:
        """True when an OPEN breaker's cooldown has elapsed, or a
        HALF_OPEN probe went unanswered long enough to re-issue (the
        probe request's process may have died mid-gather)."""
        if b.state == OPEN:
            return now - b.opened_at >= b.cooldown_s
        if b.state == HALF_OPEN:
            return now - b.probe_at >= max(b.cooldown_s, self.cooldown_s)
        return False

    def targets(self) -> List[str]:
        """Worker ids a new request may scatter to right now: closed
        breakers plus open ones whose probe is due (issuing the probe —
        the caller's scatter IS the probe). Draining workers are
        excluded. Order follows construction order."""
        now = self._now()
        out: List[str] = []
        with self._lock:
            for wid, b in self._b.items():
                if b.draining:
                    continue
                if b.state == CLOSED:
                    out.append(wid)
                elif self._due(b, now):
                    b.state = HALF_OPEN
                    b.probe_at = now
                    self.counters.inc("breaker_probes")
                    out.append(wid)
        return out

    def allow(self, wid: str) -> bool:
        """Single-worker variant of :meth:`targets` (stream routing).
        Non-members are never admittable."""
        now = self._now()
        with self._lock:
            b = self._get(wid)
            if b is None or b.draining:
                return False
            if b.state == CLOSED:
                return True
            if self._due(b, now):
                b.state = HALF_OPEN
                b.probe_at = now
                self.counters.inc("breaker_probes")
                return True
            return False

    # ---- outcome feeds ----
    def record_success(self, wid: str) -> None:
        """An answer (or stream delta) arrived from ``wid``: close a
        half-open breaker (probe succeeded), clear the miss streak. A
        reply also proves the worker is past any drain it advertised
        earlier only when it is a real answer — callers clear draining
        explicitly via :meth:`set_draining`."""
        with self._lock:
            b = self._get(wid)
            if b is None:
                return  # removed mid-gather: nothing to close
            if b.state != CLOSED:
                self.counters.inc("breaker_recoveries")
            b.state = CLOSED
            b.fails = 0
            b.cooldown_s = 0.0

    def record_failure(self, wid: str) -> None:
        """A gather miss / stream silence from ``wid``: trips the
        breaker after ``fail_threshold`` consecutive misses; a failed
        half-open probe re-opens immediately with doubled cooldown."""
        now = self._now()
        with self._lock:
            b = self._get(wid)
            if b is None:
                return  # removed mid-gather: a miss on a non-member
            if b.state == HALF_OPEN:
                b.cooldown_s = min(self.max_cooldown_s,
                                   max(self.cooldown_s,
                                       b.cooldown_s * 2.0))
                b.state = OPEN
                b.opened_at = now
                self.counters.inc("breaker_trips")
                return
            b.fails += 1
            if b.state == CLOSED and b.fails >= self.fail_threshold:
                b.state = OPEN
                b.opened_at = now
                b.cooldown_s = self.cooldown_s
                self.counters.inc("breaker_trips")

    def record_stale(self, wid: str) -> None:
        """The worker's published ``uptime_s`` stopped advancing past
        its own staleness budget (the monotonic liveness signal):
        force the breaker open without waiting for miss accumulation —
        a stale publisher is dead/hung/partitioned, not slow."""
        now = self._now()
        with self._lock:
            b = self._get(wid)
            if b is not None and b.state == CLOSED:
                b.state = OPEN
                b.opened_at = now
                b.cooldown_s = b.cooldown_s or self.cooldown_s
                self.counters.inc("breaker_trips")
                self.counters.inc("breaker_stale_trips")

    def set_draining(self, wid: str, draining: bool) -> None:
        with self._lock:
            b = self._get(wid)
            if b is not None:
                b.draining = bool(draining)

    def any_draining(self) -> bool:
        """O(n) under the lock — the scatter path's cheap guard for
        'is a drain-exclusion refresh even worth considering'."""
        with self._lock:
            return any(b.draining for b in self._b.values())

    # ---- read-out ----
    def retry_after_s(self) -> float:
        """Seconds until the next half-open probe is due across the
        fleet — the ``retry_after_s`` a fast-failed 503 carries. 0 when
        some worker is already admittable (callers shouldn't have
        fast-failed); the base cooldown when every breaker is draining
        (drain ends on its own schedule, the cooldown is a sane poll
        interval)."""
        now = self._now()
        best: Optional[float] = None
        with self._lock:
            for b in self._b.values():
                if b.draining:
                    continue
                if b.state == CLOSED or self._due(b, now):
                    return 0.0
                if b.state == OPEN:
                    wait = b.cooldown_s - (now - b.opened_at)
                else:  # HALF_OPEN: probe outstanding, re-issue later
                    wait = max(b.cooldown_s, self.cooldown_s) \
                        - (now - b.probe_at)
                if best is None or wait < best:
                    best = wait
        return max(0.0, best if best is not None else self.cooldown_s)

    def state(self, wid: str) -> str:
        with self._lock:
            b = self._b.get(wid)
            return b.state if b is not None else CLOSED

    def n_open(self) -> int:
        """Workers currently not admittable (open/half-open/draining) —
        the live gauge on /metrics."""
        with self._lock:
            return sum(1 for b in self._b.values()
                       if b.draining or b.state != CLOSED)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-worker breaker state for /health."""
        with self._lock:
            return {wid: {"state": b.state, "fails": b.fails,
                          "draining": b.draining,
                          "cooldown_s": round(b.cooldown_s, 3)}
                    for wid, b in self._b.items()}
