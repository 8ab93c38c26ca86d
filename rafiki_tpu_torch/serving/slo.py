"""SLO classes and the class-aware admission queue.

The port's own copy of what ``DecodeEngine`` admission and preemption
use from ``rafiki_tpu/serving/slo.py``: ``SLO_CLASSES``/``SLO_PRIORITY``,
``DEFAULT_SLO``, ``normalize_slo``, ``slo_priority``, the eviction policy
(``evictable_occupants``, ``preemption_victim``) and ``ClassQueue``; and
what the predictor's shed gate uses: ``BROWNOUT_STAGES`` and
``BrownoutController``, the hysteresis ladder.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, Optional, Tuple

#: priority order, highest first: admission serves interactive before
#: batch before background; preemption evicts in the reverse order.
SLO_CLASSES: Tuple[str, ...] = ("interactive", "batch", "background")

#: class -> rank (lower = more urgent)
SLO_PRIORITY: Dict[str, int] = {c: i for i, c in enumerate(SLO_CLASSES)}

DEFAULT_SLO = "interactive"

#: stage index -> operator-facing name (metrics expose the index; the
#: dashboard and /health show the name)
BROWNOUT_STAGES: Tuple[str, ...] = ("normal", "capped", "clamped",
                                    "paused")


def normalize_slo(value: Any, default: str = DEFAULT_SLO) -> str:
    """The one SLO-class validator: ``None``/empty → ``default``;
    anything else must (case-insensitively) name one of
    :data:`SLO_CLASSES` or ``ValueError``."""
    if value is None:
        return default
    s = str(value).strip().lower()
    if not s:
        return default
    if s not in SLO_PRIORITY:
        raise ValueError(
            f"unknown SLO class {value!r} (one of: "
            f"{', '.join(SLO_CLASSES)})")
    return s


def slo_priority(slo: str) -> int:
    """Rank of a class (0 = most urgent); unknown classes rank last."""
    return SLO_PRIORITY.get(slo, len(SLO_CLASSES))


def evictable_occupants(cls: str, occupants):
    """The occupants a ``cls`` head may preempt: strictly lower class,
    not shielded (aged promotions are immune). ``occupants`` is an
    iterable of ``(handle, slo, seq, shielded)``; returns the matching
    ``(handle, slo, seq)`` triples. The one eviction predicate: the
    engine's feasibility check and its victim selection both go through
    it, so the reclaim loop that relies on them agreeing terminates."""
    p = slo_priority(cls)
    return [(h, s, q) for h, s, q, shielded in occupants
            if not shielded and slo_priority(s) > p]


def preemption_victim(cls: str, occupants) -> Optional[Any]:
    """The one occupant to evict for a ``cls`` head: the youngest
    (highest seq) member of the lowest evictable class. None when
    nothing ranks below ``cls``."""
    cands = evictable_occupants(cls, occupants)
    if not cands:
        return None
    return max(cands, key=lambda t: (slo_priority(t[1]), t[2]))[0]


class ClassQueue:
    """Per-class FIFO admission queue with starvation-bounding aging.

    Not thread-safe on purpose: the decode engine mutates it under its
    own admission lock.

    Aging: every :meth:`pop` that serves class X increments a skip
    counter on every lower-priority class that had a waiter; a class
    whose counter reaches ``aging_skips`` is served next regardless of
    priority (and its counter resets)."""

    #: admissions a lower class may be skipped before force-promotion
    DEFAULT_AGING_SKIPS = 16

    def __init__(self, aging_skips: int = DEFAULT_AGING_SKIPS) -> None:
        self.aging_skips = max(1, int(aging_skips))
        self._qs: Dict[str, Deque[Any]] = {
            c: collections.deque() for c in SLO_CLASSES}
        self._skips: Dict[str, int] = {c: 0 for c in SLO_CLASSES}
        #: force-promotions performed (the aging mechanism firing)
        self.promotions = 0
        #: did the last pop fire the aging mechanism?
        self.last_pop_promoted = False

    def push(self, slo: str, item: Any, front: bool = False) -> None:
        """Enqueue ``item`` under ``slo`` (validated); ``front`` puts it
        ahead of its class peers."""
        q = self._qs[normalize_slo(slo)]
        if front:
            q.appendleft(item)
        else:
            q.append(item)

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def __bool__(self) -> bool:
        return any(self._qs.values())

    def depth(self, slo: str) -> int:
        return len(self._qs[normalize_slo(slo)])

    def depths(self) -> Dict[str, int]:
        return {c: len(q) for c, q in self._qs.items()}

    def next_class(self) -> Optional[str]:
        """The class the next :meth:`pop` will serve: an aged class
        first (most-skipped wins ties), else the highest-priority
        non-empty one. None when empty."""
        aged = [c for c in SLO_CLASSES
                if self._qs[c] and self._skips[c] >= self.aging_skips]
        if aged:
            return max(aged, key=lambda c: self._skips[c])
        for c in SLO_CLASSES:
            if self._qs[c]:
                return c
        return None

    def peek(self) -> Optional[Tuple[str, Any]]:
        """(class, head item) the next pop would return, without
        popping."""
        c = self.next_class()
        if c is None:
            return None
        return c, self._qs[c][0]

    def pop(self) -> Optional[Tuple[str, Any]]:
        """Serve the next item (see :meth:`next_class`), updating the
        aging counters."""
        c = self.next_class()
        if c is None:
            return None
        self.last_pop_promoted = bool(
            self._skips[c] >= self.aging_skips and any(
                self._qs[h] for h in SLO_CLASSES
                if SLO_PRIORITY[h] < SLO_PRIORITY[c]))
        if self.last_pop_promoted:
            self.promotions += 1
        item = self._qs[c].popleft()
        self._skips[c] = 0
        for lower in SLO_CLASSES:
            if SLO_PRIORITY[lower] > SLO_PRIORITY[c] and self._qs[lower]:
                self._skips[lower] += 1
        return c, item

    def clear(self) -> None:
        for c in SLO_CLASSES:
            self._qs[c].clear()
            self._skips[c] = 0


class BrownoutController:
    """Hysteresis ladder over degradation stages, fed by the live
    interactive latency p95.

    Stages (index is the ``brownout_stage`` gauge):

    0. **normal** — no degradation.
    1. **capped** — best-effort (batch + background) shed caps halve.
    2. **clamped** — background ``max_new`` additionally clamped to
       ``clamp_max_new`` (long best-effort generations release their
       slots/pages sooner).
    3. **paused** — background is shed outright (structured 503 with
       ``retry_after_s``); batch keeps the halved cap.

    A stage is entered only after ``dwell`` CONSECUTIVE observations
    above ``target_p95_s × enter_ratio`` and left only after ``dwell``
    consecutive observations below ``target_p95_s × exit_ratio``
    (enter > exit: the band between them is sticky, so p95 noise
    around the target cannot flap the ladder). ``target_p95_s <= 0``
    disables the ladder (stage pinned at 0) — shedding then runs on
    the static depth caps alone."""

    def __init__(self, target_p95_s: float = 0.0,
                 enter_ratio: float = 1.5, exit_ratio: float = 1.1,
                 dwell: int = 3) -> None:
        self.target_p95_s = float(target_p95_s)
        self.enter_ratio = max(1.0, float(enter_ratio))
        self.exit_ratio = max(0.0, min(float(exit_ratio),
                                       self.enter_ratio))
        self.dwell = max(1, int(dwell))
        # observe() runs on whatever request thread refreshed the load
        # snapshot, and several can race: streak counters and the stage
        # ladder mutate under the lock, readers come through the stage
        # property
        self._lock = threading.Lock()
        self._stage = 0
        self.escalations = 0
        self.deescalations = 0
        self._hot = 0
        self._cool = 0
        self._last_p95 = 0.0

    @property
    def enabled(self) -> bool:
        return self.target_p95_s > 0

    @property
    def stage(self) -> int:
        with self._lock:
            return self._stage

    @stage.setter
    def stage(self, value: int) -> None:
        # operator/test override: pin the ladder at a stage
        with self._lock:
            self._stage = value

    def observe(self, p95_s: Optional[float]) -> int:
        """Feed one interactive-p95 observation; returns the (possibly
        changed) stage. ``None``/non-positive observations (no
        interactive traffic yet) count toward COOLING — an idle fleet
        must walk back down the ladder, not stick at a stale stage."""
        if not self.enabled:
            return self.stage
        v = float(p95_s) if isinstance(p95_s, (int, float)) and \
            not isinstance(p95_s, bool) else 0.0
        with self._lock:
            self._last_p95 = v
            if v > self.target_p95_s * self.enter_ratio:
                self._hot += 1
                self._cool = 0
                if self._hot >= self.dwell and \
                        self._stage < len(BROWNOUT_STAGES) - 1:
                    self._stage += 1
                    self.escalations += 1
                    self._hot = 0
            elif v < self.target_p95_s * self.exit_ratio:
                self._cool += 1
                self._hot = 0
                if self._cool >= self.dwell and self._stage > 0:
                    self._stage -= 1
                    self.deescalations += 1
                    self._cool = 0
            else:
                # the sticky band between exit and enter: neither
                # streak survives it — transitions need consecutive
                # evidence
                self._hot = 0
                self._cool = 0
            return self._stage

    # ---- what each stage means for admission (shared semantics:
    # ---- predictor shed gate and docs both read these) ----
    def shed_cap(self, slo: str, base_cap: int) -> int:
        """The effective queue-depth cap for ``slo`` at the current
        stage: interactive is never capped, best-effort caps halve at
        stage >= 1, background drops to 0 (pause) at stage 3."""
        if slo == "interactive":
            return -1  # sentinel: no cap
        stage = self.stage
        cap = max(0, int(base_cap))
        if stage >= 1 and cap > 1:
            # halve, floored at 1 — but an operator cap of 0 or 1
            # stays put: the ladder may only TIGHTEN admission, never
            # raise a stricter configured cap
            cap = max(1, cap // 2)
        if slo == "background" and stage >= 3:
            cap = 0
        return cap

    def clamp_max_new(self, slo: str, requested: Optional[int],
                      clamp: int) -> Optional[int]:
        """Stage >= 2: background generations are clamped to ``clamp``
        new tokens (shorter holds on slots/pages). Other classes and
        lower stages pass through."""
        if self.stage >= 2 and slo == "background" and clamp > 0:
            return clamp if not requested else min(int(requested), clamp)
        return requested

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"stage": self._stage,
                    "stage_name": BROWNOUT_STAGES[self._stage],
                    "target_p95_s": self.target_p95_s,
                    "enabled": self.enabled,
                    "last_interactive_p95_s": round(self._last_p95, 4),
                    "escalations": self.escalations,
                    "deescalations": self.deescalations}
