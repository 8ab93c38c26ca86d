"""Inference-pool autoscaling policy: grow on stalls, shrink when idle.

The port's own copy of ``rafiki_tpu/admin/autoscaler.py``:
``AutoscaleConfig.from_budget`` and ``AutoscalePolicy.observe``, unchanged
in behaviour (pure host logic; ``tests/test_torch_scaleout.py`` holds the
two packages' decisions, statuses and refusals equal on seeded stat
sequences). The decision core of ``ServicesManager.autoscale_tick``,
factored out so the policy is testable without processes. It reads the
per-worker stats the workers publish to the hub and emits at most one
decision per observation:

- **"up"** after ``grow_stall_ticks`` *consecutive* observations in
  which the pool's cumulative ``admission_stalls`` counter grew:
  admissions queuing behind a full KV page pool mean a whole extra
  engine's worth of demand exists (a high page ratio alone is healthy
  utilization).
- **"down"** after ``shrink_idle_ticks`` consecutive observations with
  zero stall growth AND every worker's page-pool ratio under
  ``shrink_pages_ratio``: a drained worker's load fits in its siblings'
  headroom.
- **None** otherwise: whenever any pool member's stats are missing (a
  respawning worker blocks *shrink*: scaling down a pool you cannot see
  drops streams) and during the post-action ``cooldown_s``.

Scale-down safety is the caller's contract: the victim leaves the
routing pool first, then drains through the graceful-drain path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional


def _num(stats: Mapping[str, Any], name: str) -> Optional[float]:
    """A numeric signal accepting both the hub-publish spelling
    (``engine_admission_stalls``) and the bare engine spelling."""
    for key in (f"engine_{name}", name):
        v = stats.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


@dataclass
class AutoscaleConfig:
    """Operator-facing bounds, parsed from the inference-job budget.

    Budget keys: ``AUTOSCALE`` (truthy enables the monitor-tick
    policy), ``MAX_WORKERS`` (required — the pool's upper bound),
    ``MIN_WORKERS`` (lower bound, default 1), and
    ``AUTOSCALE_COOLDOWN_S`` (floor between scale actions, default
    30)."""

    min_workers: int = 1
    max_workers: int = 1
    cooldown_s: float = 30.0
    #: consecutive stalling observations before growing
    grow_stall_ticks: int = 2
    #: consecutive idle observations before shrinking
    shrink_idle_ticks: int = 5
    #: every worker's page ratio must sit under this to shrink
    shrink_pages_ratio: float = 0.5

    @classmethod
    def from_budget(cls, budget: Mapping[str, Any],
                    initial_workers: int) -> Optional["AutoscaleConfig"]:
        """Parse + validate the budget's autoscale keys at the API
        surface (a bad bound fails the create call, not a monitor tick
        hours later). None when ``AUTOSCALE`` is unset; the dependent
        keys without it raise — a silently ignored bound is worse than
        an error."""
        budget = budget or {}
        dependent = [k for k in ("MIN_WORKERS", "MAX_WORKERS",
                                 "AUTOSCALE_COOLDOWN_S") if k in budget]
        if not budget.get("AUTOSCALE"):
            if dependent:
                raise ValueError(
                    f"budget key(s) {dependent} require AUTOSCALE in "
                    "the same budget (they bound the autoscaler)")
            return None
        if "MAX_WORKERS" not in budget:
            # defaulting the ceiling to the initial count would make
            # the headline grow-on-stalls behavior a silent no-op —
            # the bound the operator armed AUTOSCALE for must be named
            raise ValueError(
                "AUTOSCALE requires MAX_WORKERS in the same budget "
                "(the pool's upper bound; without one the policy "
                "could never scale up)")
        mn = int(budget.get("MIN_WORKERS", 1))
        mx = int(budget["MAX_WORKERS"])
        cd = float(budget.get("AUTOSCALE_COOLDOWN_S", 30.0))
        if mn < 1:
            raise ValueError(f"MIN_WORKERS={mn} must be >= 1 (an empty "
                             "pool serves nothing)")
        if mx < mn:
            raise ValueError(
                f"MAX_WORKERS={mx} must be >= MIN_WORKERS={mn}")
        if not (mn <= initial_workers <= mx):
            raise ValueError(
                f"initial replica count {initial_workers} must lie in "
                f"[MIN_WORKERS={mn}, MAX_WORKERS={mx}] — the autoscaler "
                "bounds must contain the starting pool")
        if cd <= 0:
            raise ValueError(
                f"AUTOSCALE_COOLDOWN_S={cd} must be > 0 (back-to-back "
                "scale actions oscillate)")
        return cls(min_workers=mn, max_workers=mx, cooldown_s=cd)


class AutoscalePolicy:
    """Per-job scaling state machine over published worker stats."""

    def __init__(self, cfg: AutoscaleConfig,
                 now: Callable[[], float] = time.monotonic) -> None:
        self.cfg = cfg
        self._now = now
        #: last seen cumulative admission_stalls per worker id
        self._stalls: Dict[str, float] = {}
        self._stall_ticks = 0
        self._idle_ticks = 0
        self._last_action_at = 0.0
        self._last_set: frozenset = frozenset()
        self.last_decision = ""

    def note_action(self) -> None:
        """Stamp an externally performed scale action (manual scale,
        the caller executing a decision) so the cooldown applies to it
        too."""
        self._last_action_at = self._now()
        self._stall_ticks = 0
        self._idle_ticks = 0

    def status(self) -> Dict[str, Any]:
        return {"min_workers": self.cfg.min_workers,
                "max_workers": self.cfg.max_workers,
                "cooldown_s": self.cfg.cooldown_s,
                "stall_ticks": self._stall_ticks,
                "idle_ticks": self._idle_ticks,
                "last_decision": self.last_decision,
                "cooldown_remaining_s": round(max(
                    0.0, self._last_action_at + self.cfg.cooldown_s
                    - self._now()), 3)}

    def observe(self, stats_by_worker: Mapping[str, Optional[Mapping]]
                ) -> Optional[str]:
        """Fold one round of per-worker stats; return "up", "down", or
        None. Callers execute the decision (and the cooldown stamps
        itself here)."""
        n = len(stats_by_worker)
        wids = frozenset(stats_by_worker)
        if wids != self._last_set:
            # the pool changed under us (scale action, manual scale,
            # respawn rename): accrued tick evidence described another
            # pool — start fresh rather than e.g. instantly shrinking
            # a just-grown pool on stale idle ticks
            self._last_set = wids
            self._stall_ticks = 0
            self._idle_ticks = 0
        stall_delta = 0.0
        pages_ok = True
        missing = False
        for wid, s in stats_by_worker.items():
            if not isinstance(s, Mapping):
                missing = True
                continue
            stalls = _num(s, "admission_stalls")
            if stalls is not None:
                prev = self._stalls.get(wid)
                if prev is not None and stalls > prev:
                    stall_delta += stalls - prev
                self._stalls[wid] = stalls
            used = _num(s, "kv_pages_used")
            total = _num(s, "kv_pages_total")
            if used is not None and total:
                if used / total >= self.cfg.shrink_pages_ratio:
                    pages_ok = False
        # drop watermark entries for departed workers so a scale-down
        # followed by a same-id scale-up can't read a stale baseline
        for wid in list(self._stalls):
            if wid not in stats_by_worker:
                del self._stalls[wid]

        if stall_delta > 0:
            self._stall_ticks += 1
            self._idle_ticks = 0
        else:
            self._stall_ticks = 0
            if not missing and pages_ok:
                self._idle_ticks += 1
            else:
                self._idle_ticks = 0

        now = self._now()
        in_cooldown = now - self._last_action_at < self.cfg.cooldown_s \
            and self._last_action_at > 0
        if in_cooldown:
            return None
        if self._stall_ticks >= self.cfg.grow_stall_ticks \
                and n < self.cfg.max_workers:
            self.note_action()
            self.last_decision = "up"
            return "up"
        if self._idle_ticks >= self.cfg.shrink_idle_ticks \
                and n > self.cfg.min_workers:
            self.note_action()
            self.last_decision = "down"
            return "down"
        return None
