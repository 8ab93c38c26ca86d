"""Advisor core: the propose/feedback (ask/tell) loop.

The port's own copy of ``rafiki_tpu/advisor/base.py``: ``Proposal``,
``TrialResult``, ``BaseAdvisor`` (``propose``, ``propose_batch``,
``feedback``, ``feedback_batch``, ``trial_errored``, ``finished``,
``best_effort``), ``ADVISOR_REGISTRY`` and ``make_advisor``. A train
worker asks for a :class:`Proposal` (a knob assignment plus trial-control
flags) and reports a (knobs, score) result back; the advisor updates its
search state. Proposals and results keep the JAX package's JSON, so the
port's worker can drive the JAX advisor service and the reverse.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from rafiki_tpu_torch.model.knob import KnobConfig, Knobs


@dataclass
class Proposal:
    """One unit of work handed to a train worker."""

    trial_no: int
    knobs: Knobs
    #: fraction of full training budget to spend (BOHB rungs; 1.0 = full)
    budget_scale: float = 1.0
    #: param-sharing directive: trial id to warm-start from, or "" for none
    warm_start_trial_id: str = ""
    #: if False, the search is over and the worker should exit
    is_valid: bool = True
    #: free-form per-algorithm state echoed back in feedback (bracket ids…)
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "trial_no": self.trial_no,
            "knobs": self.knobs,
            "budget_scale": self.budget_scale,
            "warm_start_trial_id": self.warm_start_trial_id,
            "is_valid": self.is_valid,
            "meta": self.meta,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Proposal":
        return Proposal(
            trial_no=d["trial_no"],
            knobs=d["knobs"],
            budget_scale=d.get("budget_scale", 1.0),
            warm_start_trial_id=d.get("warm_start_trial_id", ""),
            is_valid=d.get("is_valid", True),
            meta=d.get("meta", {}),
        )

    @staticmethod
    def invalid() -> "Proposal":
        return Proposal(trial_no=-1, knobs={}, is_valid=False)


@dataclass
class TrialResult:
    """A completed trial as reported back to the advisor."""

    trial_no: int
    knobs: Knobs
    score: float
    trial_id: str = ""       # MetaStore/ParamStore id, for warm-start refs
    budget_scale: float = 1.0
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"trial_no": self.trial_no, "knobs": self.knobs,
                "score": self.score, "trial_id": self.trial_id,
                "budget_scale": self.budget_scale, "meta": self.meta}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TrialResult":
        return TrialResult(
            trial_no=d["trial_no"], knobs=d["knobs"], score=d["score"],
            trial_id=d.get("trial_id", ""),
            budget_scale=d.get("budget_scale", 1.0),
            meta=d.get("meta", {}))


class BaseAdvisor:
    """Thread-safe ask/tell hyperparameter search over a knob config.

    Subclasses implement ``_propose`` and ``_feedback``; the base class
    handles budget accounting (trial count / wall-clock), bookkeeping of
    results, best-trial tracking, and locking (multiple workers hit one
    advisor concurrently — SURVEY.md §3.4).
    """

    name = "base"

    def __init__(self, knob_config: KnobConfig,
                 total_trials: Optional[int] = None,
                 time_budget_s: Optional[float] = None,
                 seed: int = 0) -> None:
        self.knob_config = knob_config
        self.total_trials = total_trials
        self.time_budget_s = time_budget_s
        self._start_time = time.monotonic()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._next_trial_no = 0
        self._outstanding: Dict[int, Proposal] = {}
        self.results: List[TrialResult] = []
        self.best: Optional[TrialResult] = None

    # ---- public API ----
    def propose(self) -> Proposal:
        with self._lock:
            if self._budget_exhausted():
                return Proposal.invalid()
            proposal = self._propose(self._next_trial_no)
            if not proposal.is_valid:
                return proposal
            proposal.trial_no = self._next_trial_no
            self._next_trial_no += 1
            self._outstanding[proposal.trial_no] = proposal
            return proposal

    def propose_batch(self, k: int) -> List[Proposal]:
        """Up to ``k`` proposals under ONE lock acquisition — the gang
        engine's lane-fill primitive.

        Atomicity is the determinism guarantee: no concurrent worker can
        interleave a propose/feedback between batch members, so for a
        given advisor seed and feedback history the batch equals ``k``
        sequential :meth:`propose` calls exactly — same knob sets
        regardless of lane count (tier-1 asserts this for the random and
        BOHB advisors). Returns fewer than ``k`` (possibly zero)
        proposals when the budget runs out mid-batch."""
        out: List[Proposal] = []
        with self._lock:
            for _ in range(max(0, k)):
                if self._budget_exhausted():
                    break
                proposal = self._propose(self._next_trial_no)
                if not proposal.is_valid:
                    break
                proposal.trial_no = self._next_trial_no
                self._next_trial_no += 1
                self._outstanding[proposal.trial_no] = proposal
                out.append(proposal)
        return out

    def feedback(self, result: TrialResult) -> None:
        with self._lock:
            self._feedback_locked(result)

    def feedback_batch(self, results: Sequence[TrialResult]) -> None:
        """Report a batch of completed lanes atomically (order preserved:
        rung/posterior state sees them in the given sequence, same as
        sequential feedback calls)."""
        with self._lock:
            for result in results:
                self._feedback_locked(result)

    def _feedback_locked(self, result: TrialResult) -> None:
        self._outstanding.pop(result.trial_no, None)
        self.results.append(result)
        # Only full-budget trials compete for "best" (a BOHB low-rung
        # score is not comparable to a full train).
        if result.budget_scale >= 1.0 and (
                self.best is None or result.score > self.best.score):
            self.best = result
        self._feedback(result)

    def trial_errored(self, trial_no: int) -> None:
        """Reference semantics: an errored trial is dropped and the budget
        moves on (SURVEY.md §5.3)."""
        with self._lock:
            self._outstanding.pop(trial_no, None)
            self._on_trial_errored(trial_no)

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._budget_exhausted() and not self._outstanding

    @property
    def best_effort(self) -> Optional[TrialResult]:
        """``best`` when a full-budget trial exists, else the top scorer
        among the highest-budget completed trials (scores are only
        comparable within one budget level)."""
        with self._lock:
            if self.best is not None:
                return self.best
            if not self.results:
                return None
            max_budget = max(r.budget_scale for r in self.results)
            candidates = [r for r in self.results
                          if r.budget_scale >= max_budget - 1e-9]
            return max(candidates, key=lambda r: r.score)

    # ---- subclass interface ----
    def _propose(self, trial_no: int) -> Proposal:
        raise NotImplementedError

    def _feedback(self, result: TrialResult) -> None:
        raise NotImplementedError

    def _on_trial_errored(self, trial_no: int) -> None:
        pass

    # ---- internals ----
    def _budget_exhausted(self) -> bool:
        if self.total_trials is not None and \
                self._next_trial_no >= self.total_trials:
            return True
        if self.time_budget_s is not None and \
                time.monotonic() - self._start_time > self.time_budget_s:
            return True
        return False


# populated by rafiki_tpu_torch.advisor.__init__ (no import cycles)
ADVISOR_REGISTRY: Dict[str, Any] = {}


def make_advisor(knob_config: KnobConfig, advisor_type: str = "auto",
                 **kwargs: Any) -> BaseAdvisor:
    """Factory mirroring the reference's ``make_advisor``.

    ``advisor_type='auto'`` picks Bayesian-GP for small continuous spaces,
    BOHB when the model declares budget policies, random otherwise.
    """
    from rafiki_tpu_torch.model.knob import PolicyKnob, tunable_knobs

    if advisor_type == "auto":
        has_budget_policy = any(
            isinstance(k, PolicyKnob) and
            k.policy in ("QUICK_TRAIN", "EARLY_STOP")
            for k in knob_config.values())
        if has_budget_policy:
            advisor_type = "bohb"
        elif tunable_knobs(knob_config):
            advisor_type = "bayes_gp"
        else:
            advisor_type = "random"
        # degrade along the preference chain if a dependency is missing
        for fallback in (advisor_type, "bayes_gp", "random"):
            if fallback in ADVISOR_REGISTRY:
                advisor_type = fallback
                break
    cls = ADVISOR_REGISTRY.get(advisor_type)
    if cls is None:
        raise ValueError(
            f"unknown advisor type {advisor_type!r}; "
            f"available: {sorted(ADVISOR_REGISTRY)}")
    return cls(knob_config, **kwargs)
