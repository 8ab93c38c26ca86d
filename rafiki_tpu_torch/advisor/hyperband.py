"""BOHB-family advisor: asynchronous successive halving + TPE sampling.

The port's own copy of ``BOHBAdvisor`` from ``rafiki_tpu/advisor/
hyperband.py`` (its TPE densities are scipy's ``gaussian_kde``, imported
where they are first needed, as in JAX). ``make_advisor("auto")`` picks
it for every template that declares a QUICK_TRAIN or EARLY_STOP policy:
ViT, BERT and LlamaLoRA.

Rungs are ASHA's (async promotion: an entry in the top 1/eta of its
rung's completed entries moves up, warm-starting from its own
checkpoint through ``warm_start_trial_id``); fresh configurations come
from a TPE model over the knob unit cube once a rung holds enough
completed entries. With a trial budget too small for the rungs to reach
full budget, the last trial runs the incumbent at budget 1.0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch.advisor.base import BaseAdvisor, Proposal, TrialResult
from rafiki_tpu_torch.model.knob import (KnobConfig, PolicyKnob,
                                         knobs_from_unit_vector,
                                         sample_knobs, tunable_knobs)


class _RungEntry:
    __slots__ = ("trial_no", "trial_id", "knobs", "vec", "score", "promoted")

    def __init__(self, trial_no: int, knobs: dict, vec: List[float]) -> None:
        self.trial_no = trial_no
        self.trial_id = ""
        self.knobs = knobs
        self.vec = vec
        self.score: Optional[float] = None
        self.promoted = False


class BOHBAdvisor(BaseAdvisor):
    name = "bohb"

    def __init__(self, knob_config: KnobConfig,
                 total_trials: Optional[int] = None,
                 time_budget_s: Optional[float] = None, seed: int = 0,
                 eta: int = 3, min_budget: float = 1.0 / 9.0,
                 max_budget: float = 1.0, tpe_min_points: int = 8,
                 tpe_top_quantile: float = 0.33,
                 n_candidates: int = 256) -> None:
        super().__init__(knob_config, total_trials, time_budget_s, seed)
        self.eta = eta
        # rung budgets: min_budget * eta^k up to max_budget
        budgets = []
        b = min_budget
        while b < max_budget - 1e-9:
            budgets.append(b)
            b *= eta
        budgets.append(max_budget)
        self.budgets = budgets
        self._rungs: List[List[_RungEntry]] = [[] for _ in budgets]
        self._by_trial_no: Dict[int, Tuple[int, _RungEntry]] = {}
        self._dims = tunable_knobs(knob_config)
        self._tpe_min_points = tpe_min_points
        self._tpe_top_quantile = tpe_top_quantile
        self._n_candidates = n_candidates
        self._np_rng = np.random.default_rng(seed)

    @property
    def n_rungs(self) -> int:
        return len(self.budgets)

    # ---- BaseAdvisor hooks (called under the base lock) ----
    def _propose(self, trial_no: int) -> Proposal:
        # 0) final-trial reservation: with a small trial budget the ASHA
        # rungs may never organically reach full budget (promotion needs
        # >= eta completions per rung), which would leave the job with no
        # full-budget trial at all. Spend the last trial running the
        # incumbent at budget 1.0 so a best trial always exists.
        if (self.total_trials is not None
                and self.total_trials - trial_no <= 1
                and not any(r.budget_scale >= 1.0 for r in self.results)
                and not any(p.budget_scale >= 1.0
                            for p in self._outstanding.values())):
            return self._final_fill(trial_no)
        # 1) try to promote: highest rung first, so survivors finish fast
        for rung in range(self.n_rungs - 2, -1, -1):
            entry = self._promotable(rung)
            if entry is not None:
                entry.promoted = True
                new = _RungEntry(trial_no, dict(entry.knobs), entry.vec)
                self._rungs[rung + 1].append(new)
                self._by_trial_no[trial_no] = (rung + 1, new)
                knobs = self._with_policies(
                    dict(entry.knobs), promote=True,
                    budget_scale=self.budgets[rung + 1])
                return Proposal(
                    trial_no=trial_no, knobs=knobs,
                    budget_scale=self.budgets[rung + 1],
                    warm_start_trial_id=entry.trial_id,
                    meta={"rung": rung + 1, "parent_trial_no": entry.trial_no})
        # 2) otherwise: a fresh configuration at the lowest rung
        return self._fresh_entry(trial_no, rung=0)

    def _fresh_entry(self, trial_no: int, rung: int,
                     final_fill: bool = False) -> Proposal:
        """Sample a fresh configuration and register it at ``rung``."""
        if self._dims:
            vec = self._sample_tpe()
            knobs = knobs_from_unit_vector(self.knob_config, vec, self._rng)
        else:
            knobs = sample_knobs(self.knob_config, self._rng)
            vec = []
        entry = _RungEntry(trial_no, dict(knobs), vec)
        self._rungs[rung].append(entry)
        self._by_trial_no[trial_no] = (rung, entry)
        knobs = self._with_policies(knobs, promote=False,
                                    budget_scale=self.budgets[rung])
        meta = {"rung": rung}
        if final_fill:
            meta["final_fill"] = True
        return Proposal(trial_no=trial_no, knobs=knobs,
                        budget_scale=self.budgets[rung], meta=meta)

    def _final_fill(self, trial_no: int) -> Proposal:
        """Run the best completed entry (highest rung, then score) at full
        budget, warm-started from its checkpoint; fresh sample if nothing
        has completed yet."""
        top = self.n_rungs - 1
        best = None
        for rung in range(self.n_rungs - 1, -1, -1):
            done = [e for e in self._rungs[rung] if e.score is not None]
            if done:
                best = max(done, key=lambda e: e.score)
                break
        if best is not None:
            entry = _RungEntry(trial_no, dict(best.knobs), best.vec)
            self._rungs[top].append(entry)
            self._by_trial_no[trial_no] = (top, entry)
            knobs = self._with_policies(dict(best.knobs), promote=True,
                                        budget_scale=1.0)
            return Proposal(
                trial_no=trial_no, knobs=knobs, budget_scale=1.0,
                warm_start_trial_id=best.trial_id,
                meta={"rung": top, "parent_trial_no": best.trial_no,
                      "final_fill": True})
        return self._fresh_entry(trial_no, rung=top, final_fill=True)

    #: per-rung history cap for long-running services: beyond this, the
    #: worst-scoring unpromoted entries are pruned (they are strictly
    #: dominated, so dropping them only tightens the promotion bar).
    MAX_RUNG_ENTRIES = 2048

    def _feedback(self, result: TrialResult) -> None:
        info = self._by_trial_no.pop(result.trial_no, None)
        if info is None:
            return
        rung, entry = info
        entry.score = float(result.score)
        entry.trial_id = result.trial_id
        if len(self._rungs[rung]) > self.MAX_RUNG_ENTRIES:
            done = sorted((e for e in self._rungs[rung]
                           if e.score is not None and not e.promoted),
                          key=lambda e: e.score)
            drop = set(id(e) for e in
                       done[:len(self._rungs[rung]) - self.MAX_RUNG_ENTRIES])
            self._rungs[rung] = [e for e in self._rungs[rung]
                                 if id(e) not in drop]

    def _on_trial_errored(self, trial_no: int) -> None:
        info = self._by_trial_no.pop(trial_no, None)
        if info is not None:
            rung, entry = info
            # drop it from the rung so it never blocks promotions
            self._rungs[rung] = [e for e in self._rungs[rung] if e is not entry]

    # ---- successive halving ----
    def _promotable(self, rung: int) -> Optional[_RungEntry]:
        """Async (ASHA) rule: an entry is promotable when it sits in the top
        1/eta of *completed* entries at its rung and is not yet promoted."""
        done = [e for e in self._rungs[rung] if e.score is not None]
        if len(done) < self.eta:
            return None
        k = len(done) // self.eta
        top = sorted(done, key=lambda e: e.score, reverse=True)[:k]
        for e in top:
            if not e.promoted:
                return e
        return None

    def _with_policies(self, knobs: dict, promote: bool,
                       budget_scale: float) -> dict:
        """Flip the model's declared policy knobs for rung semantics.

        QUICK_TRAIN only on sub-full rungs: a full-budget (scale 1.0)
        trial must actually train at full budget, or rung budgets become
        indistinguishable for models whose quick_train caps epochs."""
        for n, k in self.knob_config.items():
            if not isinstance(k, PolicyKnob):
                continue
            if k.policy == "QUICK_TRAIN":
                knobs[n] = budget_scale < 1.0 - 1e-9
            elif k.policy == "EARLY_STOP":
                knobs[n] = True
            elif k.policy == "SHARE_PARAMS":
                knobs[n] = promote  # promotions resume their own checkpoint
        return knobs

    # ---- TPE sampling over the unit cube ----
    def _observations(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x, y) pairs from the highest rung that has enough data."""
        for rung in range(self.n_rungs - 1, -1, -1):
            done = [e for e in self._rungs[rung]
                    if e.score is not None and e.vec]
            if len(done) >= self._tpe_min_points:
                return (np.asarray([e.vec for e in done]),
                        np.asarray([e.score for e in done]))
        return np.empty((0, len(self._dims))), np.empty((0,))

    def _sample_tpe(self) -> List[float]:
        x, y = self._observations()
        if len(y) < self._tpe_min_points:
            return self._np_rng.random(len(self._dims)).tolist()
        from scipy.stats import gaussian_kde

        n_top = max(2, int(math.ceil(len(y) * self._tpe_top_quantile)))
        if n_top <= x.shape[1]:
            # a KDE over fewer points than dimensions has a singular
            # covariance (scipy raises outright); keep
            # exploring randomly until the top quantile outgrows the
            # dimensionality
            return self._np_rng.random(len(self._dims)).tolist()
        order = np.argsort(y)[::-1]
        good, bad = x[order[:n_top]], x[order[n_top:]]
        jitter = 1e-3 * self._np_rng.standard_normal(good.T.shape)
        try:
            kde_good = gaussian_kde(good.T + jitter, bw_method="scott")
            kde_bad = (gaussian_kde(bad.T, bw_method="scott")
                       if len(bad) > x.shape[1] else None)
        except (np.linalg.LinAlgError, ValueError):
            return self._np_rng.random(len(self._dims)).tolist()
        cand = np.clip(
            kde_good.resample(self._n_candidates,
                              seed=int(self._np_rng.integers(2 ** 31))).T,
            0.0, 1.0)
        lg = kde_good.logpdf(cand.T)
        lb = kde_bad.logpdf(cand.T) if kde_bad is not None else 0.0
        return cand[int(np.argmax(lg - lb))].tolist()

