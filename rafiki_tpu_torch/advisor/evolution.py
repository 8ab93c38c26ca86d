"""Architecture search by regularized (aging) evolution, with parameter
sharing: the port's own copy of ``ArchEvolutionAdvisor`` from
``rafiki_tpu/advisor/evolution.py``.

Each proposal past the seed population mutates ONE tunable knob of the
winner of a ``sample_size`` tournament over the newest ``population``
results (Real et al., AAAI 2019). A child whose mutation leaves the
shape signature unchanged warm-starts from its parent's parameters
(``warm_start_trial_id`` with the SHARE_PARAMS policy), the ENAS-style
weight inheritance of the JAX advisor.
"""

from __future__ import annotations

import collections
from typing import Deque, Optional

from rafiki_tpu_torch.advisor.base import BaseAdvisor, Proposal, TrialResult
from rafiki_tpu_torch.model.knob import (PolicyKnob, sample_knobs,
                                         shape_signature, tunable_knobs)


class ArchEvolutionAdvisor(BaseAdvisor):
    name = "arch_evo"

    def __init__(self, *args, population: int = 8, sample_size: int = 3,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.population = max(2, int(population))
        self.sample_size = max(1, int(sample_size))
        #: aging window — only the newest ``population`` results compete
        self._window: Deque[TrialResult] = collections.deque(
            maxlen=self.population)

    # ---- BaseAdvisor hooks (called under the base lock) ----
    def _propose(self, trial_no: int) -> Proposal:
        if len(self._window) < self.population:
            return Proposal(trial_no=trial_no,
                            knobs=self._with_policies(
                                sample_knobs(self.knob_config, self._rng)))
        parent = max(self._rng.sample(list(self._window),
                                      min(self.sample_size,
                                          len(self._window))),
                     key=lambda r: r.score)
        child = dict(parent.knobs)
        mutated = self._mutate(child)
        child = self._with_policies(child)
        warm = ""
        if parent.trial_id and not self._changes_shape(parent.knobs,
                                                       child, mutated):
            # ENAS-style weight inheritance: same shapes → same pytree
            warm = parent.trial_id
        return Proposal(trial_no=trial_no, knobs=child,
                        warm_start_trial_id=warm,
                        meta={"parent_trial_no": parent.trial_no,
                              "mutated": mutated})

    def _feedback(self, result: TrialResult) -> None:
        self._window.append(result)

    # ---- internals ----
    def _mutate(self, knobs: dict) -> str:
        """Resample ONE tunable knob in place; returns its name."""
        names = tunable_knobs(self.knob_config)
        if not names:
            return ""
        for _ in range(8):  # retry until the value actually changes
            name = self._rng.choice(names)
            new = self.knob_config[name].sample(self._rng)
            if new != knobs.get(name):
                knobs[name] = new
                return name
        knobs[name] = self.knob_config[name].sample(self._rng)
        return name

    def _changes_shape(self, parent_knobs: dict, child_knobs: dict,
                       mutated: str) -> bool:
        if mutated and not getattr(self.knob_config.get(mutated),
                                   "shape_relevant", False):
            return False
        return shape_signature(self.knob_config, parent_knobs) != \
            shape_signature(self.knob_config, child_knobs)

    def _with_policies(self, knobs: dict) -> dict:
        """Policy knobs: enable SHARE_PARAMS so warm starts take effect;
        leave other policies at their sampled values."""
        for n, k in self.knob_config.items():
            if isinstance(k, PolicyKnob) and k.policy == "SHARE_PARAMS":
                knobs[n] = True
        return knobs
