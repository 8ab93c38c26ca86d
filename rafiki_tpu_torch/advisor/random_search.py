"""Random search: the port's own copy of ``RandomAdvisor`` from
``rafiki_tpu/advisor/random_search.py``."""

from __future__ import annotations

from rafiki_tpu_torch.advisor.base import BaseAdvisor, Proposal, TrialResult
from rafiki_tpu_torch.model.knob import PolicyKnob, sample_knobs


class RandomAdvisor(BaseAdvisor):
    name = "random"

    def _propose(self, trial_no: int) -> Proposal:
        knobs = sample_knobs(self.knob_config, self._rng)
        # enable param sharing when the model supports it and a best exists
        warm_start = ""
        if self.best is not None and self.best.trial_id:
            for n, k in self.knob_config.items():
                if isinstance(k, PolicyKnob) and k.policy == "SHARE_PARAMS":
                    knobs[n] = True
                    warm_start = self.best.trial_id
        return Proposal(trial_no=trial_no, knobs=knobs,
                        warm_start_trial_id=warm_start)

    def _feedback(self, result: TrialResult) -> None:
        pass
