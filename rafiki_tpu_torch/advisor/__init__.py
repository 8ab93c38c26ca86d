"""Hyperparameter-search advisors: the port's own copies of
``rafiki_tpu/advisor`` (random, Bayesian-GP, BOHB, architecture
evolution) and the client of the JAX advisor service.

The registry is filled as the JAX package fills it: ``random``,
``arch_evo``, ``bayes_gp`` and ``bohb``.
"""

from rafiki_tpu_torch.advisor.base import (ADVISOR_REGISTRY, BaseAdvisor,
                                           Proposal, TrialResult,
                                           make_advisor)
from rafiki_tpu_torch.advisor.bayes_gp import BayesOptAdvisor
from rafiki_tpu_torch.advisor.evolution import ArchEvolutionAdvisor
from rafiki_tpu_torch.advisor.hyperband import BOHBAdvisor
from rafiki_tpu_torch.advisor.random_search import RandomAdvisor

ADVISOR_REGISTRY["random"] = RandomAdvisor
ADVISOR_REGISTRY["arch_evo"] = ArchEvolutionAdvisor
ADVISOR_REGISTRY["bayes_gp"] = BayesOptAdvisor
ADVISOR_REGISTRY["bohb"] = BOHBAdvisor

__all__ = [
    "ADVISOR_REGISTRY", "BaseAdvisor", "Proposal", "TrialResult",
    "make_advisor", "RandomAdvisor", "ArchEvolutionAdvisor",
    "BayesOptAdvisor", "BOHBAdvisor",
]
