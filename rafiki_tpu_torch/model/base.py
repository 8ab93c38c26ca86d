"""What the system injects into a trial's ``train`` call.

The port's own copy of ``TrainContext`` from ``rafiki_tpu/model/base.py``.
The port's templates take their device at construction, so the JAX
context's ``devices`` (a trial's sub-mesh) and ``profile_dir`` (a
``jax.profiler`` trace) have no field here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from rafiki_tpu_torch.model.log import ModelLogger

Params = Dict[str, Any]  # nested dicts of numpy arrays (JAX's layout)


@dataclass
class TrainContext:
    #: fraction of the full training budget to spend (BOHB rung scaling)
    budget_scale: float = 1.0
    #: warm-start parameters (SHARE_PARAMS policy): a dumped blob
    shared_params: Optional[Params] = None
    #: per-trial structured metric logger
    logger: ModelLogger = field(default_factory=ModelLogger)
    #: called with (epoch, score) between epochs; False stops training
    should_continue: Optional[Any] = None
    #: preemption safety: templates call ``ctx.checkpoint(
    #: self.dump_parameters, frac_done=(e + 1) / epochs, tree=...)`` at
    #: epoch boundaries with a zero-argument blob factory
    checkpoint: Optional[Any] = None
