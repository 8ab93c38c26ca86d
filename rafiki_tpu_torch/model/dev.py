"""The model developer's local tuning loop.

The port's own copy of ``tune_model``, ``TuneResult`` and
``TrialSummary`` from ``rafiki_tpu/model/dev.py``: the advisor's
propose/feedback cycle in one process, each trial a template built on
``device`` (None: the CUDA card), the best trial's knobs, score and
parameters returned. ``knob_overrides`` pins knobs over every proposal,
validated as JAX validates it. ``profile_dir`` records each trial's
``train`` with ``torch.profiler`` into ``profile_dir/local-<trial_no>/``.
``gang_size >= 1`` routes as JAX routes it (``check_gang_size``): a
template with a gang spec (``JaxFeedForward``, ``LlamaLoRA``) runs
through the gang engine (``_tune_model_gang``, ``rafiki_tpu_torch/
tuning``), K trials as K lanes of one train step; one without runs
sequential trials with JAX's warning. The JAX module's
``test_model_class`` harness is not ported.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.model.base import Params, TrainContext
from rafiki_tpu_torch.model.knob import Knobs, validate_override_keys
from rafiki_tpu_torch.model.log import ModelLogger
from rafiki_tpu_torch.utils.device import DeviceLike


@dataclass
class TrialSummary:
    knobs: Knobs
    score: float
    logger: ModelLogger
    params: Optional[Params] = None


@dataclass
class TuneResult:
    best_knobs: Knobs
    best_score: float
    best_params: Params
    trials: List[TrialSummary] = field(default_factory=list)


def check_gang_size(model_class: type, gang_size: int,
                    knob_overrides: Optional[Dict[str, Any]] = None
                    ) -> bool:
    """JAX's routing of ``tune_model(gang_size=...)``: True when the gang
    engine runs these trials. ``gang_size < 1`` is False; a template
    without a gang spec warns and runs sequential trials (False); one
    with a spec is True, with a warning that names each pinned knob in
    ``knob_overrides`` its ``gang_blockers`` refuse (those buckets fall
    back to sequential trials inside the engine)."""
    from rafiki_tpu_torch.tuning import supports_gang

    if gang_size < 1:
        return False
    if not supports_gang(model_class):
        warnings.warn(
            f"{model_class.__name__} has no gang spec; "
            "tune_model(gang_size=...) falling back to sequential trials")
        return False
    blockers_fn = getattr(model_class, "gang_blockers", None)
    if callable(blockers_fn) and knob_overrides:
        pinned = blockers_fn(dict(knob_overrides))
        if pinned:
            warnings.warn(
                f"{model_class.__name__} gang lanes blocked by pinned "
                "knobs: " + "; ".join(pinned)
                + " — affected trials fall back to sequential")
    return True


def profiled_train(model: Any, dataset_path: str, ctx: TrainContext,
                   profile_dir: Optional[str]) -> None:
    """``model.train(dataset_path, ctx)``, recorded by ``torch.profiler``
    (CPU and CUDA activity) into a Chrome trace under ``profile_dir``
    when one is given, the call as a ``train`` range."""
    if not profile_dir:
        model.train(dataset_path, ctx)
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("train"):
            model.train(dataset_path, ctx)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def tune_model(model_class: type, train_dataset_path: str,
               val_dataset_path: str, total_trials: int = 10,
               advisor_type: str = "auto", seed: int = 0,
               keep_params: bool = True,
               profile_dir: Optional[str] = None,
               knob_overrides: Optional[Dict[str, Any]] = None,
               gang_size: int = 0,
               device: DeviceLike = None) -> TuneResult:
    """Local single-process tuning loop: run the advisor's
    propose/feedback cycle and return the best trial (an errored trial
    is dropped with a warning and the budget moves on)."""
    from rafiki_tpu_torch.advisor import TrialResult, make_advisor

    knob_config = model_class.get_knob_config()
    validate_override_keys(knob_config, knob_overrides,
                           context="knob_overrides")
    advisor = make_advisor(knob_config, advisor_type,
                           total_trials=total_trials, seed=seed)
    if check_gang_size(model_class, gang_size, knob_overrides):
        return _tune_model_gang(model_class, advisor, train_dataset_path,
                                val_dataset_path, gang_size, knob_overrides,
                                keep_params, device)

    trials: List[TrialSummary] = []
    params_by_trial: Dict[str, Params] = {}
    while True:
        proposal = advisor.propose()
        if not proposal.is_valid:
            break
        if knob_overrides:
            proposal.knobs = {**proposal.knobs, **knob_overrides}
        logger = ModelLogger()
        model = model_class(device=device, **proposal.knobs)
        shared = params_by_trial.get(proposal.warm_start_trial_id)
        trial_id = f"local-{proposal.trial_no}"
        trial_profile_dir = None
        if profile_dir:
            trial_profile_dir = os.path.join(profile_dir, trial_id)
            os.makedirs(trial_profile_dir, exist_ok=True)
        ctx = TrainContext(logger=logger, budget_scale=proposal.budget_scale,
                           shared_params=shared, trial_id=trial_id,
                           profile_dir=trial_profile_dir)
        try:
            profiled_train(model, train_dataset_path, ctx,
                           trial_profile_dir)
            score = model.evaluate(val_dataset_path)
        except Exception as e:
            warnings.warn(f"trial {proposal.trial_no} errored: {e!r}")
            advisor.trial_errored(proposal.trial_no)
            continue
        params = model.dump_parameters()
        if keep_params:
            params_by_trial[trial_id] = params
        advisor.feedback(TrialResult(
            trial_no=proposal.trial_no, knobs=proposal.knobs, score=score,
            trial_id=trial_id, budget_scale=proposal.budget_scale,
            meta=proposal.meta))
        trials.append(TrialSummary(knobs=proposal.knobs, score=score,
                                   logger=logger,
                                   params=params if keep_params else None))

    best = advisor.best_effort
    if best is None:
        raise RuntimeError("no successful trial")
    return TuneResult(best_knobs=best.knobs, best_score=best.score,
                      best_params=params_by_trial.get(best.trial_id, {}),
                      trials=trials)



def _tune_model_gang(model_class: type, advisor: Any,
                     train_dataset_path: str, val_dataset_path: str,
                     gang_size: int,
                     knob_overrides: Optional[Dict[str, Any]],
                     keep_params: bool, device: DeviceLike) -> TuneResult:
    """The gang engine's twin of the sequential loop: the same advisor
    cycle, K lanes per step, one TrialSummary per lane-trial."""
    from rafiki_tpu_torch.tuning import GangEngine

    blobs: Dict[str, Params] = {}

    def on_result(result, blob) -> None:
        if keep_params:
            blobs[result.trial_id] = blob

    engine = GangEngine(model_class, advisor, train_dataset_path,
                        val_dataset_path, gang_size=gang_size, mode="gang",
                        knob_overrides=knob_overrides, keep_blobs=True,
                        on_result=on_result, device=device)
    results = engine.run()
    trials = [TrialSummary(knobs=r.knobs, score=r.score,
                           logger=ModelLogger(),
                           params=blobs.get(r.trial_id))
              for r in results]
    best = advisor.best_effort
    if best is None:
        raise RuntimeError("no successful trial")
    return TuneResult(best_knobs=best.knobs, best_score=best.score,
                      best_params=blobs.get(best.trial_id, {}),
                      trials=trials)
