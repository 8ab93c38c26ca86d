"""The templates' training loop.

- :func:`train_epoch` is the port's counterpart of ``train_epoch`` from
  ``rafiki_tpu/model/loop.py``. JAX's double-buffered host→device
  prefetch under a sharding and its bounded run-ahead sync have no
  counterpart: eager PyTorch queues each step's kernels as it goes, and
  the batch copy is the template's. The losses stay device scalars until
  the end of the epoch, where their mean is read once.
- :class:`GangSpec` is the port's copy of ``GangSpec`` from the same
  JAX module, plus the two lane-axis functions that stand in for
  ``jax.vmap`` (``train_lanes``, ``eval_lanes``). It leaves out JAX's
  ``compiler_options`` (the port has no XLA to pass them to) and
  ``eval_seq`` (the port's LM lanes score through ``eval_lane``, which
  is the template's sequential ``evaluate()`` path already);
- :func:`run_epochs` is the epoch loop every template's ``train`` runs
  (log, checkpoint, ``should_continue``); :func:`epoch_count` the epochs
  it spends;
- :func:`masked_ce` and :func:`fit` are the loop that ViT's and BERT's
  ``train`` each write out in the JAX package (``vit.py:402-465``,
  ``bert.py:227-294``), shared: the masked mean cross-entropy on f32
  logits, AdamW under the warmup-cosine schedule (``model/optim.py``)
  unless the template passes its own optimizer (the CNNs' SGD, the
  feed-forward template's Adam), the per-epoch ``loss`` log, and the
  checkpoint and ``should_continue`` hooks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.optim import adamw


def train_epoch(step: Callable[[Any, dict], Tuple[Any, Any]], state: Any,
                batches: Iterable[dict]) -> Tuple[Any, float]:
    """Thread ``state`` through ``step(state, batch) -> (state, loss)``
    over one epoch of batches; returns (final state, mean loss as a float,
    NaN for an empty epoch)."""
    losses = []
    for batch in batches:
        state, loss = step(state, batch)
        losses.append(loss)
    if not losses:
        return state, float("nan")
    return state, float(np.mean([float(l) for l in losses]))


@dataclass
class GangSpec:
    """A template's functional training recipe: the contract the gang
    engine (``rafiki_tpu_torch/tuning``) drives. Templates opt in with
    the classmethods ``make_gang_spec(knobs, train_path, val_path)`` and
    ``gang_epochs(knobs, budget_scale)``.

    The JAX package writes one lane's functions and lets ``jax.vmap``
    add the lane axis. PyTorch has no such transform for the port's
    kernels (``torch.func.vmap`` refuses an ``autograd.Function``
    without ``setup_context``, and a ctypes launch cannot take a batched
    tensor), so a spec also gives the K-lane functions, written with an
    explicit leading lane axis: ``train_lanes`` and ``eval_lanes``.

    A ``state`` is a nested dict of tensors (params and optimizer
    state); a gang's has a leading K on every leaf. ``hp`` maps each
    traceable knob to an f32 tensor: 0-d for one lane, (K,) for a gang.
    Host batches are numpy dicts; a gang's carry a leading K, lane i's
    slice being what its sequential twin sees at that step.

    Contract (held by the tier-1 equivalence tests): the template's
    sequential ``train()`` calls ``init_lane`` and ``train_step`` itself,
    so a 1-lane gang, which the engine runs through ``train_step`` with
    no lane axis, is the sequential trial bit for bit."""

    #: traceable knob names (``traceable_knobs(get_knob_config())``)
    hp_names: Sequence[str]
    #: ``(generator, hp) -> state``: ONE lane's state (params + optimizer
    #: state); its structure must not depend on ``hp``
    init_lane: Callable[[torch.Generator, Dict[str, Any]], Any]
    #: ``(state, hp, batch) -> (state, loss)``: one step of one lane (the
    #: sequential step; it may update ``state`` in place)
    train_step: Callable[[Any, Dict[str, Any], Dict[str, Any]],
                         Tuple[Any, Any]]
    #: ``(epoch) -> iterator of host batch dicts``: the batches the
    #: template's sequential loop sees at that epoch
    epoch_batches: Callable[[int], Iterator[Dict[str, np.ndarray]]]
    #: scoring per ``score_kind``: "accuracy": ``(state, hp, xb) ->
    #: predicted class ids``; "lm": ``(state, hp, batch) -> (loss_sum,
    #: valid_count)``, one lane
    eval_lane: Callable[[Any, Dict[str, Any], Any], Any]
    #: ``() -> iterator of host eval batches`` (the stream the template's
    #: ``evaluate()`` walks)
    eval_batches: Callable[[], Iterator[Dict[str, np.ndarray]]]
    #: ``(lane_state, hp floats) -> blob``: a ``dump_parameters()``-shaped
    #: blob (host numpy)
    export_blob: Callable[[Any, Dict[str, float]], Dict[str, Any]]
    #: ``(fresh_state, parent_blob) -> state``: params from the blob, the
    #: optimizer fresh (the sequential warm start)
    warm_lane: Callable[[Any, Dict[str, Any]], Any]
    #: ``(stacked state, stacked hp, stacked batch) -> (state, (K,)
    #: losses)``: one step of K lanes, the lane axis explicit
    train_lanes: Optional[Callable[[Any, Dict[str, Any], Dict[str, Any]],
                                   Tuple[Any, Any]]] = None
    #: ``(stacked state, stacked hp, eval batch) -> K lanes' eval_lane``
    #: (the batch is shared); None scores each lane by ``eval_lane``
    eval_lanes: Optional[Callable[[Any, Dict[str, Any], Any], Any]] = None
    #: the template's SHARE_PARAMS policy knob: a proposal's warm start
    #: applies only when it is truthy
    share_params_knob: Optional[str] = None
    #: "accuracy" (classifiers) or "lm" (inverse perplexity)
    score_kind: str = "accuracy"
    #: tokens one training sample contributes (LM templates: max_len);
    #: feeds the per-lane tokens/s gauges, 0 disables them
    tokens_per_sample: int = 0
    #: parameters of one lane's forward, for the per-lane MFU estimate
    #: (6·N·tokens/s); 0 disables it
    lane_param_count: int = 0


def masked_ce(logits: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of f32 logits over the rows where ``mask`` is
    1 (``optax.softmax_cross_entropy_with_integer_labels``, masked)."""
    losses = F.cross_entropy(logits.float(), y.long(), reduction="none")
    return (losses * mask).sum() / mask.sum().clamp(min=1.0)


def fit(model: torch.nn.Module,
        objective: Callable[[torch.nn.Module, dict], torch.Tensor],
        epoch_batches: Callable[[int], Iterator[dict]], epochs: int,
        steps_per_epoch: int, knobs: Dict[str, Any], ctx: TrainContext,
        snapshot: Callable[[], Callable[[], Any]],
        make_optimizer: Optional[Callable[[int], Tuple[Any, Any]]] = None
        ) -> None:
    """Train ``model`` in place for ``epochs`` epochs of
    ``epoch_batches(epoch)``, one AdamW step of ``objective(model,
    batch)`` per batch. The knobs ``learning_rate``, ``weight_decay`` and
    ``warmup_frac`` (default 0.1) set the optimizer, unless
    ``make_optimizer(total_steps) -> (optimizer, scheduler or None)``
    gives another. After each epoch the
    mean loss is logged; with ``ctx.checkpoint``, ``snapshot()`` publishes
    the current weights and returns the blob factory to pass it. Each
    step is a ``fit.step`` range in a ``torch.profiler`` trace."""
    total_steps = epochs * steps_per_epoch
    if make_optimizer is not None:
        opt, sched = make_optimizer(total_steps)
    else:
        warmup = int(total_steps * float(knobs.get("warmup_frac", 0.1)))
        opt, sched = adamw(model.parameters(),
                           float(knobs["learning_rate"]), warmup,
                           total_steps, float(knobs["weight_decay"]))

    def step(state, batch):
        # a named range in a torch.profiler trace (profile_dir)
        with torch.profiler.record_function("fit.step"):
            opt.zero_grad(set_to_none=True)
            loss = objective(model, batch)
            loss.backward()
            opt.step()
            if sched is not None:
                sched.step()
        return state, loss.detach()

    def checkpoint(state, frac_done):
        ctx.checkpoint(snapshot(), frac_done=frac_done)

    run_epochs(step, None, epoch_batches, epochs, ctx, checkpoint)


def run_epochs(step: Callable[[Any, dict], Tuple[Any, Any]], state: Any,
               epoch_batches: Callable[[int], Iterable[dict]], epochs: int,
               ctx: TrainContext,
               checkpoint: Callable[[Any, float], None],
               plot: str = "Loss over epochs",
               log_extra: Optional[Dict[str, Any]] = None) -> Any:
    """The epoch loop every template's ``train`` runs: :func:`train_epoch`
    over ``epoch_batches(epoch)``, the mean loss logged (with
    ``log_extra``) under ``plot``; with ``ctx.checkpoint``,
    ``checkpoint(state, frac_done)`` after each epoch; then
    ``ctx.should_continue`` on the negated loss. Returns the final
    state."""
    ctx.logger.define_plot(plot, ["loss"], x_axis="epoch")
    for epoch in range(epochs):
        state, mean_loss = train_epoch(step, state, epoch_batches(epoch))
        ctx.logger.log(epoch=epoch, loss=mean_loss, **(log_extra or {}))
        if ctx.checkpoint is not None:
            checkpoint(state, (epoch + 1) / epochs)
        if ctx.should_continue is not None and \
                not ctx.should_continue(epoch, -mean_loss):
            break
    return state


def epoch_count(knobs: Dict[str, Any], budget_scale: float) -> int:
    """``max_epochs`` scaled by the trial's budget, at least 1, at most 2
    under ``quick_train``."""
    epochs = max(1, round(int(knobs["max_epochs"]) * float(budget_scale)))
    if knobs.get("quick_train"):
        epochs = min(epochs, 2)
    return epochs
