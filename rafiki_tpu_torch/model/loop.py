"""The templates' training loop.

- :func:`train_epoch` is the port's counterpart of ``train_epoch`` from
  ``rafiki_tpu/model/loop.py``. JAX's double-buffered host→device
  prefetch under a sharding and its bounded run-ahead sync have no
  counterpart: eager PyTorch queues each step's kernels as it goes, and
  the batch copy is the template's. The losses stay device scalars until
  the end of the epoch, where their mean is read once.
- :func:`masked_ce` and :func:`fit` are the loop that ViT's and BERT's
  ``train`` each write out in the JAX package (``vit.py:402-465``,
  ``bert.py:227-294``), shared: the masked mean cross-entropy on f32
  logits, AdamW under the warmup-cosine schedule (``model/optim.py``),
  the per-epoch ``loss`` log, and the checkpoint and ``should_continue``
  hooks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Tuple

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
        snapshot: Callable[[], Callable[[], Any]]) -> None:
    """Train ``model`` in place for ``epochs`` epochs of
    ``epoch_batches(epoch)``, one AdamW step of ``objective(model,
    batch)`` per batch. The knobs ``learning_rate``, ``weight_decay`` and
    ``warmup_frac`` (default 0.1) set the optimizer. After each epoch the
    mean loss is logged; with ``ctx.checkpoint``, ``snapshot()`` publishes
    the current weights and returns the blob factory to pass it."""
    total_steps = epochs * steps_per_epoch
    warmup = int(total_steps * float(knobs.get("warmup_frac", 0.1)))
    opt, sched = adamw(model.parameters(), float(knobs["learning_rate"]),
                       warmup, total_steps, float(knobs["weight_decay"]))

    def step(state, batch):
        opt.zero_grad(set_to_none=True)
        loss = objective(model, batch)
        loss.backward()
        opt.step()
        sched.step()
        return state, loss.detach()

    ctx.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
    for epoch in range(epochs):
        _, mean_loss = train_epoch(step, None, epoch_batches(epoch))
        ctx.logger.log(epoch=epoch, loss=mean_loss)
        if ctx.checkpoint is not None:
            ctx.checkpoint(snapshot(), frac_done=(epoch + 1) / epochs)
        if ctx.should_continue is not None and \
                not ctx.should_continue(epoch, -mean_loss):
            break


def epoch_count(knobs: Dict[str, Any], ctx: TrainContext) -> int:
    """``max_epochs`` scaled by the trial's budget, at least 1, at most 2
    under ``quick_train``."""
    epochs = max(1, round(int(knobs["max_epochs"])
                          * float(ctx.budget_scale)))
    if knobs.get("quick_train"):
        epochs = min(epochs, 2)
    return epochs
