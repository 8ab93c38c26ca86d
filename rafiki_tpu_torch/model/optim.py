"""The templates' optimizers: AdamW under a warmup-cosine schedule (ViT,
BERT), SGD-Nesterov with masked decay under a cosine (the BatchNorm
CNNs), and Adam at a constant rate (the feed-forward template).

The port's counterpart of ``optax.adamw(optax.warmup_cosine_decay_schedule(
0.0, lr, max(warmup, 1), max(total, 2)), weight_decay=wd)``, as
``rafiki_tpu/models/vit.py`` and ``bert.py`` build it:

- :func:`warmup_cosine_decay` is optax's schedule: linear from
  ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine to
  ``end_value`` over the remaining ``decay_steps - warmup_steps`` (optax's
  ``decay_steps`` includes the warmup);
- :func:`adamw` is ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8
  outside the square root, decay on every parameter, as optax's mask None)
  under a ``LambdaLR`` that sets the step's absolute learning rate.
  optax reads the schedule at the update count *before* the update, so
  the first step runs at ``schedule(0)`` (0 for these templates); a
  ``LambdaLR`` stepped after each ``optimizer.step()`` does the same.
  Both scale the decay by the scheduled rate: optax's
  ``-lr·(adam + wd·p)`` is AdamW's ``p·(1 − lr·wd)`` then ``−lr·adam``;
- :func:`sgd_nesterov` is the CNN recipe of
  ``rafiki_tpu/models/_cnn_base.py``: ``optax.chain(add_decayed_weights(
  wd, mask), sgd(cosine_decay_schedule(lr, total), momentum=0.9,
  nesterov=True))``, where the mask exempts every leaf named ``bias`` or
  ``scale``. optax adds ``wd·p`` to the gradient, keeps the trace
  ``t = g + 0.9·t`` from zero and steps ``−lr(count)·(g + 0.9·t)`` with
  the count read before it is incremented: ``torch.optim.SGD`` with
  ``nesterov=True`` and per-group ``weight_decay`` computes the same,
  its first momentum buffer being the first gradient (= ``g + 0.9·0``),
  under a ``LambdaLR`` stepped after each update;
- :func:`adam` is the feed-forward template's ``optax.scale_by_adam()``
  followed by ``−lr`` (``rafiki_tpu/models/mlp.py``): Adam at a constant
  rate (b1 0.9, b2 0.999, eps 1e-8 outside the square root).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """The learning rate at each update count."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(float(count - warmup_steps), cos_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t
                                                     / cos_steps)) + alpha
        return peak_value * decayed

    return schedule


def adamw(params: Iterable[torch.Tensor], learning_rate: float,
          warmup_steps: int, total_steps: int, weight_decay: float
          ) -> Tuple[torch.optim.Optimizer,
                     torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)``: call ``optimizer.step()`` then
    ``scheduler.step()`` once per batch. The schedule is
    ``warmup_cosine_decay(0, learning_rate, max(warmup_steps, 1),
    max(total_steps, 2))``, the templates' own clamping."""
    schedule = warmup_cosine_decay(0.0, learning_rate, max(warmup_steps, 1),
                                   max(total_steps, 2))
    # lr 1.0 as the base: the lambda returns the absolute rate
    opt = torch.optim.AdamW(list(params), lr=1.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def cosine_decay(init_value: float, decay_steps: int,
                 alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)``:
    the rate at each update count, flat at ``alpha·init_value`` past
    ``decay_steps``."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must be positive")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cos = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1 - alpha) * cos + alpha)

    return schedule


#: leaves the CNN recipe does not decay: biases and BatchNorm scales
NO_DECAY_LEAVES = ("bias", "scale")


def sgd_nesterov(named_params: Iterable[Tuple[str, torch.Tensor]],
                 learning_rate: float, total_steps: int,
                 weight_decay: float
                 ) -> Tuple[torch.optim.Optimizer,
                            torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)`` of the CNN recipe over a module's
    ``named_parameters()``: call ``optimizer.step()`` then
    ``scheduler.step()`` once per batch."""
    decay, no_decay = [], []
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        (no_decay if leaf in NO_DECAY_LEAVES else decay).append(p)
    opt = torch.optim.SGD(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=1.0, momentum=0.9, nesterov=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, cosine_decay(learning_rate, total_steps))


def adam(params: Iterable[torch.Tensor], learning_rate: float
         ) -> Tuple[torch.optim.Optimizer, Optional[object]]:
    """``(optimizer, None)``: Adam at the constant ``learning_rate`` (no
    scheduler)."""
    return torch.optim.Adam(list(params), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8), None
