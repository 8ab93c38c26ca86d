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
- :func:`lane_adam_init` / :func:`lane_adam_step` are the functional
  chain the feed-forward and LoRA templates' gang lanes and their
  sequential twins share (``rafiki_tpu/models/mlp.py``,
  ``llama_lora.py``):
  ``optax.scale_by_adam()``, then ``add_decayed_weights(wd)`` when ``wd``
  is set, then ``× −lr``, in optax's order of operations, over a dict of
  f32 leaves. The rate and the update count are tensors: 0-d for one
  lane, (K,) for a gang whose leaves carry a leading K, so every lane
  steps at its own rate and count (a refilled lane restarts at 0).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Tuple

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


def lane_adam_init(params: Dict[str, torch.Tensor],
                   lanes: Tuple[int, ...] = ()) -> Dict[str, Any]:
    """``scale_by_adam``'s state over ``params``: f32 zero moments and an
    int32 count of shape ``lanes`` (``()`` for one lane, ``(K,)``)."""
    dev = next(iter(params.values())).device
    return {"count": torch.zeros(lanes, dtype=torch.int32, device=dev),
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


def _lanes(f: torch.Tensor, leaves: List[torch.Tensor]):
    """The lane-shaped factor ``f`` as a foreach operand over ``leaves``:
    the 0-d tensor itself for one lane, else one view per leaf that
    broadcasts over its trailing axes."""
    if f.dim() == 0:
        return f
    return [f.reshape(f.shape + (1,) * (x.dim() - f.dim())) for x in leaves]


@torch.no_grad()
def lane_adam_step(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], opt: Dict[str, Any],
                   lr: torch.Tensor, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> None:
    """One update in place: ``mu = (1−b1)·g + b1·mu``, ``nu = (1−b2)·g² +
    b2·nu``, ``u = mu/(1−b1^t) / (sqrt(nu/(1−b2^t)) + eps)`` with ``t``
    the count after this step, ``u += wd·p`` (``wd`` > 0), ``p += (−lr)·u``.
    ``lr`` has the count's shape; each leaf's leading axes match it.

    Every operation is one ``torch._foreach_*`` call over all the leaves,
    as ``torch.optim.AdamW(foreach=True)`` steps: on the card a few
    multi-tensor launches per operation, not one per leaf. ``mu`` is a
    ``lerp`` and ``nu`` an ``addcmul`` (optax's values, rounded in
    another order); the decay stays ``u + wd·p`` before ``× −lr``, since
    AdamW's ``p·(1 − lr·wd)`` rounds to ``p`` in f32 at the LoRA
    template's lr·wd of 1e-8. With K lanes the per-lane factors
    broadcast leaf by leaf."""
    count = opt["count"] + 1
    opt["count"].copy_(count)
    t = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)
    neg_lr = -lr.float()
    ps = list(params.values())
    gs = [grads[n] for n in params]
    mus = [opt["mu"][n] for n in params]
    nus = [opt["nu"][n] for n in params]
    torch._foreach_lerp_(mus, gs, 1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1.0 - b2)
    den = torch._foreach_div(nus, _lanes(bc2, nus))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(mus, _lanes(bc1, mus))
    torch._foreach_div_(u, den)
    del den
    if weight_decay:
        torch._foreach_add_(u, ps, alpha=weight_decay)
    torch._foreach_mul_(u, _lanes(neg_lr, u))
    torch._foreach_add_(ps, u)
