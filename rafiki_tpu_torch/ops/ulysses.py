"""Ulysses sequence parallelism: an all-to-all head / sequence swap.

Ports ``rafiki_tpu/ops/ulysses.py`` (``ulysses_attention``). Instead of
rotating K/V around a ring (``ops/ring_attention.py``), two all-to-alls
(:func:`~rafiki_tpu_torch.parallel.collectives.all_to_all`) swap the split
axis from sequence to heads and back: each position runs the ordinary
full-sequence :func:`~rafiki_tpu_torch.ops.attention.flash_attention`
(B3 forward, B5 + B6 backward) on its group of ``h / P`` heads, so the
causal mask needs no offset bookkeeping. Differentiable end to end: the
all-to-all's autograd rule is the inverse all-to-all.

GQA: ``k``/``v`` may carry ``h / rep`` kv heads. When the kv heads also
divide the axis (``small_swap``), the un-repeated K/V ride the
all-to-alls and each position repeats its landed chunk: contiguous head
tiling sends q heads ``[p·h/P, (p+1)·h/P)`` and kv heads ``[p·h_kv/P,
(p+1)·h_kv/P)`` to the same position p. Otherwise K/V repeat before the
swap. With ``head_axis`` the heads are also split over that axis (tensor
parallelism) and the swap runs within each head group.

As ``ring_attention``: per-position lists (flat mesh order, one (b, h,
L/P, d) tensor each) in and out, or global tensors split by
``(batch_axis, head_axis, axis)``. JAX's ``ValueError`` texts are kept.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rafiki_tpu_torch.ops.attention import flash_attention
from rafiki_tpu_torch.ops.common import gqa_repeat_factor
from rafiki_tpu_torch.ops.ring_attention import Tensors
from rafiki_tpu_torch.parallel.collectives import (all_to_all,
                                                   from_positions, on_axis,
                                                   to_positions)
from rafiki_tpu_torch.parallel.sharding import Mesh


def _check_heads(h_local: int, n_par: int, axis: str) -> None:
    if h_local % n_par:
        raise ValueError(
            f"ulysses needs per-shard heads % mesh[{axis!r}] == 0; got "
            f"{h_local} heads over {n_par} devices "
            "(use ring_attention instead)")


def ulysses_attention(q: Tensors, k: Tensors, v: Tensors, mesh: Mesh,
                      axis: str, sm_scale: Optional[float] = None,
                      causal: bool = False,
                      batch_axis: Optional[str] = None,
                      head_axis: Optional[str] = None) -> Tensors:
    """Attention over (b, h, L, d) with the sequence split over
    ``mesh[axis]``; the (per-shard) heads must divide by that axis's
    size. Inputs and output as :func:`ring_attention` takes them."""
    n_par = mesh.shape[axis]
    if isinstance(q, torch.Tensor):
        h, h_kv = q.shape[1], k.shape[1]
        gqa_repeat_factor(h, h_kv)
        tp = mesh.shape[head_axis] if head_axis is not None else 1
        if h % tp or h_kv % tp:
            raise ValueError(
                f"ulysses with head_axis needs heads ({h}) and kv_heads "
                f"({h_kv}) divisible by mesh[{head_axis!r}] ({tp})")
        _check_heads(h // tp, n_par, axis)
        spec = (batch_axis, head_axis, axis)
        outs = ulysses_attention(*(to_positions(t, mesh, spec)
                                   for t in (q, k, v)), mesh, axis,
                                 sm_scale, causal)
        return from_positions(outs, mesh, spec, q.device)
    qs, ks, vs = list(q), list(k), list(v)
    h_local, h_kv_local = qs[0].shape[1], ks[0].shape[1]
    rep = gqa_repeat_factor(h_local, h_kv_local)
    _check_heads(h_local, n_par, axis)
    small_swap = rep > 1 and h_kv_local % n_par == 0
    scale = sm_scale if sm_scale is not None else \
        1.0 / math.sqrt(qs[0].shape[-1])

    def swap(xs):
        # (b, h, L/P, d) → (b, h/P, L, d): split heads, gather sequence
        return on_axis(mesh, axis, all_to_all, xs, 1, 2)

    def repeat(t):
        return t.repeat_interleave(rep, dim=1) if rep > 1 else t

    def kv(xs):
        if small_swap:  # the small tensors ride the swap, repeated after
            return [repeat(t) for t in swap(xs)]
        return swap([repeat(t) for t in xs])

    qh, kh, vh = swap(qs), kv(ks), kv(vs)
    oh = [flash_attention(a, b, c, sm_scale=scale, causal=causal)
          for a, b, c in zip(qh, kh, vh)]
    # the inverse: split the sequence back out, gather this shard's heads
    return on_axis(mesh, axis, all_to_all, oh, 2, 1)
