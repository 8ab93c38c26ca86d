"""Ring attention: sequence-parallel exact attention over a mesh axis.

Ports ``rafiki_tpu/ops/ring_attention.py`` (``ring_attention``). The
sequence dim is split over ``mesh[axis]``: every position holds an L/P
slice of Q, K and V, and the K/V blocks rotate around the ring
(:func:`~rafiki_tpu_torch.parallel.collectives.ppermute`'s one hop) while
each position accumulates its queries' attention over every block. Each
resident block runs through the flash kernels
(:func:`~rafiki_tpu_torch.ops.attention.flash_attention_lse`'s B3 forward;
:func:`~rafiki_tpu_torch.ops.attention.flash_attention_block_bwd`'s B5 and
B6), so no position ever holds an (L/P)² score matrix.

- *Forward ring.* Each position merges the blocks' ``(out_s, lse_s)`` in
  f32 with JAX's online max / rescale (``m`` starts at ``NEG_INF``), then
  returns ``out`` in q's dtype and keeps ``lse_tot = m + log l``. The
  K/V rotate ``P − 1`` times.
- *Backward ring.* The dK/dV accumulators (f32) travel with their block
  and come home after ``P`` hops; each block's grads use the GLOBAL
  ``lse_tot`` and ``delta = rowsum(g·out)``, so they sum exactly.
- *GQA.* Only the ``n_kv_heads`` tensors rotate; each resident block is
  repeated locally (``repeat_interleave``, JAX's ``jnp.repeat``) and its
  dK/dV summed back over each kv head's ``rep`` query heads.
- *Causality* from global positions at block granularity: step 0 is the
  causal diagonal, a strictly past block is non-causal, a strictly future
  block is skipped with a Python ``if`` (no launch: JAX's ``lax.cond``).

:func:`ring_attention` is one ``torch.autograd.Function`` over the
per-position tensors of the mesh that one process drives (one ring per
group of positions that differ only along ``axis``): pass lists, one
(b, h, L/P, d) tensor per mesh position in flat order, and get the
outputs so. Global (b, h, L, d) tensors are also taken, as JAX takes
them: they are split by ``(batch_axis, head_axis, axis)`` and the output
joined back the same way; ``head_axis`` then checks JAX's divisibility.
Where a ring's positions share one card, a hop relabels their tensors
and copies nothing. The plain version is the same ring over the plain
B3/B5/B6 (CPU tensors).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from rafiki_tpu_torch.ops.attention import (NEG_INF,
                                            flash_attention_block_bwd,
                                            flash_attention_lse)
from rafiki_tpu_torch.ops.common import gqa_repeat_factor
from rafiki_tpu_torch.parallel.collectives import (axis_groups,
                                                   from_positions, ppermute,
                                                   to_positions)
from rafiki_tpu_torch.parallel.sharding import Mesh

Tensor = torch.Tensor
Tensors = Union[Tensor, Sequence[Tensor]]


def _expand(t: Tensor, rep: int) -> Tensor:
    """A resident K/V block repeated to the query heads (local work; the
    ring never carries the copies)."""
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _reduce_groups(t: Tensor, rep: int) -> Tensor:
    """(b, h, l, d) → (b, h / rep, l, d): each kv head's gradient summed
    over its ``rep`` query heads (the VJP of :func:`_expand`)."""
    if rep == 1:
        return t
    b, h, l, d = t.shape
    return t.reshape(b, h // rep, rep, l, d).sum(2)


def _skipped(causal: bool, s: int, i: int, n: int) -> bool:
    """Step ``s`` of position ``i``'s ring holds the block that started on
    ``(i − s) mod n``: strictly in the future of ``i``'s queries."""
    return causal and s > 0 and (i - s) % n > i


def _ring_fwd(ql: List[Tensor], kl: List[Tensor], vl: List[Tensor],
              devs: List[torch.device], scale: float, causal: bool,
              rep: int) -> Tuple[List[Tensor], List[Tensor]]:
    """One ring's forward: each member's ``(out, lse_tot)``."""
    n = len(ql)
    m = [torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                    device=q.device) for q in ql]
    l = [torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
         for q in ql]
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in ql]
    kb, vb = list(kl), list(vl)
    for s in range(n):
        for i in range(n):
            if _skipped(causal, s, i, n):
                continue  # a skipped block's weight underflows to 0
            out_s, lse_s = flash_attention_lse(
                ql[i], _expand(kb[i], rep), _expand(vb[i], rep), scale,
                causal and s == 0)
            m_new = torch.maximum(m[i], lse_s)
            alpha = torch.exp(m[i] - m_new)
            w = torch.exp(lse_s - m_new)
            acc[i] = acc[i] * alpha[..., None] + \
                out_s.float() * w[..., None]
            l[i] = l[i] * alpha + w
            m[i] = m_new
        if s + 1 < n:  # one hop around the ring
            kb, vb = ppermute(kb, devs), ppermute(vb, devs)
    outs, lses = [], []
    for i in range(n):
        norm = torch.clamp(l[i], min=1e-30)
        outs.append((acc[i] / norm[..., None]).to(ql[i].dtype))
        lses.append(m[i] + torch.log(norm))
    return outs, lses


def _ring_bwd(ql, kl, vl, ol, lsel, gl, devs, scale: float, causal: bool,
              rep: int) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """One ring's backward: the members' (dq, dk, dv) in their inputs'
    dtypes."""
    n = len(ql)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in ql]
    dkb = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in kl]
    dvb = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for v in vl]
    kb, vb = list(kl), list(vl)
    for s in range(n):
        for i in range(n):
            if _skipped(causal, s, i, n):
                continue
            dq_s, dk_s, dv_s = flash_attention_block_bwd(
                ql[i], _expand(kb[i], rep), _expand(vb[i], rep), ol[i],
                lsel[i], gl[i], scale, causal and s == 0)
            dq[i] = dq[i] + dq_s
            dkb[i] = dkb[i] + _reduce_groups(dk_s, rep)
            dvb[i] = dvb[i] + _reduce_groups(dv_s, rep)
        # the accumulators travel WITH their block: after n hops each is
        # home holding every member's contribution
        kb, vb = ppermute(kb, devs), ppermute(vb, devs)
        dkb, dvb = ppermute(dkb, devs), ppermute(dvb, devs)
    return ([d.to(q.dtype) for d, q in zip(dq, ql)],
            [d.to(k.dtype) for d, k in zip(dkb, kl)],
            [d.to(v.dtype) for d, v in zip(dvb, vl)])


class _Ring(torch.autograd.Function):
    """Every ring of the mesh in one Function: the forward saves only the
    positions' q/k/v, outputs and combined LSEs (a naive autograd of the
    unrolled ring would keep every rotated block)."""

    @staticmethod
    def forward(ctx, groups, devs, scale, causal, rep, *tensors):
        n = len(tensors) // 3
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        outs: List[Optional[Tensor]] = [None] * n
        lses: List[Optional[Tensor]] = [None] * n
        for g in groups:
            o, lse = _ring_fwd([qs[p] for p in g], [ks[p] for p in g],
                               [vs[p] for p in g], [devs[p] for p in g],
                               scale, causal, rep)
            for p, a, b in zip(g, o, lse):
                outs[p], lses[p] = a, b
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.meta = (groups, devs, scale, causal, rep, n)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        groups, devs, scale, causal, rep, n = ctx.meta
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        gs = [torch.zeros_like(o) if g is None else g
              for g, o in zip(grads, outs)]
        dq, dk, dv = [None] * n, [None] * n, [None] * n
        for g in groups:
            a, b, c = _ring_bwd([qs[p] for p in g], [ks[p] for p in g],
                                [vs[p] for p in g], [outs[p] for p in g],
                                [lses[p] for p in g], [gs[p] for p in g],
                                [devs[p] for p in g], scale, causal, rep)
            for p, x, y, z in zip(g, a, b, c):
                dq[p], dk[p], dv[p] = x, y, z
        return (None,) * 5 + tuple(dq) + tuple(dk) + tuple(dv)


def ring_attention(q: Tensors, k: Tensors, v: Tensors, mesh: Mesh,
                   axis: str, sm_scale: Optional[float] = None,
                   causal: bool = False, batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None) -> Tensors:
    """Exact attention with Q/K/V sequence-split over ``mesh[axis]``.

    ``q``/``k``/``v``: one (b, h, L/P, d) tensor per mesh position (a
    list in flat order), or global (b, h, L, d) tensors, split by
    ``(batch_axis, head_axis, axis)`` as JAX places them; the output comes
    back in the same form. ``k``/``v`` may carry ``h / rep`` kv heads
    (GQA: query head g reads kv head ``g // rep``). Differentiable in q,
    k and v through the reverse ring."""
    if isinstance(q, torch.Tensor):
        h, h_kv = q.shape[1], k.shape[1]
        gqa_repeat_factor(h, h_kv)
        tp = mesh.shape[head_axis] if head_axis is not None else 1
        if h % tp or h_kv % tp:
            raise ValueError(
                f"ring_attention with head_axis needs heads ({h}) and "
                f"kv_heads ({h_kv}) divisible by mesh[{head_axis!r}] "
                f"({tp})")
        spec = (batch_axis, head_axis, axis)
        outs = ring_attention(*(to_positions(t, mesh, spec)
                                for t in (q, k, v)), mesh, axis, sm_scale,
                              causal)
        return from_positions(outs, mesh, spec, q.device)
    qs, ks, vs = list(q), list(k), list(v)
    rep = gqa_repeat_factor(qs[0].shape[1], ks[0].shape[1])
    scale = sm_scale if sm_scale is not None else \
        1.0 / math.sqrt(qs[0].shape[-1])
    groups = axis_groups(mesh, axis)
    outs = _Ring.apply(groups, mesh.flat_devices(), float(scale),
                       bool(causal), rep,
                       *(t.contiguous() for t in qs + ks + vs))
    return list(outs)
