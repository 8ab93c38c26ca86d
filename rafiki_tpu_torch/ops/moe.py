"""Mixture-of-Experts FFN: top-k capacity routing over SwiGLU experts.

Ports ``rafiki_tpu/ops/moe.py`` (its expert parallelism is a sharding
of the stacked expert axis over a mesh: the mesh step,
``models/llama_mesh.py``, runs :func:`expert_outputs` over each shard's
range of experts):

- :data:`MOE_AUX_COEF`, the weight of the load-balancing term in the
  train objective;
- :func:`router_dispatch`, the routing as JAX returns it: one-hot
  ``dispatch`` and ``combine`` tensors over (token, expert, slot) and the
  Switch aux loss;
- :func:`route`, the same routing as slot indices and gates, and
  :func:`expert_outputs`, a range of experts run on the tokens a
  routing gave them;
- :class:`MoEFeedForward`, the routed SwiGLU FFN, whose ``forward``
  returns ``(y, aux)``: the aux is an output, not a sown collection;
- :func:`moe_aux_loss`, the sum of a forward's aux terms.

The routing is JAX's: the router in f32; top-k with ties to the lower
expert index (``lax.top_k``); Switch gates (the raw probability) at
k = 1, gates renormalized over the chosen set at k > 1; capacity
``ceil(T·k·capacity_factor / E)`` slots per expert, filled by all first
choices in arrival order, then all second choices, and so on; a choice
past its expert's capacity is dropped, so a token that loses every
choice gets exact zeros (the residual stream carries it).

:class:`MoEFeedForward` moves tokens by index, not by the one-hot
products JAX's einsums run: slots are a gather of the token rows (a
one-hot f32 product gives the same bits), the experts three batched
matmuls in the compute dtype, and each token's output the sum over its
kept choices of gate × its slot's f32 output (JAX's combine einsum adds
the same products, with zeros between them). No (T, E, C) tensor
exists.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: weight of the load-balancing aux loss in the train objective (the
#: Switch Transformer's)
MOE_AUX_COEF = 0.01


class Routing(NamedTuple):
    """One routing of T tokens to E experts of ``capacity`` slots each:
    ``slots`` (k, T) int64, each choice's flat slot ``e·capacity + c`` or
    ``E·capacity`` where it was dropped; ``gates`` (k, T) f32, each
    choice's gate (differentiable into the router); ``aux`` the f32
    load-balancing loss."""
    slots: torch.Tensor
    gates: torch.Tensor
    aux: torch.Tensor
    capacity: int
    n_experts: int


def expert_capacity(n_tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float = 1.25) -> int:
    """Slots per expert: ``ceil(T·k·capacity_factor / E)``, at least 1,
    in the float arithmetic JAX's module does."""
    return max(1, int(-(-n_tokens * top_k * capacity_factor
                        // n_experts)))


def route(logits: torch.Tensor, capacity: int, top_k: int = 1) -> Routing:
    """Top-k capacity routing from (T, E) router logits (see the module
    docstring for the rules)."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    # top-k by repeated argmax: the first maximum wins a tie, as in
    # lax.top_k (torch.topk leaves the order of ties unspecified)
    left = probs.detach()
    idx, vals = [], []
    for _ in range(top_k):
        i = left.argmax(dim=-1)
        idx.append(i)
        vals.append(probs.gather(1, i[:, None])[:, 0])
        left = left.scatter(1, i[:, None], -math.inf)
    top_vals = torch.stack(vals, dim=1)  # (T, k)
    if top_k == 1:
        gates = top_vals  # Switch: the raw probability
    else:
        gates = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                       min=1e-9)
    filled = torch.zeros(e, dtype=torch.int64, device=logits.device)
    slots = []
    for j in range(top_k):
        onehot = F.one_hot(idx[j], e)  # (T, E) int64
        # earlier same-choice tokens plus the slots higher-priority
        # choices took
        position = ((torch.cumsum(onehot, 0) - onehot + filled[None, :])
                    * onehot).sum(-1)
        keep = position < capacity
        slots.append(torch.where(keep, idx[j] * capacity + position,
                                 torch.full_like(position, e * capacity)))
        filled = filled + (onehot * keep[:, None]).sum(0)
    top1 = F.one_hot(idx[0], e).float()
    aux = e * torch.sum(top1.mean(0) * probs.mean(0))
    return Routing(torch.stack(slots), gates.t(), aux, capacity, e)


def router_dispatch(logits: torch.Tensor, capacity: int, top_k: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``router_dispatch``: ``(dispatch, combine, aux)``, the first
    two (T, E, capacity) f32 — ``dispatch`` one at each kept choice's
    slot, ``combine`` that times the choice's gate (the router's gradient
    path)."""
    r = route(logits, capacity, top_k)
    t = logits.shape[0]
    width = r.n_experts * capacity + 1  # the last column: dropped
    dispatch = torch.zeros(t, width, device=logits.device)
    combine = torch.zeros(t, width, device=logits.device)
    for j in range(top_k):
        col = r.slots[j][:, None]
        dispatch = dispatch.scatter_add(1, col, torch.ones_like(
            r.gates[j][:, None]))
        combine = combine.scatter_add(1, col, r.gates[j][:, None])
    shape = (t, r.n_experts, capacity)
    return (dispatch[:, :-1].reshape(shape), combine[:, :-1].reshape(shape),
            r.aux)


def expert_outputs(x: torch.Tensor, r: Routing, gate: torch.Tensor,
                   up: torch.Tensor, down: torch.Tensor, first_expert: int = 0,
                   tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 output, (n, d), of experts ``first_expert ..
    first_expert + E_local - 1`` (``gate`` and ``up`` (E_local, d, h),
    ``down`` (E_local, h, d), in the compute dtype) for the ``n`` tokens
    ``x`` holds, which are the routing ``r``'s tokens ``tokens`` ((n,)
    indices; None: its first n): each token's sum over its kept choices
    of those experts of gate × its slot's output (zero where it has
    none)."""
    n, d = x.shape
    cap = r.capacity
    width = gate.shape[0] * cap
    lo = first_expert * cap
    if tokens is None:
        tokens = torch.arange(n, device=x.device)
    mine = r.slots[:, tokens]
    # each choice's slot among these experts' (width: not one of them)
    local = torch.where((mine >= lo) & (mine < lo + width), mine - lo,
                        torch.full_like(mine, width))
    # each slot's token (n: an empty slot, the zero row below)
    owner = torch.full((width + 1,), n, dtype=torch.int64, device=x.device)
    rows = torch.arange(n, device=x.device)
    for c in range(local.shape[0]):
        owner = owner.scatter(0, local[c], rows)
    slots = torch.cat([x, x.new_zeros(1, d)])[owner[:-1]].reshape(-1, cap,
                                                                 d)
    g = torch.bmm(slots, gate)
    u = torch.bmm(slots, up)
    o = torch.bmm(F.silu(g) * u, down)
    outs = torch.cat([o.float().reshape(width, d),
                      o.new_zeros(1, d, dtype=torch.float32)])
    y = None
    for c in range(local.shape[0]):
        yc = r.gates[c][tokens, None] * outs[local[c]]
        y = yc if y is None else y + yc
    return y


def _lecun(shape: Sequence[int], fan_in: int, device: torch.device,
           gen: torch.Generator) -> nn.Parameter:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
    return nn.Parameter(t, requires_grad=False)


class MoEFeedForward(nn.Module):
    """Top-k routed SwiGLU experts (``top_k`` 1: Switch, 2: Mixtral's).
    Leaves, all f32 as JAX keeps them: ``router`` (d, E),
    ``experts_gate`` and ``experts_up`` (E, d, h), ``experts_down``
    (E, h, d). Random init: the router N(0, 0.02²), the experts N(0,
    1/fan_in) with flax's fan-in for a stacked kernel (E·d, E·h), drawn
    from the caller's generator (the JAX module draws a truncated
    lecun normal; the port only needs a seeded start). The experts run in
    the input's dtype, each cast per call as JAX casts them."""

    def __init__(self, hidden: int, n_experts: int, mlp_dim: int,
                 device: torch.device, gen: torch.Generator,
                 top_k: int = 1, capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.n_experts = int(n_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        e, d, h = self.n_experts, int(hidden), int(mlp_dim)
        r = torch.empty((d, e), dtype=torch.float32, device=device)
        r.normal_(0.0, 0.02, generator=gen)
        self.router = nn.Parameter(r, requires_grad=False)
        self.experts_gate = _lecun((e, d, h), e * d, device, gen)
        self.experts_up = _lecun((e, d, h), e * d, device, gen)
        self.experts_down = _lecun((e, h, d), e * h, device, gen)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x`` (..., d): every leading position is a token, routed in
        row-major order. Returns ``(y, aux)``, y in x's shape and dtype,
        aux the f32 load-balancing loss of this call."""
        d = x.shape[-1]
        xf = x.reshape(-1, d)
        t, e = xf.shape[0], self.n_experts
        capacity = expert_capacity(t, self.top_k, e, self.capacity_factor)
        r = route(xf.float() @ self.router.float(), capacity, self.top_k)
        cdt = x.dtype
        y = expert_outputs(xf, r, self.experts_gate.to(cdt),
                           self.experts_up.to(cdt),
                           self.experts_down.to(cdt))
        return y.to(x.dtype).reshape(x.shape), r.aux


def moe_aux_loss(aux: Sequence[torch.Tensor],
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum, in order from 0, of a forward's aux terms (JAX sums every
    sown ``moe_aux``), f32; 0 on ``device`` for a dense model's empty
    list."""
    total = torch.zeros((), dtype=torch.float32,
                        device=aux[0].device if aux else device)
    for a in aux:
        total = total + a.float()
    return total
