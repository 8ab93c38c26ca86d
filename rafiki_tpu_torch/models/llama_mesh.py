"""The sharded train step of ``LlamaLoRA`` on a (data, model), (data, sp)
or (data, sp, model) mesh.

Ports the mesh loop of ``rafiki_tpu/models/llama_lora.py``
(``LlamaLoRA.train`` where ``gang_blockers`` names ``model_parallel`` or
``sequence_parallel``): every leaf is sharded by ``TP_RULES`` over
``model`` (none on a (data, sp) mesh, as in JAX) and fsdp over ``data``
(``param_shardings(..., fsdp=True, min_size=2 ** 12)``, JAX's specs leaf
for leaf, the LoRA leaves included), the batch is split over ``data``
and its sequence over ``sp``, and one process drives every shard
(:mod:`rafiki_tpu_torch.parallel.collectives`). Where XLA partitions
JAX's global program, the port writes the sharded program out:

- a leaf is gathered over ``data`` where it is used (fsdp); a frozen
  kernel's gather is not kept for the backward, which gathers it again
  (:class:`_RegatherMatmul`), so a shard holds one gathered kernel at a
  time;
- ``tok_embed`` is split on hidden: each shard looks up its columns and
  they are all-gathered;
- column-parallel ``wq``/``wk``/``wv``/``gate``/``up`` compute their
  shard of the output; row-parallel ``wo``/``down`` their partial sums,
  all-reduced over ``model``; a LoRA site's rank-wide leaves are
  gathered where the rule split them (a rule's ``-1`` puts ``lora_a``'s
  rank on ``model``);
- attention runs per shard over its ``n_heads / mp`` query heads and the
  ``n_kv_heads / mp`` KV heads they read, one ``flash_attention`` call
  (B3 forward, B5 + B6 backward) per shard per layer; where the KV heads
  do not divide over ``model``, K and V are all-gathered and each shard
  takes the heads its queries read;
- ``lm_head`` is split on vocab: each shard's log-sum-exp is
  all-gathered and combined, and each shard's part of the loss takes the
  gradient with respect to its logits (:class:`_VocabShardCE`);
- a MoE block (``TP_RULES["experts"]``, dim 0) gives each shard ``E /
  mp`` experts; the routing is ``ops/moe.py``'s over the whole batch
  (the router logits are all-gathered over ``sp`` and ``data`` into the
  batch's row-major token order, as JAX routes its global batch), each
  shard runs its experts on its own tokens, and one all-reduce over
  ``model`` sums the outputs;
- with ``sp``: each position holds its (B / dp, L / sp) slice of every
  activation; rope runs at the global token positions; attention is
  ``ops/ring_attention.py``'s where a shard's ``n_heads / mp`` heads do
  not divide over ``sp``, else ``ops/ulysses.py``'s (JAX's
  ``_DecoderAttention`` dispatch), both without ``kv_lens``; the
  next-token targets are shifted over the whole sequence before they
  are split; with ``loss_chunk`` the loss is ``chunked_lm_loss_terms_sp``
  (a (data, sp) mesh: JAX refuses it with ``model``).

No spec names ``sp``, so a leaf is replicated over it. The positions of
an ``sp`` group that sit on one device hold ONE tensor of each leaf, one
autograd leaf in the step (whose gradient autograd sums over the group)
and one Adam state: on one card an ``sp`` replica costs no memory, as it
would cost a card of its own on a mesh of cards
(``llama_lora.colocated_train_bytes`` counts it so). The leaf says which
(``ShardedLeaf.owner``: each position's first holder of its tensor), and
the step, the gathers, Adam and the replica sums run once per owner.

The step is the one-card step's: the rank-scale merged into ``lora_b``,
``grad_accum`` micro-batches over the global valid count, the streamed
loss, the MoE aux term and each block under the knobs' checkpointing
schedule. The gradient of a leaf's slice is the sum over the positions
holding a copy of it (the all-reduce of a replicated leaf's gradients
over every axis); Adam is elementwise, so each distinct copy of a slice
is updated in place (``lane_adam_step``, one call per device).
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.ops.attention import flash_attention
from rafiki_tpu_torch.ops.moe import (MOE_AUX_COEF, expert_capacity,
                                      expert_outputs, route)
from rafiki_tpu_torch.ops.ring_attention import ring_attention
from rafiki_tpu_torch.ops.ulysses import ulysses_attention
from rafiki_tpu_torch.model.optim import lane_adam_init, lane_adam_step
from rafiki_tpu_torch.parallel.collectives import (ShardedLeaf, all_gather,
                                                   all_reduce, on_axis,
                                                   owners)
from rafiki_tpu_torch.parallel.sharding import (DATA_AXIS, MODEL_AXIS,
                                                SP_AXIS, Mesh, leaf_paths,
                                                param_shardings)
from rafiki_tpu_torch.store.params import MATMUL_LEAVES

#: ``param_shardings``' fsdp threshold in JAX's mesh loop
FSDP_MIN_SIZE = 2 ** 12


def mesh_specs(shapes: Dict[str, Any], mesh: Mesh,
               rules: Optional[Dict[str, int]]) -> Dict[str, Tuple]:
    """Per ``state_dict`` key, the spec JAX's mesh loop gives the leaf
    (``rules`` None: fsdp alone, as on a (data, sp) mesh)."""
    specs = param_shardings(shapes, mesh, tp_rules=rules, fsdp=True,
                            min_size=FSDP_MIN_SIZE)
    return {p.replace("/", "."): s for p, s in specs.items()}


def storage_dtype(key: str, trainable: bool,
                  dtype: torch.dtype) -> torch.dtype:
    """What a shard of ``key`` is held in: the f32 master weight when it
    trains; else a matmul leaf in the compute dtype, the rest f32 (the
    one-card template's rule, ``llama_params_from_jax``)."""
    if trainable or key.rsplit(".", 1)[-1] not in MATMUL_LEAVES:
        return torch.float32
    return dtype


def shard_tree(base: Dict[str, Any], mesh: Mesh,
               rules: Optional[Dict[str, int]], trainable: List[str],
               dtype: torch.dtype) -> Dict[str, ShardedLeaf]:
    """``base`` (a nested f32 tree in the JAX layout) sliced onto
    ``mesh``'s devices, one leaf at a time, keyed by ``state_dict`` key.
    No spec names ``sp``: the positions of an ``sp`` group that sit on
    one device hold one tensor of each leaf (:class:`MeshLlama`)."""
    specs = mesh_specs(base, mesh, rules)
    wanted = set(trainable)
    out: Dict[str, ShardedLeaf] = {}
    with warnings.catch_warnings():  # read-only blob views: only read
        warnings.simplefilter("ignore", UserWarning)
        for path, leaf in leaf_paths(base):
            key = ".".join(path)
            full = leaf if isinstance(leaf, torch.Tensor) \
                else torch.as_tensor(leaf)
            out[key] = ShardedLeaf.from_full(
                full, mesh, specs[key],
                dtype=storage_dtype(key, key in wanted, dtype),
                share=(SP_AXIS,))
    return out


def _spec_dim(spec: Tuple, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


class MeshLlama:
    """The shapes and settings the sharded step reads (a ``Llama``'s,
    without its weights) and the mesh's sharded leaves. ``dp``, ``sp``
    and ``mp`` are the mesh's ``data``, ``sp`` and ``model`` sizes (1 for
    an axis it lacks)."""

    def __init__(self, mesh: Mesh, leaves: Dict[str, ShardedLeaf], *,
                 hidden: int, depth: int, n_heads: int, n_kv_heads: int,
                 lora_rank: int, dtype: torch.dtype, rope_theta: float,
                 rope_scaling: Any, n_experts: int = 0, moe_top_k: int = 1,
                 remat_policy: str = "none", alpha: float = 16.0,
                 capacity_factor: float = 1.25, eps: float = 1e-5) -> None:
        self.mesh = mesh
        self.leaves = leaves
        self.hidden, self.depth = hidden, depth
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.rank, self.alpha = lora_rank, alpha
        self.dtype = dtype
        self.rope_theta, self.rope_scaling = rope_theta, rope_scaling
        self.n_experts, self.top_k = n_experts, moe_top_k
        self.capacity_factor = capacity_factor
        self.remat_policy = remat_policy
        self.eps = eps
        self.dp = mesh.axis_size(DATA_AXIS)
        self.sp = mesh.axis_size(SP_AXIS)
        self.mp = mesh.axis_size(MODEL_AXIS)
        self.devices = mesh.flat_devices()
        if n_heads % self.mp:
            raise ValueError(f"model_parallel={self.mp} must divide "
                             f"n_heads ({n_heads}): a shard attends with "
                             "whole query heads")
        if n_experts and n_experts % self.mp:
            raise ValueError(
                f"moe_experts={n_experts} must be divisible by the "
                f"mesh's model axis ({self.mp})")


# ---- views: a leaf in the layout one position computes with ----

def _frozen_view(leaf: ShardedLeaf, p: int, split: Optional[int]
                 ) -> torch.Tensor:
    """Position ``p``'s compute tensor of a frozen leaf (no autograd):
    gathered over ``data`` where fsdp split it, then whole (``split``
    None) or the ``p``-th model chunk along ``split``."""
    mesh = leaf.mesh
    mp = mesh.axis_size(MODEL_AXIS)
    spec = leaf.spec + (None,) * (len(leaf.shape) - len(leaf.spec))
    dev = mesh.flat_devices()[p]
    dd, dm = _spec_dim(spec, DATA_AXIS), _spec_dim(spec, MODEL_AXIS)

    def column(q: int) -> torch.Tensor:
        if dd is None:
            return leaf.shards[q]
        return torch.cat([leaf.shards[r].to(dev)
                          for r in mesh.along(q, DATA_AXIS)], dd)

    if dm is not None:
        if split is not None and split % len(leaf.shape) == dm:
            return column(p)
        t = torch.cat([column(q).to(dev)
                       for q in mesh.along(p, MODEL_AXIS)], dm)
    else:
        t = column(p)
    if split is None:
        return t
    return t.tensor_split(mp, dim=split)[mesh.coord(p, MODEL_AXIS)]


def _view(leaf: ShardedLeaf, shards: List[torch.Tensor],
          split: Optional[int]) -> List[torch.Tensor]:
    """Every position's compute tensor of a leaf whose ``shards`` take
    gradients: all-gathered over ``data`` where fsdp split it, then over
    ``model`` unless already split as asked; a leaf ``model`` does not
    split is chunked locally. Gradients flow back through the
    collectives' rules."""
    mesh = leaf.mesh
    mp = mesh.axis_size(MODEL_AXIS)
    spec = leaf.spec + (None,) * (len(leaf.shape) - len(leaf.spec))
    dd, dm = _spec_dim(spec, DATA_AXIS), _spec_dim(spec, MODEL_AXIS)
    out = list(shards)
    if dd is not None:
        out = on_axis(mesh, DATA_AXIS, all_gather, out, dd,
                      owner=leaf.owner)
    if dm is not None:
        if split is not None and split % len(leaf.shape) == dm:
            return out
        out = on_axis(mesh, MODEL_AXIS, all_gather, out, dm,
                      owner=leaf.owner)
    if split is None or mp == 1:  # whole: the gathered tensor itself
        return out
    return [t.tensor_split(mp, dim=split)[mesh.coord(p, MODEL_AXIS)]
            for p, t in enumerate(out)]


class _RegatherMatmul(torch.autograd.Function):
    """``x @ w`` for a frozen ``w = get_w()`` that is not kept for the
    backward: the backward calls ``get_w`` again (fsdp's second
    gather)."""

    @staticmethod
    def forward(ctx, x, get_w):
        ctx.get_w = get_w
        return x @ get_w().to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g @ ctx.get_w().to(g.dtype).t(), None


class _Step:
    """One forward of the mesh: ``params`` maps each trainable key to its
    per-position tensors (the merged ``lora_b``), every other leaf is
    the mesh's frozen shards."""

    def __init__(self, mm: MeshLlama, params: Dict[str, List[torch.Tensor]]
                 ) -> None:
        self.mm = mm
        self.params = params

    def view(self, key: str, split: Optional[int],
             dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """Every position's compute tensor of ``key``; with ``dtype`` a
        trainable leaf's shards are cast before they are gathered (the
        cast commutes with the gather, and a gathered f32 copy never
        exists)."""
        leaf = self.mm.leaves[key]
        if key in self.params:
            shards = self.params[key]
            if dtype is not None:  # once per tensor the positions share
                shards = _per_owner(leaf, shards, lambda t: t.to(dtype))
            return _view(leaf, shards, split)
        return [_frozen_view(leaf, p, split).to(dtype or leaf.dtype)
                for p in range(len(leaf.shards))]

    def matmul(self, xs: List[torch.Tensor], key: str, split: Optional[int]
               ) -> List[torch.Tensor]:
        """``x @ leaf`` at every position, the leaf cast to x's dtype."""
        leaf = self.mm.leaves[key]
        if key in self.params:
            return [x @ w for x, w in zip(xs, self.view(key, split,
                                                        xs[0].dtype))]
        gathered = DATA_AXIS in leaf.spec
        out = []
        for p, x in enumerate(xs):
            if gathered:
                out.append(_RegatherMatmul.apply(x, functools.partial(
                    _frozen_view, leaf, p, split)))
            else:
                out.append(x @ _frozen_view(leaf, p, split).to(x.dtype))
        return out

    def dense(self, xs: List[torch.Tensor], name: str, split: int
              ) -> List[torch.Tensor]:
        """A LoRADense site: ``split`` -1 column-parallel (each position's
        output columns), 0 row-parallel (each position's partial sum of
        its input rows)."""
        mm = self.mm
        y = self.matmul(xs, f"{name}.kernel", split)
        if not mm.rank:
            return y
        a = self.matmul(xs, f"{name}.lora_a", 0 if split == 0 else None)
        b = self.view(f"{name}.lora_b", None if split == 0 else -1)
        s = mm.alpha / mm.rank
        return [yy + (aa @ bb.to(aa.dtype)) * s
                for yy, aa, bb in zip(y, a, b)]

    def norm(self, xs: List[torch.Tensor], key: str) -> List[torch.Tensor]:
        out = []
        for x, scale in zip(xs, self.view(key, None)):
            x32 = x.float()
            n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1,
                                             keepdim=True) + self.mm.eps)
            out.append((n * scale).to(x.dtype))
        return out

    def reduce_model(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """All-reduce over ``model`` within each data row."""
        return on_axis(self.mm.mesh, MODEL_AXIS, all_reduce, xs)

    def gather_model(self, xs: List[torch.Tensor], dim: int
                     ) -> List[torch.Tensor]:
        return on_axis(self.mm.mesh, MODEL_AXIS, all_gather, xs, dim)

    # ---- the blocks ----
    def attention(self, h: List[torch.Tensor], pre: str, rows: List[Dict]
                  ) -> List[torch.Tensor]:
        from rafiki_tpu_torch.models.llama_lora import rope

        mm = self.mm
        dh = mm.hidden // mm.n_heads
        hl = mm.n_heads // mm.mp
        rep = mm.n_heads // mm.n_kv_heads
        q = self.dense(h, f"{pre}.attn.wq", -1)
        k = self.dense(h, f"{pre}.attn.wk", -1)
        v = self.dense(h, f"{pre}.attn.wv", -1)
        local_kv = mm.n_kv_heads % mm.mp == 0
        if mm.sp > 1:
            return self.sp_attention(q, k, v, rows)
        if not local_kv:  # K/V heads split mid-group: gather them whole
            k, v = self.gather_model(k, -1), self.gather_model(v, -1)
        out = []
        for p in range(len(h)):
            r = rows[p]
            b, s = r["positions"].shape
            qp = rope(q[p].reshape(b, s, hl, dh), r["positions"],
                      mm.rope_theta, mm.rope_scaling)
            kv_heads = k[p].shape[-1] // dh
            kp = rope(k[p].reshape(b, s, kv_heads, dh), r["positions"],
                      mm.rope_theta, mm.rope_scaling)
            vp = v[p].reshape(b, s, kv_heads, dh)
            if local_kv:
                kp = kp.repeat_interleave(rep, dim=2)
                vp = vp.repeat_interleave(rep, dim=2)
            else:
                j = mm.mesh.coord(p, MODEL_AXIS)
                idx = torch.arange(j * hl, (j + 1) * hl,
                                   device=kp.device) // rep
                kp, vp = kp.index_select(2, idx), vp.index_select(2, idx)
            o = flash_attention(qp.transpose(1, 2), kp.transpose(1, 2),
                                vp.transpose(1, 2), causal=True,
                                kv_lens=r["lens"]).transpose(1, 2)
            out.append(o.reshape(b * s, hl * dh))
        return out

    def sp_attention(self, q: List[torch.Tensor], k: List[torch.Tensor],
                     v: List[torch.Tensor], rows: List[Dict]
                     ) -> List[torch.Tensor]:
        """JAX's ``_DecoderAttention`` with ``seq_axis``: rope at each
        position's global token positions, then the un-repeated K/V
        (GQA) through the ring where the shard's heads do not divide
        over ``sp``, else through Ulysses; no ``kv_lens`` (a pad key is
        seen only by pad queries, whose loss is masked)."""
        from rafiki_tpu_torch.models.llama_lora import rope

        mm = self.mm
        if mm.n_kv_heads % mm.mp:
            raise ValueError(f"sequence_parallel with model_parallel="
                             f"{mm.mp} needs the kv heads "
                             f"({mm.n_kv_heads}) divisible by it")
        dh = mm.hidden // mm.n_heads
        hl = mm.n_heads // mm.mp
        qs, ks, vs = [], [], []
        for p, r in enumerate(rows):
            b, s = r["positions"].shape
            kv_heads = k[p].shape[-1] // dh
            qs.append(rope(q[p].reshape(b, s, hl, dh), r["positions"],
                           mm.rope_theta, mm.rope_scaling).transpose(1, 2))
            ks.append(rope(k[p].reshape(b, s, kv_heads, dh),
                           r["positions"], mm.rope_theta,
                           mm.rope_scaling).transpose(1, 2))
            vs.append(v[p].reshape(b, s, kv_heads, dh).transpose(1, 2))
        attn = ring_attention if hl % mm.sp else ulysses_attention
        outs = attn(qs, ks, vs, mm.mesh, SP_AXIS, causal=True)
        return [o.transpose(1, 2).reshape(-1, hl * dh) for o in outs]

    def moe(self, h: List[torch.Tensor], pre: str, rows: List[Dict]
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        mm = self.mm
        el = mm.n_experts // mm.mp
        logits = [x.float() @ w.float()
                  for x, w in zip(h, self.view(f"{pre}.moe.router", None))]
        # the routing sees the global token set in its row-major (batch,
        # sequence) order, as JAX's does: the logits gathered over
        # ``sp`` along the sequence, then over ``data``, routed once per
        # gathered tensor (the gathers share their result among the
        # positions of a group on one device: ``owners``)
        if mm.sp > 1:
            logits = [t.reshape(r["ids"].shape + (mm.n_experts,))
                      for t, r in zip(logits, rows)]
            logits = [t.reshape(-1, mm.n_experts) for t in on_axis(
                mm.mesh, SP_AXIS, all_gather, logits, 1)]
        glob = on_axis(mm.mesh, DATA_AXIS, all_gather, logits, 0,
                       owner=owners(mm.mesh, (SP_AXIS,)))
        own = owners(mm.mesh, (SP_AXIS, DATA_AXIS))
        cap = expert_capacity(glob[0].shape[0], mm.top_k, mm.n_experts,
                              mm.capacity_factor)
        routed: Dict[int, Any] = {}
        cdt = h[0].dtype
        wg = self.view(f"{pre}.moe.experts_gate", 0, cdt)
        wu = self.view(f"{pre}.moe.experts_up", 0, cdt)
        wd = self.view(f"{pre}.moe.experts_down", 0, cdt)
        out = []
        for p, x in enumerate(h):
            if own[p] not in routed:
                routed[own[p]] = route(glob[p], cap, mm.top_k)
            r = routed[own[p]]
            out.append(expert_outputs(
                x, r, wg[p], wu[p], wd[p],
                first_expert=mm.mesh.coord(p, MODEL_AXIS) * el,
                tokens=rows[p]["tokens"]))
        aux = routed[own[0]].aux
        return [y.to(x.dtype) for y, x in zip(self.reduce_model(out), h)], aux

    def block(self, k: int, rows: List[Dict], *xs: torch.Tensor):
        mm = self.mm
        pre = f"block_{k}"
        xs = list(xs)
        h = self.norm(xs, f"{pre}.RMSNorm_0.scale")
        o = self.attention(h, pre, rows)
        y = self.reduce_model(self.dense(o, f"{pre}.attn.wo", 0))
        xs = [x + yy for x, yy in zip(xs, y)]
        h = self.norm(xs, f"{pre}.RMSNorm_1.scale")
        if mm.n_experts:
            y, aux = self.moe(h, pre, rows)
            return tuple(x + yy for x, yy in zip(xs, y)) + (aux,)
        g = self.dense(h, f"{pre}.gate", -1)
        u = self.dense(h, f"{pre}.up", -1)
        y = self.reduce_model(self.dense(
            [F.silu(a) * b for a, b in zip(g, u)], f"{pre}.down", 0))
        return tuple(x + yy for x, yy in zip(xs, y))

    def hidden(self, rows: List[Dict]) -> Tuple[List[torch.Tensor],
                                                List[torch.Tensor]]:
        """The final-norm activations at every position and the blocks'
        MoE aux terms."""
        from rafiki_tpu_torch.models.llama_lora import checkpoint_block

        mm = self.mm
        key = "tok_embed.embedding"
        if key in self.params:
            tables = self.view(key, -1)
        else:  # frozen: one position's gathered table at a time
            tables = (_frozen_view(mm.leaves[key], p, -1)
                      for p in range(len(rows)))
        emb = [F.embedding(r["ids"], w).reshape(-1, w.shape[-1])
               for r, w in zip(rows, tables)]
        xs = [x.to(mm.dtype) for x in self.gather_model(emb, -1)]
        remat = mm.remat_policy != "none" and torch.is_grad_enabled()
        aux: List[torch.Tensor] = []
        for k in range(mm.depth):
            fn = functools.partial(self.block, k, rows)
            out = (checkpoint_block(mm.remat_policy, fn, *xs) if remat
                   else fn(*xs))
            if mm.n_experts:
                aux.append(out[-1])
                out = out[:-1]
            xs = list(out)
        return self.norm(xs, "final_norm.scale"), aux

    def ce_terms(self, h: List[torch.Tensor], kernels: List[torch.Tensor],
                 targets: List[torch.Tensor], valid: List[torch.Tensor]
                 ) -> torch.Tensor:
        """Summed masked cross-entropy over the mesh's rows, the logits
        split on vocab over ``model``: each shard's log-sum-exp is
        all-gathered and combined, and each shard's part of the sum
        (:class:`_VocabShardCE`) takes the gradient of the whole sum
        with respect to its own logits."""
        mm = self.mm
        logits, lse, picked, inside = [], [], [], []
        for p, (x, w) in enumerate(zip(h, kernels)):
            lg = x @ w
            j = mm.mesh.coord(p, MODEL_AXIS)
            off = sum(kernels[q].shape[-1]
                      for q in mm.mesh.along(p, MODEL_AXIS)[:j])
            t = targets[p] - off
            inside.append((t >= 0) & (t < lg.shape[-1]))
            picked.append(t.clamp(0, lg.shape[-1] - 1))
            with torch.no_grad():
                lse.append(_lse(lg)[:, None])
            logits.append(lg)
        with torch.no_grad():
            lse = [torch.logsumexp(t, dim=-1)
                   for t in self.gather_model(lse, -1)]
        dev0 = mm.devices[0]
        total = None
        for p, lg in enumerate(logits):
            part = _VocabShardCE.apply(lg, lse[p], picked[p], inside[p],
                                       valid[p],
                                       mm.mesh.coord(p, MODEL_AXIS) == 0)
            total = part.to(dev0) if total is None else \
                total + part.to(dev0)
        return total


def _lse(logits: torch.Tensor) -> torch.Tensor:
    """Each row's f32 log-sum-exp, through one f32 copy of the rows."""
    t = logits.to(torch.float32, copy=True)
    m = t.amax(dim=-1)
    t.sub_(m[:, None]).exp_()
    return m + t.sum(dim=-1).log()


class _VocabShardCE(torch.autograd.Function):
    """One shard's part of the summed cross-entropy over vocab-split
    logits: minus each valid row's target logit where the target is in
    this shard's slice, plus (on a data row's first shard) its global
    log-sum-exp ``lse`` (f32, computed over every shard). The parts sum
    to the loss; each part's backward is the loss's gradient with
    respect to its own logits, ``valid · (exp(logits - lse) - onehot)``,
    in f32 and cast to the logits' dtype, so the backward holds one f32
    copy of a shard's logits at a time (the saved logits are in the
    compute dtype)."""

    @staticmethod
    def forward(ctx, logits, lse, target, inside, valid, first):
        picked = logits.gather(1, target[:, None])[:, 0].float()
        part = -(torch.where(inside, picked, torch.zeros_like(picked))
                 * valid).sum()
        if first:
            part = part + (lse * valid).sum()
        ctx.save_for_backward(logits, lse, target, inside, valid)
        return part

    @staticmethod
    def backward(ctx, g):
        logits, lse, target, inside, valid = ctx.saved_tensors
        p = logits.to(torch.float32, copy=True)
        p.sub_(lse[:, None]).exp_()
        p.scatter_add_(1, target[:, None], -inside.float()[:, None])
        p.mul_((valid * g)[:, None])
        return p.to(logits.dtype), None, None, None, None, None


def _rows(mm: MeshLlama, batch: Dict[str, torch.Tensor]) -> List[Dict]:
    """One dict per position on its device: its (B / dp, L / sp) slice of
    ``ids``, its rows' ``lens`` (and ``mask``), its tokens' global
    positions (rope's, ``sp_index · L / sp + arange(L / sp)``) and indices
    in the batch's row-major token order (the MoE routing's), and its
    slice of the next-token ``targets`` and ``valid`` mask, both computed
    over the whole sequence first (the shift crosses the ``sp`` shards'
    boundaries)."""
    from rafiki_tpu_torch.models.llama_lora import lm_valid_mask

    ids, lens, mask = batch["ids"], batch["lens"], batch.get("mask")
    b, seq = ids.shape
    targets = F.pad(ids[:, 1:], (0, 1)).long()
    valid = lm_valid_mask(seq, lens, mask).float()
    bl, ls = b // mm.dp, seq // mm.sp
    order = torch.arange(b * seq).reshape(b, seq)
    out = []
    for p, dev in enumerate(mm.devices):
        i, s = mm.mesh.coord(p, DATA_AXIS), mm.mesh.coord(p, SP_AXIS)
        rs, cs = slice(i * bl, (i + 1) * bl), slice(s * ls, (s + 1) * ls)
        r = {"ids": ids[rs, cs].to(dev), "lens": lens[rs].to(dev),
             "targets": targets[rs, cs].reshape(-1).to(dev),
             "valid": valid[rs, cs].reshape(-1).to(dev),
             "tokens": order[rs, cs].reshape(-1).to(dev),
             "positions": (s * ls + torch.arange(
                 ls, dtype=torch.int32, device=dev)).expand(bl, ls)}
        if mask is not None:
            r["mask"] = mask[rs].to(dev)
        out.append(r)
    return out


def mesh_micro_terms(mm: MeshLlama, params: Dict[str, List[torch.Tensor]],
                     batch: Dict[str, torch.Tensor], loss_chunk: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``micro_terms`` over the mesh: (loss sum, valid count, MoE
    aux) of one (micro-)batch, each a 0-d f32 on the mesh's first
    device. The count sums over ``data`` and ``sp``; with ``sp`` and
    ``loss_chunk`` the loss is :func:`~rafiki_tpu_torch.models.llama_lora.
    chunked_lm_loss_terms_sp`'s (each position streams its own chunks)."""
    from rafiki_tpu_torch.models.llama_lora import (checkpoint_block,
                                                    chunked_lm_loss_terms_sp)

    step = _Step(mm, params)
    rows = _rows(mm, batch)
    h, aux_terms = step.hidden(rows)
    targets = [r["targets"] for r in rows]
    valid = [r["valid"] for r in rows]
    kernels = step.view("lm_head.kernel", -1, mm.dtype)
    dev0 = mm.devices[0]
    if loss_chunk and mm.sp > 1:
        total, _ = chunked_lm_loss_terms_sp(
            [x.reshape(r["ids"].shape + (-1,)) for x, r in zip(h, rows)],
            kernels, batch["ids"], batch["lens"], batch.get("mask"),
            loss_chunk, mm.mesh, DATA_AXIS, SP_AXIS)
    elif loss_chunk:
        # the streamed loss: one sequence chunk of logits at a time,
        # each chunk's body rematerialized in the backward
        b, s = rows[0]["ids"].shape
        chunk = max(1, min(int(loss_chunk), s))
        total = None
        remat = torch.is_grad_enabled()
        for c0 in range(0, s, chunk):
            def piece(*flat, c0=c0):
                n = len(h)
                hc = [x.reshape(b, s, -1)[:, c0:c0 + chunk].reshape(
                    -1, x.shape[-1]) for x in flat[:n]]
                tc = [t.reshape(b, s)[:, c0:c0 + chunk].reshape(-1)
                      for t in targets]
                vc = [v.reshape(b, s)[:, c0:c0 + chunk].reshape(-1)
                      for v in valid]
                return step.ce_terms(hc, list(flat[n:]), tc, vc)

            part = (checkpoint_block("full", piece, *h, *kernels) if remat
                    else piece(*h, *kernels))
            total = part if total is None else total + part
    else:
        total = step.ce_terms(h, kernels, targets, valid)
    count = None
    for p in range(len(rows)):
        if mm.mesh.coord(p, MODEL_AXIS) == 0:
            c = valid[p].sum().to(dev0)
            count = c if count is None else count + c
    aux = torch.zeros((), dtype=torch.float32, device=dev0)
    for a in aux_terms:
        aux = aux + a.float().to(dev0)
    return total.to(dev0), count, aux


def _per_owner(leaf: ShardedLeaf, ts: List[torch.Tensor],
               fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> List[torch.Tensor]:
    """``fn`` of each position's tensor of ``leaf`` (``ts``, shared as
    the leaf's shards are), run once per owner and shared as they are."""
    done = {p: fn(ts[p]) for p in leaf.owned()}
    return [done[o] for o in leaf.owner]


def mesh_lane_init(mm: MeshLlama, trainable: List[str], learning_rate: float
                   ) -> Dict[str, Any]:
    """The step state: per device, the trainable shards it holds (keyed
    ``key@position`` by each shard's owner, sharing the leaves' storage)
    and their Adam moments; the learning rate per device."""
    groups: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    for key in trainable:
        leaf = mm.leaves[key]
        for p in leaf.owned():
            groups.setdefault(mm.devices[p], {})[f"{key}@{p}"] = \
                leaf.shards[p]
    return {dev: {"params": params, "opt": lane_adam_init(params),
                  "lr": torch.tensor(float(learning_rate),
                                     dtype=torch.float32, device=dev)}
            for dev, params in groups.items()}


def _replica_sums(mm: MeshLlama, key: str, grads: List[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Each owner's gradient (``grads``, one per owner position, keyed by
    it) summed over every owner of the same slice (the all-reduce of a
    replicated leaf's gradients). A shard that several positions share
    (an ``sp`` group on one device) already holds their sum, autograd's,
    and counts once."""
    leaf = mm.leaves[key]
    groups: Dict[str, List[int]] = {}
    for p in leaf.owned():
        groups.setdefault(repr(leaf.bounds(p)), []).append(p)
    out = dict(grads)
    for ps in groups.values():
        if len(ps) > 1:
            res = all_reduce([grads[p] for p in ps],
                             [mm.devices[p] for p in ps])
            out.update(zip(ps, res))
    return out


def mesh_train_step(mm: MeshLlama, state: Dict[str, Any],
                    trainable: List[str], lora_scale: float,
                    batch: Dict[str, torch.Tensor], loss_chunk: int = 0,
                    grad_accum: int = 1
                    ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One step of the mesh (the one-card ``lane_train_step``): the
    objective of ``grad_accum`` micro-batches (each a contiguous block of
    the batch, split over ``data`` and ``sp``) over the batch's valid
    count, the rank-scale merged into ``lora_b``, the gradients summed
    over replicas, then Adam in place on every distinct shard. Returns
    (state, the batch loss, detached, on the mesh's first device)."""
    from rafiki_tpu_torch.models.llama_lora import (WEIGHT_DECAY,
                                                    lm_valid_mask)

    # one autograd leaf per owned shard: the positions sharing a shard
    # share its leaf, whose gradient autograd sums over them
    leaves: Dict[str, List[torch.Tensor]] = {}
    flat: List[torch.Tensor] = []
    for key in trainable:
        leaf = mm.leaves[key]
        leaves[key] = _per_owner(
            leaf, leaf.shards, lambda t: t.detach().requires_grad_(True))
        flat += [leaves[key][p] for p in leaf.owned()]
    ids, lens, mask = batch["ids"], batch["lens"], batch.get("mask")
    b, seq = ids.shape
    if b % (grad_accum * mm.dp):
        raise ValueError(f"batch {b} must divide by grad_accum "
                         f"{grad_accum} x data {mm.dp}")
    dev0 = mm.devices[0]
    denom = lm_valid_mask(seq, lens, mask).float().sum().clamp(
        min=1.0).to(dev0)
    m = b // grad_accum
    loss, grads = None, None
    for a in range(grad_accum):
        micro = {k: v[a * m:(a + 1) * m] for k, v in batch.items()}
        merged = {key: _scaled(mm.leaves[key], ts, lora_scale)
                  if "lora_b" in key else ts for key, ts in leaves.items()}
        total, _, aux = mesh_micro_terms(mm, merged, micro, loss_chunk)
        val = total / denom + MOE_AUX_COEF * aux / grad_accum
        g = torch.autograd.grad(val, flat, allow_unused=True)
        g = [torch.zeros_like(t) if gg is None else gg
             for t, gg in zip(flat, g)]
        loss = val.detach() if loss is None else loss + val.detach()
        grads = g if grads is None else [x + y for x, y in zip(grads, g)]
    by_key: Dict[str, torch.Tensor] = {}
    rest = iter(grads)
    for key in trainable:
        own = {p: next(rest) for p in mm.leaves[key].owned()}
        for p, gg in _replica_sums(mm, key, own).items():
            by_key[f"{key}@{p}"] = gg
    del grads, leaves, merged, flat, rest
    for dev_state in state.values():
        params = dev_state["params"]
        lane_adam_step(params, {n: by_key[n] for n in params},
                       dev_state["opt"], dev_state["lr"], WEIGHT_DECAY)
    return state, loss


def _scaled(leaf: ShardedLeaf, ts: List[torch.Tensor], scale: float
            ) -> List[torch.Tensor]:
    """Each owner's tensor of ``ts`` times ``scale``, once."""
    return _per_owner(leaf, ts, lambda t: t * scale)


def gather_trainable(mm: MeshLlama, trainable: List[str]
                     ) -> Dict[str, torch.Tensor]:
    """The trained leaves assembled whole on the host (f32)."""
    return {key: mm.leaves[key].full("cpu", torch.float32)
            for key in trainable}


def checkpoint_tree(mm: MeshLlama, base: Dict[str, Any],
                    trainable: List[str], lora_scale: float
                    ) -> Dict[str, Any]:
    """The live tree a sharded checkpoint saves, in the blob's values:
    each trainable leaf's shards (``lora_b`` times the rank-scale, as
    the blob folds it), each frozen leaf as host views of its f32 base
    array sliced by its spec. The manifest is JAX's for the same
    mesh (on an ``sp`` mesh: ``param_shardings``' specs, ROADMAP Queue C
    24)."""
    wanted = set(trainable)
    tree: Dict[str, Any] = {}
    for path, arr in leaf_paths(base):
        key = ".".join(path)
        leaf = mm.leaves[key]
        if key in wanted:
            shards = _per_owner(leaf, leaf.shards, torch.Tensor.detach)
            if "lora_b" in key:
                shards = _scaled(leaf, shards, lora_scale)
            out: Any = ShardedLeaf(leaf.shape, leaf.spec, mm.mesh, shards,
                                   leaf.owner)
        else:
            out = ShardedLeaf.from_full(np.asarray(arr), mm.mesh, leaf.spec,
                                        on_host=True)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = out
    return tree


def make_step_fn(mm: MeshLlama, state: Dict[str, Any],
                 trainable: List[str], lora_scale: float, loss_chunk: int,
                 grad_accum: int) -> Callable[[Any, Dict[str, Any]], Any]:
    """``step(state, host_batch) -> (state, loss)`` for ``run_epochs``."""
    def step(st, host_batch):
        batch = {"ids": torch.as_tensor(host_batch["ids"]).long(),
                 "lens": torch.as_tensor(host_batch["lens"]).int()}
        if "mask" in host_batch:
            batch["mask"] = torch.as_tensor(host_batch["mask"])
        return mesh_train_step(mm, st, trainable, lora_scale, batch,
                               loss_chunk, grad_accum)

    return step
