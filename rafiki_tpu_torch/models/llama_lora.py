"""Llama-style decoder LM with LoRA adapters: serving and fine-tuning.

Ports ``rafiki_tpu/models/llama_lora.py``:

- ``rope``, ``_parse_rope_scaling``, ``RMSNorm`` and ``LoRADense`` (its
  plain form, the int8 ``quantized`` form, whose base kernel is int8
  ``qkernel`` with per-output-channel f32 ``qscale``, and the stacked
  ``n_adapters`` form of multi-adapter serving, ``adapter_ids``
  threaded through every block), ``quantize_llama_params`` and
  ``stack_lora_adapters``;
- ``_masked_decode_attention``, the contiguous-cache decode attention;
- ``_DecoderAttention`` — its decode branch, for contiguous rows and the
  paged pool: rope'd K and raw V are written at ``(table[pos // page],
  pos % page)`` before attention (with ``kv_int8``, as int8 rows and one
  f32 absmax scale per row), and a paged module attends through
  ``paged_decode_attention`` (s == 1) or ``paged_window_attention``
  (s > 1); and its train branch (``decode=False``): causal
  ``flash_attention`` with each row's keys past ``lens`` masked;
- ``_DecoderBlock`` (SwiGLU, or the top-k routed MoE FFN of
  ``ops/moe.py``, whose aux losses ``Llama.forward`` collects in an
  explicit list) and ``Llama``, whose flax ``cache`` collection becomes
  the explicit per-layer tensors of :meth:`Llama.init_cache`, written in
  place, and whose ``remat`` / ``remat_policy`` checkpoint each block of
  the train branch (:func:`checkpoint_block`: ``torch.utils.checkpoint``,
  ``"policy"`` keeping the matrix products' outputs as JAX's
  ``dots_saveable``);
- ``greedy_generate``, a Python loop of decode steps over a contiguous
  cache;
- the functional training step of ``LlamaLoRA._lane_functions`` as
  module-level functions over any ``Llama``: the trainable masks
  (:func:`lora_trainable_names`), f32 master weights
  (:func:`make_trainable`), :func:`merge`, ``lm_valid_mask`` /
  ``lm_loss_terms``, the streamed loss (:func:`chunked_lm_loss_terms`),
  :func:`micro_terms`, :func:`lane_init` and :func:`lane_train_step` (one
  lane: the template's sequential step and a 1-lane gang's, with
  gradient accumulation and the MoE aux term of JAX's sharded step on
  one device; the update, ``optax.chain(scale_by_adam(),
  add_decayed_weights(1e-4))`` then ``−lr · u``, is
  ``model/optim.lane_adam_step``);
- the gang lanes (``make_gang_spec``; JAX ``vmap``s one lane's step over
  a broadcast base): :func:`lanes_train_step` runs K lanes as one step
  with the lane axis explicit. The trainable leaves (LoRA A and B, the
  norm scales, the LM head) carry a leading K, the frozen kernels and the
  embedding stay single; lane i's rows are one contiguous block of the
  K·B examples, so every base product is one matmul over all rows, each
  LoRA correction and the LM head a ``bmm`` over the lanes, each norm
  scale a broadcast over its block, and attention one ``flash_attention``
  call of batch K·B per layer (B3 forward, B5 + B6 backward, ``depth``
  launches each per step, not K·depth), each block under the bucket's
  checkpointing schedule;
- the ``LlamaLoRA`` template: ``train`` (JAX's ``_train_functional``
  loop and its sharded loop on one device: ``grad_accum``, ``loss_chunk``,
  ``moe_experts``, and with ``pretrained_path`` the base weights of an
  HF-convention safetensors checkpoint; with ``model_parallel > 1`` or
  ``sequence_parallel > 1`` its mesh loop, ``_train_mesh`` over
  ``models/llama_mesh.py``, ``TP_RULES``, ``_mesh`` and the (data, sp[,
  model]) meshes, with :func:`chunked_lm_loss_terms_sp`, the streamed
  loss of a sequence-split batch), ``gang_blockers``,
  ``gang_epochs``, ``make_gang_spec``, ``estimate_device_budget`` (one
  trial's, :func:`estimate_train_device_bytes`, a mesh device's,
  :func:`estimate_mesh_train_device_bytes`, or with ``gang_size`` a
  gang's, :func:`estimate_gang_device_bytes`), ``evaluate``,
  ``dump_parameters``, ``load_parameters`` (blobs move both ways with
  the JAX template, ``meta["bpe_merges"]`` included), ``predict``,
  ``warmup``, ``make_decode_engine`` (speculation with prompt-lookup or
  a draft model, a registered system prefix), ``make_multi_adapter_engine``
  and ``estimate_serving_device_bytes`` (the worker's admission budget),
  with
  the int8 serving knobs ``quantize_int8`` and ``kv_cache_int8`` and the
  byte-BPE tokenizer of ``tokenizer_path`` (``_bpe``, ``_same_tokenizer``;
  the vocabulary follows the artifact, generations decode exactly).

Layouts follow the JAX package: kernels are ``(d_in, features)`` and a
LoRA site computes ``x @ W + ((x @ A) @ B) * alpha / rank``. Parameters
take the compute dtype at construction (bf16 when the model is bf16),
except the norm scales and the embedding table, which stay f32 — the
roundings the JAX module applies per call. A trained leaf is the
exception: :func:`make_trainable` keeps it f32 and ``LoRADense`` casts it
per call, as JAX does for every leaf.
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import math
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.data.bpe import BOS_ID, ByteBPETokenizer
from rafiki_tpu_torch.data.dataset import load_text_classification_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, IntegerKnob, KnobConfig,
                                         PolicyKnob)
from rafiki_tpu_torch.model.loop import GangSpec, epoch_count, run_epochs
from rafiki_tpu_torch.model.optim import lane_adam_init, lane_adam_step
from rafiki_tpu_torch.model.template_utils import same_tree_shapes
from rafiki_tpu_torch.models.bert import _TOKEN_RE, HashTokenizer
from rafiki_tpu_torch.models.convert import (hf_name_for,
                                             import_llama_safetensors,
                                             read_hf_rope_config,
                                             structure_copy)
from rafiki_tpu_torch.ops.attention import flash_attention
from rafiki_tpu_torch.ops.common import gqa_repeat_factor
from rafiki_tpu_torch.ops.moe import (MOE_AUX_COEF, MoEFeedForward,
                                      expert_capacity, moe_aux_loss)
from rafiki_tpu_torch.models.llama_mesh import (MeshLlama, checkpoint_tree,
                                                gather_trainable,
                                                make_step_fn,
                                                mesh_lane_init, shard_tree)
from rafiki_tpu_torch.ops.paged_attention import (kv_cache_write,
                                                  paged_decode_attention,
                                                  paged_window_attention)
from rafiki_tpu_torch.parallel.collectives import (all_reduce, on_axis,
                                                   to_positions)
from rafiki_tpu_torch.parallel.sharding import Mesh, make_mesh, make_sp_mesh
from rafiki_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    TextDecodeEngine)
from rafiki_tpu_torch.store.params import (MATMUL_LEAVES, f32_tree,
                                           llama_params_from_jax,
                                           params_from_jax, params_to_jax)
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

RopeScaling = Tuple[float, float, float, float]

#: JAX's Megatron-style tensor-parallel rules (``param_shardings``' keys,
#: in JAX's order: the first matching substring wins, and "gate"/"up"/
#: "down" are substrings of the stacked expert names, so "experts" comes
#: first): column-parallel projections split the output dim, row-parallel
#: ones the input dim, the stacked MoE experts their expert dim
TP_RULES = {"experts": 0,
            "wq": -1, "wk": -1, "wv": -1, "gate": -1, "up": -1,
            "wo": 0, "down": 0, "lm_head": -1, "tok_embed": -1}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """Rotary embedding over (b, s, heads, head_dim) with (b, s)
    positions. ``scaling`` is Llama-3.1's frequency-dependent NTK scaling
    ``(factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings)``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if scaling is not None:
        factor, low_f, high_f, orig_len = scaling
        # ratio = original_context / wavelength (wavelength = 2π/freq)
        ratio = orig_len * freqs / (2.0 * math.pi)
        smooth = torch.clamp((ratio - low_f) / max(high_f - low_f, 1e-9),
                             0.0, 1.0)
        scaled = freqs / factor
        freqs = torch.where(
            ratio < low_f, scaled,
            torch.where(ratio > high_f, freqs,
                        (1.0 - smooth) * scaled + smooth * freqs))
    angles = positions[..., None].float() * freqs  # (b, s, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _same_tokenizer(a: Any, b: Any) -> bool:
    """Do two tokenizers map ids to the same text? BPE tokenizers compare
    merge tables; otherwise same type and vocab (a HashTokenizer is
    determined by its vocab size)."""
    if type(a) is not type(b):
        return False
    am, bm = getattr(a, "merges", None), getattr(b, "merges", None)
    if am is not None or bm is not None:
        return am == bm
    return a.vocab_size == b.vocab_size


def _parse_rope_scaling(value: Any) -> Optional[RopeScaling]:
    """Knob value (JSON object string, dict, or "") → the scaling tuple
    :func:`rope` consumes. HF config key names are accepted directly,
    with the published Llama-3.1 defaults for the optional band
    parameters."""
    if not value:
        return None
    if isinstance(value, str):
        value = json.loads(value)
    c = dict(value)
    kind = str(c.get("rope_type", c.get("type", "llama3"))).lower()
    if kind == "default":
        return None  # HF semantics: explicit 'default' = unscaled
    if kind != "llama3":
        # linear/dynamic/yarn use different position geometry; applying
        # the llama3 formula to them would be silently wrong
        raise ValueError(
            f"unsupported rope_scaling type {kind!r} (only 'llama3' "
            "frequency-dependent scaling is implemented)")
    if "factor" not in c:
        raise ValueError("rope_scaling requires a 'factor' key "
                         f"(got {sorted(c)})")
    return (float(c["factor"]),
            float(c.get("low_freq_factor", 1.0)),
            float(c.get("high_freq_factor", 4.0)),
            float(c.get("original_max_position_embeddings", 8192)))


def _weight(shape: Sequence[int], std: float, dtype: torch.dtype,
            device: torch.device, gen: torch.Generator) -> nn.Parameter:
    """A frozen parameter drawn from N(0, std²) (zeros for std 0) with
    the caller's generator — serving weights never take gradients."""
    t = torch.empty(tuple(shape), dtype=dtype, device=device)
    if std:
        t.normal_(0.0, std, generator=gen)
    else:
        t.zero_()
    return nn.Parameter(t, requires_grad=False)


#: a forward of fewer tokens than this runs its dense layers and norms
#: over this many rows on a CUDA device, zero-padded (``Llama.forward``).
#: cuBLAS and the reduction kernels pick their algorithm from the row
#: count, so a token would otherwise round differently in a one-token
#: decode step (8 rows) than in a speculative verify window (8 x k
#: rows); padded, both are one shape and a verify row has the decode
#: step's bits (a row's result depends on its own values only).
ROW_BUCKET = 64


def _rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``x`` as (rows, d), zero-padded to :data:`ROW_BUCKET` rows on a
    CUDA device when it has fewer; and its row count."""
    rows = x.numel() // x.shape[-1]
    return _pad_rows(x.reshape(rows, x.shape[-1]),
                     ROW_BUCKET if x.device.type == "cuda" else rows), rows


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t``'s leading axis zero-padded to ``n`` rows (as it is when it
    has as many)."""
    if t.shape[0] >= n:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 1) + (0, n - t.shape[0]))


class RMSNorm(nn.Module):
    """f32 math, f32 ``scale``, output in the input's dtype."""

    def __init__(self, dim: int, device: torch.device,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


def _quantize_int8(x: torch.Tensor, dim: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as int8 with one f32 scale per slice along ``dim``, symmetric
    absmax: ``scale = max(max|x|, 1e-8) / 127``, then ``round(x / scale)``
    (half to even, as ``jnp.round``) clipped to ±127, in f32 on x's
    device. ``dim=0``: a (d_in, features) kernel per output channel
    (JAX's ``quantize_llama_params``); ``dim=-1``: K/V vectors per row
    (the ``q8`` of JAX's ``_DecoderAttention``)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=dim, keepdim=True),
                        min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(dim)


def quantize_llama_params(params: Dict[str, Any],
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Ports ``quantize_llama_params``: an f32 params tree → the
    ``quantized=True`` module's tree. Every LoRADense base ``kernel`` (a
    2-d leaf) becomes an int8 ``qkernel`` (torch.int8) with its f32
    ``qscale`` (:func:`_quantize_int8` per output channel); every other
    leaf (adapters, norms, the embedding) passes through as it is.

    Leaf by leaf on ``device`` (None: where each leaf lies; numpy leaves
    on the CPU): one kernel at a time is widened to f32 there, so an 8B
    tree never has a second f32 copy of itself on the host."""
    dev = None if device is None else torch.device(device)

    def walk(tree: Any) -> Any:
        if not isinstance(tree, dict):
            return tree
        out: Dict[str, Any] = {}
        for name, sub in tree.items():
            if (isinstance(sub, dict) and "kernel" in sub
                    and getattr(sub["kernel"], "ndim", 0) == 2):
                k = sub["kernel"]
                if not isinstance(k, torch.Tensor):
                    k = torch.from_numpy(np.array(k, dtype=np.float32))
                q, scale = _quantize_int8(k if dev is None else k.to(dev),
                                          0)
                out[name] = {"qkernel": q, "qscale": scale,
                             **{kk: vv for kk, vv in sub.items()
                                if kk != "kernel"}}
            else:
                out[name] = walk(sub)
        return out

    return walk(params)


class LoRADense(nn.Module):
    """Frozen base kernel + low-rank adapter (classic LoRA):
    ``y = x @ kernel + ((x @ lora_a) @ lora_b) * alpha / rank``.

    Random init: kernel N(0, 1/d_in), lora_a N(0, 0.02²), lora_b zeros
    (the JAX template draws the kernel from a truncated lecun normal; the
    port only needs a seeded random base until weights are loaded).

    ``quantized=True`` (serving only) holds the base as ``qkernel`` int8
    (d_in, features) and ``qscale`` f32 (features,) — a random base drawn
    as above and quantized — and computes ``(x @ qkernel.to(x.dtype)) *
    qscale.to(x.dtype)``: the scale on the output, in x's dtype, as JAX
    does. A plain product, as JAX leaves it to XLA; in eager PyTorch the
    ``.to(x.dtype)`` materializes the kernel in x's dtype on every call
    (XLA fuses that convert into the dot)."""

    def __init__(self, d_in: int, features: int, rank: int,
                 dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator, alpha: float = 16.0,
                 quantized: bool = False, n_adapters: int = 0) -> None:
        super().__init__()
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.quantized = bool(quantized)
        self.n_adapters = int(n_adapters)
        if self.quantized:
            base = _weight((d_in, features), 1.0 / math.sqrt(d_in),
                           torch.float32, device, gen)
            q, scale = _quantize_int8(base, 0)
            del base
            self.qkernel = nn.Parameter(q, requires_grad=False)
            self.qscale = nn.Parameter(scale, requires_grad=False)
        else:
            self.kernel = _weight((d_in, features), 1.0 / math.sqrt(d_in),
                                  dtype, device, gen)
        if self.rank > 0:
            lead = (self.n_adapters,) if self.n_adapters > 0 else ()
            self.lora_a = _weight(lead + (d_in, self.rank), 0.02, dtype,
                                  device, gen)
            self.lora_b = _weight(lead + (self.rank, features), 0.0, dtype,
                                  device, gen)

    def forward(self, x: torch.Tensor,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``adapter_ids`` (multi-adapter sites): one id per example, or
        per row of x's leading axes (None: adapter 0)."""
        if self.quantized:
            y = (x @ self.qkernel.to(x.dtype)) * self.qscale.to(x.dtype)
        else:
            y = x @ self.kernel.to(x.dtype)
        if self.rank <= 0:
            return y
        if self.n_adapters <= 0:
            return y + ((x @ self.lora_a.to(x.dtype))
                        @ self.lora_b.to(x.dtype)) * (self.alpha / self.rank)
        # multi-adapter: every row takes the correction of the adapter its
        # ``adapter_ids`` entry names. Each adapter's correction is the
        # single-adapter product over all rows, selected per row: a
        # tenant's rows then equal, bit for bit, what an engine of that
        # adapter alone computes (the same matmul shapes), at N times
        # the rank-r work, which is small beside the base matmul
        if adapter_ids is None:  # an unselected call: adapter 0
            adapter_ids = torch.zeros(x.shape[0], dtype=torch.int32,
                                      device=x.device)
        pick = adapter_ids.reshape(adapter_ids.shape
                                   + (1,) * (x.dim() - adapter_ids.dim()))
        corr = None
        for j in range(self.n_adapters):
            cj = ((x @ self.lora_a[j].to(x.dtype))
                  @ self.lora_b[j].to(x.dtype))
            corr = cj if corr is None else torch.where(pick == j, cj, corr)
        return y + corr * (self.alpha / self.rank)


class Embed(nn.Module):
    """Token embedding table (``tok_embed/embedding``), kept f32."""

    def __init__(self, vocab_size: int, features: int,
                 device: torch.device, gen: torch.Generator) -> None:
        super().__init__()
        self.embedding = _weight((vocab_size, features),
                                 1.0 / math.sqrt(features), torch.float32,
                                 device, gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


def _masked_decode_attention(q: torch.Tensor, kk: torch.Tensor,
                             vv: torch.Tensor, t: torch.Tensor, dh: int,
                             dtype: torch.dtype) -> torch.Tensor:
    """The contiguous decode attention: (b, s, H, dh) queries over
    (b, length, H, dh) logical-order keys/values, each query token
    masked to keys at-or-before its own position."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
    k_pos = torch.arange(kk.shape[1], device=q.device)[None, None, None, :]
    scores = torch.where(k_pos <= t.long()[:, None, :, None], scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), vv)


def _dequant_rows(c: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 cache rows times their scales in f32, the PRODUCT cast to
    ``dtype`` (casting the scales first would drop the precision their
    f32 storage pays for)."""
    return (c.float() * scale[..., None]).to(dtype)


class _DecoderAttention(nn.Module):
    def __init__(self, hidden: int, n_heads: int, n_kv_heads: int,
                 lora_rank: int, rope_theta: float,
                 rope_scaling: Optional[RopeScaling], dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator,
                 quantized: bool = False, n_adapters: int = 0) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.rep = gqa_repeat_factor(n_heads, n_kv_heads)
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        dh = hidden // n_heads
        kw = dict(rank=lora_rank, dtype=dtype, device=device, gen=gen,
                  quantized=quantized, n_adapters=n_adapters)
        self.wq = LoRADense(hidden, n_heads * dh, **kw)
        self.wk = LoRADense(hidden, n_kv_heads * dh, **kw)
        self.wv = LoRADense(hidden, n_kv_heads * dh, **kw)
        self.wo = LoRADense(n_heads * dh, hidden, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]],
                page_tables: Optional[torch.Tensor],
                lens: Optional[torch.Tensor] = None,
                decode: bool = True,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x``: (R, d) rows, the first b·s of them the window's tokens
        in (b, s) order (``positions`` is (b, s)), the rest zero padding;
        ``adapter_ids`` one per row. Returns (R, d)."""
        b, s = positions.shape
        n, d = b * s, x.shape[-1]
        dh = d // self.n_heads
        aid = adapter_ids
        q = rope(self.wq(x, aid)[:n].reshape(b, s, self.n_heads, dh),
                 positions, self.rope_theta, self.rope_scaling)
        k = rope(self.wk(x, aid)[:n].reshape(b, s, self.n_kv_heads, dh),
                 positions, self.rope_theta, self.rope_scaling)
        v = self.wv(x, aid)[:n].reshape(b, s, self.n_kv_heads, dh)
        if not decode:
            # the train branch: causal flash attention over the window,
            # keys past each row's length masked. K/V repeat to n_heads
            # as jnp.repeat(k, rep, axis=2) does; autograd sums dK/dV
            # back over the repeats
            o = flash_attention(
                q.transpose(1, 2),
                k.repeat_interleave(self.rep, dim=2).transpose(1, 2),
                v.repeat_interleave(self.rep, dim=2).transpose(1, 2),
                causal=True, kv_lens=lens).transpose(1, 2)
            return self.wo(_pad_rows(o.reshape(n, self.n_heads * dh),
                                     x.shape[0]), aid)
        ck, cv = cache["k"], cache["v"]
        kv_int8 = "k_scale" in cache  # the int8 cache's extra leaves
        t = positions  # (b, s): each slot's own write index per token
        # write the whole window before attending: within-window
        # causality then falls out of the per-row position mask
        if page_tables is not None:
            page_size = ck.shape[1]
            col = (t // page_size).long()
            width = page_tables.shape[1]
            # a column past the table's live width (a slot re-fed at a
            # page boundary during another's chunked prefill) writes to
            # the scratch page 0, as JAX's gather fills such an index
            # and its scatter drops the write: no live row reads either
            page = torch.gather(page_tables, 1, col.clamp(max=width - 1))
            widx = (torch.where(col < width, page, torch.zeros_like(page)),
                    t % page_size)
        else:
            widx = (torch.arange(b, device=x.device)[:, None].expand(b, s),
                    t)
        if kv_int8:
            (qk, sk), (qv, sv) = (_quantize_int8(k, -1),
                                  _quantize_int8(v, -1))
            writes = [(ck, qk), (cv, qv), (cache["k_scale"], sk),
                      (cache["v_scale"], sv)]
            scales = {"k_scale": cache["k_scale"],
                      "v_scale": cache["v_scale"]}
        else:
            writes, scales = [(ck, k), (cv, v)], {}
        for leaf, val in writes:
            kv_cache_write(leaf, widx[0], widx[1], val)
        if page_tables is not None:
            # the kernels scale an int8 pool's rows inside the softmax
            sm = 1.0 / math.sqrt(dh)
            if s == 1:  # the generation hot loop
                o = paged_decode_attention(q[:, 0], ck, cv, page_tables,
                                           t[:, 0], sm, **scales)[:, None]
            else:  # chunked-prefill windows: nondecreasing positions
                o = paged_window_attention(q, ck, cv, page_tables, t, sm,
                                           **scales)
        else:
            if kv_int8:
                ck = _dequant_rows(ck, scales["k_scale"], x.dtype)
                cv = _dequant_rows(cv, scales["v_scale"], x.dtype)
            o = _masked_decode_attention(
                q, ck.repeat_interleave(self.rep, dim=2),
                cv.repeat_interleave(self.rep, dim=2), t, dh, x.dtype)
        return self.wo(_pad_rows(o.reshape(n, self.n_heads * dh),
                                 x.shape[0]), aid)


class _DecoderBlock(nn.Module):
    def __init__(self, hidden: int, n_heads: int, n_kv_heads: int,
                 mlp_dim: int, lora_rank: int, rope_theta: float,
                 rope_scaling: Optional[RopeScaling], dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator,
                 n_experts: int = 0, quantized: bool = False,
                 n_adapters: int = 0, moe_top_k: int = 1) -> None:
        super().__init__()
        self.RMSNorm_0 = RMSNorm(hidden, device)
        self.attn = _DecoderAttention(hidden, n_heads, n_kv_heads,
                                      lora_rank, rope_theta, rope_scaling,
                                      dtype, device, gen, quantized,
                                      n_adapters)
        self.RMSNorm_1 = RMSNorm(hidden, device)
        if n_experts > 0:
            # the MoE FFN (its leaves stay f32, int8 deployments too)
            self.moe = MoEFeedForward(hidden, n_experts, mlp_dim, device,
                                      gen, top_k=moe_top_k)
            return
        self.moe = None
        kw = dict(rank=lora_rank, dtype=dtype, device=device, gen=gen,
                  quantized=quantized, n_adapters=n_adapters)
        self.gate = LoRADense(hidden, mlp_dim, **kw)
        self.up = LoRADense(hidden, mlp_dim, **kw)
        self.down = LoRADense(mlp_dim, hidden, **kw)

    def forward(self, x, positions, cache, page_tables, lens=None,
                decode=True, adapter_ids=None):
        """Returns ``(x, aux)``: the block's output rows and, for a MoE
        block, its load-balancing loss (None for a dense one)."""
        x = x + self.attn(self.RMSNorm_0(x), positions, cache, page_tables,
                          lens, decode, adapter_ids)
        y = self.RMSNorm_1(x)
        if self.moe is not None:
            # route the window's b·s tokens only: padding rows would
            # take capacity slots (JAX routes every (b, s) position)
            n = positions.numel()
            out, aux = self.moe(y[:n])
            return x + _pad_rows(out, x.shape[0]), aux
        y = F.silu(self.gate(y, adapter_ids)) * self.up(y, adapter_ids)
        return x + self.down(y, adapter_ids), None


#: the checkpointing schedules of ``Llama(remat_policy=...)``
REMAT_SCHEDULES = ("none", "full", "policy")


def remat_schedule(remat: bool = False, remat_policy: str = "") -> str:
    """The schedule a module runs: ``remat_policy``, or with ``""`` the
    legacy ``remat`` flag (True: ``"full"``); JAX's ``ValueError`` for
    an unknown name."""
    ckpt = str(remat_policy or "") or ("full" if remat else "none")
    if ckpt not in REMAT_SCHEDULES:
        raise ValueError(f"unknown remat_policy {ckpt!r} "
                         "(none/full/policy)")
    return ckpt


def _dots_saveable(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
    """The ``"policy"`` schedule (JAX's ``dots_saveable``): keep every
    matrix product's output, recompute the rest (flash attention is not
    a product, in either package)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    return (CheckpointPolicy.MUST_SAVE
            if op in (aten.mm.default, aten.addmm.default,
                      aten.bmm.default, aten.baddbmm.default)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_block(schedule: str, fn: Any, *args: Any) -> Any:
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    ``"full"`` keeps only the inputs, ``"policy"`` also every matrix
    product's output. ``fn`` may be a module: the tensors bound to its
    parameters now (a ``functional_call``'s, when it runs inside one)
    are passed in and rebound for the recompute, which runs in the
    backward, after such a call has put the module's own back."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    extra: Dict[str, Any] = {}
    if schedule == "policy":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    if not isinstance(fn, nn.Module):
        return checkpoint(fn, *args, use_reentrant=False, **extra)
    names, leaves = zip(*fn.named_parameters(remove_duplicate=False))
    n = len(args)

    def run(*flat):
        return torch.func.functional_call(
            fn, dict(zip(names, flat[n:])), flat[:n])

    return checkpoint(run, *args, *leaves, use_reentrant=False, **extra)


def _check_kv_layout(max_len: int, kv_page_size: int, kv_pages: int
                     ) -> None:
    if kv_page_size > 0:
        if max_len % kv_page_size:
            raise ValueError(f"kv_page_size {kv_page_size} must divide "
                             f"max_len {max_len}")
        if kv_pages < 2:
            raise ValueError("kv_page_size > 0 needs kv_pages >= 2 (page 0 "
                             "is the scratch page; at least one usable "
                             "page)")


class Llama(nn.Module):
    """Decoder-only LM. The defaults are Llama-3-8B's published config:
    vocab 128256, context 8192, hidden 4096, depth 32, heads 32,
    kv_heads 8, mlp_dim 14336 (its rope theta, 500000, is the caller's:
    the JAX module defaults to 10000).

    ``dtype`` is the compute dtype (None = float32). ``kv_page_size > 0``
    makes the decode cache a paged pool of ``kv_pages`` pages (page 0 is
    the serving engine's scratch page); ``with_kv_layout`` gives another
    layout over the same weights. ``quantized`` holds every LoRADense
    base as int8 with per-channel scales (serving only, the tree
    :func:`quantize_llama_params` gives); ``n_adapters > 0`` stacks that
    many LoRA adapters at every site (serving only, the tree
    :func:`stack_lora_adapters` gives), each row applying the one its
    ``adapter_ids`` entry names; ``kv_int8`` makes the decode
    cache int8 with one f32 absmax scale per K/V row. ``n_experts > 0``
    replaces every block's FFN with a top-``moe_top_k`` routed MoE
    (``ops/moe.py``; its aux losses come back through ``forward``'s
    ``aux_losses``). ``remat_policy`` is the train branch's checkpointing
    schedule per block: ``"none"`` saves everything, ``"full"`` only the
    block boundaries, ``"policy"`` (JAX's ``dots_saveable``) the outputs
    of the matrix products, recomputing the rest; ``""`` defers to the
    legacy ``remat`` (True: ``"full"``). The math is the same under
    each; the decode branch never rematerializes. Weights are drawn
    from ``generator`` (a fresh one seeded 0 when None) on ``device``
    (None = the CUDA card, raising without one)."""

    def __init__(self, vocab_size: int = 128256, max_len: int = 8192,
                 hidden_dim: int = 4096, depth: int = 32,
                 n_heads: int = 32, n_kv_heads: int = 8,
                 mlp_dim: int = 14336, lora_rank: int = 0,
                 dtype: Optional[torch.dtype] = None,
                 rope_theta: float = 10000.0,
                 rope_scaling: Optional[RopeScaling] = None,
                 kv_page_size: int = 0, kv_pages: int = 0,
                 n_experts: int = 0, quantized: bool = False,
                 n_adapters: int = 0, kv_int8: bool = False,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, remat_policy: str = "",
                 moe_top_k: int = 1) -> None:
        super().__init__()
        device = resolve_device(device)
        _check_kv_layout(max_len, kv_page_size, kv_pages)
        self.remat_policy = remat_schedule(remat, remat_policy)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.hidden_dim = int(hidden_dim)
        self.depth = int(depth)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads)
        self.dtype = torch.float32 if dtype is None else dtype
        self.rope_theta = float(rope_theta)
        self.rope_scaling = rope_scaling
        self.kv_page_size = int(kv_page_size)
        self.kv_pages = int(kv_pages)
        self.quantized = bool(quantized)
        self.n_adapters = int(n_adapters)
        self.kv_int8 = bool(kv_int8)
        self.mlp_dim = int(mlp_dim)
        self.lora_rank = int(lora_rank)
        self.n_experts = int(n_experts)
        self.moe_top_k = int(moe_top_k)
        self.tok_embed = Embed(vocab_size, hidden_dim, device, generator)
        for i in range(depth):
            self.add_module(f"block_{i}", _DecoderBlock(
                hidden_dim, n_heads, n_kv_heads, mlp_dim, lora_rank,
                rope_theta, rope_scaling, self.dtype, device, generator,
                n_experts=self.n_experts, quantized=self.quantized,
                n_adapters=self.n_adapters, moe_top_k=self.moe_top_k))
        self.final_norm = RMSNorm(hidden_dim, device)
        self.lm_head = LoRADense(hidden_dim, vocab_size, 0, self.dtype,
                                 device, generator,
                                 quantized=self.quantized)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.embedding.device

    def with_kv_layout(self, kv_page_size: int, kv_pages: int) -> "Llama":
        """This model over another decode-cache layout, sharing every
        weight tensor (the JAX ``module.clone(kv_page_size=...,
        kv_pages=...)``): only the cache shape and the attention
        dispatch depend on the layout; ``quantized`` and ``kv_int8``
        carry over."""
        _check_kv_layout(self.max_len, kv_page_size, kv_pages)
        view = copy.copy(self)  # shallow: submodules and weights shared
        view.kv_page_size = int(kv_page_size)
        view.kv_pages = int(kv_pages)
        return view

    def init_cache(self, batch: int, device: DeviceLike = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """Per-layer zeroed ``{"k", "v"}`` in the compute dtype:
        ``(batch, max_len, n_kv, dh)`` rows, or ``(kv_pages, page_size,
        n_kv, dh)`` when paged. With ``kv_int8`` the two are int8, and
        ``"k_scale"``/``"v_scale"`` hold each row's f32 scale, the same
        shape without ``dh``. The forward writes them in place."""
        dev = self.device if device is None else torch.device(device)
        dh = self.hidden_dim // self.n_heads
        if self.kv_page_size > 0:
            rows = (self.kv_pages, self.kv_page_size, self.n_kv_heads)
        else:
            rows = (batch, self.max_len, self.n_kv_heads)
        kv_dtype = torch.int8 if self.kv_int8 else self.dtype

        def layer() -> Dict[str, torch.Tensor]:
            c = {name: torch.zeros(rows + (dh,), dtype=kv_dtype, device=dev)
                 for name in ("k", "v")}
            if self.kv_int8:
                c.update({name: torch.zeros(rows, dtype=torch.float32,
                                            device=dev)
                          for name in ("k_scale", "v_scale")})
            return c

        return [layer() for _ in range(self.depth)]

    def forward(self, ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[List[Dict[str, torch.Tensor]]] = None,
                page_tables: Optional[torch.Tensor] = None,
                decode: bool = True,
                return_hidden: bool = False,
                lens: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                aux_losses: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        """(b, s) ids → (b, s, vocab) logits, or the final-norm
        activations with ``return_hidden`` (prefill, which must not pay
        the lm_head; the streamed loss). ``adapter_ids`` ((b,) int32)
        selects each row's adapter on a multi-adapter model
        (``n_adapters > 0``; None is adapter 0) and is ignored otherwise.
        ``aux_losses``: a list the MoE blocks append their aux losses to,
        in block order (JAX's ``mutable=["losses"]``).

        ``decode=True`` (the default here; the JAX module's is False) is
        one decode-branch call: write the window's K/V into ``cache`` at
        ``positions`` (int32, default 0..s-1) and attend; paged models
        need ``page_tables`` ((b, n_tables) int32). ``decode=False`` is
        the train branch: no cache, causal flash attention with each
        row's keys past ``lens`` (b,) masked (default: full rows)."""
        b, s = ids.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=ids.device).expand(b, s)
        if not decode:
            if lens is None:
                lens = torch.full((b,), s, dtype=torch.int32,
                                  device=ids.device)
            cache, page_tables = [None] * self.depth, None
        elif cache is None:
            raise ValueError("decode needs the cache from init_cache()")
        elif self.kv_page_size > 0:
            if page_tables is None:
                raise ValueError(
                    "kv_page_size > 0 decode requires the page_tables "
                    "operand (the serving engine supplies it; plain "
                    "generate paths must use a contiguous-cache model)")
        else:
            page_tables = None
        # the blocks run over (R, d) rows: the b x s tokens, zero-padded
        # to ROW_BUCKET rows on the card (see there)
        x, n = _rows(self.tok_embed(ids).to(self.dtype))
        if adapter_ids is not None and self.n_adapters:
            adapter_ids = _pad_rows(adapter_ids.reshape(b, 1).expand(b, s)
                                    .reshape(n), x.shape[0])
        remat = (not decode and self.remat_policy != "none"
                 and torch.is_grad_enabled())
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            if remat:
                x, aux = checkpoint_block(
                    self.remat_policy, block, x, positions, None, None,
                    lens, False, adapter_ids)
            else:
                x, aux = block(x, positions, cache[i], page_tables, lens,
                               decode, adapter_ids)
            if aux is not None and aux_losses is not None:
                aux_losses.append(aux)
        x = self.final_norm(x)
        out = x if return_hidden else self.lm_head(x)
        return out[:n].reshape(b, s, out.shape[-1])


def greedy_generate(module: Llama, prompt_ids: np.ndarray,
                    prompt_lens: np.ndarray, max_new: int) -> torch.Tensor:
    """Greedy decode over a contiguous cache, one token per step.

    ``prompt_ids`` (b, P) left-aligned with PAD tails; each example
    starts generating right after its own last prompt token, so pads
    never enter the cache. Returns (b, max_new) generated ids (int64, on
    the module's device)."""
    dev = module.device
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=dev)
    plens = torch.as_tensor(np.asarray(prompt_lens, np.int64), device=dev)
    b, p_len = prompt.shape
    total = p_len + int(max_new)
    cache = module.init_cache(b)
    tok = prompt[:, 0]
    outs = []
    for t in range(total - 1):
        logits = module(tok[:, None],
                        positions=torch.full((b, 1), t, dtype=torch.int32,
                                             device=dev),
                        cache=cache)
        nxt = logits[:, -1].float().argmax(-1)
        # next input: the prompt token while it lasts, else our output
        tok = torch.where((t + 1) < plens,
                          prompt[:, min(t + 1, p_len - 1)], nxt)
        outs.append(nxt)
    # outs[t] is the prediction after consuming token t; example i's
    # generation starts at t = plens[i] - 1
    seq = torch.stack(outs, dim=1)  # (b, total - 1)
    gather = (plens[:, None] - 1) + torch.arange(int(max_new),
                                                 device=dev)[None, :]
    return torch.gather(seq, 1, gather.clamp(0, total - 2))


# ---- the functional training step (JAX: LlamaLoRA._lane_functions) ----

def lora_trainable_names(model: Llama, adapters_only: bool = False
                         ) -> List[str]:
    """``state_dict`` keys of the leaves a LoRA fine-tune trains: the
    adapters, every norm scale, the MoE routers and experts (no
    pretrained checkpoint carries them, so they always train) and the LM
    head (JAX's ``lora_trainable_mask``), or the adapters alone with
    ``adapters_only`` (``adapter_only_mask``). The base kernels and the
    embedding stay frozen."""
    return [name for name, _ in model.named_parameters()
            if _trains(name, adapters_only)]


def _trains(key: str, adapters_only: bool = False) -> bool:
    """JAX's ``lora_trainable_mask`` (``adapter_only_mask`` with
    ``adapters_only``) of one ``state_dict`` key."""
    path = key.replace(".", "/").lower()
    if adapters_only:
        return "lora_a" in path or "lora_b" in path
    return ("lora_" in path or "norm" in path or "/moe/" in path
            or path.startswith("lm_head"))


def make_trainable(model: Llama, names: Sequence[str]
                   ) -> Dict[str, nn.Parameter]:
    """In place: the named leaves become f32 master weights that take
    gradients (JAX keeps every parameter f32 and casts per call; a leaf
    kept in bf16 would round each Adam update away), every other leaf is
    frozen in the compute dtype, so no gradient is allocated for the
    base. Returns ``{name: parameter}`` of the trainable leaves."""
    wanted = set(names)
    out: Dict[str, nn.Parameter] = {}
    for name, p in list(model.named_parameters()):
        if name not in wanted:
            p.requires_grad_(False)
            continue
        owner, leaf = name.rsplit(".", 1)
        param = nn.Parameter(p.detach().float(), requires_grad=True)
        setattr(model.get_submodule(owner), leaf, param)
        out[name] = param
    return out


def merge(trainable: Dict[str, torch.Tensor], lora_scale: float
          ) -> Dict[str, torch.Tensor]:
    """The leaves the forward uses: every ``lora_b`` times ``lora_scale``
    (the LoRA α/r rank-scale), the stored leaf unscaled. The export folds
    the same product into the stored tree."""
    return {name: t * lora_scale if "lora_b" in name else t
            for name, t in trainable.items()}


def lm_valid_mask(seq_len: int, lens: torch.Tensor,
                  example_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(B, L) bool: positions whose next-token loss counts — before each
    example's last real token, in unmasked examples."""
    pos = torch.arange(seq_len, device=lens.device)[None, :]
    valid = pos < (lens.long()[:, None] - 1)
    if example_mask is not None:
        valid = valid & (example_mask[:, None] > 0)
    return valid


def lm_loss_terms(logits: torch.Tensor, ids: torch.Tensor,
                  lens: torch.Tensor,
                  example_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token cross-entropy on f32 logits: (sum of losses,
    valid count). Targets are ``ids`` shifted left."""
    b, length, vocab = logits.shape
    targets = F.pad(ids[:, 1:], (0, 1)).long()
    valid = lm_valid_mask(length, lens, example_mask)
    losses = F.cross_entropy(logits.float().reshape(-1, vocab),
                             targets.reshape(-1), reduction="none")
    valid = valid.float()
    return (losses.reshape(b, length) * valid).sum(), valid.sum()


def chunked_lm_loss_terms(hidden: torch.Tensor, head_kernel: torch.Tensor,
                          ids: torch.Tensor, lens: torch.Tensor,
                          example_mask: Optional[torch.Tensor] = None,
                          chunk: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lm_loss_terms` without the (B, L, vocab) logits: the final-
    norm activations ``hidden`` (B, L, d) are projected by
    ``head_kernel`` (d, vocab) and reduced to summed cross-entropy one
    sequence chunk at a time (:func:`_chunked_ce_sum`). Same math up to
    f32 summation order; sequence pads up to a chunk multiple are masked
    out of the sum and the count."""
    targets = F.pad(ids[:, 1:], (0, 1)).long()
    valid = lm_valid_mask(hidden.shape[1], lens, example_mask)
    return (_chunked_ce_sum(hidden, targets, valid, head_kernel, chunk),
            valid.float().sum())


def _chunk_ce(h: torch.Tensor, kernel: torch.Tensor, t: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    logits = h @ kernel  # (B, chunk, vocab): this chunk's only
    losses = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                             t.reshape(-1), reduction="none")
    return (losses.reshape(t.shape) * v).sum()


def _chunked_ce_sum(hidden: torch.Tensor, targets: torch.Tensor,
                    valid: torch.Tensor, head_kernel: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """The chunk loop of JAX's ``_chunked_ce_sum``: each (B, chunk)
    slice is projected in ``hidden``'s dtype, reduced in f32 and
    dropped; under a gradient the chunk body is checkpointed, so the
    backward holds one chunk of logits too. The running sum starts at
    0 and adds the chunks in order, as JAX's scan carries it."""
    b, length, d = hidden.shape
    chunk = max(1, min(int(chunk), length))
    pad = (-length) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        valid = F.pad(valid, (0, pad))
    kernel = head_kernel.to(hidden.dtype)  # cast once, as LoRADense does
    v = valid.float()
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or kernel.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, length + pad, chunk):
        args = (hidden[:, i:i + chunk], kernel, targets[:, i:i + chunk],
                v[:, i:i + chunk])
        total = total + (checkpoint_block("full", _chunk_ce, *args)
                         if remat else _chunk_ce(*args))
    return total


def chunked_lm_loss_terms_sp(hidden: Any, head_kernel: Any,
                             ids: torch.Tensor, lens: torch.Tensor,
                             example_mask: Optional[torch.Tensor],
                             chunk: int, mesh: Mesh, data_axis: str,
                             sp_axis: str
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`chunked_lm_loss_terms` with the sequence split over
    ``mesh[sp_axis]`` (JAX's ``chunked_lm_loss_terms_sp``): the
    next-token shift runs over the whole (B, L) batch first (it crosses
    the shards' boundaries), then each (data, sp) position streams its
    own (B / dp, L / sp) slice of ``hidden`` through the chunk loop
    (:func:`_chunked_ce_sum`, chunk ``min(chunk, L / sp)``) and the (sum,
    count) are all-reduced over both axes. ``hidden``: the global (B, L,
    d) tensor, or one slice per mesh position (flat order);
    ``head_kernel``: one (d, vocab) tensor, or one per position. Returns
    the first position's (sum, count), 0-d f32."""
    seq = ids.shape[1]
    sp = mesh.shape[sp_axis]
    if seq % sp:
        raise ValueError(f"sequence {seq} must divide the "
                         f"sp axis ({sp}) for the sharded chunked loss")
    chunk = max(1, min(int(chunk), seq // sp))
    spec = (data_axis, sp_axis)
    if isinstance(hidden, torch.Tensor):
        hidden = to_positions(hidden, mesh, spec)
    if isinstance(head_kernel, torch.Tensor):
        head_kernel = [head_kernel.to(d) for d in mesh.flat_devices()]
    targets = to_positions(F.pad(ids[:, 1:], (0, 1)).long(), mesh, spec)
    valid = to_positions(lm_valid_mask(seq, lens, example_mask), mesh, spec)
    totals = [_chunked_ce_sum(h, t, v, w, chunk)
              for h, t, v, w in zip(hidden, targets, valid, head_kernel)]
    counts = [v.float().sum() for v in valid]
    axes = (data_axis, sp_axis)
    return (on_axis(mesh, axes, all_reduce, totals)[0],
            on_axis(mesh, axes, all_reduce, counts)[0])


def micro_terms(model: Llama, leaves: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], loss_chunk: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``micro_terms``: (loss sum, valid count, MoE aux) of one
    (micro-)batch through the train branch, ``leaves`` (``state_dict``
    keys) in place of the model's own. With ``loss_chunk`` the forward
    stops at the final norm and the LM head runs chunk by chunk
    (:func:`chunked_lm_loss_terms`). The aux is 0 for a dense model."""
    aux: List[torch.Tensor] = []
    ids, lens = batch["ids"], batch["lens"]
    out = torch.func.functional_call(
        model, leaves, (ids,), {"decode": False, "lens": lens,
                                "return_hidden": bool(loss_chunk),
                                "aux_losses": aux})
    if loss_chunk:
        kernel = leaves.get("lm_head.kernel", model.lm_head.kernel)
        total, count = chunked_lm_loss_terms(out, kernel, ids, lens,
                                             batch.get("mask"), loss_chunk)
    else:
        total, count = lm_loss_terms(out, ids, lens, batch.get("mask"))
    return total, count, moe_aux_loss(aux, ids.device)


def lm_objective(model: Llama, trainable: Dict[str, torch.Tensor],
                 lora_scale: float, batch: Dict[str, torch.Tensor],
                 loss_chunk: int = 0) -> torch.Tensor:
    """The step objective of one batch (``ids``, ``lens`` and,
    optionally, ``mask``) through the train branch, the trainable leaves
    merged with the rank-scale: the mean masked next-token loss, plus
    ``MOE_AUX_COEF`` times the MoE aux (exactly 0 for a dense model)."""
    total, count, aux = micro_terms(model, merge(trainable, lora_scale),
                                    batch, loss_chunk)
    return total / count.clamp(min=1.0) + MOE_AUX_COEF * aux


#: the decay of the JAX step's ``optax.add_decayed_weights``
WEIGHT_DECAY = 1e-4


def lane_init(trainable: Dict[str, torch.Tensor], learning_rate: float,
              lora_scale: float = 1.0
              ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """``(state, hp)`` of one lane over :func:`make_trainable`'s leaves:
    the state's params share those leaves' storage (a step updates the
    model in place), Adam's moments start at zero; ``hp`` holds the 0-d
    f32 ``learning_rate`` and ``lora_scale``."""
    params = {n: t.detach() for n, t in trainable.items()}
    dev = next(iter(params.values())).device
    hp = {n: torch.tensor(float(v), dtype=torch.float32, device=dev)
          for n, v in (("learning_rate", learning_rate),
                       ("lora_scale", lora_scale))}
    return {"params": params, "opt": lane_adam_init(params)}, hp


def _accumulated_grads(model: "Llama", params: Dict[str, torch.Tensor],
                       lora_scale: torch.Tensor,
                       batch: Dict[str, torch.Tensor], grad_accum: int,
                       loss_chunk: int
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """JAX's gradient accumulation: ``grad_accum`` contiguous micro-
    batches, each objective ``total / global valid count + MOE_AUX_COEF
    · aux / grad_accum`` (the count over the whole batch, so the summed
    gradients are the big batch's); returns (the summed objectives, the
    summed gradients). At ``grad_accum`` 1 it is :func:`lm_objective`
    and its gradients, bit for bit."""
    ids, lens, mask = batch["ids"], batch["lens"], batch.get("mask")
    b, seq = ids.shape
    if b % grad_accum:
        raise ValueError(f"batch {b} must divide by grad_accum "
                         f"{grad_accum}")
    denom = lm_valid_mask(seq, lens, mask).float().sum().clamp(min=1.0)
    leaves = list(params.values())
    m = b // grad_accum
    loss, grads = None, None
    for i in range(grad_accum):
        micro = {key: t[i * m:(i + 1) * m] for key, t in batch.items()}
        total, _, aux = micro_terms(model, merge(params, lora_scale), micro,
                                    loss_chunk)
        val = total / denom + MOE_AUX_COEF * aux / grad_accum
        g = torch.autograd.grad(val, leaves)
        loss = val.detach() if loss is None else loss + val.detach()
        grads = list(g) if grads is None else [
            a + c for a, c in zip(grads, g)]
    return loss, grads


def lane_train_step(model: "Llama", state: Dict[str, Any],
                    hp: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], loss_chunk: int = 0,
                    grad_accum: int = 1
                    ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One step of one lane: ``state`` is ``{"params": {state_dict key:
    f32 trainable leaf}, "opt": lane Adam}``, ``hp`` the 0-d tensors
    ``learning_rate`` and ``lora_scale``. The forward is ``model`` with
    the lane's leaves in place of its own (merged with the rank-scale);
    the update is in place. ``loss_chunk`` streams the loss, and the
    gradients of ``grad_accum`` micro-batches are summed before the one
    update (JAX's non-functional step; one micro-batch is the functional
    step). Returns (state, the batch loss, detached)."""
    params = {n: p.detach().requires_grad_(True)
              for n, p in state["params"].items()}
    loss, grads = _accumulated_grads(model, params, hp["lora_scale"],
                                     batch, grad_accum, loss_chunk)
    lane_adam_step(state["params"], dict(zip(params, grads)),
                   state["opt"], hp["learning_rate"], WEIGHT_DECAY)
    return state, loss.detach()


def _lane_norm(x: torch.Tensor, norm: RMSNorm,
               scale: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """``RMSNorm`` over (R, d) rows in K lane blocks: the shared module's
    own scale, or the lanes' (K, d) scales, each over its block."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                          + norm.eps)
    if scale is None:
        return (y * norm.scale).to(x.dtype)
    return (y.reshape(k, -1, x.shape[-1]) * scale[:, None, :]) \
        .reshape(x.shape).to(x.dtype)


def _lane_dense(x: torch.Tensor, dense: LoRADense,
                lanes: Dict[str, torch.Tensor], name: str,
                k: int) -> torch.Tensor:
    """A ``LoRADense`` over (R, d_in) rows in K lane blocks: the shared
    base kernel as one matmul over every row, each lane's correction
    ``((x @ A) @ B) · α/r`` a ``bmm`` over its block; a lane-stacked
    kernel (the LM head) is one ``bmm``."""
    kernel = lanes.get(f"{name}.kernel")
    if kernel is not None:
        return torch.bmm(x.reshape(k, -1, x.shape[-1]),
                         kernel.to(x.dtype)).reshape(x.shape[0], -1)
    y = x @ dense.kernel.to(x.dtype)
    if dense.rank <= 0:
        return y
    xk = x.reshape(k, -1, x.shape[-1])
    corr = torch.bmm(torch.bmm(xk, lanes[f"{name}.lora_a"].to(x.dtype)),
                     lanes[f"{name}.lora_b"].to(x.dtype))
    return y + (corr * (dense.alpha / dense.rank)).reshape(y.shape)


def _lane_block(model: "Llama", i: int, lanes: Dict[str, torch.Tensor],
                positions: torch.Tensor, lens: torch.Tensor, k: int,
                x: torch.Tensor) -> torch.Tensor:
    """Block ``i`` of :func:`lanes_forward` over (K·B·L, d) rows."""
    b, s = positions.shape
    pre = f"block_{i}"
    blk = getattr(model, pre)
    att = blk.attn

    def dense(mod, name, h):
        return _lane_dense(h, mod, lanes, name, k)

    def norm(mod, name, h):
        return _lane_norm(h, mod, lanes.get(f"{name}.scale"), k)

    h = norm(blk.RMSNorm_0, f"{pre}.RMSNorm_0", x)
    dh = x.shape[-1] // att.n_heads
    q = rope(dense(att.wq, f"{pre}.attn.wq", h).reshape(
        b, s, att.n_heads, dh), positions, att.rope_theta, att.rope_scaling)
    kk = rope(dense(att.wk, f"{pre}.attn.wk", h).reshape(
        b, s, att.n_kv_heads, dh), positions, att.rope_theta,
        att.rope_scaling)
    v = dense(att.wv, f"{pre}.attn.wv", h).reshape(b, s, att.n_kv_heads, dh)
    o = flash_attention(
        q.transpose(1, 2),
        kk.repeat_interleave(att.rep, dim=2).transpose(1, 2),
        v.repeat_interleave(att.rep, dim=2).transpose(1, 2),
        causal=True, kv_lens=lens).transpose(1, 2)
    x = x + dense(att.wo, f"{pre}.attn.wo",
                  o.reshape(b * s, att.n_heads * dh))
    h = norm(blk.RMSNorm_1, f"{pre}.RMSNorm_1", x)
    h = F.silu(dense(blk.gate, f"{pre}.gate", h)) \
        * dense(blk.up, f"{pre}.up", h)
    return x + dense(blk.down, f"{pre}.down", h)


def lanes_forward(model: "Llama", lanes: Dict[str, torch.Tensor],
                  ids: torch.Tensor, lens: torch.Tensor,
                  k: int) -> torch.Tensor:
    """The train branch of ``model.forward`` for K lanes: ``ids`` (K·B,
    L), lane i's examples the i-th block of B; ``lanes`` maps each
    trainable ``state_dict`` key to its (K, ...) leaf (``lora_b`` already
    times the lane's rank-scale); every other leaf is ``model``'s. Each
    block runs under ``model``'s checkpointing schedule. Returns (K·B,
    L, vocab) logits."""
    b, s = ids.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=ids.device).expand(b, s)
    x = model.tok_embed(ids).to(model.dtype).reshape(b * s, -1)
    remat = model.remat_policy != "none" and torch.is_grad_enabled()
    for i in range(model.depth):
        block = functools.partial(_lane_block, model, i, lanes, positions,
                                  lens, k)
        x = (checkpoint_block(model.remat_policy, block, x) if remat
             else block(x))
    x = _lane_norm(x, model.final_norm, lanes.get("final_norm.scale"), k)
    return _lane_dense(x, model.lm_head, lanes, "lm_head",
                       k).reshape(b, s, -1)


def lanes_train_step(model: "Llama", state: Dict[str, Any],
                     hp: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One step of K lanes (:func:`lanes_forward`): ``state`` leaves and
    ``hp`` carry a leading K, ``batch`` holds (K, B, ...) ``ids``,
    ``lens`` and ``mask``. Each lane's loss is its masked mean, the sum
    of the K the one backward. Returns (state, (K,) losses)."""
    ids, lens, mask = batch["ids"], batch["lens"], batch.get("mask")
    k, bsz, length = ids.shape
    params = {n: p.detach().requires_grad_(True)
              for n, p in state["params"].items()}
    scale = hp["lora_scale"].float()
    lanes = {n: t * scale.reshape((k,) + (1,) * (t.dim() - 1))
             if "lora_b" in n else t for n, t in params.items()}
    flat_ids = ids.reshape(k * bsz, length)
    flat_lens = lens.reshape(k * bsz)
    logits = lanes_forward(model, lanes, flat_ids, flat_lens, k)
    vocab = logits.shape[-1]
    targets = F.pad(flat_ids[:, 1:], (0, 1)).long()
    valid = lm_valid_mask(length, flat_lens, None if mask is None
                          else mask.reshape(k * bsz)).float()
    losses = F.cross_entropy(logits.float().reshape(-1, vocab),
                             targets.reshape(-1), reduction="none")
    valid = valid.reshape(k, -1)
    lane_loss = (losses.reshape(k, -1) * valid).sum(1) \
        / valid.sum(1).clamp(min=1.0)
    grads = torch.autograd.grad(lane_loss.sum(), list(params.values()))
    lane_adam_step(state["params"], dict(zip(params, grads)),
                   state["opt"], hp["learning_rate"], WEIGHT_DECAY)
    return state, lane_loss.detach()


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A host batch (``ids``, ``lens``[, ``mask``]) as device tensors."""
    out = {"ids": torch.as_tensor(batch["ids"]).long().to(device),
           "lens": torch.as_tensor(batch["lens"]).int().to(device)}
    if "mask" in batch:
        out["mask"] = torch.as_tensor(batch["mask"]).to(device)
    return out


def _default_kv_pages(max_slots: int, max_len: int, page_size: int) -> int:
    """Full-coverage pool: every slot can hold ``max_len`` (no saving, no
    stalls) plus the scratch page."""
    return 1 + max_slots * (max_len // page_size)


def stack_lora_adapters(trees: Sequence[Dict[str, Any]],
                        validate: bool = True) -> Dict[str, Any]:
    """Ports ``stack_lora_adapters``: N adapter-only fine-tunes of one
    base (nested-dict params trees, the JAX layout) merged into the tree
    of ``Llama(n_adapters=N)``. ``lora_a``/``lora_b`` leaves stack along
    a new leading adapter axis (f32 numpy); every other leaf is taken
    from ``trees[0]`` as it is (not copied) and, with ``validate``,
    checked byte-identical across the inputs: a mismatch means the
    trials were not trained with ``adapters_only`` and cannot share one
    serving engine. ``validate=False`` skips the scan."""
    trees = list(trees)
    if not trees:
        raise ValueError("need at least one adapter tree")

    def as_np(leaf: Any) -> np.ndarray:
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", torch.float32).numpy()
        return np.asarray(leaf)

    def merge(path: List[str], nodes: List[Any]) -> Any:
        if isinstance(nodes[0], dict):
            return {k: merge(path + [k], [n[k] for n in nodes])
                    for k in nodes[0]}
        name = "/".join(path).lower()
        if "lora_a" in name or "lora_b" in name:
            return np.stack([as_np(n).astype(np.float32) for n in nodes])
        if validate:
            first = as_np(nodes[0])
            for i, leaf in enumerate(nodes[1:], start=1):
                if leaf is not nodes[0] and not np.array_equal(
                        first, as_np(leaf)):
                    raise ValueError(
                        f"non-adapter leaf {name!r} differs between "
                        f"adapter 0 and {i}: multi-adapter serving "
                        "requires trials trained with adapters_only=True "
                        "(shared base/norms/lm_head)")
        return nodes[0]

    return merge([], trees)


def _load_leaves(model: nn.Module, tree: Dict[str, Any]) -> None:
    """``model.load_state_dict(llama_params_from_jax(tree, dtype))``, one
    leaf at a time: each leaf is cast to its parameter's type on the way
    in (the bits the bridge's cast gives), so an 8B tree never has a
    second, compute-dtype copy of itself on the host. The keys must be
    the model's, and the shapes its parameters'."""
    state = model.state_dict()
    flat = params_from_jax(tree)
    if set(flat) != set(state):
        raise ValueError(f"params tree does not match the model: missing "
                         f"{sorted(set(state) - set(flat))[:4]}, unexpected "
                         f"{sorted(set(flat) - set(state))[:4]}")
    with torch.no_grad():
        for key, t in flat.items():
            if tuple(t.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != the "
                                 f"model's {tuple(state[key].shape)}")
            state[key].copy_(t)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``state_dict``-keyed leaves as the nested params tree."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _replace_leaves(tree: Dict[str, Any],
                    leaves: Dict[str, torch.Tensor],
                    copy: bool = True) -> Dict[str, Any]:
    """``tree`` (an f32 tree the caller owns and never writes) with the
    leaves named by ``state_dict`` key replaced by f32 numpy copies (with
    ``copy=False``, views of CPU f32 leaves the caller hands over); the
    other leaves are shared, not copied."""
    out = structure_copy(tree)
    for key, t in leaves.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        host = t.detach().to("cpu", torch.float32)
        node[leaf] = np.array(host) if copy else host.numpy()
    return out


class LlamaDims(NamedTuple):
    """The shapes a train estimate reads: ``act`` is the compute dtype's
    bytes, ``rank`` the LoRA rank (0: no adapters)."""
    vocab: int
    hidden: int
    depth: int
    heads: int
    kv_heads: int
    mlp: int
    rank: int
    act: int
    n_experts: int = 0
    top_k: int = 1

    @classmethod
    def of(cls, model: Llama) -> "LlamaDims":
        return cls(model.vocab_size, model.hidden_dim, model.depth,
                   model.n_heads, model.n_kv_heads, model.mlp_dim,
                   model.lora_rank, torch.finfo(model.dtype).bits // 8,
                   model.n_experts, model.moe_top_k)


def _train_terms(d: LlamaDims, batch_size: int, seq: int,
                 adapters_only: bool = False, remat_policy: str = "none",
                 grad_accum: int = 1, loss_chunk: int = 0, mp: int = 0,
                 route_tokens: int = 0, sp: int = 1) -> Dict[str, int]:
    """The element and byte counts :func:`estimate_train_device_bytes`
    and :func:`estimate_gang_device_bytes` share: ``trainable``
    (elements), ``slots`` (the bytes of the trainable leaves as the
    module draws them), ``frozen`` (bytes), ``activations`` and
    ``transient`` (bytes of one (micro-)batch's step). ``mp >= 1`` gives
    one shard's of the mesh loop on a ``model`` axis of ``mp``
    (``batch_size`` then its data row's): the residual stream and the
    norms whole, the heads, the MLP, the experts and the vocabulary
    split ``mp`` ways, the MoE capacity of ``route_tokens`` (the global
    micro-batch's); its loss (``llama_mesh._VocabShardCE``) keeps the
    logits in the compute dtype and adds ``working``: its backward's f32
    softmax and cast gradient, made for one shard at a time. ``sp > 1``
    gives one position's of a sequence-split mesh (``seq`` then its
    slice's length): the ring's attention (where ``heads / mp`` do not
    divide over ``sp``) keeps K and V un-repeated, and the streamed loss
    (:func:`chunked_lm_loss_terms_sp`) is the one-card chunk loop's, its
    chunk's buffers in ``working`` and the LM head's compute-dtype
    gradient, which the chunks accumulate into, in ``transient``."""
    mesh = mp >= 1
    mp = max(1, mp)
    act, hd, depth = d.act, d.hidden, d.depth
    rank, k = d.rank, d.top_k
    mlp, vocab, e = d.mlp // mp, -(-d.vocab // mp), d.n_experts // mp
    dh = hd // d.heads
    kv = d.kv_heads * dh // (mp if d.kv_heads % mp == 0 else 1)
    sites = [(hd, hd // mp), (hd, kv), (hd, kv), (hd // mp, hd)]
    if not e:
        sites += [(hd, mlp), (hd, mlp), (mlp, hd)]
    lora = depth * sum(rank * (i + o) for i, o in sites)
    norms = (2 * depth + 1) * hd
    head = hd * vocab
    experts = depth * e * (hd + 3 * hd * mlp)  # routers and experts, f32
    tokens = max(1, batch_size // max(1, grad_accum)) * seq
    # one block's saved tensors per token under "none": each RMSNorm's
    # f32 input and rsqrt, and its normalized output where the scale
    # trains; the attention input, q, K/V repeated to every head, the
    # attention output and its reshaped copy in the compute dtype;
    # rope's f32 cos and sin for q and k; the f32 LSE; each LoRA site's
    # rank-wide x @ lora_a. A dense FFN adds its input and the SwiGLU's
    # gate, silu, up and product; a MoE FFN the router's f32 input, its
    # probabilities, each choice's f32 output row and, per layer, the
    # expert slots, their SwiGLU tensors and the experts' per-call casts
    rms = (4 if adapters_only else 8) * hd + 4
    # q, K/V (repeated, or the ring's un-repeated), the output, its copy
    qkvo = (3 * (hd // mp) + 2 * kv if sp > 1 and (d.heads // mp) % sp
            else 5 * (hd // mp))
    block = (2 * rms + act * (hd + qkvo) + 8 * dh
             + 4 * (d.heads // mp) + act * len(sites) * rank)
    layer = 0
    if e:
        cap = e * expert_capacity(route_tokens or tokens, k, d.n_experts)
        block += 4 * hd + 4 * d.n_experts + k * (4 * hd + 16)
        layer = cap * (act * hd + 4 * act * mlp + 8) \
            + (3 * e * hd * mlp * act if act != 4 else 0)
    else:
        block += act * (hd + 4 * mlp)
    whole = tokens * block + layer  # one block, nothing rematerialized
    if remat_policy == "none":
        blocks, recompute = depth * whole, 0
    else:
        # the checkpoint's input rows; "policy" adds every product's
        # output (the base kernels' and, with adapters, x @ A and its
        # product with B), the router's logits and the experts' products
        keep = act * hd
        if remat_policy == "policy":
            width = sum(o for _, o in sites)
            keep += act * (width + (width + len(sites) * rank
                                    if rank else 0))
            if e:
                keep += 4 * d.n_experts
        kept_layer = (cap * act * (2 * mlp + hd)
                      if e and remat_policy == "policy" else 0)
        blocks = depth * (tokens * keep + kept_layer)
        recompute = whole  # one block's, in the backward
    # after the blocks: the final norm's and the LM head's input, then
    # the loss's f32 log-probs, their cotangent and the logits' f32
    # cotangent, alive together as the backward starts; streamed, one
    # chunk of those plus the compute-dtype gradient of the LM head the
    # chunks accumulate into
    rows = max(1, batch_size // max(1, grad_accum))
    logit_rows = rows * min(loss_chunk, seq) if loss_chunk else tokens
    working = 0
    streamed_sp = sp > 1 and bool(loss_chunk)
    if streamed_sp:  # one position's chunk at a time, in the backward
        working = logit_rows * 12 * vocab
        logits = 0
    elif mesh:  # the compute-dtype logits (a streamed chunk's: none kept)
        working = logit_rows * vocab * (4 + (act if act != 4 else 0)
                                        + (act if loss_chunk else 0))
        logits = act * head if loss_chunk else tokens * vocab * act
    else:
        logits = logit_rows * 12 * vocab + (act * head if loss_chunk
                                            else 0)
    final = tokens * (rms + act * hd) + max(logits, recompute)
    return {
        "working": working,
        "trainable": lora if adapters_only else lora + norms + head
        + experts,
        "slots": act * lora + (0 if adapters_only else
                               4 * norms + act * head + 4 * experts),
        "frozen": act * (depth * sum(i * o for i, o in sites)
                         + (head if adapters_only else 0))
        + 4 * (vocab * hd + (norms + experts if adapters_only else 0)),
        "activations": blocks + final,
        # the compute-dtype cast of the LM head, made per call (and, on
        # a sequence-split mesh's streamed loss, its gradient)
        "transient": (0 if adapters_only or act == 4 else head * act)
        + (head * act if streamed_sp else 0)}


def estimate_train_device_bytes(dims: LlamaDims, *, batch_size: int,
                                seq: int, adapters_only: bool = False,
                                remat: bool = False,
                                remat_policy: str = "",
                                grad_accum: int = 1, loss_chunk: int = 0
                                ) -> Dict[str, int]:
    """Device memory of one train step of a ``Llama`` of ``dims`` on one
    card (JAX's ``estimate_train_device_bytes`` on a mesh of one), in
    what the port allocates, term by term:

    - ``params``: trainable leaves (adapters, norms, MoE routers and
      experts, the LM head) as f32 master weights; frozen leaves as
      ``train`` holds them (base kernels in the compute dtype, the
      embedding f32);
    - ``grads``: one f32 gradient per trainable leaf;
    - ``opt``: Adam's two f32 moments per trainable leaf;
    - ``activations``: what autograd holds when the backward starts over
      one (micro-)batch of ``batch_size / grad_accum`` × ``seq`` tokens,
      under the checkpointing schedule (``remat_policy``, or ``remat``'s
      ``"full"``): every block's saved tensors (``"none"``), their
      inputs and matrix products' outputs (``"policy"``) or their inputs
      alone (``"full"``, then one block rematerialized at a time), then
      the loss's, dense or streamed (``loss_chunk``);
    - ``transient``: the compute-dtype cast of the LM head.

    The terms do not all live at once, so ``total`` is the step's peak:
    ``params + opt`` and the larger of the backward (``activations +
    transient``, plus the ``grads`` accumulator after the first
    micro-batch with ``grad_accum > 1``) and the update (the gradients
    and the lane Adam's two temporaries, ``3 · grads``)."""
    return _step_bytes(_train_terms(
        dims, batch_size, seq, adapters_only,
        remat_schedule(remat, remat_policy), grad_accum, loss_chunk),
        grad_accum > 1)


def _step_bytes(t: Dict[str, int], accumulating: bool) -> Dict[str, int]:
    """:func:`estimate_train_device_bytes` from :func:`_train_terms`'
    counts ``t``."""
    trainable = t["trainable"]
    out = {"params": 4 * trainable + t["frozen"], "grads": 4 * trainable,
           "opt": 2 * 4 * trainable, "activations": t["activations"],
           "transient": t["transient"]}
    if t.get("working"):
        out["working"] = t["working"]
    backward = out["activations"] + out["transient"] + out.get(
        "working", 0) + (out["grads"] if accumulating else 0)
    out["total"] = out["params"] + out["opt"] + max(backward,
                                                    3 * out["grads"])
    return out


def estimate_mesh_train_device_bytes(template: "LlamaLoRA", dp: int,
                                     mp: int, sp: int = 1
                                     ) -> Dict[str, int]:
    """One device's memory of :meth:`LlamaLoRA._train_mesh` on a (dp, mp)
    mesh, or with ``sp > 1`` a (dp, sp[, mp]) one (JAX's
    ``estimate_train_device_bytes`` at ``data_parallel`` dp,
    ``model_parallel`` mp, ``sequence_parallel`` sp), in
    :func:`estimate_train_device_bytes`' terms and peak rule: ``params``
    and ``opt`` are exact sums over the shard shapes of JAX's specs
    (``TP_RULES`` and fsdp; fsdp alone on a (data, sp) mesh), each leaf
    as the mesh holds it (trainable f32, frozen kernels in the compute
    dtype); ``activations``, ``transient`` and ``working`` (the loss
    backward's buffers) are one shard's (:func:`_train_terms` with
    ``mp`` and ``sp``) over its ``batch / (dp · grad_accum)`` rows of
    ``max_len / sp`` tokens. Shards that share a card (a mesh that
    repeats a device) hold their other terms each, but one process makes
    the ``working`` buffers for one shard at a time, the data rows of a
    model position share its gathered LM head, and an ``sp`` group holds
    one copy of its leaves (:func:`colocated_train_bytes`)."""
    from rafiki_tpu_torch.models.llama_mesh import (mesh_specs,
                                                    storage_dtype)
    from rafiki_tpu_torch.parallel.sharding import leaf_paths, shard_shape

    k = template.knobs
    if sp > 1:
        mesh = make_sp_mesh(["cpu"] * (dp * sp * mp), sp, mp)
    else:
        mesh = make_mesh(["cpu"] * (dp * mp), model=mp)
    shapes = template._param_shapes()
    specs = mesh_specs(shapes, mesh,
                       None if sp > 1 and mp == 1 else TP_RULES)
    adapters_only = bool(k.get("adapters_only", False))
    dtype = template._dtype()
    trainable, frozen = 0, 0
    for path, leaf in leaf_paths(shapes):
        key = ".".join(path)
        n = math.prod(shard_shape(leaf.shape, specs[key], mesh))
        if _trains(key, adapters_only):
            trainable += n
        else:
            frozen += n * torch.finfo(storage_dtype(key, False, dtype)).bits \
                // 8
    grad_accum = int(k.get("grad_accum", 1) or 1)
    batch = int(k["batch_size"])
    batch = max(grad_accum * dp, batch - batch % (grad_accum * dp))
    t = _train_terms(
        template._dims(), batch // dp, int(k["max_len"]) // sp,
        adapters_only, remat_schedule(bool(k.get("remat", False)),
                                      str(k.get("remat_policy", "") or "")),
        grad_accum, int(k.get("loss_chunk", 0) or 0), mp=mp,
        route_tokens=batch // grad_accum * int(k["max_len"]), sp=sp)
    t.update(trainable=trainable, frozen=frozen)
    return _step_bytes(t, grad_accum > 1)


def colocated_train_bytes(est: Dict[str, int], dp: int, mp: int,
                          accumulating: bool = False, sp: int = 1) -> int:
    """The peak of a (dp, mp) mesh's shards (or a (dp, sp, mp) mesh's)
    all on one card, each estimated ``est``
    (:func:`estimate_mesh_train_device_bytes`): the step's peak rule over
    their summed terms, with the ``working`` buffers counted once (one
    process makes them for one shard at a time), the gathered LM head
    (``transient``) once per model position (the ``dp`` data rows and
    ``sp`` positions of a model position make it onto one card, and the
    gather's result is one tensor there), and the leaves, their Adam
    moments and gradients once per ``sp`` group (its positions on one
    card share one tensor of each, ``ShardedLeaf.owner``); the
    activations are every position's."""
    u = dp * mp
    backward = u * sp * est["activations"] + mp * est["transient"] + \
        est.get("working", 0) + (u * est["grads"] if accumulating else 0)
    return u * (est["params"] + est["opt"]) + max(backward,
                                                  3 * u * est["grads"])


def estimate_gang_device_bytes(template: "LlamaLoRA",
                               gang_size: int) -> Dict[str, int]:
    """Device memory of a K-lane gang step of ``template``'s knobs, in the
    port's own accounting (:func:`estimate_train_device_bytes`'s terms):
    ONE frozen base (``base``: the frozen leaves, plus the module's own
    copies of the trainable leaves, which the lanes replace per call), K
    lanes of f32 trainable leaves with their gradients and two Adam
    moments, K lanes of activations under the bucket's checkpointing
    schedule, and the LM head cast per call for all K lanes. ``params``
    includes ``base``; ``total`` is the sum of the terms, not the one
    trial's peak rule (:func:`estimate_train_device_bytes`): that rule is
    fitted to one lane, and a gang holds more of its terms at once (on an
    H100, ``chip_smoke.py``'s phase 31 gang of four lanes at hidden 4096,
    depth 4, peaked at 58.35 GB, above the rule's 56.11 GB and under the
    sum's 64.61 GB). So a 1-lane gang is budgeted above the same trial
    run alone."""
    template._check_trainable_knobs()
    t = template._budget_terms()
    k = max(1, int(gang_size))
    trainable = t["trainable"]
    out = {"params": t["frozen"] + t["slots"] + k * 4 * trainable,
           "grads": k * 4 * trainable, "opt": k * 2 * 4 * trainable,
           "activations": k * t["activations"],
           "transient": k * t["transient"]}
    out["total"] = sum(out.values())
    out["base"] = t["frozen"] + t["slots"]  # already inside params
    return out


class LlamaLoRA:
    """Causal-LM template: LoRA fine-tuning (``train``, ``evaluate``,
    ``dump_parameters``) and serving (``load_parameters``, ``predict``,
    ``make_decode_engine``). Knobs are the JAX template's (``hidden_dim``,
    ``depth``, ``n_heads``, ``kv_ratio``, ``lora_rank``, ``lora_scale``,
    ``learning_rate``, ``batch_size``, ``max_epochs``, ``max_len``,
    ``vocab_size``, ``bf16``, ``adapters_only``, ``rope_theta``,
    ``rope_scaling``, ``quantize_int8``, ``kv_cache_int8``,
    ``tokenizer_path``, ``pretrained_path``, the checkpointing schedules
    ``remat`` and ``remat_policy``, ``grad_accum``, ``loss_chunk``,
    ``moe_experts``, ``moe_top_k``, ``model_parallel`` and
    ``sequence_parallel``: the mesh loop, ...); ``pipeline_stages`` is a
    later slice and raises when it trains. ``device=None`` is the CUDA
    card.

    Parameters live as the JAX template keeps them: ``_params``, nested
    dicts of f32 numpy arrays in the JAX layout (what ``dump_parameters``
    returns), and ``_model``, the compute-dtype ``Llama`` built from them
    for evaluation and serving. With ``quantize_int8`` serving takes
    ``_qmodel`` instead, the int8 model of :func:`quantize_llama_params`,
    built once per loaded tree (JAX's cached ``_qparams``), and ``_model``
    is built only when ``evaluate`` asks for it, so an int8 deployment
    holds no compute-dtype copy of its weights on the card."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        """The JAX template's search space, knob for knob (its JSON is
        JAX's). ``pipeline_stages``, a later slice's, keeps its domain: a
        proposal that sets it raises when it trains."""
        return {
            "max_epochs": FixedKnob(6),
            "vocab_size": FixedKnob(1 << 14),
            "hidden_dim": CategoricalKnob([64, 128, 256, 512],
                                          shape_relevant=True),
            "depth": IntegerKnob(2, 8, shape_relevant=True),
            "n_heads": CategoricalKnob([4, 8], shape_relevant=True),
            "kv_ratio": CategoricalKnob([1, 2, 4], shape_relevant=True),
            "lora_rank": CategoricalKnob([4, 8, 16], shape_relevant=True),
            "max_len": CategoricalKnob([32, 64, 128], shape_relevant=True),
            "model_parallel": CategoricalKnob([1, 2, 4],
                                              shape_relevant=True),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True,
                                       traceable=True),
            # the LoRA rank-scale, folded into lora_b at export
            "lora_scale": FloatKnob(0.25, 4.0, is_exp=True,
                                    traceable=True),
            "batch_size": CategoricalKnob([8, 16, 32], shape_relevant=True),
            "bf16": CategoricalKnob([True, False]),
            "remat": FixedKnob(False),
            "remat_policy": CategoricalKnob(["none", "full", "policy"]),
            "overlap_collectives": CategoricalKnob([False, True]),
            "adapters_only": PolicyKnob("ADAPTERS_ONLY"),
            "sequence_parallel": FixedKnob(1),
            "pipeline_stages": FixedKnob(1),
            "pipeline_microbatches": FixedKnob(0),
            "loss_chunk": FixedKnob(0),
            "moe_experts": FixedKnob(0),
            "moe_top_k": FixedKnob(1),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "share_params": PolicyKnob("SHARE_PARAMS"),
            "quantize_int8": FixedKnob(False),
            "grad_accum": FixedKnob(1),
            "kv_cache_int8": FixedKnob(False),
            "rope_theta": FixedKnob(10000.0),
            "rope_scaling": FixedKnob(""),
            "tokenizer_path": FixedKnob(""),
            "pretrained_path": FixedKnob(""),
        }

    @classmethod
    def validate_knobs(cls, knobs: Dict[str, Any]) -> None:
        validate_template_knobs(cls, knobs)

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.device = resolve_device(device)
        self.knobs: Dict[str, Any] = dict(knobs)
        tok_path = str(self.knobs.get("tokenizer_path") or "")
        if tok_path:
            # the vocabulary follows the artifact: the embedding must
            # match the merge table, not the vocab_size knob
            self.tokenizer: Any = ByteBPETokenizer.load(tok_path)
        else:
            self.tokenizer = HashTokenizer(int(self.knobs.get("vocab_size",
                                                              1 << 14)))
        self._params: Optional[Dict[str, Any]] = None
        self._model: Optional[Llama] = None
        self._qmodel: Optional[Llama] = None  # the int8 serving model
        self._id2tok: Dict[int, str] = {}

    def _dtype(self) -> torch.dtype:
        # single source of truth for the bf16 knob → compute dtype
        return torch.bfloat16 if self.knobs.get("bf16", True) \
            else torch.float32

    def _module(self, quantized: bool = False,
                n_adapters: int = 0) -> Llama:
        """A freshly initialized model for these knobs (mlp = 4·hidden,
        as in the JAX template), contiguous cache layout; int8 base
        kernels with ``quantized``, ``n_adapters`` stacked adapters at
        every LoRA site, an int8 cache with the ``kv_cache_int8``
        knob, the knobs' checkpointing schedule and MoE FFN."""
        k = self.knobs
        hd = int(k["hidden_dim"])
        heads = int(k["n_heads"])
        return Llama(vocab_size=self.tokenizer.vocab_size,
                     max_len=int(k["max_len"]), hidden_dim=hd,
                     depth=int(k["depth"]), n_heads=heads,
                     n_kv_heads=max(1, heads // int(k["kv_ratio"])),
                     mlp_dim=4 * hd, lora_rank=int(k["lora_rank"]),
                     dtype=self._dtype(),
                     rope_theta=float(k.get("rope_theta", 10000.0)
                                      or 10000.0),
                     rope_scaling=_parse_rope_scaling(
                         k.get("rope_scaling", "")),
                     quantized=quantized, n_adapters=n_adapters,
                     kv_int8=bool(k.get("kv_cache_int8", False)),
                     device=self.device,
                     remat=bool(k.get("remat", False)),
                     remat_policy=str(k.get("remat_policy", "") or ""),
                     n_experts=int(k.get("moe_experts", 0) or 0),
                     moe_top_k=int(k.get("moe_top_k", 1) or 1))

    def _serving_module_params(self, kv_page_size: int = 0,
                               kv_pages: int = 0) -> Llama:
        """The loaded model over the requested cache layout (the JAX
        method returns (module, params); here the module holds them):
        the int8 model when the ``quantize_int8`` knob is set, quantized
        once per loaded tree and then cached."""
        if not self.knobs.get("quantize_int8"):
            return self._float_model().with_kv_layout(kv_page_size,
                                                      kv_pages)
        if self._qmodel is None:
            self._require_params()
            model = self._module(quantized=True)
            model.load_state_dict(llama_params_from_jax(
                quantize_llama_params(self._params, model.device),
                model.dtype))
            self._qmodel = model
        return self._qmodel.with_kv_layout(kv_page_size, kv_pages)

    def _require_params(self) -> None:
        if self._params is None:
            raise RuntimeError("model is not loaded (load_parameters)")

    def _float_model(self) -> Llama:
        """The compute-dtype model of the f32 tree (evaluate's, and
        serving's without ``quantize_int8``), built at first use."""
        if self._model is None:
            self._require_params()
            model = self._module()
            model.load_state_dict(llama_params_from_jax(self._params,
                                                        model.dtype))
            self._model = model
        return self._model

    def load_parameters(self, params: Dict[str, Any]) -> None:
        """Load a ``dump_parameters()`` dict — the port's or the JAX
        template's: the format is one. A ``meta["bpe_merges"]`` table
        rebuilds the byte-BPE tokenizer it was trained with."""
        meta = params["meta"]
        self._id2tok = {int(k): v for k, v in meta["id2tok"].items()}
        merges = meta.get("bpe_merges")
        if merges is not None:
            self.tokenizer = ByteBPETokenizer(
                [tuple(int(x) for x in m) for m in merges])
        self._set_params(params["params"])

    def _set_params(self, tree: Dict[str, Any], own: bool = False) -> None:
        """Keep ``tree`` (f32 copies, but read-only f32 leaves — views
        into a param-store blob — as they are, and every leaf as it is
        when ``own``: a tree :meth:`train` just built) and drop the
        models of the previous tree; build the compute-dtype model from
        it (matmul leaves cast once) unless ``quantize_int8`` serves the
        int8 one instead."""
        self._params = tree if own else f32_tree(tree, copy=False)
        self._model = self._qmodel = None
        if not self.knobs.get("quantize_int8"):
            self._float_model()

    def dump_parameters(self) -> Dict[str, Any]:
        """``{"params": f32 numpy tree, "meta": {"id2tok": ...}}`` — the
        JAX template's format, loadable by either template."""
        if self._params is None:
            raise RuntimeError("model is not trained/loaded")
        meta: Dict[str, Any] = {"id2tok": {str(k): v
                                           for k, v in self._id2tok.items()}}
        if self._bpe:
            # the merge table travels with the weights: a serving host
            # rebuilds the tokenizer without the artifact file
            meta["bpe_merges"] = [list(m) for m in self.tokenizer.merges]
        return {"params": f32_tree(self._params), "meta": meta}

    @property
    def _bpe(self) -> bool:
        """True when a real (invertible) tokenizer is active."""
        return hasattr(self.tokenizer, "decode")

    # ---- training ----
    def _encode_lm(self, texts: Sequence[str]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """BOS-prefixed token rows. With the hash tokenizer this also
        grows the id→token table used to detokenize generations (hashing
        is one-way); BPE decodes exactly and needs no table."""
        max_len = int(self.knobs["max_len"])
        ids = np.zeros((len(texts), max_len), np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            row, n = self.tokenizer.encode(t, max_len)  # CLS slot = BOS
            ids[i], lens[i] = row, n
            if not self._bpe:
                # mirror the tokenizer's own splitting so ids align
                # with words
                for tok_str, tok_id in zip(_TOKEN_RE.findall(t.lower()),
                                           row[1:n]):
                    self._id2tok[int(tok_id)] = tok_str
        return ids, lens

    # ---- the gang lanes (JAX: vmapped LoRA lanes) ----
    @classmethod
    def gang_blockers(cls, knobs: Dict[str, Any]) -> List[str]:
        """Why THIS assignment cannot train as a gang lane (empty:
        gangable), each entry naming its knob: JAX's entries, word for
        word (a lane is one unsharded step over a shared base). The
        checkpointing schedules are no blocker: each is a bucket of its
        own."""
        def _i(name: str, default: int = 0) -> int:
            return int(knobs.get(name, default) or default)

        out: List[str] = []
        if _i("model_parallel", 1) > 1:
            out.append("model_parallel>1 (tensor parallelism needs the "
                       "sharded mesh path)")
        if _i("sequence_parallel", 1) > 1:
            out.append("sequence_parallel>1 (sp shards activations over "
                       "a mesh the lane step does not build)")
        if _i("pipeline_stages", 1) > 1:
            out.append("pipeline_stages>1 (GPipe owns the device set)")
        if _i("grad_accum", 1) > 1:
            out.append("grad_accum>1 (the accumulation scan is not "
                       "factored into the lane step)")
        if _i("moe_experts") > 0:
            out.append("moe_experts>0 (expert parallelism + aux-loss "
                       "sow need the mesh path)")
        if _i("loss_chunk") > 0:
            out.append("loss_chunk>0 (the streamed loss is not factored "
                       "into the lane step)")
        if str(knobs.get("pretrained_path") or ""):
            out.append("pretrained_path set (lanes broadcast the shared "
                       "PRNGKey(0) base; checkpoint import is a mesh-"
                       "path feature)")
        return out

    @classmethod
    def gang_epochs(cls, knobs: Dict[str, Any], budget_scale: float) -> int:
        """Epochs :meth:`train` spends (:func:`epoch_count`)."""
        return epoch_count(knobs, budget_scale)

    @classmethod
    def make_gang_spec(cls, knobs: Dict[str, Any], train_dataset_path: str,
                       val_dataset_path: str,
                       device: DeviceLike = None) -> GangSpec:
        """The gang engine's recipe for this static bucket: K LoRA lanes
        (trainable leaves and their Adam state) over ONE frozen base on
        ``device`` (None: the CUDA card). Everything but
        ``learning_rate`` / ``lora_scale`` (the traceable knobs) is
        burned in from ``knobs``."""
        blockers = cls.gang_blockers(knobs)
        if blockers:
            raise ValueError("knobs block gang lanes: "
                             + "; ".join(blockers))
        model = cls(device=device, **knobs)  # tokenizer wiring
        model._check_trainable_knobs()
        dev = model.device
        ids, lens = model._encode_lm(
            load_text_classification_dataset(train_dataset_path).texts)
        vids, vlens = model._encode_lm(
            load_text_classification_dataset(val_dataset_path).texts)
        base = model._module()
        for p in base.parameters():
            p.requires_grad_(False)
        names = lora_trainable_names(
            base, bool(knobs.get("adapters_only", False)))
        state = base.state_dict()
        batch_size = int(knobs["batch_size"])
        meta: Dict[str, Any] = {
            "id2tok": {str(k): v for k, v in model._id2tok.items()}}
        if model._bpe:
            meta["bpe_merges"] = [list(m) for m in model.tokenizer.merges]
        folded_base: List[Dict[str, Any]] = []  # the f32 tree, at export

        def init_lane(gen, hp):
            params = {n: state[n].to(torch.float32, copy=True)
                      for n in names}
            return {"params": params, "opt": lane_adam_init(params)}

        def train_step(lane_state, hp, batch):
            return lane_train_step(base, lane_state, hp,
                                   batch_to_device(batch, dev))

        def train_lanes(stacked, hp, batch):
            return lanes_train_step(base, stacked, hp,
                                    batch_to_device(batch, dev))

        def epoch_batches(epoch: int):
            return batch_iterator({"ids": ids, "lens": lens}, batch_size,
                                  seed=epoch)

        def eval_batches():
            # the bucket-32 zero-padded stream evaluate() walks
            bucket = 32
            for i in range(0, len(vids), bucket):
                ib, lb = vids[i:i + bucket], vlens[i:i + bucket]
                pad = bucket - len(ib)
                if pad:
                    ib = np.concatenate(
                        [ib, np.zeros((pad, vids.shape[1]), ib.dtype)])
                    lb = np.concatenate([lb, np.zeros((pad,), lb.dtype)])
                yield {"ids": ib, "lens": lb}

        def eval_lane(lane_state, hp, batch):
            # evaluate()'s model: the rank-scale folded into lora_b, each
            # matmul leaf in the compute dtype, the norms f32
            leaves = {n: t.to(base.dtype) if n.rsplit(".", 1)[-1]
                      in MATMUL_LEAVES else t
                      for n, t in merge(lane_state["params"],
                                        hp["lora_scale"]).items()}
            b = batch_to_device(batch, dev)
            with torch.no_grad():
                logits = torch.func.functional_call(
                    base, leaves, (b["ids"],),
                    {"decode": False, "lens": b["lens"]})
                return lm_loss_terms(logits, b["ids"], b["lens"])

        def export_blob(lane_state, hp):
            # the rank-scale folded into lora_b, as train() stores it
            if not folded_base:
                folded_base.append(params_to_jax(state))
            scale = torch.tensor(float(hp["lora_scale"]),
                                 dtype=torch.float32, device=dev)
            return {"params": _replace_leaves(folded_base[0], merge(
                        dict(lane_state["params"]), scale)),
                    "meta": dict(meta)}

        def warm_lane(fresh, blob):
            shared = (blob or {}).get("params")
            if shared is None or not same_tree_shapes(_nest(state), shared):
                return fresh  # incompatible architecture → cold start
            # the parent's trainable leaves; the frozen base is this
            # spec's (pretrained bases are blockers: both are the seed-0
            # init)
            flat = params_from_jax(shared)
            return {"params": {n: flat[n].to(dev, torch.float32, copy=True)
                               for n in names},
                    "opt": fresh["opt"]}

        return GangSpec(
            hp_names=("learning_rate", "lora_scale"), init_lane=init_lane,
            train_step=train_step, train_lanes=train_lanes,
            epoch_batches=epoch_batches, eval_lane=eval_lane,
            eval_batches=eval_batches, export_blob=export_blob,
            warm_lane=warm_lane, share_params_knob="share_params",
            score_kind="lm", tokens_per_sample=int(knobs["max_len"]),
            lane_param_count=sum(t.numel() for t in state.values()))

    def _check_trainable_knobs(self) -> None:
        """``pipeline_stages`` needs the pipeline of a later slice; it
        raises, by name. ``model_parallel`` and ``sequence_parallel``
        train on a mesh (``_train_mesh``)."""
        k = self.knobs
        blockers = [name for name in ("pipeline_stages",)
                    if int(k.get(name, 1) or 1) > 1]
        if blockers:
            raise NotImplementedError(
                f"knob(s) {blockers} need the sharded train path, which "
                "is not ported yet")

    def _check_sp_knobs(self, n_devices: int) -> None:
        """JAX's refusals of a ``sequence_parallel > 1`` trial, word for
        word and in its order (``LlamaLoRA.train``)."""
        k = self.knobs
        sp = int(k.get("sequence_parallel", 1) or 1)
        if sp <= 1:
            return
        sp_tp = int(k.get("model_parallel", 1) or 1)
        if int(k.get("pipeline_stages", 1) or 1) > 1:
            raise ValueError(
                "sequence_parallel>1 is mutually exclusive with "
                "pipeline_stages>1 (pick sp[×tp]×dp or pp×dp)")
        if int(k.get("moe_experts", 0)) and sp_tp == 1:
            raise ValueError(
                "moe_experts with sequence_parallel requires "
                "model_parallel>1: experts shard over the `model` "
                "axis, which the dp x sp mesh lacks (the 3-axis "
                "dp x sp x model mesh carries both)")
        if int(k.get("loss_chunk", 0) or 0) and sp_tp > 1:
            raise ValueError(
                "loss_chunk with sequence_parallel requires "
                "model_parallel=1 (the sharded chunked loss keeps "
                "the head replicated; a vocab-sharded head inside "
                "the shard would need cross-axis softmax)")
        if n_devices % (sp * sp_tp):
            raise ValueError(
                f"sequence_parallel={sp} x model_parallel={sp_tp} "
                f"must divide the trial's {n_devices} devices")
        if int(k["max_len"]) % sp:
            raise ValueError(f"max_len {k['max_len']} must "
                             f"divide by sequence_parallel={sp}")
        heads = int(k["n_heads"])
        kv_heads = max(1, heads // int(k["kv_ratio"]))
        if sp_tp > 1 and (heads % sp_tp or kv_heads % sp_tp):
            raise ValueError(
                f"sequence_parallel with model_parallel={sp_tp} "
                f"needs n_heads ({heads}) and kv heads ({kv_heads}) "
                "divisible by it (TP shards whole heads)")

    def _mesh(self, devices: Sequence[Any]) -> Mesh:
        """JAX's rule: ``model_parallel`` halved until it divides the
        device count; the rest of the devices are ``data``. With
        ``sequence_parallel > 1`` the (data, sp) mesh, or (data, sp,
        model) with ``model_parallel > 1`` (not halved), in row-major
        order."""
        sp = int(self.knobs.get("sequence_parallel", 1) or 1)
        if sp > 1:
            return make_sp_mesh(devices, sp, int(
                self.knobs.get("model_parallel", 1) or 1))
        n = len(devices)
        mp = int(self.knobs.get("model_parallel", 1))
        while n % mp:
            mp //= 2
        return make_mesh(devices, model=max(1, mp))

    def _train_devices(self, ctx: TrainContext) -> List[torch.device]:
        """``ctx.devices``, or every visible card (JAX's
        ``jax.local_devices()``), or one CPU device on a CPU template."""
        if ctx.devices:
            return [torch.device(d) for d in ctx.devices]
        if self.device.type == "cuda":
            return [torch.device("cuda", k)
                    for k in range(torch.cuda.device_count())]
        return [self.device]

    def _dims(self) -> LlamaDims:
        k = self.knobs
        hd, heads = int(k["hidden_dim"]), int(k["n_heads"])
        return LlamaDims(
            self.tokenizer.vocab_size, hd, int(k["depth"]), heads,
            max(1, heads // int(k["kv_ratio"])), 4 * hd,
            int(k["lora_rank"]), torch.finfo(self._dtype()).bits // 8,
            int(k.get("moe_experts", 0) or 0),
            int(k.get("moe_top_k", 1) or 1))

    def _train_batch_size(self) -> int:
        """The batch :meth:`train` steps with: the knob's, rounded down to
        a multiple of ``grad_accum`` (JAX's rounding on a data axis of
        one)."""
        batch_size = int(self.knobs["batch_size"])
        q = int(self.knobs.get("grad_accum", 1) or 1)
        return max(q, batch_size - batch_size % q) if q > 1 else batch_size

    def _budget_terms(self) -> Dict[str, int]:
        """:func:`_train_terms` of these knobs."""
        k = self.knobs
        return _train_terms(
            self._dims(), self._train_batch_size(), int(k["max_len"]),
            bool(k.get("adapters_only", False)),
            remat_schedule(bool(k.get("remat", False)),
                           str(k.get("remat_policy", "") or "")),
            int(k.get("grad_accum", 1) or 1),
            int(k.get("loss_chunk", 0) or 0))

    def estimate_device_budget(self, n_devices: int = 1,
                               gang_size: int = 0) -> Dict[str, int]:
        """Device memory of one train step of these knobs at its peak,
        per device. With ``model_parallel > 1`` the mesh :meth:`train`
        builds over ``n_devices`` (JAX's factors: ``model_parallel``
        halved until it divides, the rest ``data``;
        :func:`estimate_mesh_train_device_bytes`); with
        ``sequence_parallel > 1`` its (data, sp[, model]) mesh (JAX's:
        ``sequence_parallel`` and ``model_parallel`` as the knobs say,
        ``data`` the rest of ``n_devices``); otherwise the one-card
        step (:func:`estimate_train_device_bytes`), which trains on one
        device whatever ``n_devices`` is. ``gang_size >= 1`` budgets a
        K-lane gang step instead (:func:`estimate_gang_device_bytes`).
        Knobs :meth:`train` refuses raise the same error here."""
        if gang_size >= 1:
            return estimate_gang_device_bytes(self, gang_size)
        self._check_trainable_knobs()
        sp = int(self.knobs.get("sequence_parallel", 1) or 1)
        if sp > 1:
            mp = int(self.knobs.get("model_parallel", 1) or 1)
            return estimate_mesh_train_device_bytes(
                self, max(1, int(n_devices) // (sp * mp)), mp, sp)
        if int(self.knobs.get("model_parallel", 1) or 1) > 1:
            shape = self._mesh(["cpu"] * max(1, int(n_devices))).shape
            return estimate_mesh_train_device_bytes(self, shape["data"],
                                                    shape["model"])
        return _step_bytes(self._budget_terms(),
                           int(self.knobs.get("grad_accum", 1) or 1) > 1)

    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        """LoRA fine-tune on a ``.jsonl`` text corpus with the gang lanes'
        step (:func:`lane_train_step`) on one lane. The JAX template runs
        its functional loop (``_train_functional``) when ``gang_blockers``
        is empty, else (``grad_accum``, ``moe_experts``, ``loss_chunk``,
        ``pretrained_path``) its sharded loop, which on one device is
        this step with the streamed loss, the MoE aux term
        (``MOE_AUX_COEF · aux``) and gradient accumulation over
        ``grad_accum`` micro-batches, and the batch rounded down to a
        multiple of ``grad_accum``; with none of those knobs the two are
        the same step, so one loop serves both. With ``model_parallel >
        1`` or ``sequence_parallel > 1`` it runs JAX's mesh loop
        (:meth:`_train_mesh`) over ``ctx.devices``, after JAX's refusals
        of a sequence-parallel trial (:meth:`_check_sp_knobs`). The knobs'
        checkpointing schedule runs in every block. One difference, on
        purpose (ROADMAP Queue C 23): JAX's sharded loop never reads
        ``lora_scale`` (it trains at scale 1 and stores ``lora_b``
        unscaled); here every loop applies it and folds it into the
        stored ``lora_b``.

        The init is :meth:`_initial_base`'s: the loaded weights when
        their shapes match, else ``ctx.shared_params`` under the
        ``share_params`` knob, else the port's seeded init; with
        ``pretrained_path`` on a fresh, non-warm start every base leaf
        comes from that HF-convention checkpoint, read tensor by tensor
        (the LoRA adapters and the MoE routers and experts, which no such
        checkpoint carries, keep their init; a ``config.json`` whose
        ``rope_theta`` or ``rope_scaling`` disagrees with the knobs is
        warned about, as in JAX). Batches
        come from ``batch_iterator(seed=epoch)``; ``loss`` and ``tokens``
        are logged per epoch. At the end ``_params`` holds the trained
        tree with ``lora_scale`` folded into ``lora_b``."""
        ctx = ctx or TrainContext()
        self._check_sp_knobs(len(self._train_devices(ctx)))
        self._check_trainable_knobs()
        ds = load_text_classification_dataset(dataset_path)
        ids, lens = self._encode_lm(ds.texts)
        if int(self.knobs.get("model_parallel", 1) or 1) > 1 or \
                int(self.knobs.get("sequence_parallel", 1) or 1) > 1:
            return self._train_mesh(ids, lens, ctx)
        model = self._module()
        names = lora_trainable_names(
            model, bool(self.knobs.get("adapters_only", False)))
        base = self._initial_base(model, ctx)
        trainable = make_trainable(model, names)
        model.load_state_dict(llama_params_from_jax(base, model.dtype,
                                                    trainable))
        # the lane functions of the gang engine, on one lane: the state's
        # leaves are the model's own f32 trainable parameters
        state_, hp = lane_init(trainable,
                               float(self.knobs["learning_rate"]),
                               float(self.knobs.get("lora_scale", 1.0)))
        params = state_["params"]
        batch_size = self._train_batch_size()
        loss_chunk = int(self.knobs.get("loss_chunk", 0) or 0)
        grad_accum = int(self.knobs.get("grad_accum", 1) or 1)
        epochs = self.gang_epochs(self.knobs, ctx.budget_scale)

        def folded() -> Dict[str, Any]:
            return _replace_leaves(base, merge(params, hp["lora_scale"]))

        def step(state, batch):
            return lane_train_step(model, state, hp,
                                   batch_to_device(batch, self.device),
                                   loss_chunk, grad_accum)

        def checkpoint(state, frac_done):
            self._params = folded()
            ctx.checkpoint(self.dump_parameters, frac_done=frac_done,
                           tree={"params": self._params})

        run_epochs(step, state_, lambda epoch: batch_iterator(
                       {"ids": ids, "lens": lens}, batch_size, seed=epoch),
                   epochs, ctx, checkpoint, plot="LM loss",
                   log_extra={"tokens": int(ids.shape[0] * ids.shape[1])})
        del state_, model
        self._set_params(folded(), own=True)

    def _initial_base(self, model: Llama, ctx: TrainContext,
                      on_device: Sequence[str] = ()) -> Dict[str, Any]:
        """The f32 tree a fine-tune starts from: the loaded weights when
        their shapes match ``model``'s, else ``ctx.shared_params`` under
        the ``share_params`` knob (a blob, or a sharded checkpoint handle,
        restored to host arrays once its manifest matches, in the
        one-card loop too, where JAX's functional loop starts cold:
        ROADMAP Queue C 25; a restore that fails starts cold, as in JAX),
        else ``model``'s own init; with
        ``pretrained_path`` on a fresh, non-warm start every base leaf
        comes from that checkpoint, read tensor by tensor. Leaves named in
        ``on_device`` that come from a CUDA module's init stay its tensors
        (the caller moves them on the card and replaces them in the tree
        it builds at the end)."""
        state = model.state_dict()
        shapes = _nest(state)  # the module's own tensors: no host copy
        base = None
        warm = False
        if self._params is not None and \
                same_tree_shapes(shapes, self._params):
            base = self._params  # re-train / load_parameters
        shared_obj = ctx.shared_params if self.knobs.get("share_params") \
            else None
        shared = None
        if hasattr(shared_obj, "restore"):
            if shared_obj.matches({"params": shapes}):
                try:
                    shared = shared_obj.restore({"params": shapes})[
                        "params"]
                except (KeyError, ValueError):
                    logging.getLogger(__name__).warning(
                        "sharded warm-start checkpoint does not match "
                        "this parameterization; training cold",
                        exc_info=True)
        elif shared_obj is not None:
            shared = shared_obj.get("params")
        if shared is not None and same_tree_shapes(shapes, shared):
            base, warm = shared, True
        pretrained = str(self.knobs.get("pretrained_path") or "")
        if pretrained and self._params is None and not warm:
            self._check_pretrained_rope(pretrained, model)
            # adapters from the init (copied off the module), the rest
            # straight from the file into a tree of fresh f32 arrays
            return import_llama_safetensors(pretrained, _nest({
                key: (np.array(t.detach().to("cpu", torch.float32))
                      if hf_name_for(tuple(key.split("."))) is None
                      else t) for key, t in state.items()}))
        if base is None and model.device.type != "cpu":
            # the card's leaves come to the host as fresh f32 arrays (a
            # CPU module's may share its parameters' memory: copied)
            keep = set(on_device)
            tree = params_to_jax({k: t for k, t in state.items()
                                  if k not in keep})
            for key in keep:
                *path, leaf = key.split(".")
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = state[key]
            return tree
        return f32_tree(params_to_jax(state) if base is None else base)

    def _train_mesh(self, ids: np.ndarray, lens: np.ndarray,
                    ctx: TrainContext) -> None:
        """JAX's mesh loop (``model_parallel > 1`` or ``sequence_parallel
        > 1``): the mesh of :meth:`_mesh` over :meth:`_train_devices`,
        every leaf sharded by ``TP_RULES`` (none on a (data, sp) mesh)
        and fsdp, the batch over ``data`` and its sequence over ``sp``,
        the step of ``models/llama_mesh.py``. The start is the one-card
        loop's (:meth:`_initial_base`, the seeded init drawn on the
        template's device, then held as the f32 host tree the blob is
        built from), so a (1, 1) mesh starts where one card does; with
        ``pretrained_path`` the checkpoint is read tensor by tensor into
        that tree and each leaf then sliced onto its shards (JAX's import
        reads each shard's slice from the file). The batch rounds down to
        a multiple of ``data`` (times ``grad_accum``). A checkpoint hands ``ctx.checkpoint`` the live
        tree (:func:`checkpoint_tree`, JAX's manifest) beside the blob
        factory. ``overlap_collectives`` changes nothing (JAX's compiler
        options are TPU-only)."""
        mesh = self._mesh(self._train_devices(ctx))
        dp = mesh.shape["data"]
        model = self._module()
        names = lora_trainable_names(
            model, bool(self.knobs.get("adapters_only", False)))
        base = self._initial_base(model, ctx, on_device=names)
        k = self.knobs
        mm = MeshLlama(
            mesh, {}, hidden=model.hidden_dim, depth=model.depth,
            n_heads=model.n_heads, n_kv_heads=model.n_kv_heads,
            lora_rank=model.lora_rank, dtype=model.dtype,
            rope_theta=model.rope_theta, rope_scaling=model.rope_scaling,
            n_experts=model.n_experts, moe_top_k=model.moe_top_k,
            remat_policy=model.remat_policy)
        del model
        rules = None if mm.sp > 1 and mm.mp == 1 else TP_RULES
        mm.leaves = shard_tree(base, mesh, rules, names, mm.dtype)
        for key in names:  # the shards hold them now: keep shapes only
            *path, leaf = key.split(".")
            node = base
            for part in path:
                node = node[part]
            node[leaf] = np.broadcast_to(np.float32(0), node[leaf].shape)
        state = mesh_lane_init(mm, names, float(k["learning_rate"]))
        scale = float(k.get("lora_scale", 1.0))
        grad_accum = int(k.get("grad_accum", 1) or 1)
        batch_size = int(k["batch_size"])
        q = grad_accum * dp
        batch_size = max(q, batch_size - batch_size % q)
        step = make_step_fn(mm, state, names, scale,
                            int(k.get("loss_chunk", 0) or 0), grad_accum)

        def folded() -> Dict[str, Any]:
            # the gathered leaves are fresh host tensors: not copied again
            return _replace_leaves(base, merge(gather_trainable(mm, names),
                                               scale), copy=False)

        def make_blob() -> Dict[str, Any]:
            self._params = folded()
            return self.dump_parameters()

        def checkpoint(state, frac_done):
            ctx.checkpoint(make_blob, frac_done=frac_done,
                           tree={"params": checkpoint_tree(mm, base, names,
                                                           scale)})

        run_epochs(step, state, lambda epoch: batch_iterator(
                       {"ids": ids, "lens": lens}, batch_size, seed=epoch),
                   self.gang_epochs(k, ctx.budget_scale), ctx, checkpoint,
                   plot="LM loss",
                   log_extra={"tokens": int(ids.shape[0] * ids.shape[1])})
        trained = folded()
        del step, state, mm
        # the serving model is built when evaluate or predict first asks
        # for it (the mesh's shards are gone by then)
        self._params = trained
        self._model = self._qmodel = None

    def _check_pretrained_rope(self, pretrained: str, model: Llama) -> None:
        """Warn when the checkpoint's ``config.json`` disagrees with the
        rope the model applies: a mismatched ``rope_theta``, or
        ``rope_scaling`` declared but not applied, applied but not
        declared, different, or of a type this model cannot apply. Each
        loads cleanly and generates garbage."""
        import logging

        log = logging.getLogger(__name__)
        cfg_theta, cfg_scaling = read_hf_rope_config(pretrained)
        if cfg_theta is not None and \
                abs(cfg_theta - model.rope_theta) > 1e-6:
            log.warning(
                "checkpoint config.json says rope_theta=%s but the "
                "rope_theta knob is %s — a mismatched theta loads "
                "cleanly and generates GARBAGE; set the knob to match "
                "the checkpoint", cfg_theta, model.rope_theta)
        have = model.rope_scaling
        if cfg_scaling or have is not None:
            want = None
            unsupported = False
            if cfg_scaling:
                try:
                    want = _parse_rope_scaling(cfg_scaling)
                except (ValueError, TypeError):
                    unsupported = True
            if unsupported or (have is None) != (want is None) or (
                    have is not None and want is not None and any(
                        abs(a - b) > 1e-6 for a, b in zip(have, want))):
                log.warning(
                    "checkpoint config.json rope_scaling=%r but the "
                    "rope_scaling knob resolves to %r — set the knob to "
                    "the checkpoint's values (or clear it) or "
                    "long-context generations silently degrade",
                    cfg_scaling, have)

    def evaluate(self, dataset_path: str) -> float:
        """Inverse perplexity exp(−nll) in (0, 1]; higher is better.
        Buckets of 32 rows; pad rows have ``lens = 0``, so no loss
        position of theirs counts. The f32 tree's model, int8 knobs or
        not (JAX's evaluate takes ``_params``); with ``loss_chunk`` the
        loss is streamed, as the step streams it."""
        model = self._float_model()
        loss_chunk = int(self.knobs.get("loss_chunk", 0) or 0)
        ds = load_text_classification_dataset(dataset_path)
        ids, lens = self._encode_lm(ds.texts)
        total, count = 0.0, 0.0
        bucket = 32
        with torch.no_grad():
            for i in range(0, len(ids), bucket):
                ib, lb = ids[i:i + bucket], lens[i:i + bucket]
                pad = bucket - len(ib)
                if pad:
                    ib = np.concatenate([ib, np.zeros((pad, ids.shape[1]),
                                                      ib.dtype)])
                    lb = np.concatenate([lb, np.zeros((pad,), lb.dtype)])
                batch = batch_to_device({"ids": ib, "lens": lb},
                                        self.device)
                out = model(batch["ids"], decode=False, lens=batch["lens"],
                            return_hidden=bool(loss_chunk))
                if loss_chunk:
                    s, c = chunked_lm_loss_terms(
                        out, model.lm_head.kernel, batch["ids"],
                        batch["lens"], chunk=loss_chunk)
                else:
                    s, c = lm_loss_terms(out, batch["ids"], batch["lens"])
                total += float(s)
                count += float(c)
        return float(np.exp(-total / max(count, 1.0)))

    def predict(self, queries: Sequence[Any],
                max_new_tokens: int = 8) -> List[str]:
        """Greedy continuations, detokenized via the learned id→token
        table (unknown ids render as ``<id>``), through the serving model
        (int8 under the int8 knobs). The JAX template pads the batch to a
        power of two with BOS-only rows for its compile cache; eager
        PyTorch has none to hit, so a dense model runs the batch as
        given, but a MoE model pads as JAX does: its routing (which
        tokens an expert's capacity drops) depends on every row of a
        call."""
        model = self._serving_module_params()
        texts = [q if isinstance(q, str) else str(q) for q in queries]
        max_len = int(self.knobs["max_len"])
        # the KV cache holds max_len positions (prompt + generation)
        max_new = min(max_new_tokens, max_len - 1)
        ids, lens = self.tokenizer.encode_batch(texts,
                                                max(1, max_len - max_new))
        n = len(texts)
        bucket = 1 << max(0, (n - 1).bit_length())
        if model.n_experts and bucket > n:
            ids = np.concatenate(
                [ids, np.zeros((bucket - n, ids.shape[1]), ids.dtype)])
            ids[n:, 0] = BOS_ID
            lens = np.concatenate([lens, np.ones((bucket - n,), lens.dtype)])
        out = greedy_generate(model, ids, lens, max_new).cpu().numpy()[:n]
        return [self._detok(row) for row in out]

    def warmup(self) -> None:
        """Run the serving generate once before traffic arrives (JAX
        compiles it here; the port builds the serving model and, on the
        card, its kernels)."""
        if self._params is None:
            return
        self.predict(["warmup"])

    def _param_bytes(self) -> int:
        """Bytes of the weights the port serves from on its device: the
        matmul leaves (``kernel``, ``lora_a``, ``lora_b``) in the compute
        dtype, or under ``quantize_int8`` each 2-d base ``kernel`` as an
        int8 ``qkernel`` plus its f32 ``qscale`` (the adapters still in
        the compute dtype); the embedding, the norm scales and the MoE
        routers and experts f32. From
        the loaded tree's shapes, else from the knobs' (JAX counts its
        f32 tree, which it keeps on the device; the port keeps that tree
        on the host)."""
        act = torch.finfo(self._dtype()).bits // 8
        int8 = bool(self.knobs.get("quantize_int8"))

        def leaf_bytes(name: str, shape: Sequence[int]) -> int:
            n = int(np.prod(shape))
            if name not in MATMUL_LEAVES:
                return 4 * n
            if int8 and name == "kernel" and len(shape) == 2:
                return n + 4 * int(shape[1])
            return act * n

        if self._params is not None:
            def walk(tree: Dict[str, Any]) -> int:
                return sum(walk(sub) if isinstance(sub, dict)
                           else leaf_bytes(name, np.shape(sub))
                           for name, sub in tree.items())

            return walk(self._params)
        k = self.knobs
        hd, heads = int(k["hidden_dim"]), int(k["n_heads"])
        kv = max(1, heads // int(k["kv_ratio"])) * (hd // heads)
        rank, vocab = int(k["lora_rank"]), self.tokenizer.vocab_size
        experts = int(k.get("moe_experts", 0) or 0)
        sites = [(hd, hd), (hd, kv), (hd, kv), (hd, hd)]
        if not experts:
            sites += [(hd, 4 * hd), (hd, 4 * hd), (4 * hd, hd)]
        block = 2 * leaf_bytes("scale", (hd,)) + sum(
            leaf_bytes("kernel", (i, o))
            + (leaf_bytes("lora_a", (i, rank))
               + leaf_bytes("lora_b", (rank, o)) if rank else 0)
            for i, o in sites) + 4 * experts * (hd + 3 * hd * 4 * hd)
        return (int(k["depth"]) * block + leaf_bytes("kernel", (hd, vocab))
                + leaf_bytes("embedding", (vocab, hd))
                + leaf_bytes("scale", (hd,)))

    def _param_shapes(self) -> Dict[str, Any]:
        """The params tree these knobs give, its leaves zero-byte
        broadcast views of the right shapes (the JAX template's
        ``jax.eval_shape`` of the init): what a loaded tree must
        match."""
        k = self.knobs
        hd, heads = int(k["hidden_dim"]), int(k["n_heads"])
        kv = max(1, heads // int(k["kv_ratio"])) * (hd // heads)
        rank, vocab = int(k["lora_rank"]), self.tokenizer.vocab_size

        def leaf(*shape: int) -> np.ndarray:
            return np.broadcast_to(np.float32(0), shape)

        def site(d_in: int, out: int) -> Dict[str, np.ndarray]:
            out_tree = {"kernel": leaf(d_in, out)}
            if rank:
                out_tree.update(lora_a=leaf(d_in, rank),
                                lora_b=leaf(rank, out))
            return out_tree

        block = {"attn": {"wq": site(hd, hd), "wk": site(hd, kv),
                          "wv": site(hd, kv), "wo": site(hd, hd)},
                 "RMSNorm_0": {"scale": leaf(hd)},
                 "RMSNorm_1": {"scale": leaf(hd)}}
        e = int(k.get("moe_experts", 0) or 0)
        if e:
            block["moe"] = {"router": leaf(hd, e),
                            "experts_gate": leaf(e, hd, 4 * hd),
                            "experts_up": leaf(e, hd, 4 * hd),
                            "experts_down": leaf(e, 4 * hd, hd)}
        else:
            block.update(gate=site(hd, 4 * hd), up=site(hd, 4 * hd),
                         down=site(4 * hd, hd))
        tree: Dict[str, Any] = {f"block_{i}": block
                                for i in range(int(k["depth"]))}
        tree.update(tok_embed={"embedding": leaf(vocab, hd)},
                    final_norm={"scale": leaf(hd)},
                    lm_head={"kernel": leaf(hd, vocab)})
        return tree

    def estimate_serving_device_bytes(self, max_slots: int = 8,
                                      n_extra_adapters: int = 0,
                                      draft: Optional["LlamaLoRA"] = None,
                                      kv_page_size: int = 0,
                                      kv_pages: int = 0,
                                      host_kv_pages: int = 0
                                      ) -> Dict[str, int]:
        """Per-device memory budget of a continuous-batching deployment,
        term by term as the JAX template's (admission control compares
        ``total`` with the card's memory before any engine is built):

        - ``params``: the bytes of the weights the port holds on its
          device (:meth:`_param_bytes`), where JAX counts its f32 tree;
        - ``kv_cache``: max_slots x max_len positions per layer, or the
          paged pool's kv_pages x kv_page_size (kv_pages 0 = full
          coverage), x kv heads x head dim x 2 (K and V) x depth, at the
          compute dtype, or int8 plus one f32 scale per row under
          ``kv_cache_int8``;
        - ``adapters``: extra tenants' f32 LoRA tensors (7 sites a block);
        - ``draft``: a draft model's ``params`` and cache, as above;
        - ``working``: a 32-token prefill chunk and one (slots, vocab)
          f32 logits buffer;
        - ``host_kv_cache`` (``host_kv_pages > 0``): the host page tier's
          bytes, host memory, left out of ``total``.

        Every term but ``params`` reads the compute dtype as the JAX
        estimator reads it (``bf16`` absent counts as f32), so those terms
        equal JAX's."""
        k = self.knobs
        if int(host_kv_pages) and int(kv_page_size) <= 0:
            raise ValueError("host_kv_pages requires kv_page_size > 0 "
                             "(pages are the host tier's transfer unit)")
        hd, heads = int(k["hidden_dim"]), int(k["n_heads"])
        kv_heads = max(1, heads // int(k["kv_ratio"]))
        dh = hd // heads
        L, depth = int(k["max_len"]), int(k["depth"])
        act_bytes = 2 if bool(k.get("bf16", False)) else 4
        per_pos = kv_heads * dh
        if int(kv_page_size) > 0:
            if L % int(kv_page_size):
                raise ValueError(f"kv_page_size {kv_page_size} must "
                                 f"divide max_len {L}")
            if kv_pages and int(kv_pages) < 2:
                raise ValueError("paged KV needs kv_pages >= 2 (scratch "
                                 "page + at least one usable page)")
            n_pages = int(kv_pages) or _default_kv_pages(
                max_slots, L, int(kv_page_size))
            n_pos = n_pages * int(kv_page_size)
        else:
            n_pos = max_slots * L
        int8_kv = bool(k.get("kv_cache_int8", False))

        def kv_bytes(positions: int) -> int:
            if int8_kv:  # int8 rows + one f32 scale per (pos, head)
                return positions * depth * 2 * (per_pos + 4 * kv_heads)
            return positions * depth * 2 * per_pos * act_bytes

        adapters_dev = 0
        if n_extra_adapters:
            rank = int(k.get("lora_rank", 0) or 0)
            sites = [(hd, heads * dh), (hd, kv_heads * dh),
                     (hd, kv_heads * dh), (heads * dh, hd), (hd, 4 * hd),
                     (hd, 4 * hd), (4 * hd, hd)]
            adapters_dev = n_extra_adapters * depth * sum(
                (i * rank + rank * o) * 4 for i, o in sites)
        draft_dev = 0
        if draft is not None:
            d = draft.estimate_serving_device_bytes(max_slots=max_slots)
            draft_dev = d["params"] + d["kv_cache"]
        working = (max_slots * 32 * hd * act_bytes
                   + max_slots * self.tokenizer.vocab_size * 4)
        out = {"params": self._param_bytes(), "kv_cache": kv_bytes(n_pos),
               "adapters": adapters_dev, "draft": draft_dev,
               "working": working}
        out["total"] = sum(out.values())
        if int(host_kv_pages):
            out["host_kv_cache"] = kv_bytes(int(host_kv_pages)
                                            * int(kv_page_size))
        return out

    def _detok(self, ids: Sequence[Any]) -> str:
        """Render generated ids: exact BPE decode when a real tokenizer
        is active, else the learned id→token table (hashing is one-way;
        unknown ids render as ``<id>``)."""
        if self._bpe:
            return self.tokenizer.decode(int(t) for t in ids).lstrip()
        return " ".join(self._id2tok.get(int(t), f"<{int(t)}>")
                        for t in ids)

    def make_decode_engine(self, max_slots: int = 8,
                           max_new_tokens: int = 8,
                           steps_per_sync: int = 4,
                           prefill_chunk: int = 32,
                           speculate_k: int = 0,
                           system_prefix: str = "",
                           draft_model: Optional["LlamaLoRA"] = None,
                           kv_page_size: int = 0,
                           kv_pages: int = 0,
                           host_kv_pages: int = 0) -> TextDecodeEngine:
        """Continuous-batching serving engine over this model's weights.
        ``kv_page_size > 0`` serves from a paged KV pool of ``kv_pages``
        pages (0 = full coverage); on a CUDA device every decode call
        then runs the paged-attention kernels (their int8 instances under
        ``kv_cache_int8``), verify windows included.

        ``speculate_k >= 2`` verifies ``speculate_k - 1`` drafted tokens
        a call: prompt-lookup drafts, or with ``draft_model`` (a smaller
        loaded ``LlamaLoRA`` with this model's tokenizer) the draft
        model's greedy continuations; the draft keeps its own contiguous
        cache. ``system_prefix`` registers the text's KV once; requests
        that extend it skip its prefill. ``host_kv_pages > 0`` (paged
        engines only) attaches the host KV page tier: the admission
        budget becomes pool pages plus host pages, cold pages spill to
        pinned host memory and come back ahead of the step that resumes
        them (``serving/kv_tier.py``)."""
        self._require_params()
        if host_kv_pages and kv_page_size <= 0:
            raise ValueError("host_kv_pages requires kv_page_size > 0 "
                             "(pages are the host tier's transfer "
                             "unit)")
        if kv_page_size > 0 and not kv_pages:
            kv_pages = _default_kv_pages(max_slots,
                                         int(self.knobs["max_len"]),
                                         int(kv_page_size))
        module = self._serving_module_params(kv_page_size, kv_pages)
        engine = self._build_text_engine(module, max_slots, max_new_tokens,
                                         steps_per_sync, prefill_chunk,
                                         speculate_k,
                                         draft_model=draft_model,
                                         host_kv_pages=host_kv_pages)
        if system_prefix:
            engine.register_prefix(system_prefix)
        return engine

    def make_multi_adapter_engine(self, adapter_params: Sequence[Any],
                                  max_slots: int = 8,
                                  max_new_tokens: int = 8,
                                  steps_per_sync: int = 4,
                                  prefill_chunk: int = 32,
                                  speculate_k: int = 0,
                                  validate: bool = True,
                                  kv_page_size: int = 0,
                                  kv_pages: int = 0,
                                  host_kv_pages: int = 0
                                  ) -> TextDecodeEngine:
        """One engine serving N adapter-only fine-tunes of one base: each
        request picks its fine-tune with ``submit(..., adapter_id=i)``,
        and requests of different adapters share every decode call.
        ``adapter_params``: params trees in adapter-id order (a
        ``dump_parameters()["params"]`` each); their non-adapter leaves
        must be identical (checked unless ``validate=False``) and the
        engine serves ``adapter_params[0]``'s base. Tokenization is this
        model's. Under ``quantize_int8`` the shared base kernels are
        quantized once and the adapters pass through as they are. This
        template's own serving model is dropped first (it is rebuilt by
        the next call that needs it), so the card holds one base."""
        trees = list(adapter_params)
        if not trees:
            raise ValueError("adapter_params must name >= 1 trees")
        if host_kv_pages and kv_page_size <= 0:
            raise ValueError("host_kv_pages requires kv_page_size > 0 "
                             "(pages are the host tier's transfer "
                             "unit)")
        stacked = stack_lora_adapters(trees, validate=validate)
        self._model = self._qmodel = None
        quantized = bool(self.knobs.get("quantize_int8"))
        model = self._module(quantized=quantized, n_adapters=len(trees))
        if quantized:
            stacked = quantize_llama_params(stacked, model.device)
        _load_leaves(model, stacked)
        del stacked
        if kv_page_size > 0 and not kv_pages:
            kv_pages = _default_kv_pages(max_slots,
                                         int(self.knobs["max_len"]),
                                         int(kv_page_size))
        return self._build_text_engine(
            model.with_kv_layout(kv_page_size, kv_pages), max_slots,
            max_new_tokens, steps_per_sync, prefill_chunk, speculate_k,
            host_kv_pages=host_kv_pages)

    def _build_text_engine(self, module: Llama, max_slots: int,
                           max_new_tokens: int, steps_per_sync: int,
                           prefill_chunk: int, speculate_k: int,
                           draft_model: Optional["LlamaLoRA"] = None,
                           host_kv_pages: int = 0) -> TextDecodeEngine:
        """This model's tokenizer around a DecodeEngine, with the JAX
        template's checks of a draft model: ``speculate_k >= 2``, the same
        tokenizer, a ``max_len`` covering this model's, and parameters of
        the draft's own knobs' shapes."""
        max_len = int(self.knobs["max_len"])

        def encode(text: str) -> np.ndarray:
            row, n = self.tokenizer.encode(str(text), max_len)
            return np.asarray(row[:max(1, int(n))], np.int32)

        draft = None
        if draft_model is not None:
            if int(speculate_k) < 2:
                raise ValueError(
                    "draft_model requires speculate_k >= 2 "
                    f"(got {speculate_k})")
            if draft_model._params is None:
                raise RuntimeError("draft model is not trained/loaded")
            if not _same_tokenizer(self.tokenizer, draft_model.tokenizer):
                raise ValueError(
                    "draft and target tokenize differently (merge "
                    "tables / vocab mismatch): speculation compares "
                    "token ids, so the models must share a tokenizer")
            if int(draft_model.knobs["max_len"]) < max_len:
                raise ValueError(
                    "draft max_len must cover the target's (the draft "
                    "cache walks the same positions)")
            if not same_tree_shapes(draft_model._param_shapes(),
                                    draft_model._params):
                raise ValueError(
                    "draft parameters do not match the draft model's "
                    "knobs (pass the draft trial's own knobs, e.g. "
                    "the worker config's draft_knobs)")
            draft = draft_model._serving_module_params()
        core = DecodeEngine(module, max_slots=max_slots, max_len=max_len,
                            steps_per_sync=steps_per_sync,
                            prefill_chunk=prefill_chunk,
                            speculate_k=speculate_k, draft=draft,
                            host_kv_pages=int(host_kv_pages),
                            device=self.device)
        return TextDecodeEngine(core, encode, self._detok,
                                max_new=min(max_new_tokens, max_len - 1))
