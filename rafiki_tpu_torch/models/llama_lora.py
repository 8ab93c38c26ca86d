"""Llama-style decoder LM with LoRA adapters: serving and fine-tuning.

Ports ``rafiki_tpu/models/llama_lora.py``:

- ``rope``, ``_parse_rope_scaling``, ``RMSNorm`` and ``LoRADense`` (its
  plain form and the int8 ``quantized`` form, whose base kernel is int8
  ``qkernel`` with per-output-channel f32 ``qscale``; the stacked
  ``n_adapters`` form raises), and ``quantize_llama_params``;
- ``_masked_decode_attention``, the contiguous-cache decode attention;
- ``_DecoderAttention`` — its decode branch, for contiguous rows and the
  paged pool: rope'd K and raw V are written at ``(table[pos // page],
  pos % page)`` before attention (with ``kv_int8``, as int8 rows and one
  f32 absmax scale per row), and a paged module attends through
  ``paged_decode_attention`` (s == 1) or ``paged_window_attention``
  (s > 1); and its train branch (``decode=False``): causal
  ``flash_attention`` with each row's keys past ``lens`` masked;
- ``_DecoderBlock`` (SwiGLU; the MoE FFN raises) and ``Llama``, whose
  flax ``cache`` collection becomes the explicit per-layer tensors of
  :meth:`Llama.init_cache`, written in place;
- ``greedy_generate``, a Python loop of decode steps over a contiguous
  cache;
- the functional training step of ``LlamaLoRA._lane_functions`` as
  module-level functions over any ``Llama``: the trainable masks
  (:func:`lora_trainable_names`), f32 master weights
  (:func:`make_trainable`), :func:`merge`, ``lm_valid_mask`` /
  ``lm_loss_terms``, :func:`adamw` and :func:`train_step`;
- the ``LlamaLoRA`` template: ``train`` (the unsharded
  ``_train_functional`` loop), ``evaluate``, ``dump_parameters``,
  ``load_parameters`` (blobs move both ways with the JAX template),
  ``predict`` and ``make_decode_engine``, with the int8 serving knobs
  ``quantize_int8`` and ``kv_cache_int8``.

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
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.data.dataset import load_text_classification_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.loop import epoch_count
from rafiki_tpu_torch.model.template_utils import same_tree_shapes
from rafiki_tpu_torch.models.bert import _TOKEN_RE, HashTokenizer
from rafiki_tpu_torch.ops.attention import flash_attention
from rafiki_tpu_torch.ops.common import gqa_repeat_factor
from rafiki_tpu_torch.ops.paged_attention import (kv_cache_write,
                                                  paged_decode_attention,
                                                  paged_window_attention)
from rafiki_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    TextDecodeEngine)
from rafiki_tpu_torch.store.params import (f32_tree, llama_params_from_jax,
                                           params_to_jax)
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

RopeScaling = Tuple[float, float, float, float]


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
        if n_adapters:
            raise NotImplementedError(
                "multi-adapter LoRA sites are not ported yet")
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.quantized = bool(quantized)
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
            self.lora_a = _weight((d_in, self.rank), 0.02, dtype, device,
                                  gen)
            self.lora_b = _weight((self.rank, features), 0.0, dtype,
                                  device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            y = (x @ self.qkernel.to(x.dtype)) * self.qscale.to(x.dtype)
        else:
            y = x @ self.kernel.to(x.dtype)
        if self.rank > 0:
            y = y + ((x @ self.lora_a.to(x.dtype))
                     @ self.lora_b.to(x.dtype)) * (self.alpha / self.rank)
        return y


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
                 quantized: bool = False) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.rep = gqa_repeat_factor(n_heads, n_kv_heads)
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        dh = hidden // n_heads
        kw = dict(rank=lora_rank, dtype=dtype, device=device, gen=gen,
                  quantized=quantized)
        self.wq = LoRADense(hidden, n_heads * dh, **kw)
        self.wk = LoRADense(hidden, n_kv_heads * dh, **kw)
        self.wv = LoRADense(hidden, n_kv_heads * dh, **kw)
        self.wo = LoRADense(n_heads * dh, hidden, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]],
                page_tables: Optional[torch.Tensor],
                lens: Optional[torch.Tensor] = None,
                decode: bool = True) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.n_heads
        q = rope(self.wq(x).reshape(b, s, self.n_heads, dh), positions,
                 self.rope_theta, self.rope_scaling)
        k = rope(self.wk(x).reshape(b, s, self.n_kv_heads, dh), positions,
                 self.rope_theta, self.rope_scaling)
        v = self.wv(x).reshape(b, s, self.n_kv_heads, dh)
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
            return self.wo(o.reshape(b, s, self.n_heads * dh))
        ck, cv = cache["k"], cache["v"]
        kv_int8 = "k_scale" in cache  # the int8 cache's extra leaves
        t = positions  # (b, s): each slot's own write index per token
        # write the whole window before attending: within-window
        # causality then falls out of the per-row position mask
        if page_tables is not None:
            page_size = ck.shape[1]
            widx = (torch.gather(page_tables, 1, (t // page_size).long()),
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
        return self.wo(o.reshape(b, s, self.n_heads * dh))


class _DecoderBlock(nn.Module):
    def __init__(self, hidden: int, n_heads: int, n_kv_heads: int,
                 mlp_dim: int, lora_rank: int, rope_theta: float,
                 rope_scaling: Optional[RopeScaling], dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator,
                 n_experts: int = 0, quantized: bool = False) -> None:
        super().__init__()
        if n_experts:
            raise NotImplementedError("the MoE FFN is not ported yet")
        self.RMSNorm_0 = RMSNorm(hidden, device)
        self.attn = _DecoderAttention(hidden, n_heads, n_kv_heads,
                                      lora_rank, rope_theta, rope_scaling,
                                      dtype, device, gen, quantized)
        self.RMSNorm_1 = RMSNorm(hidden, device)
        kw = dict(rank=lora_rank, dtype=dtype, device=device, gen=gen,
                  quantized=quantized)
        self.gate = LoRADense(hidden, mlp_dim, **kw)
        self.up = LoRADense(hidden, mlp_dim, **kw)
        self.down = LoRADense(mlp_dim, hidden, **kw)

    def forward(self, x, positions, cache, page_tables, lens=None,
                decode=True):
        x = x + self.attn(self.RMSNorm_0(x), positions, cache, page_tables,
                          lens, decode)
        y = self.RMSNorm_1(x)
        y = F.silu(self.gate(y)) * self.up(y)  # SwiGLU
        return x + self.down(y)


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
    :func:`quantize_llama_params` gives); ``kv_int8`` makes the decode
    cache int8 with one f32 absmax scale per K/V row. Weights are drawn
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
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        if n_adapters:
            raise NotImplementedError(
                "multi-adapter serving is not ported yet")
        _check_kv_layout(max_len, kv_page_size, kv_pages)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.hidden_dim = int(hidden_dim)
        self.depth = int(depth)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads)
        self.dtype = torch.float32 if dtype is None else dtype
        self.kv_page_size = int(kv_page_size)
        self.kv_pages = int(kv_pages)
        self.quantized = bool(quantized)
        self.kv_int8 = bool(kv_int8)
        self.tok_embed = Embed(vocab_size, hidden_dim, device, generator)
        for i in range(depth):
            self.add_module(f"block_{i}", _DecoderBlock(
                hidden_dim, n_heads, n_kv_heads, mlp_dim, lora_rank,
                rope_theta, rope_scaling, self.dtype, device, generator,
                n_experts=n_experts, quantized=self.quantized))
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
                lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(b, s) ids → (b, s, vocab) logits, or the final-norm
        activations with ``return_hidden`` (prefill, which must not pay
        the lm_head).

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
        x = self.tok_embed(ids).to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, positions, cache[i],
                                            page_tables, lens, decode)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.lm_head(x)


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
    adapters, every norm scale and the LM head (JAX's
    ``lora_trainable_mask``), or the adapters alone with
    ``adapters_only`` (``adapter_only_mask``). The base kernels and the
    embedding stay frozen."""
    def trainable(path: str) -> bool:
        if adapters_only:
            return "lora_a" in path or "lora_b" in path
        return ("lora_" in path or "norm" in path
                or path.startswith("lm_head"))

    return [name for name, _ in model.named_parameters()
            if trainable(name.replace(".", "/").lower())]


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


def lm_objective(model: Llama, trainable: Dict[str, torch.Tensor],
                 lora_scale: float, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """Mean masked next-token loss of one batch (``ids``, ``lens`` and,
    optionally, ``mask``) through the train branch, the trainable leaves
    merged with the rank-scale."""
    logits = torch.func.functional_call(
        model, merge(trainable, lora_scale), (batch["ids"],),
        {"decode": False, "lens": batch["lens"]})
    total, count = lm_loss_terms(logits, batch["ids"], batch["lens"],
                                 batch.get("mask"))
    return total / count.clamp(min=1.0)


def adamw(trainable: Dict[str, torch.Tensor], learning_rate: float
          ) -> torch.optim.Optimizer:
    """The JAX step's update, ``optax.chain(scale_by_adam(),
    add_decayed_weights(1e-4))`` then ``−lr · u``: Adam with b1 0.9, b2
    0.999, eps 1e-8 outside the square root, bias correction, and the
    decay added to the update — which is ``AdamW`` with weight decay
    1e-4."""
    return torch.optim.AdamW(list(trainable.values()), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def train_step(model: Llama, trainable: Dict[str, torch.Tensor],
               opt: torch.optim.Optimizer, lora_scale: float,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One optimizer step on one batch; returns the batch loss (a
    detached 0-d tensor: reading it synchronizes, so the caller
    decides when)."""
    opt.zero_grad(set_to_none=True)
    loss = lm_objective(model, trainable, lora_scale, batch)
    loss.backward()
    opt.step()
    return loss.detach()


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


def _replace_leaves(tree: Dict[str, Any],
                    leaves: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``tree`` with the leaves named by ``state_dict`` key replaced (as
    f32 numpy)."""
    out = f32_tree(tree)
    for key, t in leaves.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return out


class LlamaLoRA:
    """Causal-LM template: LoRA fine-tuning (``train``, ``evaluate``,
    ``dump_parameters``) and serving (``load_parameters``, ``predict``,
    ``make_decode_engine``). Knobs are the JAX template's (``hidden_dim``,
    ``depth``, ``n_heads``, ``kv_ratio``, ``lora_rank``, ``lora_scale``,
    ``learning_rate``, ``batch_size``, ``max_epochs``, ``max_len``,
    ``vocab_size``, ``bf16``, ``adapters_only``, ``rope_theta``,
    ``rope_scaling``, ``quantize_int8``, ``kv_cache_int8``, ...); the
    byte-BPE tokenizer, ``pretrained_path`` and the MoE knob are later
    slices and raise. ``device=None`` is the CUDA card.

    Parameters live as the JAX template keeps them: ``_params``, nested
    dicts of f32 numpy arrays in the JAX layout (what ``dump_parameters``
    returns), and ``_model``, the compute-dtype ``Llama`` built from them
    for evaluation and serving. With ``quantize_int8`` serving takes
    ``_qmodel`` instead, the int8 model of :func:`quantize_llama_params`,
    built once per loaded tree (JAX's cached ``_qparams``), and ``_model``
    is built only when ``evaluate`` asks for it, so an int8 deployment
    holds no compute-dtype copy of its weights on the card."""

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.device = resolve_device(device)
        self.knobs: Dict[str, Any] = dict(knobs)
        for key in ("tokenizer_path", "pretrained_path", "moe_experts"):
            if self.knobs.get(key):
                raise NotImplementedError(f"knob {key!r} is not ported yet")
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

    def _module(self, quantized: bool = False) -> Llama:
        """A freshly initialized model for these knobs (mlp = 4·hidden,
        as in the JAX template), contiguous cache layout; int8 base
        kernels with ``quantized``, an int8 cache with the
        ``kv_cache_int8`` knob."""
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
                     quantized=quantized,
                     kv_int8=bool(k.get("kv_cache_int8", False)),
                     device=self.device)

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
        template's: the format is one."""
        meta = params["meta"]
        if meta.get("bpe_merges") is not None:
            raise NotImplementedError(
                "the byte-BPE tokenizer is not ported yet")
        self._id2tok = {int(k): v for k, v in meta["id2tok"].items()}
        self._set_params(params["params"])

    def _set_params(self, tree: Dict[str, Any]) -> None:
        """Keep ``tree`` (f32 copies) and drop the models of the previous
        tree; build the compute-dtype model from it (matmul leaves cast
        once) unless ``quantize_int8`` serves the int8 one instead."""
        self._params = f32_tree(tree)
        self._model = self._qmodel = None
        if not self.knobs.get("quantize_int8"):
            self._float_model()

    def dump_parameters(self) -> Dict[str, Any]:
        """``{"params": f32 numpy tree, "meta": {"id2tok": ...}}`` — the
        JAX template's format, loadable by either template."""
        if self._params is None:
            raise RuntimeError("model is not trained/loaded")
        return {"params": f32_tree(self._params),
                "meta": {"id2tok": {str(k): v
                                    for k, v in self._id2tok.items()}}}

    # ---- training ----
    def _encode_lm(self, texts: Sequence[str]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """BOS-prefixed token rows. Also grows the id→token table used
        to detokenize generations (hashing is one-way)."""
        max_len = int(self.knobs["max_len"])
        ids = np.zeros((len(texts), max_len), np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            row, n = self.tokenizer.encode(t, max_len)  # CLS slot = BOS
            ids[i], lens[i] = row, n
            # mirror the tokenizer's own splitting so ids align with words
            for tok_str, tok_id in zip(_TOKEN_RE.findall(t.lower()),
                                       row[1:n]):
                self._id2tok[int(tok_id)] = tok_str
        return ids, lens

    def _check_trainable_knobs(self) -> None:
        """The JAX template routes every knob set that ``gang_blockers``
        names to its sharded mesh loop, which is not ported; so are the
        remat schedules."""
        k = self.knobs

        def on(name: str, default: int = 0) -> bool:
            return int(k.get(name, default) or default) > default

        blockers = [name for name, default in (
            ("model_parallel", 1), ("sequence_parallel", 1),
            ("pipeline_stages", 1), ("grad_accum", 1), ("moe_experts", 0),
            ("loss_chunk", 0)) if on(name, default)]
        if k.get("pretrained_path"):
            blockers.append("pretrained_path")
        if k.get("remat"):
            blockers.append("remat")
        if str(k.get("remat_policy") or "none") != "none":
            blockers.append("remat_policy")
        if blockers:
            raise NotImplementedError(
                f"knob(s) {blockers} need the sharded / rematerialized "
                "train path, which is not ported yet")

    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        """LoRA fine-tune on a ``.jsonl`` text corpus: the JAX template's
        functional loop (``_train_functional``). The init is the loaded
        weights when their shapes match, else ``ctx.shared_params`` under
        the ``share_params`` knob, else the port's seeded init. Batches
        come from ``batch_iterator(seed=epoch)``; ``loss`` and ``tokens``
        are logged per epoch. At the end ``_params`` holds the trained
        tree with ``lora_scale`` folded into ``lora_b``."""
        self._check_trainable_knobs()
        ctx = ctx or TrainContext()
        ds = load_text_classification_dataset(dataset_path)
        ids, lens = self._encode_lm(ds.texts)
        model = self._module()
        names = lora_trainable_names(
            model, bool(self.knobs.get("adapters_only", False)))
        fresh = params_to_jax(model.state_dict())
        base = fresh
        if self._params is not None and \
                same_tree_shapes(fresh, self._params):
            base = self._params  # re-train / load_parameters
        shared = (ctx.shared_params or {}).get("params")
        if self.knobs.get("share_params") and shared is not None and \
                same_tree_shapes(fresh, shared):
            base = shared
        base = f32_tree(base)
        trainable = make_trainable(model, names)
        model.load_state_dict(llama_params_from_jax(base, model.dtype,
                                                    trainable))
        lr = float(self.knobs["learning_rate"])
        scale = float(self.knobs.get("lora_scale", 1.0))
        opt = adamw(trainable, lr)
        batch_size = int(self.knobs["batch_size"])
        epochs = epoch_count(self.knobs, ctx)  # JAX gang_epochs
        ctx.logger.define_plot("LM loss", ["loss"], x_axis="epoch")

        def folded() -> Dict[str, Any]:
            return _replace_leaves(base, merge(
                {n: t.detach() for n, t in trainable.items()}, scale))

        for epoch in range(epochs):
            losses = [train_step(model, trainable, opt, scale,
                                 batch_to_device(batch, self.device))
                      for batch in batch_iterator(
                          {"ids": ids, "lens": lens}, batch_size,
                          seed=epoch)]
            mean_loss = (float(np.mean([float(l) for l in losses]))
                         if losses else float("nan"))
            ctx.logger.log(epoch=epoch, loss=mean_loss,
                           tokens=int(ids.shape[0] * ids.shape[1]))
            if ctx.checkpoint is not None:
                self._params = folded()
                ctx.checkpoint(self.dump_parameters,
                               frac_done=(epoch + 1) / epochs,
                               tree={"params": self._params})
            if ctx.should_continue is not None and \
                    not ctx.should_continue(epoch, -mean_loss):
                break
        del opt, model
        self._set_params(folded())

    def evaluate(self, dataset_path: str) -> float:
        """Inverse perplexity exp(−nll) in (0, 1]; higher is better.
        Buckets of 32 rows; pad rows have ``lens = 0``, so no loss
        position of theirs counts. The f32 tree's model, int8 knobs or
        not (JAX's evaluate takes ``_params``)."""
        model = self._float_model()
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
                logits = model(batch["ids"], decode=False,
                               lens=batch["lens"])
                s, c = lm_loss_terms(logits, batch["ids"], batch["lens"])
                total += float(s)
                count += float(c)
        return float(np.exp(-total / max(count, 1.0)))

    def predict(self, queries: Sequence[Any],
                max_new_tokens: int = 8) -> List[str]:
        """Greedy continuations, detokenized via the learned id→token
        table (unknown ids render as ``<id>``), through the serving model
        (int8 under the int8 knobs). The JAX template pads the batch to a
        power of two for its compile cache; eager PyTorch has none to
        hit, so the batch runs as given."""
        model = self._serving_module_params()
        texts = [q if isinstance(q, str) else str(q) for q in queries]
        max_len = int(self.knobs["max_len"])
        # the KV cache holds max_len positions (prompt + generation)
        max_new = min(max_new_tokens, max_len - 1)
        ids, lens = self.tokenizer.encode_batch(texts,
                                                max(1, max_len - max_new))
        out = greedy_generate(model, ids, lens, max_new).cpu().numpy()
        return [self._detok(row) for row in out]

    def _detok(self, ids: Sequence[Any]) -> str:
        """Render generated ids through the learned id→token table
        (hashing is one-way; unknown ids render as ``<id>``)."""
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
        ``kv_cache_int8``). Speculation, draft models, system prefixes and
        the host KV tier are later slices."""
        if system_prefix:
            raise NotImplementedError(
                "registered prefixes are not ported yet")
        if draft_model is not None:
            raise NotImplementedError(
                "draft-model speculation is not ported yet")
        if kv_page_size > 0 and not kv_pages:
            kv_pages = _default_kv_pages(max_slots,
                                         int(self.knobs["max_len"]),
                                         int(kv_page_size))
        module = self._serving_module_params(kv_page_size, kv_pages)
        return self._build_text_engine(module, max_slots, max_new_tokens,
                                       steps_per_sync, prefill_chunk,
                                       speculate_k,
                                       host_kv_pages=host_kv_pages)

    def _build_text_engine(self, module: Llama, max_slots: int,
                           max_new_tokens: int, steps_per_sync: int,
                           prefill_chunk: int, speculate_k: int,
                           host_kv_pages: int = 0) -> TextDecodeEngine:
        """This model's tokenizer around a DecodeEngine."""
        max_len = int(self.knobs["max_len"])

        def encode(text: str) -> np.ndarray:
            row, n = self.tokenizer.encode(str(text), max_len)
            return np.asarray(row[:max(1, int(n))], np.int32)

        core = DecodeEngine(module, max_slots=max_slots, max_len=max_len,
                            steps_per_sync=steps_per_sync,
                            prefill_chunk=prefill_chunk,
                            speculate_k=speculate_k,
                            host_kv_pages=int(host_kv_pages),
                            device=self.device)
        return TextDecodeEngine(core, encode, self._detok,
                                max_new=min(max_new_tokens, max_len - 1))
