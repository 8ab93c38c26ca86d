"""The flax layers the classifier templates are built from.

Counterparts of ``flax.linen``'s ``Dense``, ``LayerNorm`` and ``Embed`` as
the JAX package's ViT and BERT use them, and of ``Conv``, ``BatchNorm``,
``max_pool`` and ``avg_pool`` as its BatchNorm CNNs (``resnet.py``,
``vgg.py``, ``densenet.py``) use them, with flax's parameter names
(``kernel``/``bias``, ``scale``/``bias``, ``embedding``; BatchNorm's
``mean``/``var`` are buffers) and, but for the conv kernels, flax's
layouts (``kernel`` is (d_in, features)), so a ``state_dict`` key is the
flax path (``store/params.py``). Parameters are f32; ``dtype`` is the
compute dtype, and ``None`` promotes, as flax does:

- ``Dense``: input, kernel and bias cast to ``dtype`` (``None``: their
  promoted type), then ``x @ kernel`` and ``+ bias`` as two roundings;
- ``LayerNorm`` (eps 1e-6, flax's, not torch's 1e-5): mean and
  ``E[x²] − E[x]²`` (clamped at 0) in f32, the output in ``dtype`` or, for
  ``None``, the promotion of the input with the f32 scale — so a bf16
  input comes out f32;
- ``Embed``: the table cast to ``dtype`` before the lookup;
- ``Conv`` (``use_bias=False``, ``padding="SAME"``): input and kernel cast
  to ``dtype``. The activations are NCHW tensors (channels-last in memory
  when they come from NHWC images, so cuDNN takes its NHWC paths) and the
  kernel is OIHW, where flax's is HWIO. SAME pads as XLA does, which is
  not symmetric: :func:`same_pads`;
- ``BatchNorm`` (momentum 0.9, eps 1e-5): in training, the batch's mean
  and *biased* variance ``E[x²] − E[x]²`` (clamped at 0) reduced in f32,
  and the running stats blended as ``0.9·ra + 0.1·stat`` in place (torch's
  ``BatchNorm2d`` would blend the unbiased variance); in eval, the running
  stats. It normalizes in f32 and casts to ``dtype``;
- :func:`max_pool_same` pads with −∞ as XLA's SAME does; VALID pools are
  ``F.max_pool2d`` / ``F.avg_pool2d``.

Initializers match flax's distributions from a ``torch.Generator``, not
its bits: ``lecun_normal`` (a normal truncated at two standard deviations,
rescaled to variance 1/fan_in) for ``Dense`` kernels and for ``Conv``
kernels (fan_in kh·kw·cin), zeros for biases, ones for scales (or the
given constant: the CNNs zero some), and N(0, 1/features) for the
embedding table.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: flax's lecun_normal draws a unit normal truncated to [-2, 2] and
#: divides the target std by that distribution's std
_TRUNC_STD = 0.87962566103423978


def param(shape: Sequence[int], device: torch.device,
          gen: Optional[torch.Generator] = None, std: float = 0.0,
          fill: float = 0.0, truncated: bool = False) -> nn.Parameter:
    """An f32 parameter: N(0, std²) (truncated at ±2 std when
    ``truncated``) drawn from ``gen``, or the constant ``fill`` for
    ``std == 0``."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if not std:
        t.fill_(fill)
    elif truncated:
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
    else:
        t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


def lecun_normal(shape: Sequence[int], device: torch.device,
                 gen: torch.Generator,
                 fan_in: Optional[int] = None) -> nn.Parameter:
    """flax ``lecun_normal`` over a kernel whose fan-in is ``fan_in``
    (default ``shape[0]``: a (fan_in, fan_out) kernel)."""
    fan_in = shape[0] if fan_in is None else fan_in
    return param(shape, device, gen, std=math.sqrt(1.0 / fan_in)
                 / _TRUNC_STD, truncated=True)


def _compute_dtype(dtype: Optional[torch.dtype],
                   *ts: torch.Tensor) -> torch.dtype:
    if dtype is not None:
        return dtype
    out = ts[0].dtype
    for t in ts[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Dense(nn.Module):
    def __init__(self, d_in: int, features: int,
                 dtype: Optional[torch.dtype], device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = lecun_normal((d_in, features), device, gen)
        self.bias = param((features,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.dtype, x, self.kernel, self.bias)
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device: torch.device,
                 dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = param((dim,), device, fill=1.0)
        self.bias = param((dim,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        y = y + self.bias
        return y.to(_compute_dtype(self.dtype, x, self.scale, self.bias))


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 dtype: Optional[torch.dtype], device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        self.dtype = dtype
        self.embedding = param((num_embeddings, features), device, gen,
                               std=1.0 / math.sqrt(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embedding
        if self.dtype is not None:
            table = table.to(self.dtype)
        return F.embedding(ids, table)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: the output is ``ceil(size /
    s)`` wide, the total pad ``max((out − 1)·s + k − size, 0)``, and the
    low side takes its floor half: a 7×7 / 2 conv on 224 pads (2, 3), a
    3×3 / 2 on an even size (0, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int],
              value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``(x, padding)``: ``x`` padded where SAME is asymmetric, and the
    symmetric padding left for the op itself (one copy fewer when SAME
    is symmetric, e.g. a 3×3 / 1 conv)."""
    (hl, hh) = same_pads(x.shape[2], k[0], s[0])
    (wl, wh) = same_pads(x.shape[3], k[1], s[1])
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


class Conv(nn.Module):
    """``nn.Conv(features, kernel_size, strides, padding="SAME",
    use_bias=False, dtype)`` over NCHW activations; ``kernel`` is OIHW."""

    def __init__(self, cin: int, features: int,
                 kernel_size: Tuple[int, int], strides: Tuple[int, int],
                 dtype: Optional[torch.dtype], device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        kh, kw = kernel_size
        self.dtype = dtype
        self.strides = tuple(strides)
        self.kernel = lecun_normal((features, cin, kh, kw), device, gen,
                                   fan_in=kh * kw * cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.dtype, x, self.kernel)
        w = self.kernel.to(dtype, memory_format=torch.channels_last)
        x, padding = _pad_same(x.to(dtype), tuple(w.shape[2:]),
                               self.strides)
        return F.conv2d(x, w, stride=self.strides, padding=padding)


class BatchNorm(nn.Module):
    """``nn.BatchNorm(use_running_average=not self.training,
    momentum=0.9, dtype)`` over the channels (dim 1) of NCHW
    activations."""

    def __init__(self, features: int, dtype: Optional[torch.dtype],
                 device: torch.device, scale_init: float = 1.0,
                 momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.scale = param((features,), device, fill=scale_init)
        self.bias = param((features,), device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            x32 = x.float()
            mean = x32.mean((0, 2, 3))
            var = torch.clamp(x32.square().mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1 - m)
                self.var.mul_(m).add_(var, alpha=1 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(_compute_dtype(self.dtype, x, self.scale, self.bias))


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: −∞ padding,
    placed as XLA places it."""
    x, padding = _pad_same(x, (k, k), (s, s), value=float("-inf"))
    return F.max_pool2d(x, k, s, padding=padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2)).astype(f32)`` of NHWC, here over NCHW's
    dims 2 and 3: reduced in f32, rounded to ``x``'s dtype as jnp's mean
    returns it, then widened for the f32 head."""
    return x.mean((2, 3), dtype=torch.float32).to(x.dtype).float()
