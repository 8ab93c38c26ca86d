"""The flax layers the classifier templates are built from.

Counterparts of ``flax.linen``'s ``Dense``, ``LayerNorm`` and ``Embed`` as
the JAX package's ViT and BERT use them, with flax's parameter names
(``kernel``/``bias``, ``scale``/``bias``, ``embedding``) and layouts
(``kernel`` is (d_in, features)), so a ``state_dict`` key is the flax path
(``store/params.py``). Parameters are f32; ``dtype`` is the compute dtype,
and ``None`` promotes, as flax does:

- ``Dense``: input, kernel and bias cast to ``dtype`` (``None``: their
  promoted type), then ``x @ kernel`` and ``+ bias`` as two roundings;
- ``LayerNorm`` (eps 1e-6, flax's, not torch's 1e-5): mean and
  ``E[x²] − E[x]²`` (clamped at 0) in f32, the output in ``dtype`` or, for
  ``None``, the promotion of the input with the f32 scale — so a bf16
  input comes out f32;
- ``Embed``: the table cast to ``dtype`` before the lookup.

Initializers match flax's distributions from a ``torch.Generator``, not
its bits: ``lecun_normal`` (a normal truncated at two standard deviations,
rescaled to variance 1/fan_in) for ``Dense`` kernels, zeros for biases,
ones for scales, and N(0, 1/features) for the embedding table.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
                 gen: torch.Generator) -> nn.Parameter:
    """flax ``lecun_normal`` over a (fan_in, fan_out) kernel."""
    return param(shape, device, gen, std=math.sqrt(1.0 / shape[0])
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
