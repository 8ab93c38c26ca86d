"""ViT: the image-classification template, serving and training.

Ports ``rafiki_tpu/models/vit.py``:

- ``_Attention``, ``_Block``, ``_PatchEmbed`` and ``ViT``, with flax's
  parameter names (``store/params.py``), so a JAX blob loads as is. The
  patch projection runs :func:`patch_embed` (kernel B7) and attention
  :func:`flash_attention`, non-causal over all ``n + 1`` tokens (B3, or
  B4 under a ``block_h`` default > 1; B5/B6 backward). ``remat`` is
  ``torch.utils.checkpoint`` around each block;
- the ``ViTBase16`` template: ``train``, ``evaluate``, ``predict``,
  ``_predict_probs``, ``warmup``, ``dump_parameters``,
  ``load_parameters`` and ``_prep`` (``prep_version`` 1: pixels / 255;
  2: centred to [-1, 1]).

Numerics follow the flax module: parameters are f32 and cast to the
compute dtype per call; the norms have no dtype, so a bf16 residual comes
out of a norm in f32 and the next ``Dense`` casts it back, keeping the
residual stream in bf16; ``cls`` and ``pos_embed`` take the activations'
dtype; ``final_norm`` and ``head`` run in f32; ``gelu`` is the tanh
approximation (flax's default). Where flax infers the patch count and the
channels from the first input, the port's ``ViT`` takes ``image_shape``.
Its seeded init matches flax's distributions, not its bits.

The JAX template trains data-parallel over a TPU sub-mesh; the port trains
on its one device (``device=None`` is the CUDA card). Knob search
(``get_knob_config``) waits for the port's knob module.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rafiki_tpu_torch.data.dataset import load_image_classification_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.loop import epoch_count, fit, masked_ce
from rafiki_tpu_torch.model.template_utils import (bucketed_forward,
                                                   conform_images,
                                                   same_tree_shapes)
from rafiki_tpu_torch.models.layers import (Dense, LayerNorm, lecun_normal,
                                            param)
from rafiki_tpu_torch.ops.attention import flash_attention
from rafiki_tpu_torch.ops.patch_embed import patch_embed
from rafiki_tpu_torch.store.params import f32_tree, params_from_jax, \
    params_to_jax
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

Dtype = Optional[torch.dtype]


class _Attention(nn.Module):
    def __init__(self, d: int, n_heads: int, dtype: Dtype,
                 device: torch.device, gen: torch.Generator) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.qkv = Dense(d, 3 * d, dtype, device, gen)
        self.proj = Dense(d, d, dtype, device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.n_heads
        q, k, v = self.qkv(x).split(d, dim=-1)

        def heads(t):
            return t.reshape(b, s, self.n_heads, dh).transpose(1, 2)

        o = flash_attention(heads(q), heads(k), heads(v))
        return self.proj(o.transpose(1, 2).reshape(b, s, d))


class _Block(nn.Module):
    def __init__(self, d: int, n_heads: int, mlp_dim: int, dtype: Dtype,
                 device: torch.device, gen: torch.Generator) -> None:
        super().__init__()
        # the norms reduce in f32 and have no dtype (flax dtype=None); the
        # matmuls run in ``dtype``
        self.LayerNorm_0 = LayerNorm(d, device)
        self.attn = _Attention(d, n_heads, dtype, device, gen)
        self.LayerNorm_1 = LayerNorm(d, device)
        self.Dense_0 = Dense(d, mlp_dim, dtype, device, gen)
        self.Dense_1 = Dense(mlp_dim, d, dtype, device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.LayerNorm_0(x))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, channels: int, hidden_dim: int,
                 dtype: Dtype, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.kernel = lecun_normal(
            (patch_size * patch_size * channels, hidden_dim), device, gen)
        self.bias = param((hidden_dim,), device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        w, b = self.kernel, self.bias
        if self.dtype is not None:
            images, w, b = (t.to(self.dtype) for t in (images, w, b))
        return patch_embed(images, w, b, self.patch_size)


class ViT(nn.Module):
    """Vision Transformer over (B, H, W, C) images of ``image_shape``.

    ViT-B/16 = patch_size 16, hidden_dim 768, depth 12, n_heads 12,
    mlp_dim 3072. ``dtype`` is the compute dtype of the matmuls (None =
    f32). Weights are drawn from ``generator`` (a fresh one seeded 0 when
    None) on ``device`` (None = the CUDA card, raising without one)."""

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768,
                 depth: int = 12, n_heads: int = 12, mlp_dim: int = 3072,
                 n_classes: int = 1000, dtype: Dtype = None,
                 remat: bool = False,
                 image_shape: Sequence[int] = (224, 224, 3),
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        h, w, c = (int(v) for v in image_shape)
        n = (h // patch_size) * (w // patch_size)
        self.depth = int(depth)
        self.remat = bool(remat)
        self.patch_embed = _PatchEmbed(patch_size, c, hidden_dim, dtype,
                                       device, generator)
        self.cls = param((1, 1, hidden_dim), device)
        self.pos_embed = param((1, n + 1, hidden_dim), device, generator,
                               std=0.02)
        for i in range(self.depth):
            self.add_module(f"block_{i}", _Block(
                hidden_dim, n_heads, mlp_dim, dtype, device, generator))
        self.final_norm = LayerNorm(hidden_dim, device)
        self.head = Dense(hidden_dim, n_classes, None, device, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images)
        b, _, d = x.shape
        x = torch.cat([self.cls.expand(b, 1, d).to(x.dtype), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            if self.remat and torch.is_grad_enabled():
                # drop the block's activations, recompute them in backward
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.final_norm(x)
        return self.head(x[:, 0])



class ViTBase16:
    """ViT template: image classification. Knobs are the JAX template's
    (``patch_size``, ``hidden_dim``, ``depth``, ``n_heads``,
    ``learning_rate``, ``weight_decay``, ``warmup_frac``, ``batch_size``,
    ``max_epochs``, ``bf16``, ``remat``, ``quick_train``,
    ``share_params``); ``device=None`` is the CUDA card.

    Parameters live as the JAX template keeps them: ``_params``, nested
    dicts of f32 numpy arrays in the flax layout (what
    ``dump_parameters`` returns), and a ``ViT`` built from them on the
    device for serving (``_net``)."""

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.device = resolve_device(device)
        self.knobs: Dict[str, Any] = dict(knobs)
        self._params: Optional[Dict[str, Any]] = None
        self._n_classes: Optional[int] = None
        self._image_shape: Optional[Sequence[int]] = None
        self._net: Optional[ViT] = None
        #: input normalization the active params were trained under: fresh
        #: trains use 2, load_parameters adopts the checkpoint's
        self._prep_version: int = 2

    # ---- internals ----
    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.knobs.get("bf16", True) \
            else torch.float32

    def _module(self) -> ViT:
        """A freshly initialized ``ViT`` (seed 0) for these knobs (mlp =
        4·hidden) over the prepped image shape."""
        k = self.knobs
        hd = int(k["hidden_dim"])
        heads = int(k["n_heads"])
        if hd % heads:
            raise ValueError(f"hidden_dim={hd} not divisible by "
                             f"n_heads={heads}")
        p = int(k["patch_size"])
        h, w, c = (int(v) for v in self._image_shape)
        return ViT(patch_size=p, hidden_dim=hd, depth=int(k["depth"]),
                   n_heads=heads, mlp_dim=4 * hd,
                   n_classes=int(self._n_classes), dtype=self._dtype(),
                   remat=bool(k.get("remat", False)),
                   image_shape=(h + (-h) % p, w + (-w) % p, c),
                   device=self.device)

    def _prep(self, images: np.ndarray) -> np.ndarray:
        if self._prep_version == 1:
            # v1 checkpoints were trained on [0, 1] inputs
            x = images.astype(np.float32) / 255.0
        else:
            x = images.astype(np.float32) / 127.5 - 1.0  # [-1, 1]
        if x.ndim == 3:
            x = x[..., None]
        # pos_embed is sized to the train-time patch count
        x = conform_images(x, self._image_shape)
        p = int(self.knobs["patch_size"])
        ph = (-x.shape[1]) % p
        pw = (-x.shape[2]) % p
        if ph or pw:
            x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)))
        return x

    def _serving_net(self) -> ViT:
        if self._params is None:
            raise RuntimeError("model is not trained/loaded")
        if self._net is None:
            net = self._module()
            net.load_state_dict(params_from_jax(self._params))
            self._net = net.requires_grad_(False)
        return self._net

    # ---- contract ----
    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        """Train on an image ``.npz``: from the loaded params, else
        ``ctx.shared_params`` under ``share_params`` (same shapes and
        ``prep_version``), else the seeded init; batches from
        ``batch_iterator(seed=epoch)``, the mean loss logged per
        epoch."""
        ctx = ctx or TrainContext()
        ds = load_image_classification_dataset(dataset_path)
        self._n_classes = ds.n_classes
        self._image_shape = ds.image_shape
        x = self._prep(ds.images)
        y = ds.labels
        model = self._module()
        params = self._params
        if ctx.shared_params is not None and \
                self.knobs.get("share_params") and \
                hasattr(ctx.shared_params, "get"):
            shared = ctx.shared_params.get("params")
            donor_prep = int(ctx.shared_params.get("meta", {})
                             .get("prep_version", 1))
            if shared is not None and donor_prep != self._prep_version:
                # weights trained under another input normalization would
                # start worse than a cold start
                logging.getLogger(__name__).warning(
                    "skipping warm start: donor checkpoint prep_version="
                    "%d != this train's %d (input normalization "
                    "contracts differ)", donor_prep, self._prep_version)
            elif shared is not None and same_tree_shapes(
                    params if params is not None
                    else params_to_jax(model.state_dict()), shared):
                params = shared
        if params is not None:
            model.load_state_dict(params_from_jax(params))
        self._params, self._net = None, None

        dtype = self._dtype()
        batch_size = int(self.knobs["batch_size"])

        def objective(m, b):
            xb = torch.from_numpy(b["x"]).to(self.device).to(dtype)
            yb = torch.from_numpy(b["y"]).to(self.device)
            mask = torch.from_numpy(b["mask"]).to(self.device).float()
            return masked_ce(m(xb), yb, mask)

        def snapshot():
            self._params = params_to_jax(model.state_dict())
            return self.dump_parameters

        fit(model, objective,
            lambda epoch: batch_iterator({"x": x, "y": y}, batch_size,
                                         seed=epoch),
            epoch_count(self.knobs, ctx),
            max(1, -(-len(x) // batch_size)), self.knobs, ctx, snapshot)
        self._params = params_to_jax(model.state_dict())
        self._net = model.requires_grad_(False)

    def evaluate(self, dataset_path: str) -> float:
        ds = load_image_classification_dataset(dataset_path)
        probs = self._predict_probs(self._prep(ds.images))
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        x = self._prep(np.stack([np.asarray(q) for q in queries]))
        return [p.tolist() for p in self._predict_probs(x)]

    def _predict_probs(self, x: np.ndarray) -> np.ndarray:
        """f32 softmax probabilities, in buckets of 64 images."""
        net = self._serving_net()
        dtype = self._dtype()

        def forward(xb: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                logits = net(torch.from_numpy(xb).to(self.device).to(dtype))
                return torch.softmax(logits.float(), -1).cpu().numpy()

        return bucketed_forward(forward, x, bucket=64,
                                out_dim=int(self._n_classes))

    def warmup(self) -> None:
        """One zero query through the bucketed serving path."""
        if self._params is None or self._image_shape is None:
            return
        self.predict([np.zeros(list(self._image_shape), np.uint8)])

    def dump_parameters(self) -> Dict[str, Any]:
        """``{"params": f32 numpy tree, "meta": {...}}`` — the JAX
        template's format, loadable by either template."""
        if self._params is None:
            raise RuntimeError("model is not trained")
        return {
            "params": f32_tree(self._params),
            "meta": {"n_classes": self._n_classes,
                     "image_shape": list(self._image_shape or []),
                     # the input normalization the params were trained
                     # under; a re-dumped v1 load stays v1
                     "prep_version": self._prep_version},
        }

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._n_classes = int(params["meta"]["n_classes"])
        self._image_shape = list(params["meta"]["image_shape"])
        self._prep_version = int(params["meta"].get("prep_version", 1))
        self._params = f32_tree(params["params"])
        self._net = None
