"""DenseNet-style CNN family (DenseNet-BC shape).

Ports ``rafiki_tpu/models/densenet.py``: ``VARIANTS`` (layers per dense
block), ``_DenseLayer``, ``DenseNet`` and the ``DenseNetClassifier``
template (knobs knob for knob; the recipe is ``models/_cnn_base.py``'s).
Each dense layer is BN-relu-1×1 (4k) then BN-relu-3×3 (k), concatenated
onto its input; between blocks a transition is BN-relu, a 1×1
compression to ``max(k, C // 2)`` channels and a 2×2 / 2 VALID average
pool while the map is at least 2 pixels on each side; the head is
BN-relu, the global average pool and ``head``. Names are flax's
(``models/layers.py``): ``stem``; ``_DenseLayer_k`` counted over the
network, each with ``BatchNorm_0/1`` and ``Conv_0/1``; the transitions'
and the final ``BatchNorm_k`` / ``Conv_k`` in creation order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, KnobConfig, PolicyKnob)
from rafiki_tpu_torch.models._cnn_base import BatchNormCNNTemplate
from rafiki_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                            global_avg_pool)
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

#: layers per dense block
VARIANTS: Dict[str, Sequence[int]] = {
    "densenet-s": (2, 4, 4),
    "densenet-m": (4, 8, 8),
}


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator) -> None:
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin, dtype, device)
        self.Conv_0 = Conv(cin, 4 * growth, (1, 1), (1, 1), dtype, device,
                           gen)
        self.BatchNorm_1 = BatchNorm(4 * growth, dtype, device)
        self.Conv_1 = Conv(4 * growth, growth, (3, 3), (1, 1), dtype,
                           device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y)))
        return torch.cat([x, y], dim=1)  # dense connectivity


class DenseNet(nn.Module):
    """Dense blocks + compression transitions over (B, H, W, C) float
    images. ``dtype``, ``device`` and ``generator`` as for ``ResNet``."""

    def __init__(self, block_sizes: Sequence[int], growth: int,
                 n_classes: int, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        self.dtype = dtype
        c = 2 * growth
        self.stem = Conv(in_channels, c, (3, 3), (1, 1), dtype, device, gen)
        self.layers = []  # ("dense", k) and ("transition", k), in order
        n_dense = 0
        for b, n_layers in enumerate(block_sizes):
            for _ in range(n_layers):
                self.add_module(f"_DenseLayer_{n_dense}", _DenseLayer(
                    c, growth, dtype, device, gen))
                self.layers.append(("dense", n_dense))
                n_dense, c = n_dense + 1, c + growth
            if b < len(block_sizes) - 1:
                out = max(growth, c // 2)
                self.add_module(f"BatchNorm_{b}", BatchNorm(c, dtype,
                                                            device))
                self.add_module(f"Conv_{b}", Conv(c, out, (1, 1), (1, 1),
                                                  dtype, device, gen))
                self.layers.append(("transition", b))
                c = out
        self.final_bn = f"BatchNorm_{len(block_sizes) - 1}"
        self.add_module(self.final_bn, BatchNorm(c, dtype, device))
        self.head = Dense(c, n_classes, torch.float32, device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.stem(x)
        for kind, k in self.layers:
            if kind == "dense":
                x = getattr(self, f"_DenseLayer_{k}")(x)
                continue
            # transition: BN-relu, 1x1 compression 0.5, 2x2 avg-pool
            x = F.relu(getattr(self, f"BatchNorm_{k}")(x))
            x = getattr(self, f"Conv_{k}")(x)
            if min(x.shape[2], x.shape[3]) >= 2:
                x = F.avg_pool2d(x, 2, 2)
        x = F.relu(getattr(self, self.final_bn)(x))
        return self.head(global_avg_pool(x))


class DenseNetClassifier(BatchNormCNNTemplate):
    """DenseNet template: image classification, SGD-Nesterov with cosine
    decay (the shared BatchNorm-CNN recipe, ``models/_cnn_base.py``)."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(5),
            "variant": CategoricalKnob(list(VARIANTS),
                                       shape_relevant=True),
            "growth": CategoricalKnob([8, 12, 24], shape_relevant=True),
            "learning_rate": FloatKnob(1e-3, 1.0, is_exp=True),
            "weight_decay": FloatKnob(1e-5, 1e-2, is_exp=True),
            "batch_size": CategoricalKnob([32, 64, 128, 256],
                                          shape_relevant=True),
            "bf16": CategoricalKnob([True, False]),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "share_params": PolicyKnob("SHARE_PARAMS"),
        }

    def _module(self) -> DenseNet:
        assert self._n_classes is not None and self._image_shape is not None
        return DenseNet(block_sizes=VARIANTS[str(self.knobs["variant"])],
                        growth=int(self.knobs["growth"]),
                        n_classes=int(self._n_classes), dtype=self._dtype(),
                        in_channels=int(self._image_shape[2]),
                        device=self.device, generator=self._generator())
