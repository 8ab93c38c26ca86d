"""VGG-style CNN family (VGG-BN with a global-average-pool head).

Ports ``rafiki_tpu/models/vgg.py``: ``VARIANTS`` (vgg11/13/16: convs per
stage), ``VGG`` and the ``VGGClassifier`` template (knobs knob for knob;
the recipe is ``models/_cnn_base.py``'s). Each stage is 3×3 SAME convs,
each followed by BatchNorm and relu, then a 2×2 / 2 VALID max-pool while
the map is at least 2 pixels on each side; the channels double per stage
from ``width`` up to 8×. The layers are flax's auto-named ``Conv_k`` and
``BatchNorm_k`` (counted over the whole network) and ``head``
(``models/layers.py``).
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

#: convs per stage (each stage ends in a 2×2 max-pool)
VARIANTS: Dict[str, Sequence[int]] = {
    "vgg11": (1, 1, 2, 2, 2),
    "vgg13": (2, 2, 2, 2, 2),
    "vgg16": (2, 2, 3, 3, 3),
}


class VGG(nn.Module):
    """Conv stacks over (B, H, W, C) float images; a logits head on the
    global average pool. ``dtype``, ``device`` and ``generator`` as for
    ``ResNet``."""

    def __init__(self, stage_sizes: Sequence[int], width: int,
                 n_classes: int, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        self.dtype = dtype
        self.stages = []  # per stage, the indices of its convs
        cin, k = in_channels, 0
        for stage, n_convs in enumerate(stage_sizes):
            ch = min(width * (2 ** stage), width * 8)
            self.stages.append(list(range(k, k + n_convs)))
            for _ in range(n_convs):
                self.add_module(f"Conv_{k}", Conv(cin, ch, (3, 3), (1, 1),
                                                  dtype, device, gen))
                self.add_module(f"BatchNorm_{k}", BatchNorm(ch, dtype,
                                                            device))
                cin, k = ch, k + 1
        self.head = Dense(cin, n_classes, torch.float32, device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for convs in self.stages:
            for k in convs:
                x = F.relu(getattr(self, f"BatchNorm_{k}")(
                    getattr(self, f"Conv_{k}")(x)))
            if min(x.shape[2], x.shape[3]) >= 2:  # never pool below 1px
                x = F.max_pool2d(x, 2, 2)
        return self.head(global_avg_pool(x))


class VGGClassifier(BatchNormCNNTemplate):
    """VGG template: image classification, SGD-Nesterov with cosine
    decay (the shared BatchNorm-CNN recipe, ``models/_cnn_base.py``)."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(5),
            "variant": CategoricalKnob(list(VARIANTS),
                                       shape_relevant=True),
            "width_mult": CategoricalKnob([0.25, 0.5, 1.0],
                                          shape_relevant=True),
            "learning_rate": FloatKnob(1e-3, 1.0, is_exp=True),
            "weight_decay": FloatKnob(1e-5, 1e-2, is_exp=True),
            "batch_size": CategoricalKnob([32, 64, 128, 256],
                                          shape_relevant=True),
            "bf16": CategoricalKnob([True, False]),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "share_params": PolicyKnob("SHARE_PARAMS"),
        }

    def _module(self) -> VGG:
        assert self._n_classes is not None and self._image_shape is not None
        width = max(8, int(64 * float(self.knobs["width_mult"])))
        return VGG(stage_sizes=VARIANTS[str(self.knobs["variant"])],
                   width=width, n_classes=int(self._n_classes),
                   dtype=self._dtype(),
                   in_channels=int(self._image_shape[2]),
                   device=self.device, generator=self._generator())
