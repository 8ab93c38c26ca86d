"""ResNet: the BOHB-search workhorse family (BASELINE config #2).

Ports ``rafiki_tpu/models/resnet.py``: ``VARIANTS`` (resnet18/34/50/101),
``_Block`` (3×3 ×2), ``_Bottleneck`` (1×1 → 3×3 → 1×1, 4× expansion,
the stride on the 3×3: the "v1.5" placement), ``ResNet`` and the
``ResNetClassifier`` template (knobs knob for knob; the recipe is
``models/_cnn_base.py``'s).

The layers are ``models/layers.py``'s flax counterparts with flax's names
(``stem``, ``stem_bn``, ``stage{i}_block{j}`` with ``Conv_k`` /
``BatchNorm_k`` / ``shortcut`` / ``shortcut_bn``, ``head``). The last
BatchNorm of each block starts at scale 0 (the residual branch starts as
the identity). Inputs with ``min(H, W) < 64`` take a 3×3 / 1 stem with no
pool; larger ones the 7×7 / 2 stem and a 3×3 / 2 SAME max-pool, both
padded as XLA pads them. The convolutions, pools and the head run on
cuDNN and cuBLAS as in JAX they run on XLA: no Pallas kernel lies on this
path, so the port has no kernel of its own here either.

Where flax infers a block's input channels and whether it needs a
projection shortcut from the first input, the port's modules take
``in_channels`` and build the shortcut when the stride or the channel
count changes (in every ``VARIANTS`` network that is exactly when flax's
shapes differ).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, KnobConfig, PolicyKnob)
from rafiki_tpu_torch.models._cnn_base import BatchNormCNNTemplate
from rafiki_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                            global_avg_pool, max_pool_same)
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

#: variant name -> (stage sizes, use bottleneck blocks)
VARIANTS: Dict[str, Tuple[Tuple[int, ...], bool]] = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
}


class _Block(nn.Module):
    """Basic residual block: 3×3 conv ×2."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int,
                 dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        s = (strides, strides)
        self.Conv_0 = Conv(cin, filters, (3, 3), s, dtype, device, gen)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, (3, 3), (1, 1), dtype, device,
                           gen)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device, scale_init=0.0)
        if strides != 1 or cin != filters:
            self.shortcut = Conv(cin, filters, (1, 1), s, dtype, device, gen)
            self.shortcut_bn = BatchNorm(filters, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if hasattr(self, "shortcut"):
            residual = self.shortcut_bn(self.shortcut(x))
        return F.relu(residual + y)


class _Bottleneck(nn.Module):
    """Bottleneck residual block: 1×1 → 3×3 → 1×1 (4× expansion)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int,
                 dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        s = (strides, strides)
        out = filters * 4
        self.Conv_0 = Conv(cin, filters, (1, 1), (1, 1), dtype, device, gen)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, (3, 3), s, dtype, device, gen)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device)
        self.Conv_2 = Conv(filters, out, (1, 1), (1, 1), dtype, device, gen)
        self.BatchNorm_2 = BatchNorm(out, dtype, device, scale_init=0.0)
        if strides != 1 or cin != out:
            self.shortcut = Conv(cin, out, (1, 1), s, dtype, device, gen)
            self.shortcut_bn = BatchNorm(out, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if hasattr(self, "shortcut"):
            residual = self.shortcut_bn(self.shortcut(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet over (B, H, W, C) float images; ``resnet50`` is
    ``stage_sizes`` (3, 4, 6, 3), ``bottleneck=True``, ``width`` 64.
    ``dtype`` is the compute dtype (params and BatchNorm stats stay f32;
    the head runs in f32). Weights are drawn from ``generator`` (a fresh
    one seeded 0 when None) on ``device`` (None: the CUDA card)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = True, width: int = 64,
                 n_classes: int = 1000, small_inputs: bool = False,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        self.dtype = dtype
        self.small_inputs = bool(small_inputs)
        if self.small_inputs:
            self.stem = Conv(in_channels, width, (3, 3), (1, 1), dtype,
                             device, gen)
        else:
            self.stem = Conv(in_channels, width, (7, 7), (2, 2), dtype,
                             device, gen)
        self.stem_bn = BatchNorm(width, dtype, device)
        block = _Bottleneck if bottleneck else _Block
        cin = width
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            filters = width * (2 ** i)
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                name = f"stage{i}_block{j}"
                self.add_module(name, block(cin, filters, strides, dtype,
                                            device, gen))
                self.blocks.append(name)
                cin = filters * block.expansion
        self.head = Dense(cin, n_classes, torch.float32, device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC in, NCHW views over channels-last memory from here on
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_bn(self.stem(x)))
        if not self.small_inputs:
            x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(global_avg_pool(x))


class ResNetClassifier(BatchNormCNNTemplate):
    """ResNet template: image classification, SGD-Nesterov with cosine
    decay (the shared BatchNorm-CNN recipe, ``models/_cnn_base.py``)."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(5),
            "variant": CategoricalKnob(list(VARIANTS),
                                       shape_relevant=True),
            "width_mult": CategoricalKnob([0.25, 0.5, 1.0],
                                          shape_relevant=True),
            "learning_rate": FloatKnob(1e-3, 1.0, is_exp=True,
                                       traceable=True),
            "weight_decay": FloatKnob(1e-5, 1e-2, is_exp=True,
                                      traceable=True),
            "batch_size": CategoricalKnob([32, 64, 128, 256],
                                          shape_relevant=True),
            "bf16": CategoricalKnob([True, False]),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "share_params": PolicyKnob("SHARE_PARAMS"),
        }

    def _module(self) -> ResNet:
        assert self._n_classes is not None and self._image_shape is not None
        stages, bottleneck = VARIANTS[str(self.knobs["variant"])]
        width = max(8, int(64 * float(self.knobs["width_mult"])))
        small = min(self._image_shape[0], self._image_shape[1]) < 64
        return ResNet(stage_sizes=stages, bottleneck=bottleneck, width=width,
                      n_classes=int(self._n_classes), small_inputs=small,
                      dtype=self._dtype(),
                      in_channels=int(self._image_shape[2]),
                      device=self.device, generator=self._generator())

