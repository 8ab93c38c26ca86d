"""Shared template body for the BatchNorm CNN families (ResNet / VGG /
DenseNet).

Ports ``BatchNormCNNTemplate`` of ``rafiki_tpu/models/_cnn_base.py``, the
whole contract: ``gang_epochs``, ``_prep``, ``train``, ``evaluate``,
``predict``, ``warmup``, ``_predict_probs`` (``bucketed_forward`` at
bucket 64), ``dump_parameters`` and ``load_parameters``. Each family
contributes its module (``_module``) and knob config.

- The recipe is JAX's: SGD-Nesterov (momentum 0.9) with decay on every
  leaf but biases and BatchNorm scales, under a cosine over
  ``epochs × steps_per_epoch`` (``model/optim.sgd_nesterov``), the
  masked-mean f32 cross-entropy, bf16 compute by knob with f32 params
  and BatchNorm stats, per-epoch checkpoints and ``should_continue``,
  ``share_params`` warm starts from a blob of the same shapes.
- ``train`` streams the archive (``data/stream.py``, worker-thread
  decode with flip + crop augmentation) when it is streamable and
  ``should_stream`` says so, as JAX's does; else it loads it whole.
- The blob is flax's: ``{"params", "batch_stats", "meta"}`` with HWIO
  kernels and flax's auto-names (``store/params.cnn_params_*``), so a
  JAX-trained blob serves here and the reverse.
- The JAX template trains data-parallel over a TPU sub-mesh and rounds
  the batch down to a multiple of its devices; the port trains on its
  one device with the whole batch, so the batch statistics are JAX's
  global ones.
- ``_prep`` scales by 1/255 with no centering, as JAX's
  ``astype(float32) / 255``. A uint8 batch stays uint8 on the host and is
  divided on the device, by a divisor on the device so that it is a true
  f32 division there too (a host scalar divisor becomes a product with
  its reciprocal on CUDA): the same values with a quarter of the bytes
  copied. Any other dtype (a JSON query's floats, a float ``.npz``) is
  divided on the host exactly as JAX does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.data.dataset import load_image_classification_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.data.stream import StreamingImageDataset, \
    should_stream
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.loop import epoch_count, fit, masked_ce
from rafiki_tpu_torch.model.optim import sgd_nesterov
from rafiki_tpu_torch.model.template_utils import (bucketed_forward,
                                                   conform_images,
                                                   same_tree_shapes)
from rafiki_tpu_torch.store.params import (cnn_params_from_jax,
                                           cnn_params_to_jax, f32_tree)
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device


class BatchNormCNNTemplate:
    """Image-classification template over a port module with BatchNorm
    buffers. Subclasses implement ``get_knob_config`` and ``_module``;
    ``device=None`` is the CUDA card."""

    TASKS = (TaskType.IMAGE_CLASSIFICATION,)

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.device = resolve_device(device)
        self.knobs: Dict[str, Any] = dict(knobs)
        #: ``{"params", "batch_stats"}``: f32 numpy trees, flax's layout
        self._vars: Optional[Dict[str, Any]] = None
        self._n_classes: Optional[int] = None
        self._image_shape: Optional[Sequence[int]] = None
        self._net: Optional[nn.Module] = None  # the serving module

    @classmethod
    def validate_knobs(cls, knobs: Dict[str, Any]) -> None:
        validate_template_knobs(cls, knobs)

    # ---- family-specific ----
    def _module(self) -> nn.Module:
        """A freshly initialized module (seed 0) on ``self.device`` for
        these knobs, ``self._n_classes`` and ``self._image_shape``."""
        raise NotImplementedError

    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.knobs.get("bf16", True) \
            else torch.float32

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(0)

    @classmethod
    def gang_epochs(cls, knobs: Dict[str, Any],
                    budget_scale: float) -> int:
        """Epoch count ``train()`` spends (:func:`epoch_count`)."""
        return epoch_count(knobs, budget_scale)

    # ---- shared internals ----
    def _prep(self, images: np.ndarray) -> np.ndarray:
        """Images with a channel dim, conformed to the train-time shape
        (the stem's channel count is fixed at train time): uint8 as they
        are, anything else as f32 divided by 255."""
        x = np.asarray(images)
        if x.dtype != np.uint8:
            x = x.astype(np.float32) / 255.0
        if x.ndim == 3:
            x = x[..., None]
        return conform_images(x, self._image_shape)

    def _device_images(self, x: np.ndarray) -> torch.Tensor:
        """A prepped batch on the device as f32 in the pixels' scale
        (NHWC; the modules lay it out channels-last)."""
        t = torch.from_numpy(x).to(self.device)
        if t.dtype != torch.uint8:
            return t
        return t.float() / torch.full((), 255.0, device=t.device)

    def _serving_net(self) -> nn.Module:
        if self._vars is None:
            raise RuntimeError("model is not trained/loaded")
        if self._net is None:
            net = self._module()
            net.load_state_dict(cnn_params_from_jax(self._vars))
            self._net = net.eval().requires_grad_(False)
        return self._net

    # ---- contract ----
    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        stream = (StreamingImageDataset.is_streamable(dataset_path)
                  and should_stream(dataset_path))
        if stream:
            sds = StreamingImageDataset(dataset_path)
            self._n_classes = sds.n_classes
            self._image_shape = list(sds.image_shape)
            n_samples = sds.n
        else:
            ds = load_image_classification_dataset(dataset_path)
            self._n_classes = ds.n_classes
            self._image_shape = list(ds.image_shape)
            x = self._prep(ds.images)
            y = ds.labels
            n_samples = len(x)

        model = self._module()
        batch_size = int(self.knobs["batch_size"])
        variables = self._vars
        if variables is None:
            variables = cnn_params_to_jax(model.state_dict())
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            shared = ctx.shared_params.get("params")
            if shared is not None and same_tree_shapes(variables["params"],
                                                       shared):
                variables = {
                    "params": shared,
                    "batch_stats": ctx.shared_params.get(
                        "batch_stats", variables["batch_stats"])}
        model.load_state_dict(cnn_params_from_jax(variables))
        self._vars, self._net = None, None
        model.train()

        def objective(m, b):
            xb = self._device_images(b["x"])
            yb = torch.from_numpy(b["y"]).to(self.device)
            mask = torch.from_numpy(b["mask"]).to(self.device).float()
            return masked_ce(m(xb), yb, mask)

        def epoch_batches(epoch: int):
            if stream:
                # decode/augment on worker threads, prep per batch: host
                # memory stays constant in the dataset's size
                for b in sds.iter_batches(batch_size, epoch=epoch,
                                          shuffle=True, seed=0,
                                          augment=True):
                    yield {"x": self._prep(b["x"]), "y": b["y"],
                           "mask": b["mask"]}
            else:
                yield from batch_iterator({"x": x, "y": y}, batch_size,
                                          seed=epoch)

        def snapshot():
            self._vars = cnn_params_to_jax(model.state_dict())
            return self.dump_parameters

        fit(model, objective, epoch_batches,
            self.gang_epochs(self.knobs, ctx.budget_scale),
            max(1, -(-n_samples // batch_size)), self.knobs, ctx, snapshot,
            make_optimizer=lambda total: sgd_nesterov(
                model.named_parameters(),
                float(self.knobs["learning_rate"]), total,
                float(self.knobs["weight_decay"])))
        self._vars = cnn_params_to_jax(model.state_dict())
        self._net = model.eval().requires_grad_(False)

    def evaluate(self, dataset_path: str) -> float:
        ds = load_image_classification_dataset(dataset_path)
        probs = self._predict_probs(self._prep(ds.images))
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        x = self._prep(np.stack([np.asarray(q) for q in queries]))
        return [p.tolist() for p in self._predict_probs(x)]

    def warmup(self) -> None:
        """One zero query through the bucketed serving path."""
        if self._vars is None or self._image_shape is None:
            return
        self.predict([np.zeros(list(self._image_shape), np.uint8)])

    def _predict_probs(self, x: np.ndarray) -> np.ndarray:
        """f32 softmax probabilities, in buckets of 64 images."""
        net = self._serving_net()

        def forward(xb: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                logits = net(self._device_images(xb))
                return torch.softmax(logits.float(), -1).cpu().numpy()

        return bucketed_forward(forward, x, bucket=64,
                                out_dim=int(self._n_classes))

    def dump_parameters(self) -> Dict[str, Any]:
        if self._vars is None:
            raise RuntimeError("model is not trained")
        return {
            "params": f32_tree(self._vars["params"]),
            "batch_stats": f32_tree(self._vars["batch_stats"]),
            "meta": {"n_classes": self._n_classes,
                     "image_shape": list(self._image_shape or [])},
        }

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._n_classes = int(params["meta"]["n_classes"])
        self._image_shape = list(params["meta"]["image_shape"])
        self._vars = {"params": f32_tree(params["params"]),
                      "batch_stats": f32_tree(params["batch_stats"])}
        self._net = None
