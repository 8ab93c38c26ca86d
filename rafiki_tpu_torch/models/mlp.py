"""JaxFeedForward: the ``TfFeedForward``-equivalent template (BASELINE
config #1, FashionMNIST).

Ports ``rafiki_tpu/models/mlp.py``: ``_MLP`` (flatten, ``Dense_k`` + relu
per hidden layer, then the logits ``Dense``; flax's auto-names and
(d_in, features) kernels, ``models/layers.py``) and the
``JaxFeedForward`` template, under the name users type:
``get_knob_config`` knob for knob, ``gang_epochs``, ``train``,
``evaluate``, ``predict``, ``_predict_probs`` (buckets of 256),
``warmup``, ``dump_parameters`` and ``load_parameters``. Training is
JAX's: pixels / 255, batches from ``batch_iterator(seed=epoch)``, the
masked mean cross-entropy, ``optax.scale_by_adam()`` then ``−lr``
(``model/optim.adam``), the mean loss per epoch, checkpoints and
``should_continue``; a loaded blob or a ``share_params`` donor of the
same shapes warm-starts the weights with a fresh optimizer state.

The JAX template also has a gang spec (``make_gang_spec``): the port has
no gang engine, so ``gang_size >= 1`` is refused by name
(``GANG_SPEC_NOT_PORTED``, ``model/dev.py`` ``check_gang_size``);
sequential trials run.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.data.dataset import load_image_classification_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, IntegerKnob, KnobConfig,
                                         PolicyKnob)
from rafiki_tpu_torch.model.loop import fit, masked_ce
from rafiki_tpu_torch.model.optim import adam
from rafiki_tpu_torch.model.template_utils import (bucketed_forward,
                                                   conform_images,
                                                   same_tree_shapes)
from rafiki_tpu_torch.models.layers import Dense
from rafiki_tpu_torch.store.params import f32_tree, params_from_jax, \
    params_to_jax
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device


class _MLP(nn.Module):
    def __init__(self, d_in: int, hidden_layer_count: int,
                 hidden_layer_units: int, n_classes: int,
                 device: torch.device, gen: torch.Generator) -> None:
        super().__init__()
        self.n_hidden = int(hidden_layer_count)
        for k in range(self.n_hidden):
            self.add_module(f"Dense_{k}", Dense(d_in, hidden_layer_units,
                                                None, device, gen))
            d_in = hidden_layer_units
        self.add_module(f"Dense_{self.n_hidden}",
                        Dense(d_in, n_classes, None, device, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for k in range(self.n_hidden):
            x = F.relu(getattr(self, f"Dense_{k}")(x))
        return getattr(self, f"Dense_{self.n_hidden}")(x)


class JaxFeedForward:
    """Dense image classifier (FashionMNIST-class workloads);
    ``device=None`` is the CUDA card."""

    TASKS = (TaskType.IMAGE_CLASSIFICATION,)
    #: the JAX template has a gang spec; ``gang_size >= 1`` is refused
    GANG_SPEC_NOT_PORTED = True

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(5),
            "hidden_layer_count": IntegerKnob(1, 3, shape_relevant=True),
            "hidden_layer_units": IntegerKnob(16, 256, is_exp=True,
                                              shape_relevant=True),
            "learning_rate": FloatKnob(1e-4, 1e-1, is_exp=True,
                                       traceable=True),
            "batch_size": CategoricalKnob([32, 64, 128],
                                          shape_relevant=True),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "share_params": PolicyKnob("SHARE_PARAMS"),
        }

    @classmethod
    def validate_knobs(cls, knobs: Dict[str, Any]) -> None:
        validate_template_knobs(cls, knobs)

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.device = resolve_device(device)
        self.knobs: Dict[str, Any] = dict(knobs)
        self._params: Optional[Dict[str, Any]] = None  # flax's tree
        self._n_classes: Optional[int] = None
        self._image_shape: Optional[Sequence[int]] = None
        self._net: Optional[_MLP] = None

    # ---- internals ----
    def _module(self) -> _MLP:
        """A freshly initialized ``_MLP`` (seed 0) over the train-time
        image shape."""
        assert self._n_classes is not None and self._image_shape is not None
        return _MLP(int(np.prod(self._image_shape)),
                    int(self.knobs["hidden_layer_count"]),
                    int(self.knobs["hidden_layer_units"]),
                    int(self._n_classes), self.device,
                    torch.Generator(device=self.device).manual_seed(0))

    @staticmethod
    def _to_float(images: np.ndarray) -> np.ndarray:
        return images.astype(np.float32) / 255.0

    @classmethod
    def gang_epochs(cls, knobs: Dict[str, Any], budget_scale: float) -> int:
        """Epoch count ``train()`` spends: ``max_epochs`` scaled by the
        budget, at least 1 (no ``quick_train`` cap, as in JAX)."""
        return max(1, round(int(knobs["max_epochs"]) * float(budget_scale)))

    def _serving_net(self) -> _MLP:
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
        ctx = ctx or TrainContext()
        ds = load_image_classification_dataset(dataset_path)
        self._n_classes = ds.n_classes
        self._image_shape = list(ds.image_shape)
        x = self._to_float(ds.images)
        y = ds.labels
        model = self._module()
        params = self._params
        if params is None:
            params = params_to_jax(model.state_dict())
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            shared = ctx.shared_params.get("params")
            if shared is not None and same_tree_shapes(params, shared):
                params = shared
            # else: incompatible architecture → cold start
        model.load_state_dict(params_from_jax(params))
        self._params, self._net = None, None
        batch_size = int(self.knobs["batch_size"])

        def objective(m, b):
            xb = torch.from_numpy(b["x"]).to(self.device)
            yb = torch.from_numpy(b["y"]).to(self.device)
            mask = torch.from_numpy(b["mask"]).to(self.device).float()
            return masked_ce(m(xb), yb, mask)

        def snapshot():
            self._params = params_to_jax(model.state_dict())
            return self.dump_parameters

        fit(model, objective,
            lambda epoch: batch_iterator({"x": x, "y": y}, batch_size,
                                         seed=epoch),
            self.gang_epochs(self.knobs, ctx.budget_scale),
            max(1, -(-len(x) // batch_size)), self.knobs, ctx, snapshot,
            make_optimizer=lambda total: adam(
                model.parameters(), float(self.knobs["learning_rate"])))
        self._params = params_to_jax(model.state_dict())
        self._net = model.requires_grad_(False)

    def evaluate(self, dataset_path: str) -> float:
        ds = load_image_classification_dataset(dataset_path)
        x = conform_images(self._to_float(ds.images), self._image_shape)
        probs = self._predict_probs(x)
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        x = self._to_float(np.stack([np.asarray(q) for q in queries]))
        if x.ndim == 3:
            x = x[..., None]
        # the flatten → Dense input width is fixed at train time
        x = conform_images(x, self._image_shape)
        return [p.tolist() for p in self._predict_probs(x)]

    def _predict_probs(self, x: np.ndarray) -> np.ndarray:
        """f32 softmax probabilities, in buckets of 256 rows."""
        net = self._serving_net()

        def forward(xb: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                logits = net(torch.from_numpy(xb).to(self.device))
                return torch.softmax(logits, -1).cpu().numpy()

        return bucketed_forward(forward, x, bucket=256,
                                out_dim=int(self._n_classes))

    def warmup(self) -> None:
        """One zero query through the bucketed serving path."""
        if self._params is None or self._image_shape is None:
            return
        self.predict([np.zeros(list(self._image_shape), np.uint8)])

    def dump_parameters(self) -> Dict[str, Any]:
        if self._params is None:
            raise RuntimeError("model is not trained")
        return {
            "params": f32_tree(self._params),
            "meta": {"n_classes": self._n_classes,
                     "image_shape": list(self._image_shape or [])},
        }

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._n_classes = int(params["meta"]["n_classes"])
        self._image_shape = list(params["meta"]["image_shape"])
        self._params = f32_tree(params["params"])
        self._net = None
