"""JaxFeedForward: the ``TfFeedForward``-equivalent template (BASELINE
config #1, FashionMNIST).

Ports ``rafiki_tpu/models/mlp.py``: ``_MLP`` (flatten, ``Dense_k`` + relu
per hidden layer, then the logits ``Dense``; flax's auto-names and
(d_in, features) kernels, ``models/layers.py``) and the
``JaxFeedForward`` template, under the name users type:
``get_knob_config`` knob for knob, ``gang_epochs``, ``_lane_functions``,
``make_gang_spec``, ``train``, ``evaluate``, ``predict``,
``_predict_probs`` (buckets of 256), ``warmup``, ``dump_parameters`` and
``load_parameters``. Training is JAX's: pixels / 255, batches from
``batch_iterator(seed=epoch)``, the masked mean cross-entropy,
``optax.scale_by_adam()`` then ``−lr`` (``model/optim.lane_adam_step``),
the mean loss per epoch, checkpoints and ``should_continue``; a loaded
blob or a ``share_params`` donor of the same shapes warm-starts the
weights with a fresh optimizer state.

As in JAX, the functional lane step (``_lane_functions``) backs both the
sequential ``train()`` and the gang engine, so a 1-lane gang is the
sequential trial bit for bit. A gang of K lanes stacks every leaf on a
leading K: each dense layer is one ``torch.bmm`` over (K, B, in) × (K,
in, out), and the Adam update takes ``lr`` as a (K,) tensor.
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
from rafiki_tpu_torch.model.loop import GangSpec, masked_ce, run_epochs
from rafiki_tpu_torch.model.optim import lane_adam_init, lane_adam_step
from rafiki_tpu_torch.model.template_utils import (bucketed_forward,
                                                   conform_images,
                                                   eval_buckets,
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


def _dense_names(n_hidden: int) -> List[str]:
    return [f"Dense_{k}" for k in range(n_hidden + 1)]


def _forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
             n_hidden: int, masks: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """One lane's logits: ``_MLP.forward`` over ``state_dict``-keyed
    leaves (``x @ kernel + bias``, relu between), each hidden layer's
    output times ``masks[k]`` when given (the tabular template's
    dropout)."""
    x = x.reshape(x.shape[0], -1)
    for k, name in enumerate(_dense_names(n_hidden)):
        x = x @ params[f"{name}.kernel"] + params[f"{name}.bias"]
        if k < n_hidden:
            x = F.relu(x)
            if masks is not None:
                x = x * masks[k]
    return x


def _forward_lanes(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   n_hidden: int, masks: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """K lanes' logits: leaves (K, ...), ``x`` (K, B, ...), ``masks``
    (n_hidden, K, B, units) or None; each dense layer one ``bmm`` over
    the lanes."""
    x = x.reshape(x.shape[0], x.shape[1], -1)
    for k, name in enumerate(_dense_names(n_hidden)):
        x = torch.bmm(x, params[f"{name}.kernel"]) \
            + params[f"{name}.bias"][:, None, :]
        if k < n_hidden:
            x = F.relu(x)
            if masks is not None:
                x = x * masks[k]
    return x


def _grad_aliases(params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Leaves that share ``params``' storage and take gradients."""
    return {n: p.detach().requires_grad_(True) for n, p in params.items()}


class JaxFeedForward:
    """Dense image classifier (FashionMNIST-class workloads);
    ``device=None`` is the CUDA card."""

    TASKS = (TaskType.IMAGE_CLASSIFICATION,)

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

    @staticmethod
    def _lane_functions(knobs: Dict[str, Any], d_in: int, n_classes: int,
                        device: torch.device):
        """``(init_lane, train_step, train_lanes)``: the functional core
        the sequential ``train()`` and the gang lanes share. A state is
        ``{"params": {state_dict key: f32 leaf}, "opt": lane Adam}``;
        ``hp["learning_rate"]`` is 0-d for a lane, (K,) for a gang."""
        n_hidden = int(knobs["hidden_layer_count"])
        units = int(knobs["hidden_layer_units"])

        def init_lane(gen: torch.Generator, hp: Dict[str, Any]
                      ) -> Dict[str, Any]:
            net = _MLP(d_in, n_hidden, units, n_classes, device, gen)
            params = {n: p.detach() for n, p in net.state_dict().items()}
            return {"params": params, "opt": lane_adam_init(params)}

        def to_dev(batch: Dict[str, np.ndarray]):
            return (torch.from_numpy(batch["x"]).to(device),
                    torch.from_numpy(batch["y"]).to(device),
                    torch.from_numpy(batch["mask"]).to(device).float())

        def train_step(state, hp, batch):
            xb, yb, mask = to_dev(batch)
            params = _grad_aliases(state["params"])
            loss = masked_ce(_forward(params, xb, n_hidden), yb, mask)
            grads = torch.autograd.grad(loss, list(params.values()))
            lane_adam_step(state["params"], dict(zip(params, grads)),
                           state["opt"], hp["learning_rate"])
            return state, loss.detach()

        def train_lanes(state, hp, batch):
            xb, yb, mask = to_dev(batch)
            params = _grad_aliases(state["params"])
            logits = _forward_lanes(params, xb, n_hidden).float()
            k, b = yb.shape
            losses = F.cross_entropy(logits.reshape(k * b, -1),
                                     yb.reshape(-1).long(),
                                     reduction="none").reshape(k, b)
            lane_loss = (losses * mask).sum(1) / mask.sum(1).clamp(min=1.0)
            grads = torch.autograd.grad(lane_loss.sum(),
                                        list(params.values()))
            lane_adam_step(state["params"], dict(zip(params, grads)),
                           state["opt"], hp["learning_rate"])
            return state, lane_loss.detach()

        return init_lane, train_step, train_lanes

    @classmethod
    def make_gang_spec(cls, knobs: Dict[str, Any], train_dataset_path: str,
                       val_dataset_path: str,
                       device: DeviceLike = None) -> GangSpec:
        """The gang engine's recipe for this static bucket: everything
        but ``learning_rate`` (the traceable knob) burned in from
        ``knobs``; the lanes train on ``device`` (None: the CUDA
        card)."""
        dev = resolve_device(device)
        ds = load_image_classification_dataset(train_dataset_path)
        x = cls._to_float(ds.images)
        y = ds.labels
        n_hidden = int(knobs["hidden_layer_count"])
        batch_size = int(knobs["batch_size"])
        init_lane, train_step, train_lanes = cls._lane_functions(
            knobs, int(np.prod(ds.image_shape)), ds.n_classes, dev)
        vds = load_image_classification_dataset(val_dataset_path)
        vx = conform_images(cls._to_float(vds.images), ds.image_shape)
        vy = vds.labels
        meta = {"n_classes": ds.n_classes,
                "image_shape": list(ds.image_shape)}

        def epoch_batches(epoch: int):
            return batch_iterator({"x": x, "y": y}, batch_size, seed=epoch)

        def eval_lane(state, hp, xb):
            # argmax(logits) == argmax(softmax(logits)): evaluate()'s
            # accuracy, on the same 256-row buckets
            with torch.no_grad():
                return _forward(state["params"],
                                torch.from_numpy(xb).to(dev),
                                n_hidden).argmax(-1)

        def eval_lanes(state, hp, xb):
            k = int(hp["learning_rate"].shape[0])
            xk = torch.from_numpy(xb).to(dev).expand(k, *xb.shape)
            with torch.no_grad():
                return _forward_lanes(state["params"], xk,
                                      n_hidden).argmax(-1)

        def eval_batches():
            return eval_buckets(vx, vy)

        def export_blob(lane_state, hp):
            return {"params": params_to_jax(
                        {n: t.detach().clone()
                         for n, t in lane_state["params"].items()}),
                    "meta": dict(meta)}

        def warm_lane(fresh, blob):
            shared = (blob or {}).get("params")
            shapes = params_to_jax({n: torch.empty(t.shape) for n, t in
                                    fresh["params"].items()})
            if shared is None or not same_tree_shapes(shapes, shared):
                return fresh  # incompatible architecture → cold start
            return {"params": {n: t.to(dev, copy=True) for n, t in
                               params_from_jax(shared).items()},
                    "opt": fresh["opt"]}

        return GangSpec(hp_names=("learning_rate",), init_lane=init_lane,
                        train_step=train_step, train_lanes=train_lanes,
                        epoch_batches=epoch_batches, eval_lane=eval_lane,
                        eval_lanes=eval_lanes, eval_batches=eval_batches,
                        export_blob=export_blob, warm_lane=warm_lane,
                        share_params_knob="share_params")

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
        init_lane, train_step, _ = self._lane_functions(
            self.knobs, int(np.prod(self._image_shape)), ds.n_classes,
            self.device)
        hp = {"learning_rate": torch.tensor(
            float(self.knobs["learning_rate"]), dtype=torch.float32,
            device=self.device)}
        state = init_lane(
            torch.Generator(device=self.device).manual_seed(0), hp)
        params = self._params  # warm-started via load_parameters
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            shared = ctx.shared_params.get("params")
            if shared is not None and same_tree_shapes(
                    params_to_jax(state["params"]), shared):
                params = shared
            # else: incompatible architecture → cold start
        if params is not None:  # a copy: the donor blob stays as it is
            state["params"] = {n: t.to(self.device, copy=True) for n, t in
                               params_from_jax(params).items()}
        self._params, self._net = None, None
        batch_size = int(self.knobs["batch_size"])
        epochs = self.gang_epochs(self.knobs, ctx.budget_scale)

        def step(state, batch):
            # a named range in a torch.profiler trace (profile_dir)
            with torch.profiler.record_function("fit.step"):
                return train_step(state, hp, batch)

        def checkpoint(state, frac_done):
            self._params = params_to_jax(state["params"])
            ctx.checkpoint(self.dump_parameters, frac_done=frac_done)

        state = run_epochs(
            step, state, lambda epoch: batch_iterator(
                {"x": x, "y": y}, batch_size, seed=epoch),
            epochs, ctx, checkpoint)
        self._params = params_to_jax(state["params"])
        self._net = None

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
