"""JaxTabularMLP: the dense classifier over standardized tabular
features, on the card.

Ports ``rafiki_tpu/models/tabular.py``: the ``_Net`` of
``_build_module`` (``Dense_k`` + relu per hidden layer, each times its
inverted-dropout mask, then the logits ``Dense``; flax's auto-names and
(d_in, features) kernels) and the ``JaxTabularMLP`` template under the
name users type: ``get_knob_config`` knob for knob, ``_lane_functions``,
``gang_epochs``, ``_standardize``, ``train``, ``make_gang_spec``,
``_probs`` (buckets of 256), ``evaluate``, ``predict``,
``dump_parameters`` and ``load_parameters``.

Training is JAX's: the train split's per-feature mean and std + 1e-6
(carried in the blob), batches from ``batch_iterator(seed=epoch)``, the
masked mean cross-entropy, ``optax.scale_by_adam()`` then ``−lr``
(``model/optim.lane_adam_step``). Dropout is JAX's explicit inverted
mask with a per-lane keep probability ``1 − dropout``: the lane state
carries its threefry key, ``PRNGKey(1)`` at init, and each step splits
it, splits the step key once per hidden layer and draws
``bernoulli(layer_key, keep, (batch, units)) / keep``
(``utils/threefry.py``), so the masks are JAX's bit for bit and an f32
run follows JAX's losses. A loaded blob or a ``share_params`` donor of
the same shapes warm-starts the weights with a fresh optimizer state and
key.

The functional lane step backs both the sequential ``train()`` and the
gang engine, so a 1-lane gang is the sequential trial bit for bit. A
gang of K lanes stacks every leaf on a leading K: each dense layer is one
``torch.bmm``, the keys split per lane, and ``dropout`` and
``learning_rate`` are (K,) tensors. A refilled or promoted lane restarts
at ``PRNGKey(1)``, as JAX's ``init_lane`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.data.dataset import load_tabular_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, IntegerKnob, KnobConfig,
                                         PolicyKnob)
from rafiki_tpu_torch.model.loop import (GangSpec, epoch_count, masked_ce,
                                         run_epochs)
from rafiki_tpu_torch.model.optim import lane_adam_init, lane_adam_step
from rafiki_tpu_torch.model.template_utils import (bucketed_forward,
                                                   eval_buckets,
                                                   refuse_regression,
                                                   same_tree_shapes)
from rafiki_tpu_torch.models.mlp import (_MLP, _forward, _forward_lanes,
                                         _grad_aliases)
from rafiki_tpu_torch.store.params import f32_tree, params_from_jax, \
    params_to_jax
from rafiki_tpu_torch.utils import threefry
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device


def _drop_masks(key: torch.Tensor, keep: torch.Tensor, n_hidden: int,
                batch: int, units: int):
    """One step's ``(next key, masks)``: JAX's ``split(rng)``, then
    ``split(step_key, max(n_hidden, 1))`` and per hidden layer
    ``bernoulli(layer_key, keep, (batch, units)) / keep``. ``key`` (2,)
    or (K, 2) and ``keep`` 0-d or (K,); the masks (n_hidden, [K,] batch,
    units), all layers drawn in one call."""
    pair = threefry.split(key)
    layer_keys = threefry.split(pair[..., 1, :], max(n_hidden, 1))
    lanes = key.dim() == 2
    # (L, [K,] 2): the layers lead, each a batch of keys
    layer_keys = layer_keys.movedim(-2, 0)[:n_hidden]
    keep_b = keep.float().expand(layer_keys.shape[:-1])
    bits = threefry.bernoulli(layer_keys, keep_b, (batch, units))
    kk = keep.float().reshape((-1, 1, 1) if lanes else ())
    return pair[..., 0, :], bits.float() / kk


class JaxTabularMLP:
    """Dense net over standardized tabular features; ``device=None`` is
    the CUDA card."""

    TASKS = (TaskType.TABULAR_CLASSIFICATION,)

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(10),
            "hidden_layer_count": IntegerKnob(1, 4, shape_relevant=True),
            "hidden_layer_units": IntegerKnob(16, 256, is_exp=True,
                                              shape_relevant=True),
            "dropout": FloatKnob(0.0, 0.5, traceable=True),
            "learning_rate": FloatKnob(1e-4, 1e-1, is_exp=True,
                                       traceable=True),
            "batch_size": CategoricalKnob([64, 128, 256],
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
        self._n_classes: int = 0
        self._mean: Optional[np.ndarray] = None
        self._std: Optional[np.ndarray] = None
        self._net: Optional[_MLP] = None

    # ---- internals ----
    @staticmethod
    def _lane_functions(knobs: Dict[str, Any], n_features: int,
                        n_classes: int, device: torch.device):
        """``(init_lane, train_step, train_lanes)``. A state is
        ``{"params": {state_dict key: f32 leaf}, "opt": lane Adam, "rng":
        int64 threefry key}``; ``hp`` holds ``dropout`` and
        ``learning_rate``, 0-d for a lane, (K,) for a gang."""
        n_hidden = int(knobs["hidden_layer_count"])
        units = int(knobs["hidden_layer_units"])
        batch_size = int(knobs["batch_size"])

        def init_lane(gen: torch.Generator, hp: Dict[str, Any]
                      ) -> Dict[str, Any]:
            net = _MLP(n_features, n_hidden, units, n_classes, device, gen)
            params = {n: p.detach() for n, p in net.state_dict().items()}
            return {"params": params, "opt": lane_adam_init(params),
                    "rng": threefry.prng_key(1, device=device)}

        def to_dev(batch: Dict[str, np.ndarray]):
            return (torch.from_numpy(batch["x"]).to(device),
                    torch.from_numpy(batch["y"]).to(device),
                    torch.from_numpy(batch["mask"]).to(device).float())

        def train_step(state, hp, batch):
            xb, yb, mask = to_dev(batch)
            rng, masks = _drop_masks(state["rng"], 1.0 - hp["dropout"],
                                     n_hidden, batch_size, units)
            params = _grad_aliases(state["params"])
            loss = masked_ce(_forward(params, xb, n_hidden, masks), yb,
                             mask)
            grads = torch.autograd.grad(loss, list(params.values()))
            lane_adam_step(state["params"], dict(zip(params, grads)),
                           state["opt"], hp["learning_rate"])
            return {**state, "rng": rng}, loss.detach()

        def train_lanes(state, hp, batch):
            xb, yb, mask = to_dev(batch)
            rng, masks = _drop_masks(state["rng"], 1.0 - hp["dropout"],
                                     n_hidden, batch_size, units)
            params = _grad_aliases(state["params"])
            logits = _forward_lanes(params, xb, n_hidden, masks)
            k, b = yb.shape
            losses = F.cross_entropy(logits.reshape(k * b, -1),
                                     yb.reshape(-1).long(),
                                     reduction="none").reshape(k, b)
            lane_loss = (losses * mask).sum(1) / mask.sum(1).clamp(min=1.0)
            grads = torch.autograd.grad(lane_loss.sum(),
                                        list(params.values()))
            lane_adam_step(state["params"], dict(zip(params, grads)),
                           state["opt"], hp["learning_rate"])
            return {**state, "rng": rng}, lane_loss.detach()

        return init_lane, train_step, train_lanes

    @classmethod
    def gang_epochs(cls, knobs: Dict[str, Any], budget_scale: float) -> int:
        """``max_epochs`` scaled by the budget, at least 1, at most 2
        under ``quick_train``."""
        return epoch_count(knobs, budget_scale)

    @staticmethod
    def _stats(features: np.ndarray):
        return features.mean(axis=0), features.std(axis=0) + 1e-6

    def _standardize(self, x: np.ndarray) -> np.ndarray:
        assert self._mean is not None and self._std is not None
        return ((x - self._mean) / self._std).astype(np.float32)

    def _hp(self) -> Dict[str, torch.Tensor]:
        return {n: torch.tensor(float(self.knobs.get(n, 0.0)),
                                dtype=torch.float32, device=self.device)
                for n in ("dropout", "learning_rate")}

    # ---- contract ----
    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        ds = load_tabular_dataset(dataset_path)
        refuse_regression("JaxTabularMLP", ds.n_classes)
        self._n_classes = int(ds.n_classes)
        self._mean, self._std = self._stats(ds.features)
        x = self._standardize(ds.features)
        y = ds.labels
        init_lane, train_step, _ = self._lane_functions(
            self.knobs, x.shape[1], self._n_classes, self.device)
        hp = self._hp()
        state = init_lane(
            torch.Generator(device=self.device).manual_seed(0), hp)
        params = self._params  # warm-started via load_parameters
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            shared = ctx.shared_params.get("params")
            if shared is not None and same_tree_shapes(
                    params_to_jax(state["params"]), shared):
                params = shared
        if params is not None:  # a copy: the donor blob stays as it is
            state["params"] = {n: t.to(self.device, copy=True) for n, t in
                               params_from_jax(params).items()}
        self._params, self._net = None, None
        batch_size = int(self.knobs["batch_size"])
        epochs = self.gang_epochs(self.knobs, ctx.budget_scale)

        def step(state, batch):
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

    @classmethod
    def make_gang_spec(cls, knobs: Dict[str, Any], train_dataset_path: str,
                       val_dataset_path: str,
                       device: DeviceLike = None) -> GangSpec:
        """The gang engine's recipe for this static bucket: lanes share
        the architecture and batch shape and differ in the traced
        ``dropout`` and ``learning_rate``; they train on ``device`` (None:
        the CUDA card)."""
        dev = resolve_device(device)
        ds = load_tabular_dataset(train_dataset_path)
        refuse_regression("JaxTabularMLP", ds.n_classes)
        mean, std = cls._stats(ds.features)
        x = ((ds.features - mean) / std).astype(np.float32)
        y = ds.labels
        n_hidden = int(knobs["hidden_layer_count"])
        batch_size = int(knobs["batch_size"])
        init_lane, train_step, train_lanes = cls._lane_functions(
            knobs, x.shape[1], int(ds.n_classes), dev)
        vds = load_tabular_dataset(val_dataset_path)
        vx = ((vds.features - mean) / std).astype(np.float32)
        vy = vds.labels
        meta = {"n_classes": int(ds.n_classes)}

        def epoch_batches(epoch: int):
            return batch_iterator({"x": x, "y": y}, batch_size, seed=epoch)

        def eval_lane(state, hp, xb):
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
                    "mean": np.asarray(mean), "std": np.asarray(std),
                    "meta": dict(meta)}

        def warm_lane(fresh, blob):
            shared = (blob or {}).get("params")
            shapes = params_to_jax({n: torch.empty(t.shape) for n, t in
                                    fresh["params"].items()})
            if shared is None or not same_tree_shapes(shapes, shared):
                return fresh  # incompatible architecture → cold start
            return {**fresh,
                    "params": {n: t.to(dev, copy=True) for n, t in
                               params_from_jax(shared).items()}}

        return GangSpec(hp_names=("dropout", "learning_rate"),
                        init_lane=init_lane, train_step=train_step,
                        train_lanes=train_lanes,
                        epoch_batches=epoch_batches, eval_lane=eval_lane,
                        eval_lanes=eval_lanes, eval_batches=eval_batches,
                        export_blob=export_blob, warm_lane=warm_lane,
                        share_params_knob="share_params")

    def _serving_net(self) -> _MLP:
        if self._params is None:
            raise RuntimeError("model is not trained/loaded")
        if self._net is None:
            assert self._mean is not None
            net = _MLP(len(self._mean),
                       int(self.knobs["hidden_layer_count"]),
                       int(self.knobs["hidden_layer_units"]),
                       self._n_classes, self.device,
                       torch.Generator(device=self.device).manual_seed(0))
            net.load_state_dict(params_from_jax(self._params))
            self._net = net.requires_grad_(False)
        return self._net

    def _probs(self, x: np.ndarray) -> np.ndarray:
        """f32 softmax probabilities of standardized rows, in buckets of
        256."""
        net = self._serving_net()

        def forward(xb: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                logits = net(torch.from_numpy(xb).to(self.device))
                return torch.softmax(logits, -1).cpu().numpy()

        return bucketed_forward(forward, x, bucket=256,
                                out_dim=self._n_classes)

    def evaluate(self, dataset_path: str) -> float:
        ds = load_tabular_dataset(dataset_path)
        probs = self._probs(self._standardize(ds.features))
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        x = np.asarray([np.asarray(q, np.float32).ravel()
                        for q in queries], np.float32)
        return [p.tolist() for p in self._probs(self._standardize(x))]

    def dump_parameters(self) -> Dict[str, Any]:
        if self._params is None:
            raise RuntimeError("model is not trained")
        return {"params": f32_tree(self._params),
                "mean": self._mean, "std": self._std,
                "meta": {"n_classes": self._n_classes}}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._n_classes = int(params["meta"]["n_classes"])
        self._mean = np.asarray(params["mean"])
        self._std = np.asarray(params["std"])
        self._params = f32_tree(params["params"])
        self._net = None
