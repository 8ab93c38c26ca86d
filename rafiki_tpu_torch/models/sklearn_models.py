"""The tabular templates that JAX fits with scikit-learn: a decision
tree, gradient-boosted trees and a kernel SVM, fitted on the host in
numpy without scikit-learn.

Ports ``rafiki_tpu/models/sklearn_models.py``, under the names users
type: ``SklearnDecisionTree``, ``_walk_tree``, ``SklearnGBDT`` and
``SklearnSVM`` (``get_knob_config``, ``train``, ``_probs``, ``evaluate``,
``predict``, ``dump_parameters``, ``load_parameters``). Where JAX calls
``DecisionTreeClassifier``, ``GradientBoostingClassifier`` and ``SVC``
(all ``random_state=0``), the port calls its own fits, which reproduce
scikit-learn 1.9.0's: ``models/_tree_fit.py`` (``fit_tree``,
``fit_gbdt``) and ``models/_svm_fit.py`` (``fit_svc``). The exported
arrays are JAX's blob layout, so a blob either package dumps loads in
the other, and prediction walks those arrays as JAX's does.

Like the reference's sklearn, the three run on the host: they take no
device (``device`` is accepted and unused) and need no card.

One deliberate difference (``ROADMAP.md`` Queue C 21): for two classes
scikit-learn exports ``dual_coef_`` and ``intercept_`` negated, and
JAX's one-vs-one vote reads them unchanged, so its binary SVM votes for
the other class. The port's vote takes the two-class decision with
libsvm's sign, giving sklearn's own prediction; from three classes up
the two agree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.data.dataset import load_tabular_dataset
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.knob import (CategoricalKnob, FloatKnob,
                                         IntegerKnob, KnobConfig)
from rafiki_tpu_torch.model.template_utils import refuse_regression
from rafiki_tpu_torch.models._svm_fit import fit_svc
from rafiki_tpu_torch.models._tree_fit import fit_gbdt, fit_tree
from rafiki_tpu_torch.utils.device import DeviceLike


def _rows(queries: Sequence[Any], dtype=np.float32) -> np.ndarray:
    return np.asarray([np.asarray(q, dtype).ravel() for q in queries],
                      dtype)


def _walk_tree(x: np.ndarray, left: np.ndarray, right: np.ndarray,
               feature: np.ndarray, threshold: np.ndarray,
               rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized leaf lookup shared by the DT and GBDT templates (JAX's:
    the row's value ``<=`` the float32 threshold goes left); ``rows`` is
    a precomputed ``np.arange(len(x))``."""
    node = np.zeros(len(x), np.int32)
    if rows is None:
        rows = np.arange(len(x))
    for _ in range(64):  # > max tree depth
        feat = feature[node]
        leaf = feat < 0
        if leaf.all():
            break
        go_left = x[rows, np.maximum(feat, 0)] <= threshold[node]
        nxt = np.where(go_left, left[node], right[node])
        node = np.where(leaf, node, nxt).astype(np.int32)
    return node


class _HostTemplate:
    """What the three share: knobs, no device, the tabular contract."""

    TASKS = (TaskType.TABULAR_CLASSIFICATION,)

    @classmethod
    def validate_knobs(cls, knobs: Dict[str, Any]) -> None:
        validate_template_knobs(cls, knobs)

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.knobs: Dict[str, Any] = dict(knobs)

    def _probs(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _train_error(self, x: np.ndarray, labels: np.ndarray) -> float:
        return float(1.0 - np.mean(np.argmax(self._probs(x), -1)
                                   == labels))

    def evaluate(self, dataset_path: str) -> float:
        ds = load_tabular_dataset(dataset_path)
        probs = self._probs(ds.features)
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        return [p.tolist() for p in self._probs(_rows(queries))]


class SklearnDecisionTree(_HostTemplate):
    """Decision-tree classifier over tabular features."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_depth": IntegerKnob(2, 16),
            "min_samples_split": IntegerKnob(2, 32, is_exp=True),
            "min_impurity_decrease": FloatKnob(1e-6, 1e-1, is_exp=True),
            "criterion": CategoricalKnob(["gini", "entropy"]),
        }

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        super().__init__(device, **knobs)
        self._tree: Optional[Dict[str, np.ndarray]] = None
        self._n_classes: int = 0

    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        ds = load_tabular_dataset(dataset_path)
        refuse_regression("SklearnDecisionTree", ds.n_classes)
        classes, y = np.unique(ds.labels, return_inverse=True)
        t = fit_tree(ds.features, y,
                     max_depth=int(self.knobs["max_depth"]),
                     min_samples_split=int(self.knobs["min_samples_split"]),
                     min_impurity_decrease=float(
                         self.knobs["min_impurity_decrease"]),
                     criterion=str(self.knobs["criterion"]),
                     n_classes=len(classes))
        # leaf value → class distribution (normalized counts)
        dist = t.value / np.maximum(t.value.sum(axis=1, keepdims=True),
                                    1e-12)
        self._tree = {
            "children_left": t.children_left.astype(np.int32),
            "children_right": t.children_right.astype(np.int32),
            "feature": t.feature.astype(np.int32),
            "threshold": t.threshold.astype(np.float32),
            "dist": dist.astype(np.float32),
        }
        self._n_classes = int(ds.n_classes)
        pred = classes[np.argmax(t.value[t.apply(ds.features)], -1)]
        ctx.logger.log(epoch=0, loss=float(1.0 - np.mean(pred
                                                         == ds.labels)))

    def _probs(self, x: np.ndarray) -> np.ndarray:
        if self._tree is None:
            raise RuntimeError("model is not trained/loaded")
        t = self._tree
        node = _walk_tree(x, t["children_left"], t["children_right"],
                          t["feature"], t["threshold"])
        return t["dist"][node]

    def dump_parameters(self) -> Dict[str, Any]:
        if self._tree is None:
            raise RuntimeError("model is not trained")
        return {**self._tree, "meta": {"n_classes": self._n_classes}}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._n_classes = int(params["meta"]["n_classes"])
        self._tree = {k: np.asarray(params[k]) for k in
                      ("children_left", "children_right", "feature",
                       "threshold", "dist")}


class SklearnGBDT(_HostTemplate):
    """Gradient-boosted decision trees over tabular features; the blob
    holds every tree's arrays, the prior raw scores and the classes, and
    prediction accumulates ``prior + lr·Σ tree(x)`` and applies the
    sigmoid (two classes) or the softmax."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "n_estimators": IntegerKnob(10, 200, is_exp=True),
            "learning_rate_gb": FloatKnob(0.01, 0.5, is_exp=True),
            "max_depth": IntegerKnob(2, 6),
            "subsample": FloatKnob(0.5, 1.0),
        }

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        super().__init__(device, **knobs)
        self._blob: Optional[Dict[str, Any]] = None

    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        ds = load_tabular_dataset(dataset_path)
        refuse_regression("SklearnGBDT", ds.n_classes)
        lr = float(self.knobs["learning_rate_gb"])
        fit = fit_gbdt(ds.features, ds.labels,
                       n_estimators=int(self.knobs["n_estimators"]),
                       learning_rate=lr,
                       max_depth=int(self.knobs["max_depth"]),
                       subsample=float(self.knobs["subsample"]))
        trees = []
        for stage in fit["trees"]:
            for t in stage:
                trees.append({
                    "left": t.children_left.astype(np.int32),
                    "right": t.children_right.astype(np.int32),
                    "feature": t.feature.astype(np.int32),
                    "threshold": t.threshold.astype(np.float32),
                    "value": t.value[:, 0].astype(np.float32),
                })
        # JAX's raw baseline: log(p/(1-p)) for two classes, log(p_k)
        # for more, of the class shares clipped to [1e-12, 1 - 1e-12]
        p0 = np.clip(fit["class_prior"], 1e-12, 1 - 1e-12)
        k = int(fit["k"])
        raw0 = np.asarray([np.log(p0[1] / (1.0 - p0[1]))]) if k == 1 \
            else np.log(p0)
        self._blob = {
            "trees": trees, "n_stages": len(fit["trees"]), "k": k,
            "lr": lr, "prior": np.asarray(raw0, np.float32),
            "classes": fit["classes"].astype(np.int64),
            "n_classes": int(ds.n_classes),
        }
        ctx.logger.log(epoch=0, loss=self._train_error(ds.features,
                                                       ds.labels))

    def _probs(self, x: np.ndarray) -> np.ndarray:
        if self._blob is None:
            raise RuntimeError("model is not trained/loaded")
        b = self._blob
        n_stages, k, lr = int(b["n_stages"]), int(b["k"]), float(b["lr"])
        raw = np.tile(np.asarray(b["prior"], np.float64), (len(x), 1))
        rows = np.arange(len(x))
        for s in range(n_stages):
            for c in range(k):
                t = b["trees"][s * k + c]
                node = _walk_tree(x, np.asarray(t["left"]),
                                  np.asarray(t["right"]),
                                  np.asarray(t["feature"]),
                                  np.asarray(t["threshold"]), rows=rows)
                raw[:, c] += lr * np.asarray(t["value"], np.float64)[node]
        if k == 1:  # two classes: the sigmoid of the one raw column
            p1 = 1.0 / (1.0 + np.exp(-raw[:, 0]))
            local = np.stack([1.0 - p1, p1], axis=1)
        else:
            raw -= raw.max(axis=1, keepdims=True)
            e = np.exp(raw)
            local = e / e.sum(axis=1, keepdims=True)
        probs = np.zeros((len(x), int(b["n_classes"])), np.float64)
        for i, cls in enumerate(np.asarray(b["classes"])):
            probs[:, int(cls)] = local[:, i]
        return probs

    def dump_parameters(self) -> Dict[str, Any]:
        if self._blob is None:
            raise RuntimeError("model is not trained")
        return self._blob

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._blob = params


class SklearnSVM(_HostTemplate):
    """Kernel SVM over standardized tabular features: libsvm's
    one-vs-one classifiers, pairwise vote shares as probabilities."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "C": FloatKnob(0.01, 100.0, is_exp=True),
            "kernel": CategoricalKnob(["linear", "rbf"]),
            "gamma_scale": FloatKnob(0.1, 10.0, is_exp=True),
        }

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        super().__init__(device, **knobs)
        self._blob: Optional[Dict[str, Any]] = None

    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        ds = load_tabular_dataset(dataset_path)
        refuse_regression("SklearnSVM", ds.n_classes)
        mean = ds.features.mean(axis=0)
        std = ds.features.std(axis=0) + 1e-6
        x = (ds.features - mean) / std
        # gamma: 'scale' default times a tunable multiplier
        base_gamma = 1.0 / (x.shape[1] * max(x.var(), 1e-12))
        gamma = base_gamma * float(self.knobs["gamma_scale"])
        kernel = str(self.knobs["kernel"])
        fit = fit_svc(x, ds.labels, c=float(self.knobs["C"]),
                      kernel=kernel, gamma=gamma)
        self._blob = {
            "sv": fit["support_vectors_"].astype(np.float32),
            "dual_coef": fit["dual_coef_"].astype(np.float32),
            "intercept": fit["intercept_"].astype(np.float32),
            "n_support": fit["n_support_"].astype(np.int32),
            "classes": fit["classes_"].astype(np.int64),
            "mean": mean.astype(np.float32), "std": std.astype(np.float32),
            "meta": {"kernel": kernel, "gamma": float(gamma),
                     "n_classes": int(ds.n_classes)},
        }
        ctx.logger.log(epoch=0, loss=self._train_error(ds.features,
                                                       ds.labels))

    def _kernel(self, x: np.ndarray, sv: np.ndarray) -> np.ndarray:
        assert self._blob is not None
        if self._blob["meta"]["kernel"] == "linear":
            return x @ sv.T
        gamma = float(self._blob["meta"]["gamma"])
        d2 = (np.sum(x * x, 1)[:, None] + np.sum(sv * sv, 1)[None, :]
              - 2.0 * (x @ sv.T))
        return np.exp(-gamma * np.maximum(d2, 0.0))

    def decision_values(self, x: np.ndarray) -> np.ndarray:
        """Each one-vs-one pair's decision (JAX's, from the blob's
        arrays): (N, K(K-1)/2), pairs (i, j) with i < j in class order."""
        if self._blob is None:
            raise RuntimeError("model is not trained/loaded")
        b = self._blob
        x = (x - np.asarray(b["mean"])) / np.asarray(b["std"])
        km = self._kernel(np.asarray(x, np.float64),
                          np.asarray(b["sv"], np.float64))
        dual = np.asarray(b["dual_coef"], np.float64)
        intercept = np.asarray(b["intercept"], np.float64)
        k = len(np.asarray(b["classes"]))
        starts = np.concatenate([[0], np.cumsum(np.asarray(
            b["n_support"]))])
        out = []
        for i in range(k):
            for j in range(i + 1, k):
                si, ei = starts[i], starts[i + 1]
                sj, ej = starts[j], starts[j + 1]
                out.append(km[:, si:ei] @ dual[j - 1, si:ei]
                           + km[:, sj:ej] @ dual[i, sj:ej]
                           + intercept[len(out)])
        return np.stack(out, 1) if out else np.zeros((len(x), 0))

    def _probs(self, x: np.ndarray) -> np.ndarray:
        if self._blob is None:
            raise RuntimeError("model is not trained/loaded")
        b = self._blob
        classes = np.asarray(b["classes"])
        k = len(classes)
        dec = self.decision_values(np.asarray(x, np.float64))
        if k == 2:  # the blob's two-class sign is sklearn's public one
            dec = -dec
        votes = np.zeros((len(x), k), np.float64)
        p = 0
        for i in range(k):
            for j in range(i + 1, k):
                votes[:, i] += dec[:, p] > 0
                votes[:, j] += dec[:, p] <= 0
                p += 1
        if k == 1:  # degenerate single-class fit
            votes[:, 0] = 1.0
        share = votes / np.maximum(votes.sum(axis=1, keepdims=True), 1e-12)
        probs = np.zeros((len(x), int(b["meta"]["n_classes"])), np.float64)
        for i, cls in enumerate(classes):
            probs[:, int(cls)] = share[:, i]
        return probs

    def evaluate(self, dataset_path: str) -> float:
        ds = load_tabular_dataset(dataset_path)
        probs = self._probs(np.asarray(ds.features, np.float64))
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        return [p.tolist() for p in self._probs(_rows(queries, np.float64))]

    def dump_parameters(self) -> Dict[str, Any]:
        if self._blob is None:
            raise RuntimeError("model is not trained")
        return self._blob

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._blob = params
