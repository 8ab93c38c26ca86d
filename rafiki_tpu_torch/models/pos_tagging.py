"""The POS-tagging templates: the bigram HMM on the host and the BiLSTM
tagger on the card.

Ports ``rafiki_tpu/models/pos_tagging.py``:

- :class:`BigramHMM` (``train``, ``_viterbi``, ``evaluate``, ``predict``,
  ``dump_parameters``, ``load_parameters``): add-k smoothed float64 log
  emission [T, V] and transition [T+1, T] tables counted in numpy, then a
  numpy Viterbi, as in JAX, where it is host numpy too; the tables equal
  JAX's bit for bit. It takes no device;
- ``_hash_token`` (FNV-1a, id 0 kept for padding), an exact copy;
- :class:`BiLSTMTagger` (``_module``, ``_encode``, ``train``,
  ``_predict_tags``, ``evaluate``, ``predict``, ``dump_parameters``,
  ``load_parameters``): ``Embed_0``, a forward and a backward LSTM, a
  ``Dense_0`` head over their concatenation. JAX runs flax's
  ``nn.RNN(OptimizedLSTMCell)`` scans, the backward one reversing each
  row within its length (``reverse=True, keep_order=True``); the port
  runs one bidirectional ``torch.nn.LSTM`` (cuDNN on the card) over the
  rows packed by length, which reverses the same way. A row of length 0
  (a padding row of a serving bucket, an empty query) cannot be packed:
  its outputs are zeros, and neither package reads them (the loss masks
  them, ``predict`` returns ``[]``). Training is JAX's: batches from
  ``batch_iterator(seed=epoch)``, the token- and row-masked mean
  cross-entropy, ``optax.adam(lr)`` (``model/optim.lane_adam_step``), no
  checkpoint between epochs (JAX's template takes none).

Precision: the LSTM runs in f32 with cuDNN's TF32 off
(:data:`LSTM_ALLOW_TF32`), so the card follows the CPU to f32 rounding
(phase 33 of ``chip_smoke.py`` holds the two within 1e-4 relative over
8 steps). Blobs are JAX's layout (``store/params.lstm_params_*``).
Queries for both: a list of token lists; answers: a list of tag lists.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.data.dataset import CorpusDataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, IntegerKnob, KnobConfig,
                                         PolicyKnob)
from rafiki_tpu_torch.model.loop import epoch_count, run_epochs
from rafiki_tpu_torch.model.optim import lane_adam_init, lane_adam_step
from rafiki_tpu_torch.model.template_utils import same_tree_shapes
from rafiki_tpu_torch.models.layers import Dense, lecun_normal, param
from rafiki_tpu_torch.store.params import (f32_tree, lstm_params_from_jax,
                                           lstm_params_to_jax,
                                           params_from_jax, params_to_jax)
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

UNK = "<unk>"

#: cuDNN's RNN kernels round their matmuls to TF32 unless told not to;
#: the tagger runs its LSTM in full f32
LSTM_ALLOW_TF32 = False


class BigramHMM:
    """Count-based bigram HMM tagger with add-k smoothing (host numpy;
    ``device`` is accepted and unused)."""

    TASKS = (TaskType.POS_TAGGING,)

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "emission_k": FloatKnob(1e-3, 1.0, is_exp=True),
            "transition_k": FloatKnob(1e-3, 1.0, is_exp=True),
            "min_word_count": IntegerKnob(1, 3),
        }

    @classmethod
    def validate_knobs(cls, knobs: Dict[str, Any]) -> None:
        validate_template_knobs(cls, knobs)

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.knobs: Dict[str, Any] = dict(knobs)
        self._vocab: Dict[str, int] = {}
        self._tags: List[str] = []
        self._log_emit: Optional[np.ndarray] = None   # [T, V]
        self._log_trans: Optional[np.ndarray] = None  # [T+1, T], 0 = start

    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        ds = CorpusDataset.load(dataset_path)
        self._tags = list(ds.tag_names)
        tag_ix = {t: i for i, t in enumerate(self._tags)}
        counts: Dict[str, int] = {}
        for tokens, _ in ds.sentences:
            for w in tokens:
                counts[w] = counts.get(w, 0) + 1
        min_count = int(self.knobs.get("min_word_count", 1))
        self._vocab = {UNK: 0}
        for w, c in sorted(counts.items()):
            if c >= min_count:
                self._vocab[w] = len(self._vocab)
        n_tags, n_words = len(self._tags), len(self._vocab)
        emit = np.zeros((n_tags, n_words), np.float64)
        trans = np.zeros((n_tags + 1, n_tags), np.float64)
        for tokens, tags in ds.sentences:
            prev = 0
            for w, tag in zip(tokens, tags):
                t = tag_ix[tag]
                emit[t, self._vocab.get(w, 0)] += 1
                trans[prev, t] += 1
                prev = t + 1
        ek = float(self.knobs.get("emission_k", 0.1))
        tk = float(self.knobs.get("transition_k", 0.1))
        self._log_emit = np.log(emit + ek) - np.log(
            (emit + ek).sum(axis=1, keepdims=True))
        self._log_trans = np.log(trans + tk) - np.log(
            (trans + tk).sum(axis=1, keepdims=True))
        ctx.logger.log(epoch=0, loss=0.0)  # a single counting pass

    def _viterbi(self, tokens: Sequence[str]) -> List[str]:
        if self._log_emit is None or self._log_trans is None:
            raise RuntimeError("model is not trained/loaded")
        n_tags = len(self._tags)
        ids = [self._vocab.get(w, 0) for w in tokens]
        if not ids:
            return []
        delta = self._log_trans[0] + self._log_emit[:, ids[0]]
        psi = np.zeros((len(ids), n_tags), np.int64)
        for i in range(1, len(ids)):
            scores = delta[:, None] + self._log_trans[1:]
            psi[i] = np.argmax(scores, axis=0)
            delta = scores[psi[i], np.arange(n_tags)] \
                + self._log_emit[:, ids[i]]
        path = [int(np.argmax(delta))]
        for i in range(len(ids) - 1, 0, -1):
            path.append(int(psi[i][path[-1]]))
        return [self._tags[t] for t in reversed(path)]

    def evaluate(self, dataset_path: str) -> float:
        ds = CorpusDataset.load(dataset_path)
        correct = total = 0
        for tokens, tags in ds.sentences:
            pred = self._viterbi(tokens)
            correct += sum(p == t for p, t in zip(pred, tags))
            total += len(tags)
        return correct / max(total, 1)

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        return [self._viterbi([str(w) for w in q]) for q in queries]

    def dump_parameters(self) -> Dict[str, Any]:
        if self._log_emit is None:
            raise RuntimeError("model is not trained")
        words = sorted(self._vocab, key=self._vocab.get)
        return {"log_emit": self._log_emit, "log_trans": self._log_trans,
                "meta": {"tags": self._tags, "words": words}}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._log_emit = np.asarray(params["log_emit"], np.float64)
        self._log_trans = np.asarray(params["log_trans"], np.float64)
        self._tags = [str(t) for t in params["meta"]["tags"]]
        self._vocab = {str(w): i
                       for i, w in enumerate(params["meta"]["words"])}


@functools.lru_cache(maxsize=1 << 16)
def _hash_token(w: str, vocab_size: int) -> int:
    """Deterministic token→id (FNV-1a); id 0 is reserved for padding."""
    h = 2166136261
    for ch in w.encode("utf-8"):
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return 1 + h % (vocab_size - 1)


class _Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        self.embedding = param((vocab, dim), device, gen,
                               std=dim ** -0.5)


class _BiLSTM(nn.Module):
    """``Embed_0`` → bidirectional ``lstm`` → ``Dense_0`` over the
    concatenated directions; ``forward(ids, lens)`` gives (B, S, T)
    logits, zeros past each row's length in the LSTM's output."""

    def __init__(self, vocab: int, embed: int, hidden: int, n_tags: int,
                 device: torch.device, gen: torch.Generator) -> None:
        super().__init__()
        self.Embed_0 = _Embed(vocab, embed, device, gen)
        # built on the meta device (torch's own init would draw from
        # the global generator), then filled with flax's initializers
        self.lstm = nn.LSTM(embed, hidden, batch_first=True,
                            bidirectional=True,
                            device="meta").to_empty(device=device)
        with torch.no_grad():
            for sfx in ("_l0", "_l0_reverse"):
                getattr(self.lstm, "weight_ih" + sfx).copy_(torch.cat(
                    [lecun_normal((embed, hidden), device, gen).t()
                     for _ in range(4)]))
                getattr(self.lstm, "weight_hh" + sfx).copy_(torch.cat(
                    [_orthogonal(hidden, device, gen) for _ in range(4)]))
                getattr(self.lstm, "bias_ih" + sfx).zero_()
                getattr(self.lstm, "bias_hh" + sfx).zero_()
                # flax has one bias per gate: bias_ih stays zero
                getattr(self.lstm, "bias_ih" + sfx).requires_grad_(False)
        self.Dense_0 = Dense(2 * hidden, n_tags, None, device, gen)

    def forward(self, ids: torch.Tensor, lens: torch.Tensor
                ) -> torch.Tensor:
        x = F.embedding(ids.long(), self.Embed_0.embedding)
        h = torch.zeros(x.shape[0], x.shape[1], 2 * self.lstm.hidden_size,
                        dtype=x.dtype, device=x.device)
        lens_cpu = lens.detach().to("cpu", torch.int64)
        rows = torch.nonzero(lens_cpu > 0).flatten()
        if len(rows):
            packed = nn.utils.rnn.pack_padded_sequence(
                x[rows.to(x.device)], lens_cpu[rows], batch_first=True,
                enforce_sorted=False)
            with lstm_precision():
                out, _ = self.lstm(packed)
            out, _ = nn.utils.rnn.pad_packed_sequence(
                out, batch_first=True, total_length=x.shape[1])
            h = h.index_copy(0, rows.to(x.device), out)
        return self.Dense_0(h)


def lstm_precision():
    """cuDNN's flags for the LSTM's forward and backward: TF32 as
    :data:`LSTM_ALLOW_TF32` says, the rest at torch's defaults."""
    return torch.backends.cudnn.flags(enabled=True,
                                      allow_tf32=LSTM_ALLOW_TF32)


def _orthogonal(n: int, device: torch.device,
                gen: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal()`` recurrent kernel: Q of a normal matrix's
    QR, signs fixed by R's diagonal."""
    a = torch.randn((n, n), generator=gen, device=device)
    q, r = torch.linalg.qr(a.cpu())
    return (q * torch.sign(torch.diagonal(r))).to(device)


def _to_port(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX params tree → ``_BiLSTM``'s ``state_dict``."""
    out = params_from_jax({k: tree[k] for k in ("Embed_0", "Dense_0")})
    lstm = lstm_params_from_jax([tree["OptimizedLSTMCell_0"],
                                 tree["OptimizedLSTMCell_1"]])
    out.update({f"lstm.{k}": v for k, v in lstm.items()})
    return out


def _to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``_BiLSTM``'s ``state_dict`` → the JAX params tree (keys sorted as
    ``jax.tree_util`` sorts them)."""
    tree = params_to_jax({k: v for k, v in state.items()
                          if not k.startswith("lstm.")})
    cells = lstm_params_to_jax({k[len("lstm."):]: v for k, v in
                                state.items() if k.startswith("lstm.")})
    tree.update({f"OptimizedLSTMCell_{d}": c for d, c in enumerate(cells)})
    return {k: tree[k] for k in sorted(tree)}


class BiLSTMTagger:
    """Bidirectional LSTM tagger (masked cross-entropy); ``device=None``
    is the CUDA card."""

    TASKS = (TaskType.POS_TAGGING,)

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(10),
            "vocab_size": CategoricalKnob([1024, 4096],
                                          shape_relevant=True),
            "embed_dim": CategoricalKnob([32, 64, 128],
                                         shape_relevant=True),
            "hidden_dim": CategoricalKnob([64, 128, 256],
                                          shape_relevant=True),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64],
                                          shape_relevant=True),
            "max_len": FixedKnob(32),
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
        self._tags: List[str] = []
        self._net_cache: Optional[_BiLSTM] = None

    # ---- internals ----
    def _module(self) -> _BiLSTM:
        """A freshly initialized ``_BiLSTM`` (seed 0)."""
        return _BiLSTM(int(self.knobs["vocab_size"]),
                       int(self.knobs["embed_dim"]),
                       int(self.knobs["hidden_dim"]), len(self._tags),
                       self.device,
                       torch.Generator(device=self.device).manual_seed(0))

    def _encode(self, sents: Sequence[Sequence[str]]
                ) -> Tuple[np.ndarray, np.ndarray]:
        vocab = int(self.knobs["vocab_size"])
        max_len = int(self.knobs["max_len"])
        ids = np.zeros((len(sents), max_len), np.int32)
        lens = np.zeros((len(sents),), np.int32)
        for i, toks in enumerate(sents):
            toks = list(toks)[:max_len]
            lens[i] = len(toks)
            for j, w in enumerate(toks):
                ids[i, j] = _hash_token(str(w), vocab)
        return ids, lens

    def _arrays(self, ds: CorpusDataset) -> Dict[str, np.ndarray]:
        """The corpus as ``batch_iterator``'s arrays: ids ``i``,
        lengths ``l`` and tag ids ``t``, cut at ``max_len``."""
        tag_ix = {t: i for i, t in enumerate(self._tags)}
        max_len = int(self.knobs["max_len"])
        ids, lens = self._encode([toks for toks, _ in ds.sentences])
        tags = np.zeros_like(ids)
        for i, (_, ts) in enumerate(ds.sentences):
            for j, t in enumerate(list(ts)[:max_len]):
                tags[i, j] = tag_ix[t]
        return {"i": ids, "l": lens, "t": tags}

    def _net(self, params: Optional[Dict[str, Any]] = None) -> _BiLSTM:
        """A fresh ``_BiLSTM`` on the template's device, with ``params``
        (a JAX tree) loaded when given."""
        net = self._module()
        if params is not None:
            net.load_state_dict(_to_port(params))
        return net

    @staticmethod
    def _step_fn(net: _BiLSTM, learning_rate: float,
                 device: torch.device):
        """``step(batch) -> loss``: one Adam step of ``net`` on a host
        batch (JAX's ``train_step``: the token- and row-masked mean
        cross-entropy)."""
        trainable = {n: p for n, p in net.named_parameters()
                     if p.requires_grad}
        opt = lane_adam_init({n: p.detach() for n, p in trainable.items()})
        lr = torch.tensor(learning_rate, dtype=torch.float32, device=device)

        def step(b: Dict[str, np.ndarray]) -> torch.Tensor:
            with lstm_precision():
                ib = torch.from_numpy(b["i"]).to(device)
                lb = torch.from_numpy(b["l"]).to(device)
                tb = torch.from_numpy(b["t"]).to(device)
                row = torch.from_numpy(b["mask"]).to(device).float()
                logits = net(ib, lb)
                tok = (torch.arange(ib.shape[1], device=device)[None, :]
                       < lb[:, None]).float() * row[:, None]
                losses = F.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]).float(),
                    tb.reshape(-1).long(), reduction="none")
                loss = (losses * tok.reshape(-1)).sum() \
                    / tok.sum().clamp(min=1.0)
                grads = torch.autograd.grad(loss, list(trainable.values()))
                lane_adam_step({n: p.data for n, p in trainable.items()},
                               dict(zip(trainable, grads)), opt, lr)
            return loss.detach()

        return step

    # ---- contract ----
    def train(self, dataset_path: str,
              ctx: Optional[TrainContext] = None) -> None:
        ctx = ctx or TrainContext()
        ds = CorpusDataset.load(dataset_path)
        self._tags = list(ds.tag_names)
        arrays = self._arrays(ds)
        params = self._params  # warm-started via load_parameters
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            shared = ctx.shared_params.get("params")
            if shared is not None and same_tree_shapes(
                    _to_jax(self._module().state_dict()), shared):
                params = shared
        net = self._net(params)
        self._params, self._net_cache = None, None
        step = self._step_fn(net, float(self.knobs["learning_rate"]),
                             self.device)

        def fit_step(state, b):
            with torch.profiler.record_function("fit.step"):
                return state, step(b)

        epochs = epoch_count(self.knobs, ctx.budget_scale)
        batch_size = int(self.knobs["batch_size"])
        run_epochs(fit_step, None, lambda epoch: batch_iterator(
            arrays, batch_size, seed=epoch), epochs, ctx,
            lambda state, frac_done: None)
        self._params = _to_jax(net.state_dict())
        self._net_cache = net.requires_grad_(False)

    def _serving_net(self) -> _BiLSTM:
        if self._params is None:
            raise RuntimeError("model is not trained/loaded")
        if self._net_cache is None:
            self._net_cache = self._net(self._params).requires_grad_(False)
        return self._net_cache

    def _predict_tags(self, sents: Sequence[Sequence[str]]
                      ) -> List[List[str]]:
        net = self._serving_net()
        ids, lens = self._encode(sents)
        out: List[List[str]] = []
        bucket = 64
        for i in range(0, len(ids), bucket):
            ib, lb = ids[i:i + bucket], lens[i:i + bucket]
            pad = bucket - len(ib)
            if pad:
                ib = np.concatenate([ib, np.zeros((pad, ib.shape[1]),
                                                  ib.dtype)])
                lb = np.concatenate([lb, np.zeros((pad,), lb.dtype)])
            with torch.no_grad():
                pred = net(torch.from_numpy(ib).to(self.device),
                           torch.from_numpy(lb)).argmax(-1).cpu().numpy()
            for j in range(bucket - pad):
                out.append([self._tags[t] for t in pred[j, :lb[j]]])
        return out

    def evaluate(self, dataset_path: str) -> float:
        ds = CorpusDataset.load(dataset_path)
        max_len = int(self.knobs["max_len"])
        preds = self._predict_tags([toks for toks, _ in ds.sentences])
        correct = total = 0
        for pred, (_, tags) in zip(preds, ds.sentences):
            tags = list(tags)[:max_len]
            correct += sum(p == t for p, t in zip(pred, tags))
            total += len(tags)
        return correct / max(total, 1)

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        return self._predict_tags([[str(w) for w in q] for q in queries])

    def dump_parameters(self) -> Dict[str, Any]:
        if self._params is None:
            raise RuntimeError("model is not trained")
        return {"params": f32_tree(self._params),
                "meta": {"tags": self._tags}}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._tags = [str(t) for t in params["meta"]["tags"]]
        self._params = f32_tree(params["params"])
        self._net_cache = None
