"""BERT: the text-classification template, and its hashed tokenizer.

Ports ``rafiki_tpu/models/bert.py``:

- ``HashTokenizer`` (with ``_TOKEN_RE``, ``PAD_ID``, ``CLS_ID``,
  ``_RESERVED``), id for id the JAX package's; ``LlamaLoRA`` serves text
  through it too;
- ``_EncoderBlock`` and ``Bert``, a pre-LN encoder over hashed ids with
  flax's parameter names (``store/params.py``). Attention is
  :func:`flash_attention`, non-causal with each example's keys past its
  length masked (``kv_lens``): B3 (or B4 under a ``block_h`` default > 1)
  forward, B5/B6 backward;
- the ``BertClassifier`` template: ``train``, ``evaluate``, ``predict``,
  ``_predict_probs``, ``warmup``, ``dump_parameters`` and
  ``load_parameters``.

Numerics follow the flax module: parameters are f32 and cast to
``dtype`` per call; unlike ViT's, the block norms carry ``dtype`` (stats
in f32, output in ``dtype``); the embedding table is cast to ``dtype``
before the lookup; ``final_norm`` runs on the f32 activations and
``head`` in f32; ``gelu`` is the tanh approximation. The seeded init
matches flax's distributions, not its bits. The port trains on its one
device (``device=None`` is the CUDA card); ``get_knob_config`` is the
JAX template's search space, knob for knob.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.data.dataset import load_text_classification_dataset
from rafiki_tpu_torch.data.loader import batch_iterator
from rafiki_tpu_torch.model.base import (TrainContext,
                                         validate_template_knobs)
from rafiki_tpu_torch.model.knob import (CategoricalKnob, FixedKnob,
                                         FloatKnob, IntegerKnob, KnobConfig,
                                         PolicyKnob)
from rafiki_tpu_torch.model.loop import epoch_count, fit, masked_ce
from rafiki_tpu_torch.model.template_utils import (bucketed_forward,
                                                   same_tree_shapes)
from rafiki_tpu_torch.models.layers import Dense, Embed, LayerNorm, param
from rafiki_tpu_torch.ops.attention import flash_attention
from rafiki_tpu_torch.store.params import f32_tree, params_from_jax, \
    params_to_jax
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2  # ids below this are special tokens

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class HashTokenizer:
    """Deterministic open-vocabulary tokenizer: lowercase word pieces →
    blake2b-hashed ids. Stable across processes (unlike Python ``hash``,
    which is salted per interpreter), and id-for-id the JAX package's."""

    def __init__(self, vocab_size: int = 1 << 15) -> None:
        if vocab_size <= _RESERVED:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size

    def token_id(self, token: str) -> int:
        h = hashlib.blake2b(token.encode("utf-8"), digest_size=8)
        return _RESERVED + int.from_bytes(h.digest(), "big") % (
            self.vocab_size - _RESERVED)

    def encode(self, text: str, max_len: int) -> Tuple[List[int], int]:
        """Returns (ids padded to ``max_len`` with a leading CLS, true
        length including CLS)."""
        ids = [CLS_ID]
        for tok in _TOKEN_RE.findall(text.lower()):
            if len(ids) >= max_len:
                break
            ids.append(self.token_id(tok))
        length = len(ids)
        ids = ids + [PAD_ID] * (max_len - length)
        return ids, length

    def encode_batch(self, texts: Sequence[str],
                     max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_len), np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            row, n = self.encode(t, max_len)
            ids[i] = row
            lens[i] = n
        return ids, lens


class _EncoderBlock(nn.Module):
    def __init__(self, d: int, n_heads: int, mlp_dim: int,
                 dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.LayerNorm_0 = LayerNorm(d, device, dtype)
        self.qkv = Dense(d, 3 * d, dtype, device, gen)
        self.proj = Dense(d, d, dtype, device, gen)
        self.LayerNorm_1 = LayerNorm(d, device, dtype)
        self.Dense_0 = Dense(d, mlp_dim, dtype, device, gen)
        self.Dense_1 = Dense(mlp_dim, d, dtype, device, gen)

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.n_heads
        q, k, v = self.qkv(self.LayerNorm_0(x)).split(d, dim=-1)

        def heads(t):
            return t.reshape(b, s, self.n_heads, dh).transpose(1, 2)

        o = flash_attention(heads(q), heads(k), heads(v), kv_lens=lens)
        x = x + self.proj(o.transpose(1, 2).reshape(b, s, d))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class Bert(nn.Module):
    """Pre-LN transformer encoder over hashed token ids, CLS pooling.

    BERT-base = hidden_dim 768, depth 12, n_heads 12, mlp_dim 3072.
    ``dtype`` is the compute dtype (params stay f32). Weights are drawn
    from ``generator`` (a fresh one seeded 0 when None) on ``device``
    (None = the CUDA card, raising without one)."""

    def __init__(self, vocab_size: int, max_len: int,
                 hidden_dim: int = 768, depth: int = 12, n_heads: int = 12,
                 mlp_dim: int = 3072, n_classes: int = 2,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.dtype = dtype
        self.depth = int(depth)
        self.tok_embed = Embed(vocab_size, hidden_dim, dtype, device,
                               generator)
        self.pos_embed = param((1, max_len, hidden_dim), device, generator,
                               std=0.02)
        for i in range(self.depth):
            self.add_module(f"block_{i}", _EncoderBlock(
                hidden_dim, n_heads, mlp_dim, dtype, device, generator))
        self.final_norm = LayerNorm(hidden_dim, device)
        self.head = Dense(hidden_dim, n_classes, None, device, generator)

    def forward(self, ids: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """(b, s) ids and (b,) valid lengths → (b, n_classes) f32
        logits."""
        x = self.tok_embed(ids)
        x = x + self.pos_embed[:, :ids.shape[1], :].to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, lens)
        x = self.final_norm(x.float())
        return self.head(x[:, 0])  # position 0 is always CLS


class BertClassifier:
    """Text classification: hashed tokens → pre-LN encoder → CLS head,
    AdamW with linear warmup and cosine decay. Knobs are the JAX
    template's (``vocab_size``, ``hidden_dim``, ``depth``, ``n_heads``,
    ``max_len``, ``learning_rate``, ``weight_decay``, ``warmup_frac``,
    ``batch_size``, ``max_epochs``, ``bf16``, ``quick_train``,
    ``share_params``); ``device=None`` is the CUDA card. ``_params`` holds
    the f32 numpy tree in the flax layout, ``_net`` the ``Bert`` built
    from it for serving."""

    @staticmethod
    def get_knob_config() -> KnobConfig:
        return {
            "max_epochs": FixedKnob(8),
            "vocab_size": FixedKnob(1 << 15),
            # all hidden_dim choices divide by all n_heads choices
            "hidden_dim": CategoricalKnob([96, 192, 384, 768],
                                          shape_relevant=True),
            "depth": IntegerKnob(2, 12, shape_relevant=True),
            "n_heads": CategoricalKnob([4, 8, 12], shape_relevant=True),
            "max_len": CategoricalKnob([32, 64, 128], shape_relevant=True),
            "learning_rate": FloatKnob(1e-5, 1e-2, is_exp=True),
            "weight_decay": FloatKnob(1e-5, 1e-1, is_exp=True),
            "warmup_frac": FloatKnob(0.0, 0.2),
            "batch_size": CategoricalKnob([16, 32, 64, 128],
                                          shape_relevant=True),
            "bf16": CategoricalKnob([True, False]),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "share_params": PolicyKnob("SHARE_PARAMS"),
        }

    @classmethod
    def validate_knobs(cls, knobs: Dict[str, Any]) -> None:
        validate_template_knobs(cls, knobs)

    def __init__(self, device: DeviceLike = None, **knobs: Any) -> None:
        self.device = resolve_device(device)
        self.knobs: Dict[str, Any] = dict(knobs)
        self._params: Optional[Dict[str, Any]] = None
        self._n_classes: Optional[int] = None
        self._net: Optional[Bert] = None
        self.tokenizer = HashTokenizer(int(self.knobs.get("vocab_size",
                                                          1 << 15)))

    # ---- internals ----
    def _module(self) -> Bert:
        k = self.knobs
        hd = int(k["hidden_dim"])
        heads = int(k["n_heads"])
        if hd % heads:
            raise ValueError(f"hidden_dim={hd} not divisible by "
                             f"n_heads={heads}")
        return Bert(vocab_size=self.tokenizer.vocab_size,
                    max_len=int(k["max_len"]), hidden_dim=hd,
                    depth=int(k["depth"]), n_heads=heads, mlp_dim=4 * hd,
                    n_classes=int(self._n_classes), dtype=self._dtype(),
                    device=self.device)

    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.knobs.get("bf16", True) \
            else torch.float32

    def _encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return self.tokenizer.encode_batch(texts,
                                           int(self.knobs["max_len"]))

    def _serving_net(self) -> Bert:
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
        """Train on a ``.jsonl`` corpus: from the loaded params, else
        ``ctx.shared_params`` under ``share_params`` (same shapes), else
        the seeded init; batches from ``batch_iterator(seed=epoch)``, the
        mean loss logged per epoch."""
        ctx = ctx or TrainContext()
        ds = load_text_classification_dataset(dataset_path)
        self._n_classes = ds.n_classes
        ids, lens = self._encode(ds.texts)
        y = ds.labels
        model = self._module()
        params = self._params
        if ctx.shared_params is not None and self.knobs.get("share_params"):
            shared = ctx.shared_params.get("params")
            if shared is not None and same_tree_shapes(
                    params if params is not None
                    else params_to_jax(model.state_dict()), shared):
                params = shared
        if params is not None:
            model.load_state_dict(params_from_jax(params))
        self._params, self._net = None, None
        batch_size = int(self.knobs["batch_size"])

        def objective(m, b):
            ib = torch.from_numpy(b["ids"]).to(self.device).long()
            lb = torch.from_numpy(b["lens"]).to(self.device)
            yb = torch.from_numpy(b["y"]).to(self.device)
            mask = torch.from_numpy(b["mask"]).to(self.device).float()
            return masked_ce(m(ib, lb), yb, mask)

        def snapshot():
            self._params = params_to_jax(model.state_dict())
            return self.dump_parameters

        fit(model, objective,
            lambda epoch: batch_iterator({"ids": ids, "lens": lens, "y": y},
                                         batch_size, seed=epoch),
            epoch_count(self.knobs, ctx.budget_scale),
            max(1, -(-len(ids) // batch_size)), self.knobs, ctx, snapshot)
        self._params = params_to_jax(model.state_dict())
        self._net = model.requires_grad_(False)

    def evaluate(self, dataset_path: str) -> float:
        ds = load_text_classification_dataset(dataset_path)
        probs = self._predict_probs(ds.texts)
        return float(np.mean(np.argmax(probs, -1) == ds.labels))

    def predict(self, queries: Sequence[Any]) -> List[Any]:
        texts = [q if isinstance(q, str) else str(q) for q in queries]
        return [p.tolist() for p in self._predict_probs(texts)]

    def _predict_probs(self, texts: Sequence[str]) -> np.ndarray:
        """f32 softmax probabilities, in buckets of 64 texts."""
        net = self._serving_net()
        ids, lens = self._encode(texts)

        def forward(ib: np.ndarray, lb: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                logits = net(torch.from_numpy(ib).to(self.device).long(),
                             torch.from_numpy(lb).to(self.device))
                return torch.softmax(logits.float(), -1).cpu().numpy()

        return bucketed_forward(forward, ids, lens, bucket=64,
                                out_dim=int(self._n_classes))

    def warmup(self) -> None:
        """One query through the bucketed serving path."""
        if self._params is None:
            return
        self.predict(["warmup"])

    def dump_parameters(self) -> Dict[str, Any]:
        if self._params is None:
            raise RuntimeError("model is not trained")
        return {"params": f32_tree(self._params),
                "meta": {"n_classes": self._n_classes}}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._n_classes = int(params["meta"]["n_classes"])
        self._params = f32_tree(params["params"])
        self._net = None
