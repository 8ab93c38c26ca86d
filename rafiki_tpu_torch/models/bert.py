"""Hashed-vocabulary tokenizer.

The port's own copy of the tokenizer half of ``rafiki_tpu/models/bert.py``
(``HashTokenizer``, ``_TOKEN_RE``, ``PAD_ID``, ``CLS_ID``, ``_RESERVED``):
``LlamaLoRA`` serves text through it. The BERT model itself is a later
slice.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence, Tuple

import numpy as np

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
