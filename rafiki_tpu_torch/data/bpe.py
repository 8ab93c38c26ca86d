"""Trainable byte-level BPE tokenizer: the real tokenizer of the Llama
template (``tokenizer_path``).

The port's own copy of ``rafiki_tpu/data/bpe.py``: ``ByteBPETokenizer``
(``encode_ids``, ``encode``, ``encode_batch``, ``decode``, ``save``,
``load``, ``train``, ``train_file``), the chunker ``_CHUNK_RE``, the
specials (PAD 0, BOS 1, EOS 2), and the native chunk encoder
(``_NativeBPE``, ``_native_encoder``) over ``native/bpe_encoder.cc``.
Artifacts move both ways with the JAX package: the same JSON, the same
ids.

- Byte-level and lossless: the base vocabulary is the 256 bytes, so any
  text round-trips (``decode(encode_ids(s)) == s``).
- Pre-tokenization splits text into "optional leading space + non-space
  run" or whitespace runs; merges never cross a chunk.
- Ids: the specials, then the 256 byte tokens, then one id per merge in
  training order.

The merge loop runs natively: the encoder is built with ``g++`` at first
use (``native/client.py`` ``ensure_built(target="librbpe.so")``) and
loaded with ``ctypes``; a build or load that fails raises. The Python
loop (:meth:`ByteBPETokenizer._bpe_chunk`) is the plain version, taken
only when asked for with ``native=False``.
"""

from __future__ import annotations

import ctypes
import json
import re
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
N_SPECIAL = 3
_N_BYTES = 256

#: chunker: a word keeps one leading space; other whitespace runs stand
#: alone. Chunks partition the text, so concatenating decoded chunks
#: reproduces it byte for byte.
_CHUNK_RE = re.compile(r" ?[^\s]+|\s+")


class _NativeBPE:
    """ctypes handle over ``native/bpe_encoder.cc``: holds the library
    and the encoder handle, so their lifetime is the tokenizer's."""

    _lib = None       # the process's loaded library
    _lib_key = None   # (path, mtime_ns) it was loaded from: a rebuild
    #                   (atomic rename, new mtime) loads a fresh CDLL

    def __init__(self, lib, handle) -> None:
        self._l = lib
        self._h = handle

    def __del__(self) -> None:  # process exit frees it too
        try:
            self._l.rbpe_free(self._h)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def encode_chunk(self, chunk: bytes) -> Tuple[int, ...]:
        n = len(chunk)
        out = (ctypes.c_int32 * max(n, 1))()
        got = self._l.rbpe_encode_chunk(
            self._h, ctypes.c_char_p(chunk), n, out, max(n, 1))
        if got < 0:  # merges only shrink a chunk: cannot happen
            raise RuntimeError("native bpe buffer overflow")
        return tuple(out[:got])


def _native_encoder(merges: Sequence[Tuple[int, int]]) -> _NativeBPE:
    """The native chunk encoder over ``merges``, building the library
    when it is missing or stale. Raises when it cannot be built or
    loaded."""
    from rafiki_tpu_torch.native.client import ensure_built

    lib_path = ensure_built(target="librbpe.so")
    key = (str(lib_path), lib_path.stat().st_mtime_ns)
    if _NativeBPE._lib is None or _NativeBPE._lib_key != key:
        lib = ctypes.CDLL(str(lib_path))
        lib.rbpe_create.restype = ctypes.c_void_p
        lib.rbpe_create.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_int32]
        lib.rbpe_free.argtypes = [ctypes.c_void_p]
        lib.rbpe_encode_chunk.restype = ctypes.c_int32
        lib.rbpe_encode_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        _NativeBPE._lib, _NativeBPE._lib_key = lib, key
    lib = _NativeBPE._lib
    flat = [x for pair in merges for x in pair]
    arr = (ctypes.c_int32 * max(len(flat), 1))(*flat)
    handle = lib.rbpe_create(arr, len(merges))
    if not handle:
        raise RuntimeError("rbpe_create returned no encoder")
    return _NativeBPE(lib, ctypes.c_void_p(handle))


class ByteBPETokenizer:
    """Byte-level BPE with a JSON-artifact merge table. The
    ``HashTokenizer`` call surface (``encode(text, max_len) -> (row,
    n)`` with a leading BOS, ``encode_batch``, ``vocab_size``) plus an
    exact ``decode``. ``native=False`` encodes with the Python merge
    loop (the plain version) instead of the native encoder."""

    def __init__(self, merges: Sequence[Tuple[int, int]],
                 native: bool = True) -> None:
        #: merge table in training order; merge i creates token id
        #: N_SPECIAL + 256 + i from its (left, right) pair
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self._rank: Dict[Tuple[int, int], int] = {
            m: i for i, m in enumerate(self.merges)}
        #: id -> byte string (specials decode to b"")
        self._bytes: List[bytes] = [b""] * N_SPECIAL + [
            bytes([i]) for i in range(_N_BYTES)]
        for left, right in self.merges:
            self._bytes.append(self._bytes[left] + self._bytes[right])
        self._native = _native_encoder(self.merges) if native else None
        impl = (self._native.encode_chunk if self._native is not None
                else self._bpe_chunk)
        self._encode_chunk = lru_cache(maxsize=65536)(impl)

    @property
    def vocab_size(self) -> int:
        return N_SPECIAL + _N_BYTES + len(self.merges)

    # ---- encoding ----
    def _bpe_chunk(self, chunk: bytes) -> Tuple[int, ...]:
        ids = [N_SPECIAL + b for b in chunk]
        while len(ids) > 1:
            best, best_rank = None, None
            for pair in zip(ids, ids[1:]):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            merged = N_SPECIAL + _N_BYTES + best_rank
            out: List[int] = []
            i = 0
            while i < len(ids):
                if i + 1 < len(ids) and (ids[i], ids[i + 1]) == best:
                    out.append(merged)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        return tuple(ids)

    def encode_ids(self, text: str) -> List[int]:
        """Token ids for ``text`` (no BOS, no padding)."""
        out: List[int] = []
        for chunk in _CHUNK_RE.findall(text):
            out.extend(self._encode_chunk(chunk.encode("utf-8")))
        return out

    def encode(self, text: str, max_len: int) -> Tuple[List[int], int]:
        """HashTokenizer-compatible: (ids padded to ``max_len`` with a
        leading BOS, true length including BOS)."""
        ids = [BOS_ID] + self.encode_ids(text)[:max_len - 1]
        length = len(ids)
        return ids + [PAD_ID] * (max_len - length), length

    def encode_batch(self, texts: Sequence[str],
                     max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_len), np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            row, n = self.encode(t, max_len)
            ids[i], lens[i] = row, n
        return ids, lens

    def decode(self, ids: Iterable[int]) -> str:
        """Exact inverse of ``encode_ids`` (specials vanish; invalid
        UTF-8 from truncated multi-byte tokens is replaced)."""
        data = b"".join(self._bytes[i] for i in ids
                        if 0 <= int(i) < len(self._bytes))
        return data.decode("utf-8", errors="replace")

    # ---- artifact ----
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "rafiki-bpe-v1",
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str, native: bool = True) -> "ByteBPETokenizer":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("format") != "rafiki-bpe-v1":
            raise ValueError(f"{path}: not a rafiki-bpe-v1 artifact")
        return cls([tuple(m) for m in blob["merges"]], native=native)

    # ---- training ----
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int,
              native: bool = True) -> "ByteBPETokenizer":
        """Learn merges from text lines until ``vocab_size`` is reached
        (or no pair repeats). Deterministic: ties break on the
        lexicographically smallest pair."""
        n_merges = vocab_size - N_SPECIAL - _N_BYTES
        if n_merges < 0:
            raise ValueError(
                f"vocab_size must be ≥ {N_SPECIAL + _N_BYTES}")
        # word histogram: merge statistics over unique chunks
        words: Dict[Tuple[int, ...], int] = {}
        for line in corpus:
            for chunk in _CHUNK_RE.findall(line):
                key = tuple(N_SPECIAL + b for b in chunk.encode("utf-8"))
                if key:
                    words[key] = words.get(key, 0) + 1
        merges: List[Tuple[int, int]] = []
        for _ in range(n_merges):
            counts: Dict[Tuple[int, int], int] = {}
            for word, freq in words.items():
                for pair in zip(word, word[1:]):
                    counts[pair] = counts.get(pair, 0) + freq
            if not counts:
                break
            best = max(counts, key=lambda p: (counts[p], (-p[0], -p[1])))
            if counts[best] < 2:
                break  # nothing repeats: more merges would memorize
            new_id = N_SPECIAL + _N_BYTES + len(merges)
            merges.append(best)
            new_words: Dict[Tuple[int, ...], int] = {}
            for word, freq in words.items():
                out: List[int] = []
                i = 0
                while i < len(word):
                    if i + 1 < len(word) and \
                            (word[i], word[i + 1]) == best:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                key = tuple(out)
                new_words[key] = new_words.get(key, 0) + freq
            words = new_words
        return cls(merges, native=native)

    @classmethod
    def train_file(cls, corpus_path: str, vocab_size: int,
                   native: bool = True) -> "ByteBPETokenizer":
        with open(corpus_path, encoding="utf-8") as f:
            return cls.train(f, vocab_size, native=native)
