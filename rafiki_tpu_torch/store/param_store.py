"""ParamStore: trial parameter blobs, and the Flax-msgpack byte codec.

Ports ``rafiki_tpu/store/param_store.py``:

- ``params_to_bytes`` / ``params_from_bytes``: the bytes of
  ``flax.serialization.msgpack_serialize`` / ``msgpack_restore``, written
  and read here in plain Python (neither msgpack nor flax is imported).
  flax packs with ``strict_types=True`` and ``use_bin_type=True``: dict
  keys in sorted order (``jax.tree_util`` rebuilds every dict sorted),
  ints in their smallest encoding, floats as float64, ``str`` as str and
  ``bytes`` as bin, tuples refused. numpy arrays are ext 1, the msgpack of
  ``(shape, dtype.name, tobytes('C'))``; numpy scalars ext 3 (the same
  body at shape ``()``); Python complex ext 2. An array over
  ``MAX_CHUNK_SIZE`` bytes that is a dict value (or the whole tree) is
  split into ``{"__msgpack_chunked_array__": True, "shape": {...},
  "chunks": {...}}``. Unpacking decodes str as str, refuses map keys that
  are not str or bytes, and joins chunked leaves back.
- A leaf may also be a torch tensor on any device: it is copied to the
  host when its bytes are written, one leaf at a time, so a tree that
  lives on the card never has a second whole copy on the host. A
  ``bfloat16`` leaf (numpy has no such type without ``ml_dtypes``) is
  written under the name ``"bfloat16"`` and read back as a CPU
  ``torch.bfloat16`` tensor through a ``uint16`` view (a bf16 numpy
  scalar, ext 3, reads as a 0-d tensor and so writes back as ext 1).
- Arrays read back are zero-copy, read-only views into the blob, as
  flax's ``np.frombuffer`` gives them.
- ``InMemoryBackend``, ``FileBackend``, ``KVBackend`` and ``ParamStore``
  (its LRU bytes cache, ``from_uri`` for ``mem://``, ``file://`` and
  ``kv://``), with JAX's sharded-checkpoint methods
  (``sharded_checkpointer``, ``save_sharded_async``, ``sharded_ref``,
  ``copy_sharded``, ``exists_sharded``): a ``file://`` store keeps
  ``store/sharded_ckpt.py``'s directories under ``<root>/sharded``, the
  other backends have none (``None`` / ``False``), and ``delete`` drops a
  key's sharded checkpoint with its blob.
"""

from __future__ import annotations

import collections
import hashlib
import io
import os
import struct
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

Params = Dict[str, Any]

#: an array leaf above this many bytes is split into chunks (flax's
#: ``MAX_CHUNK_SIZE``: msgpack holds at most 2**31 - 1 bytes an object)
MAX_CHUNK_SIZE = 2 ** 30

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---- packing --------------------------------------------------------------

def _pack_int(out: io.BytesIO, v: int) -> None:
    if v > 0:
        if v < 0x80:
            out.write(bytes((v,)))
        elif v < 1 << 8:
            out.write(b"\xcc" + struct.pack(">B", v))
        elif v < 1 << 16:
            out.write(b"\xcd" + struct.pack(">H", v))
        elif v < 1 << 32:
            out.write(b"\xce" + struct.pack(">I", v))
        elif v < 1 << 64:
            out.write(b"\xcf" + struct.pack(">Q", v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.write(struct.pack(">b", v))
    elif v >= -(1 << 7):
        out.write(b"\xd0" + struct.pack(">b", v))
    elif v >= -(1 << 15):
        out.write(b"\xd1" + struct.pack(">h", v))
    elif v >= -(1 << 31):
        out.write(b"\xd2" + struct.pack(">i", v))
    elif v >= -(1 << 63):
        out.write(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(out: io.BytesIO, n: int, fix: Optional[int], fix_max: int,
              codes: bytes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes`` lists them; a leading 0 means no 8-bit
    form)."""
    if fix is not None and n < fix_max:
        out.write(bytes((fix | n,)))
    elif codes[0] and n < 1 << 8:
        out.write(bytes((codes[0], n)))
    elif n < 1 << 16:
        out.write(bytes((codes[1],)) + struct.pack(">H", n))
    elif n < 1 << 32:
        out.write(bytes((codes[2],)) + struct.pack(">I", n))
    else:
        raise ValueError(f"object of {n} bytes or items is too large for "
                         "msgpack")


def _pack_str(out: io.BytesIO, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xa0, 32, b"\xd9\xda\xdb")
    out.write(b)


def _pack_bin(out: io.BytesIO, b: Any) -> None:
    mv = memoryview(b).cast("B")
    _pack_len(out, mv.nbytes, None, 0, b"\xc4\xc5\xc6")
    out.write(mv)


def _pack_ext_header(out: io.BytesIO, code: int, n: int) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.write(bytes((fixed[n], code)))
        return
    _pack_len(out, n, None, 0, b"\xc7\xc8\xc9")
    out.write(bytes((code,)))


#: lists at least this long of only floats (a reply's probabilities) are
#: packed and unpacked in one vectorized pass, same bytes
_FLOAT_RUN = 16


def _float_run(x: List[float]) -> bytes:
    """The msgpack items of a list of floats: 0xcb and a big-endian
    float64 each."""
    items = np.empty((len(x), 9), np.uint8)
    items[:, 0] = 0xcb
    items[:, 1:] = np.asarray(x, ">f8").view(np.uint8).reshape(-1, 8)
    return items.tobytes()


def _host_array(x: Any) -> np.ndarray:
    """A leaf's bytes as a C-contiguous host array (a bf16 tensor as its
    uint16 bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return np.ascontiguousarray(t.cpu().numpy())
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    return np.ascontiguousarray(x)


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(str(x.dtype).replace("torch.", "")).name
    return x.dtype.name


def _pack_array(out: io.BytesIO, x: Any, code: int) -> None:
    """ext ``code`` around the msgpack of ``(shape, dtype name, C bytes)``
    (flax's ``_ndarray_to_bytes``), the data copied once, into ``out``."""
    data = _host_array(x)
    head = io.BytesIO()
    shape = tuple(int(d) for d in x.shape)
    _pack_len(head, 3, 0x90, 16, b"\x00\xdc\xdd")
    _pack_len(head, len(shape), 0x90, 16, b"\x00\xdc\xdd")
    for d in shape:
        _pack_int(head, d)
    _pack_str(head, _dtype_name(x))
    _pack_len(head, data.nbytes, None, 0, b"\xc4\xc5\xc6")
    head = head.getvalue()
    _pack_ext_header(out, code, len(head) + data.nbytes)
    out.write(head)
    out.write(memoryview(data).cast("B") if data.nbytes else b"")


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x: Any) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.nbytes


class _InOrder(dict):
    """A dict packed in insertion order, not sorted: flax builds the
    chunked-leaf dicts after the tree's dicts were sorted."""


def _chunk(arr: Any) -> _InOrder:
    """flax's ``_chunk``: the flattened array in slices of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return _InOrder([
        (_CHUNKED, True),
        ("shape", _InOrder((str(i), int(d))
                           for i, d in enumerate(arr.shape))),
        ("chunks", _InOrder((str(j), flat[i:i + size])
                            for j, i in enumerate(range(0, n, size))))])


def _pack(out: io.BytesIO, x: Any, chunk: bool) -> None:
    """One object. ``chunk``: an oversized array here is chunked (dict
    values and the root; flax leaves arrays inside lists whole)."""
    if x is None:
        out.write(b"\xc0")
    elif x is True:
        out.write(b"\xc3")
    elif x is False:
        out.write(b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.write(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _pack_str(out, x)
    elif type(x) in (bytes, bytearray, memoryview):
        _pack_bin(out, x)
    elif type(x) in (dict, _InOrder):
        keys = sorted(x) if type(x) is dict else list(x)
        _pack_len(out, len(keys), 0x80, 16, b"\x00\xde\xdf")
        for k in keys:
            _pack(out, k, False)
            _pack(out, x[k], True)
    elif type(x) is list:
        _pack_len(out, len(x), 0x90, 16, b"\x00\xdc\xdd")
        if len(x) >= _FLOAT_RUN and all(type(v) is float for v in x):
            out.write(_float_run(x))
        else:
            for v in x:
                _pack(out, v, False)
    elif _is_array(x):
        if chunk and _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(out, _chunk(x), False)
        else:
            _pack_array(out, x, _EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _pack_array(out, np.asarray(x), _EXT_NPSCALAR)
    elif type(x) is complex:
        body = io.BytesIO()
        _pack_len(body, 2, 0x90, 16, b"\x00\xdc\xdd")
        for part in (x.real, x.imag):
            body.write(b"\xcb" + struct.pack(">d", part))
        body = body.getvalue()
        _pack_ext_header(out, _EXT_COMPLEX, len(body))
        out.write(body)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def params_to_bytes(params: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for
    ``params``: nested dicts and lists of None, bool, int, float, str,
    bytes, complex, numpy scalars and arrays, and torch tensors (copied
    to the host as they are written)."""
    out = io.BytesIO()
    _pack(out, params, True)
    return out.getvalue()


# ---- unpacking ------------------------------------------------------------

class _Reader:
    __slots__ = ("mv", "pos", "raw")

    def __init__(self, data: Any, raw: bool = False) -> None:
        self.mv = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("msgpack data is truncated")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> Any:
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def list_(self, n: int) -> List[Any]:
        if n >= _FLOAT_RUN and self.pos + 9 * n <= len(self.mv):
            items = np.frombuffer(self.mv[self.pos:self.pos + 9 * n],
                                  np.uint8).reshape(n, 9)
            if (items[:, 0] == 0xcb).all():
                self.pos += 9 * n
                return items[:, 1:].copy().view(">f8").ravel().tolist()
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        for _ in range(n):
            k = self.read()
            if type(k) not in (str, bytes):
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 "map key when strict_map_key=True")
            out[k] = self.read()
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map_(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str_(b & 0x1f)
        if b == 0xc0:
            return None
        if b == 0xc2:
            return False
        if b == 0xc3:
            return True
        simple = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                  0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                  0xd2: ">i", 0xd3: ">q"}
        if b in simple:
            return self.unpack(simple[b])
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B",
                 0xc8: ">H", 0xc9: ">I", 0xd9: ">B", 0xda: ">H",
                 0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H",
                 0xdf: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b <= 0xc9:
                return self.ext(n)
            if b <= 0xdb:
                return self.str_(n)
            if b <= 0xdd:
                return self.list_(n)
            return self.map_(n)
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")


def _array_from_bytes(data: memoryview) -> Any:
    """flax's ``_ndarray_from_bytes``: a read-only view of the blob's bytes
    (a ``bfloat16`` array as a CPU torch tensor over its uint16 bits)."""
    r = _Reader(data, raw=True)
    if r.take(1)[0] != 0x93:
        raise ValueError("ndarray ext is not a (shape, dtype, buffer) "
                         "triple")
    shape, name = r.read(), r.read().decode()
    # the buffer, a bin, is taken as a view rather than read as bytes
    head = r.take(1)[0]
    sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
    if head not in sizes:
        raise ValueError("ndarray ext holds no bin buffer")
    buf = r.take(r.unpack(sizes[head]))
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape,
                                                            order="C")


def _ext_unpack(code: int, data: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_COMPLEX:
        re_, im = _Reader(data).read()
        return complex(re_, im)
    if code == _EXT_NPSCALAR:
        arr = _array_from_bytes(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    # flax hands an unknown code back as msgpack.ExtType; nothing on this
    # wire writes one
    raise ValueError(f"unknown msgpack ext code {code}")


def _unchunk(d: Dict[str, Any]) -> Any:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: dicts only, in place."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_tree(v)
    return d


def params_from_bytes(data: Any) -> Any:
    """What ``flax.serialization.msgpack_restore`` gives for ``data``."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.mv):
        raise ValueError("msgpack data has extra bytes after its object")
    return _unchunk_tree(out)


# ---- backends -------------------------------------------------------------

class ParamBackend:
    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.get(key) is not None


class InMemoryBackend(ParamBackend):
    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = data

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._data)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data


class FileBackend(ParamBackend):
    """One blob per file, written atomically by rename; file names are
    hashes of the keys, listed in ``index.tsv`` — the JAX backend's
    layout, so either package reads the other's directory."""

    def __init__(self, root: str) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._names: Dict[str, str] = {}
        self._lock = threading.Lock()
        idx = self.root / "index.tsv"
        if idx.exists():
            for line in idx.read_text().splitlines():
                if "\t" in line:
                    k, f = line.split("\t", 1)
                    self._names[k] = f

    def _fname(self, key: str) -> str:
        return hashlib.sha256(key.encode()).hexdigest()[:32] + ".msgpack"

    def put(self, key: str, data: bytes) -> None:
        fname = self._fname(key)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, self.root / fname)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            if key not in self._names:
                self._names[key] = fname
                with open(self.root / "index.tsv", "a") as f:
                    f.write(f"{key}\t{fname}\n")

    def get(self, key: str) -> Optional[bytes]:
        try:
            return (self.root / self._fname(key)).read_bytes()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            (self.root / self._fname(key)).unlink()
        except FileNotFoundError:
            pass
        with self._lock:
            self._names.pop(key, None)

    def keys(self) -> List[str]:
        with self._lock:
            return [k for k, f in self._names.items()
                    if (self.root / f).exists()]

    def exists(self, key: str) -> bool:
        return (self.root / self._fname(key)).exists()


class KVBackend(ParamBackend):
    """Blobs on the kv/queue data-plane server, under ``params:<key>``;
    the client's reconnect window rides out a server respawn."""

    RETRY_WINDOW_S = 8.0

    def __init__(self, host: str = "127.0.0.1", port: int = 6399) -> None:
        from rafiki_tpu_torch.native.client import KVClient

        self._client = KVClient(host, port,
                                retry_window_s=self.RETRY_WINDOW_S)

    def put(self, key: str, data: bytes) -> None:
        self._client.set(f"params:{key}", data)

    def get(self, key: str) -> Optional[bytes]:
        return self._client.get(f"params:{key}")

    def delete(self, key: str) -> None:
        self._client.delete(f"params:{key}")

    def keys(self) -> List[str]:
        return [k[len("params:"):] for k in self._client.keys("params:*")]

    def exists(self, key: str) -> bool:
        return self._client.exists(f"params:{key}")


# ---- the store ------------------------------------------------------------

class ParamStore:
    """Save/load trial parameters with an LRU bytes cache."""

    def __init__(self, backend: Optional[ParamBackend] = None,
                 cache_size: int = 4) -> None:
        self.backend = backend or InMemoryBackend()
        self._cache: "collections.OrderedDict[str, bytes]" = \
            collections.OrderedDict()
        self._cache_size = cache_size
        self._lock = threading.Lock()

    @staticmethod
    def from_uri(uri: str) -> "ParamStore":
        """``mem://`` | ``file:///path`` | ``kv://host:port``."""
        if uri.startswith("mem://") or uri == "mem":
            return ParamStore(InMemoryBackend())
        if uri.startswith("file://"):
            return ParamStore(FileBackend(uri[len("file://"):]))
        if uri.startswith("kv://"):
            host, _, port = uri[len("kv://"):].partition(":")
            return ParamStore(KVBackend(host or "127.0.0.1",
                                        int(port or 6399)))
        return ParamStore(FileBackend(uri))  # bare path

    def _cache_put(self, trial_id: str, data: bytes) -> None:
        with self._lock:
            self._cache[trial_id] = data
            self._cache.move_to_end(trial_id)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)

    def save(self, trial_id: str, params: Params) -> str:
        data = params_to_bytes(params)
        self.backend.put(trial_id, data)
        self._cache_put(trial_id, data)
        return trial_id

    def load(self, trial_id: str) -> Optional[Params]:
        with self._lock:
            data = self._cache.get(trial_id)
            if data is not None:
                self._cache.move_to_end(trial_id)
        if data is None:
            data = self.backend.get(trial_id)
            if data is None:
                return None
            self._cache_put(trial_id, data)
        return params_from_bytes(data)

    def delete(self, trial_id: str) -> None:
        self.backend.delete(trial_id)
        with self._lock:
            self._cache.pop(trial_id, None)
        # a key's sharded checkpoint is the same logical object
        ckptr = self.sharded_checkpointer()
        if ckptr is not None and ckptr.exists(trial_id):
            ckptr.delete(trial_id)

    def keys(self) -> List[str]:
        return self.backend.keys()

    def exists(self, trial_id: str) -> bool:
        with self._lock:
            if trial_id in self._cache:
                return True
        return self.backend.exists(trial_id)

    def copy(self, src: str, dst: str) -> bool:
        """Bytes-level blob copy (no decode); False if ``src`` is absent."""
        with self._lock:
            data = self._cache.get(src)
        if data is None:
            data = self.backend.get(src)
            if data is None:
                return False
        self.backend.put(dst, data)
        self._cache_put(dst, data)
        return True

    # ---- sharded checkpoints ----
    def sharded_checkpointer(self):
        """The sharded checkpoint store beside a file backend
        (``<root>/sharded``); None for mem and kv backends, where
        callers save whole-tree blobs instead."""
        if getattr(self, "_sharded", None) is None:
            if not isinstance(self.backend, FileBackend):
                return None
            from rafiki_tpu_torch.store.sharded_ckpt import \
                ShardedCheckpointer

            self._sharded = ShardedCheckpointer(
                str(self.backend.root / "sharded"))
        return self._sharded

    def save_sharded_async(self, key: str, tree: Any) -> bool:
        """An async sharded save of ``tree``; False when the backend has
        no sharded store (the caller saves a blob instead)."""
        ckptr = self.sharded_checkpointer()
        if ckptr is None:
            return False
        ckptr.save_async(key, tree)
        return True

    def sharded_ref(self, key: str):
        """A lazy restore handle for ``key``'s sharded checkpoint, or
        None when there is none. An in-flight save lands first; an
        earlier save's failure is logged, not raised."""
        ckptr = self.sharded_checkpointer()
        if ckptr is None:
            return None
        ckptr.wait(reraise=False, log=True)
        if not ckptr.exists(key):
            return None
        from rafiki_tpu_torch.store.sharded_ckpt import ShardedCheckpointRef

        return ShardedCheckpointRef(ckptr, key)

    def copy_sharded(self, src: str, dst: str) -> bool:
        ckptr = self.sharded_checkpointer()
        if ckptr is None:
            return False
        return ckptr.copy(src, dst)  # waits internally (quiet)

    def exists_sharded(self, key: str) -> bool:
        ckptr = self.sharded_checkpointer()
        if ckptr is None:
            return False
        ckptr.wait(reraise=False, log=True)
        return ckptr.exists(key)
