"""The safetensors file format, read and written without the
``safetensors`` package.

A file is an 8-byte little-endian header length ``n``, a JSON header of
``n`` bytes (for each tensor its ``dtype``, ``shape`` and
``data_offsets`` ``[begin, end)`` into the byte buffer that follows; an
optional ``__metadata__`` map of strings), then the raw little-endian
tensor bytes. :class:`SafeFile` memory-maps a file and reads a tensor
only when it is asked for (``np.memmap``), so an 8B checkpoint never sits
in host memory whole; BF16 is mapped as 16-bit integers and viewed as
``torch.bfloat16``. :func:`save_file` writes tensors one at a time.
"""

from __future__ import annotations

import json
import struct
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

#: the checkpoint dtypes: safetensors name -> (numpy storage dtype,
#: torch dtype); BF16's storage is its 16 bits
DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
}
_TORCH_NAME = {t: name for name, (_n, t) in DTYPES.items()}
_NUMPY_NAME = {np.dtype("<f4"): "F32", np.dtype("<f2"): "F16"}

Array = Union[np.ndarray, torch.Tensor]


def read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header dict, byte offset of the data buffer)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: safetensors header is not an object")
    return header, 8 + n


class SafeFile:
    """A safetensors file opened for reading: ``keys()``, ``shape``,
    ``dtype``, ``metadata()`` from its header; :meth:`get_tensor_view`
    memory-maps one tensor's bytes as a CPU tensor."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        header, self._base = read_header(self.path)
        self._meta = header.pop("__metadata__", None) or {}
        self._entries: Dict[str, Dict[str, Any]] = header

    def keys(self) -> List[str]:
        return list(self._entries)

    def metadata(self) -> Dict[str, str]:
        return dict(self._meta)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(int(d) for d in self._entries[name]["shape"])

    def dtype(self, name: str) -> str:
        return str(self._entries[name]["dtype"])

    def get_numpy(self, name: str) -> np.ndarray:
        """The tensor's bytes as a read-only memory-mapped array of its
        storage dtype (BF16 as ``uint16``)."""
        e = self._entries[name]
        code = str(e["dtype"])
        if code not in DTYPES:
            raise ValueError(f"{self.path}: {name} has dtype {code}, "
                             "which this reader does not take")
        storage = DTYPES[code][0]
        begin, end = (int(x) for x in e["data_offsets"])
        shape = self.shape(name)
        count = int(np.prod(shape)) if shape else 1
        if end - begin != count * storage.itemsize:
            raise ValueError(f"{self.path}: {name} spans {end - begin} "
                             f"bytes, its shape {shape} needs "
                             f"{count * storage.itemsize}")
        if count == 0:
            return np.zeros(shape, storage)
        return np.memmap(self.path, dtype=storage, mode="r",
                         offset=self._base + begin, shape=shape)

    def get_tensor_view(self, name: str) -> torch.Tensor:
        """The tensor as a read-only CPU tensor over the memory-mapped
        bytes (BF16 viewed as ``torch.bfloat16``): nothing is read until
        it is used, and it must not be written."""
        arr = self.get_numpy(name)
        if self.dtype(name) == "BF16":
            arr = arr.view(np.int16)
        with warnings.catch_warnings():  # "not writable": only read
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if self.dtype(name) == "BF16" else t


def _as_bytes_source(value: Array) -> Tuple[str, Tuple[int, ...],
                                             np.ndarray]:
    """(dtype code, shape, a contiguous little-endian numpy view of the
    bytes) of a tensor or array to write."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        code = _TORCH_NAME.get(t.dtype)
        if code is None:
            raise ValueError(f"cannot write a {t.dtype} tensor")
        if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        return code, tuple(t.shape), arr
    arr = np.ascontiguousarray(value)
    dt = arr.dtype.newbyteorder("<")
    code = _NUMPY_NAME.get(dt)
    if code is None:
        raise ValueError(f"cannot write a {arr.dtype} array")
    return code, tuple(arr.shape), arr.astype(dt, copy=False)


def save_file(tensors: Mapping[str, Array], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors of any device, or numpy arrays)
    to ``path`` in the safetensors format, in the given order, one tensor
    at a time. The header is padded with spaces to a multiple of 8
    bytes, as the ``safetensors`` package writes it."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    offset = 0
    plan = []
    for name, value in tensors.items():
        if isinstance(value, torch.Tensor):
            code = _TORCH_NAME.get(value.dtype)
            shape = tuple(value.shape)
            itemsize = value.element_size()
        else:
            code = _NUMPY_NAME.get(
                np.asarray(value).dtype.newbyteorder("<"))
            shape = tuple(np.shape(value))
            itemsize = np.asarray(value).dtype.itemsize
        if code is None:
            raise ValueError(f"{name}: cannot write dtype "
                             f"{getattr(value, 'dtype', type(value))}")
        n = int(np.prod(shape)) * itemsize if shape else itemsize
        header[name] = {"dtype": code, "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        plan.append((name, n))
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, n in plan:
            _code, _shape, arr = _as_bytes_source(tensors[name])
            data = memoryview(arr.reshape(-1).view(np.uint8))
            if len(data) != n:
                raise ValueError(f"{name}: wrote {len(data)} bytes, "
                                 f"planned {n}")
            f.write(data)
