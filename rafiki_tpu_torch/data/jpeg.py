"""JPEG decode and encode over the port's native codec.

The JAX package reads JPEG members through PIL (``np.asarray(
Image.open(...))``) and its streaming generator writes them with
``Image.save(format="JPEG")``; PIL runs libjpeg-turbo with its defaults.
The card's machine has no PIL, so the port keeps its own codec,
``native/jpeg_codec.cc``, built with ``g++`` into
``build/rafiki_tpu_torch/librjpeg.so`` at first use and bound here
through ``ctypes`` (which releases the GIL for the call, so the stream's
worker threads decode in parallel). There is no fallback: when ``g++``
is missing or the build fails, the call raises.

- :func:`decode_jpeg`: what ``np.asarray(PIL.Image.open(...))`` returns,
  bit for bit: uint8 (H, W) for one component, (H, W, 3) RGB for three.
  Baseline, extended sequential and progressive Huffman files with 8-bit
  samples. CMYK/YCCK, arithmetic coding, 12-bit samples, lossless and
  hierarchical files raise ``NotPorted`` naming the feature; a file that
  is not valid JPEG raises ``ValueError``.
- :func:`encode_jpeg`: the bytes PIL's ``save(format="JPEG")`` writes
  with its defaults (quality 75, 4:2:0 for RGB, baseline, the standard
  Huffman tables, a JFIF APP0) for a uint8 greyscale (H, W) or RGB
  (H, W, 3) image. It takes no options: the JAX package's generator
  passes none.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from rafiki_tpu_torch.serving.decode_engine import NotPorted

SOI = b"\xff\xd8\xff"
_ERR_LEN = 512
_NOT_PORTED, _INVALID, _TOO_SMALL = -1, -2, -3

_lib: Optional[ctypes.CDLL] = None
_lib_key: Optional[Tuple[str, int]] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """The codec, building it when it is missing or older than its
    source. Raises when it cannot be built or loaded."""
    global _lib, _lib_key
    from rafiki_tpu_torch.native.client import ensure_built

    path = ensure_built(target="librjpeg.so")
    key = (str(path), path.stat().st_mtime_ns)
    with _lib_lock:
        if _lib is None or _lib_key != key:
            lib = ctypes.CDLL(str(path))
            buf = ctypes.c_char_p
            lib.rjpeg_header.restype = ctypes.c_int32
            lib.rjpeg_header.argtypes = [
                buf, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p, ctypes.c_int32]
            lib.rjpeg_decode.restype = ctypes.c_int32
            lib.rjpeg_decode.argtypes = [
                buf, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int32]
            lib.rjpeg_encode.restype = ctypes.c_int64
            lib.rjpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int32]
            _lib, _lib_key = lib, key
        return _lib


def _raise(rc: int, err: ctypes.Array) -> None:
    msg = err.value.decode(errors="replace")
    if rc == _NOT_PORTED:
        raise NotPorted(msg)
    raise ValueError(msg)


def decode_jpeg(data: bytes) -> np.ndarray:
    """One JPEG file's pixels, as ``np.asarray(PIL.Image.open(...))``."""
    data = bytes(data)
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int32 * 3)()
    rc = lib.rjpeg_header(data, len(data), dims, err, _ERR_LEN)
    if rc:
        _raise(rc, err)
    h, w, c = dims
    out = np.empty((h, w) if c == 1 else (h, w, c), np.uint8)
    rc = lib.rjpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                          err, _ERR_LEN)
    if rc:
        _raise(rc, err)
    return out


def encode_jpeg(img: np.ndarray) -> bytes:
    """PIL's default JPEG of a uint8 (H, W) greyscale or (H, W, 3) RGB
    image (an (H, W, 1) image is greyscale)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8 pixels, not {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[-1] == 3)):
        raise ValueError(f"cannot write an image of shape {a.shape} as "
                         "JPEG (greyscale or RGB only)")
    a = np.ascontiguousarray(a)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else 3
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = 8 * a.size + 4096  # past any block's worst case
    out = np.empty(cap, np.uint8)
    n = lib.rjpeg_encode(a.ctypes.data, h, w, c, out.ctypes.data, cap, err,
                         _ERR_LEN)
    if n < 0:
        if n == _TOO_SMALL:
            raise RuntimeError(f"JPEG of {err.value.decode()} bytes "
                               f"overflows its {cap}-byte buffer")
        _raise(int(n), err)
    return out[:n].tobytes()
