"""PNG decode and encode on ``zlib`` and ``struct`` alone.

The JAX package reads the ``.zip`` / ``labels.csv`` image layouts and the
streaming loader's members through PIL (``rafiki_tpu/data/dataset.py``
``_load_zip_dataset``, ``rafiki_tpu/data/stream.py`` ``_decode``) and
writes its archives with it (``generate_fashion_archive``,
``generate_streaming_image_zip``). The card's machine has no PIL, so the
port keeps its own codec for what those layouts hold:

- :func:`decode_png`: 8-bit greyscale, greyscale + alpha, RGB and RGBA,
  non-interlaced, every row filter (None, Sub, Up, Average, Paeth). It
  returns what ``np.asarray(PIL.Image.open(...))`` returns: uint8
  (H, W) for greyscale, (H, W, C) otherwise. Palette, 16-bit and
  sub-byte depths, interlaced (Adam7) PNGs, and JPEG, raise ``NotPorted``
  naming themselves;
- :func:`encode_png`: filter type 0 on every row, one ``IDAT``.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

from rafiki_tpu_torch.serving.decode_engine import NotPorted

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> channels, for the types the decoder reads
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_JPEG_SOI = b"\xff\xd8\xff"


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """One PNG file's pixels, as ``np.asarray(PIL.Image.open(...))``."""
    if not data.startswith(SIGNATURE):
        if data.startswith(_JPEG_SOI):
            raise NotPorted("JPEG decoding is not ported (the port reads "
                            "PNG and .npy images)")
        raise ValueError("not a PNG file (bad signature)")
    header = None
    idat: List[bytes] = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _compression, _filter, interlace = header
    if color == 3:
        raise NotPorted("palette (colour type 3) PNG decoding is not "
                        "ported")
    if color not in CHANNELS:
        raise ValueError(f"PNG colour type {color} is not valid")
    if depth != 8:
        raise NotPorted(f"{depth}-bit PNG decoding is not ported (8-bit "
                        "only)")
    if interlace:
        raise NotPorted("interlaced (Adam7) PNG decoding is not ported")
    bpp = CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data is {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        start = r * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:
            cur = np.frombuffer(_unfilter_average(
                line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_unfilter_paeth(
                line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {r}: filter type {ftype} is not "
                             "valid")
        out[r] = cur
        prev = out[r]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """A PNG of a uint8 (H, W) or (H, W, C) image, C in 1..4 (1 is
    greyscale, 2 greyscale + alpha), every row filter type 0."""
    a = np.ascontiguousarray(img, np.uint8)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    bpp = 1 if a.ndim == 2 else a.shape[-1]
    color = {1: 0, 2: 4, 3: 2, 4: 6}.get(bpp)
    if a.ndim not in (2, 3) or color is None:
        raise ValueError(f"cannot encode an image of shape {img.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, w * bpp)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + \
        _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b"")
