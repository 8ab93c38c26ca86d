"""PNG decode and encode on ``zlib`` and ``struct`` alone.

The JAX package reads the ``.zip`` / ``labels.csv`` image layouts and the
streaming loader's members through PIL (``rafiki_tpu/data/dataset.py``
``_load_zip_dataset``, ``rafiki_tpu/data/stream.py`` ``_decode``) and
writes its archives with it (``generate_fashion_archive``,
``generate_streaming_image_zip``). The card's machine has no PIL, so the
port keeps its own codec for what those layouts hold:

- :func:`decode_png`: every colour type and bit depth the PNG
  specification allows (greyscale 1/2/4/8/16, RGB 8/16, palette
  1/2/4/8, greyscale + alpha 8/16, RGBA 8/16), plain or Adam7-interlaced,
  every row filter (None, Sub, Up, Average, Paeth) in every pass. It
  returns what ``np.asarray(PIL.Image.open(...))`` returns, in dtype,
  shape and value: a palette image's indices (uint8 (H, W); ``PLTE``
  and ``tRNS`` are read past, as PIL's array ignores them), 1-bit
  greyscale as bool, 2- and 4-bit greyscale scaled by 85 and 17, 16-bit
  greyscale as uint16, 16-bit RGB and RGBA as their high bytes, 16-bit
  greyscale + alpha as RGBA (H, W, 4) high bytes, the rest uint8 (H, W)
  for greyscale and (H, W, C) otherwise;
- :func:`to_uint8`: the loaders' cast of a decoded image to uint8 (16-bit
  samples by their high byte);
- :func:`encode_png`: filter type 0 on every row, one ``IDAT``.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> channels
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: colour type -> the bit depths the PNG specification allows
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
#: 2 x PIL's ``Image.MAX_IMAGE_PIXELS``: PIL's ``Image.open`` refuses a
#: larger image (``DecompressionBombError``)
MAX_PIXELS = 2 * 89478485
#: Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter(raw: bytes, offset: int, rows: int, stride: int,
              bpp: int) -> np.ndarray:
    """``rows`` filtered scanlines of ``stride`` bytes from ``raw`` at
    ``offset``, each led by its filter byte; ``bpp`` is the filters'
    byte distance to the left neighbour."""
    out = np.empty((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(rows):
        start = offset + r * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
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
    return out


def _samples(lines: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """Unfiltered scanlines -> (rows, width, channels) sample values:
    uint16 for 16-bit, uint8 otherwise (sub-byte samples unscaled)."""
    rows = lines.shape[0]
    n = width * channels
    if depth == 8:
        flat = lines
    elif depth == 16:
        pairs = lines.reshape(rows, n, 2).astype(np.uint16)
        flat = (pairs[..., 0] << 8) | pairs[..., 1]
    else:
        bits = np.unpackbits(lines, axis=1)[:, :n * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        flat = (bits.reshape(rows, n, depth) * weights).sum(
            axis=2, dtype=np.uint8)
    return flat.reshape(rows, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """One PNG file's pixels, as ``np.asarray(PIL.Image.open(...))``."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header = None
    idat: List[bytes] = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        # PLTE and tRNS are read past: PIL applies neither to the array
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _compression, _filter, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"PNG colour type {color} is not valid")
    channels = CHANNELS[color]
    if depth not in DEPTHS[color]:
        raise ValueError(f"PNG colour type {color} has no {depth}-bit "
                         "depth")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not valid")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG of {w}x{h} pixels is over PIL's "
                         "decompression-bomb limit")
    bpp = max(1, depth * channels // 8)
    raw = zlib.decompress(b"".join(idat))
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((h, w, channels),
                       np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:  # an empty pass holds no bytes at all
            continue
        stride = -(-(pw * channels * depth) // 8)
        if offset + ph * (stride + 1) > len(raw):
            raise ValueError(f"PNG data is {len(raw)} bytes, too short "
                             f"for its {w}x{h} image")
        lines = _unfilter(raw, offset, ph, stride, bpp)
        samples[y0::dy, x0::dx] = _samples(lines, pw, depth, channels)
        offset += ph * (stride + 1)
    if offset != len(raw):
        raise ValueError(f"PNG data is {len(raw)} bytes, expected {offset}")
    return _as_pil(samples, depth, color)


def _as_pil(samples: np.ndarray, depth: int, color: int) -> np.ndarray:
    """PIL's array for the samples: the mode its PNG plugin picks and the
    unpacker's values."""
    if color == 3:  # mode P: the palette indices
        return samples[..., 0].astype(np.uint8)
    if color == 0:
        grey = samples[..., 0]
        if depth == 1:  # mode 1
            return grey != 0
        if depth == 16:  # mode I;16
            return grey.astype(np.uint16)
        return (grey * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16:  # RGB;16B, RGBA;16B, LA;16B: the high bytes
        hi = (samples >> 8).astype(np.uint8)
        if color == 4:  # mode RGBA: L, L, L, A
            return hi[..., [0, 0, 0, 1]]
        return hi
    return samples


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """A decoded image as the port's loaders store it: uint8, 16-bit
    samples by their high byte (as PIL reads 16-bit RGB), a 1-bit image's
    booleans as 0/1. The JAX loaders cast with ``astype(np.uint8)``,
    which keeps a 16-bit greyscale image's low byte instead."""
    if arr.dtype == np.uint16:
        return (arr >> 8).astype(np.uint8)
    return np.asarray(arr, np.uint8)


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
