"""One image file's pixels: the port's counterpart of
``np.asarray(PIL.Image.open(io.BytesIO(data)))``.

:func:`decode_image` reads the file's signature, as PIL's plugins accept
a file, and hands it to the port's own decoders: ``data/png.py`` for
PNG, ``data/jpeg.py`` for JPEG. Every other format PIL opens raises
``NotPorted`` naming it; bytes that no format claims raise
``ValueError``, as PIL's ``UnidentifiedImageError`` does.
:func:`decode_uint8` is what the loaders store: the decoded array cast
to uint8 (``data/png.py``'s :func:`~rafiki_tpu_torch.data.png.to_uint8`).
"""

from __future__ import annotations

import numpy as np

from rafiki_tpu_torch.data.jpeg import SOI as JPEG_SOI
from rafiki_tpu_torch.data.jpeg import decode_jpeg
from rafiki_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from rafiki_tpu_torch.data.png import decode_png, to_uint8
from rafiki_tpu_torch.serving.decode_engine import NotPorted

#: (signature at offset 0, format name) for the formats PIL opens that
#: the port does not read
_UNPORTED = (
    (b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "BigTIFF"),
    (b"MM\x00+", "BigTIFF"), (b"\x00\x00\x01\x00", "ICO"),
    (b"\x00\x00\x02\x00", "CUR"), (b"\x00\x00\x00\x0cjP  \r\n\x87\n",
                                   "JPEG 2000"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"qoif", "QOI"), (b"DDS ", "DDS"),
    (b"8BPS", "PSD"), (b"icns", "ICNS"), (b"\x01\xda", "SGI"),
    (b"\x59\xa6\x6a\x95", "Sun raster"), (b"BLP1", "BLP"), (b"BLP2", "BLP"),
    (b"SIMPLE", "FITS"), (b"#define", "XBM"), (b"/* XPM */", "XPM"),
)


def _unported_name(data: bytes) -> str:
    for sig, name in _UNPORTED:
        if data.startswith(sig):
            return name
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"123456fF" \
            and data[2:3].isspace():
        return "PPM/PGM/PBM"
    return ""


def decode_image(data: bytes) -> np.ndarray:
    """The pixels of one PNG or JPEG file, as
    ``np.asarray(PIL.Image.open(io.BytesIO(data)))`` gives them."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data)
    name = _unported_name(data)
    if name:
        raise NotPorted(f"{name} images are not ported (the port reads "
                        "PNG and JPEG)")
    raise ValueError("cannot identify image file (not PNG or JPEG, nor a "
                     "format PIL knows by its signature)")


def decode_uint8(data: bytes) -> np.ndarray:
    """:func:`decode_image`, cast to uint8 as the loaders store it."""
    return to_uint8(decode_image(data))
