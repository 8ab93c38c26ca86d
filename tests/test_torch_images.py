"""Port parity: the image codecs the JAX loaders reach through PIL
(``rafiki_tpu_torch/data/png.py``, ``data/jpeg.py`` over
``native/jpeg_codec.cc``, ``data/image.py``), held against PIL, which
only tests import, and through the loaders against the JAX package.

- PNG: every colour type and bit depth the specification allows, plain
  and Adam7-interlaced, at odd sizes (1x1 and 3x5, where passes are
  empty, and 13x17), every row filter in every pass, written by a numpy
  + ``zlib`` writer here (PIL writes few of them): ``decode_png`` equals
  ``np.asarray(PIL.Image.open(...))`` in dtype, shape and value.
- JPEG decode: greyscale and RGB, subsampling 4:4:4 / 4:2:2 / 4:2:0,
  quality 10 / 75 / 95 / 100, optimized tables, progressive, restart
  intervals, at 1x1, 8x8, 13x17 and 225x223, plus RGB under an Adobe
  APP14 marker and under 'R','G','B' component ids: bit-equal to PIL.
- JPEG encode: ``encode_jpeg`` writes PIL's ``save(format="JPEG")``
  bytes for the streaming generator's images and for odd sizes, and the
  port's generator writes JAX's zip member for member.
- The zip and directory layouts with JPEG and palette-PNG members load
  as JAX's loader loads them; a 16-bit greyscale PNG is the one
  deliberate difference (JAX keeps its low byte, the port its high
  byte).
- Refusals: CMYK, arithmetic, 12-bit, lossless and hierarchical JPEG,
  BMP and GIF raise ``NotPorted`` naming themselves; a missing ``g++``
  raises instead of falling back.
- The chip run's fixtures under ``tests/fixtures/torch_images/`` are
  rebuilt here from PIL and JAX and must be unchanged
  (``PYTHONPATH=. python tests/test_torch_images.py --write``, from the
  repository's root, rewrites them).

Every comparison is exact.
"""

import hashlib
import io
import itertools
import json
import struct
import sys
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rafiki_tpu.data import dataset as jds
from rafiki_tpu.data import stream as jstream
from rafiki_tpu_torch.data import dataset as pds
from rafiki_tpu_torch.data import image, jpeg, png
from rafiki_tpu_torch.data import stream as pstream
from rafiki_tpu_torch.native import client
from rafiki_tpu_torch.serving.decode_engine import NotPorted

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_images"
ARRAYS = "pil_arrays.npz"
DIGESTS = "generator_digests.json"
#: (n, image shape, seed) of the generator cases the chip run re-digests
GENERATOR_CASES = ((4, (224, 224, 3), 0), (6, (13, 17, 3), 1),
                   (3, (1, 1, 3), 2))

# ---- a PNG writer from the specification


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
#: colour type -> (channels, bit depths)
PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
             3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples, depth):
    """(rows, width, channels) sample values -> packed scanlines."""
    rows = samples.shape[0]
    vals = samples.reshape(rows, -1).astype(np.int64)
    if depth == 8:
        return vals.astype(np.uint8)
    if depth == 16:
        return vals.astype(">u2").view(np.uint8).reshape(rows, -1)
    bits = (vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(rows, -1).astype(np.uint8), axis=1)


def _filter(lines, bpp, first):
    """Filter each scanline, its type cycling through all five from
    ``first``."""
    out = bytearray()
    prev = np.zeros(lines.shape[1], np.int64)
    for r, cur in enumerate(lines.astype(np.int64)):
        ftype = (first + r) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return out


def write_png(samples, depth, color, interlace):
    """A PNG of ``samples`` (rows, width, channels), with a ``PLTE`` and
    a ``tRNS`` for palette images."""
    h, w, channels = samples.shape
    bpp = max(1, depth * channels // 8)
    raw = bytearray()
    for i, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, i)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if color == 3:
        n = 1 << depth
        out += _chunk(b"PLTE", bytes((7 * i) % 256 for i in range(3 * n)))
        out += _chunk(b"tRNS", bytes((11 * i) % 256 for i in range(n)))
    return out + _chunk(b"IDAT", zlib.compress(bytes(raw))) + \
        _chunk(b"IEND", b"")


def _png_case(color, depth, interlace, shape, seed):
    channels = PNG_TYPES[color][0]
    rng = np.random.default_rng(seed)
    samples = rng.integers(0, 1 << depth, shape + (channels,))
    return write_png(samples, depth, color, interlace)


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", [
    (c, d) for c, (_, depths) in PNG_TYPES.items() for d in depths])
def test_png_decode_equals_pil(color, depth, interlace):
    for i, shape in enumerate(((1, 1), (3, 5), (13, 17))):
        data = _png_case(color, depth, interlace, shape, 100 * color + depth
                         + 10 * i + interlace)
        _assert_same(png.decode_png(data), _pil(data))
        _assert_same(image.decode_image(data), _pil(data))


# ---- JPEG

JPEG_SIZES = ((1, 1), (8, 8), (13, 17), (225, 223))
JPEG_FLAGS = ({}, {"optimize": True}, {"progressive": True},
              {"restart_marker_rows": 1},
              {"progressive": True, "optimize": True})


def jpeg_cases():
    """40 (mode, size, options) cases: each mode x quality x flag set,
    the size and the subsampling cycling through theirs."""
    cases = []
    for i, (mode, quality, flags) in enumerate(itertools.product(
            ("L", "RGB"), (10, 75, 95, 100), JPEG_FLAGS)):
        opts = dict(flags, quality=quality)
        if mode == "RGB":
            opts["subsampling"] = (i + 1) % 3
        cases.append((mode, JPEG_SIZES[i % len(JPEG_SIZES)], opts))
    return cases


def _photo(shape, channels, seed):
    """A smooth image with noise on it: the quantizers' every level sees
    use."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[:h, :w]
    base = 128 + 100 * np.sin(x / 5.0 + 0.3 * seed) * np.cos(y / 7.0)
    img = base[..., None] + rng.normal(0, 20, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pil_jpeg(img, mode=None, **opts):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("mode,size,opts", jpeg_cases(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_jpeg_decode_equals_pil(mode, size, opts):
    img = _photo(size, len(mode), seed=size[0] + len(mode))
    data = _pil_jpeg(img, mode, **opts)
    _assert_same(jpeg.decode_jpeg(data), _pil(data))
    _assert_same(image.decode_image(data), _pil(data))


def _segments(data, every_scan=False):
    """(marker, start, end) of each marker segment up to the first SOS,
    or through the last one with ``every_scan`` (skipping each scan's
    entropy-coded data)."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return out
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, pos, pos + 2 + length))
        pos += 2 + length
        if marker == 0xDA:
            if not every_scan:
                return out
            while data[pos] != 0xFF or data[pos + 1] == 0 or \
                    0xD0 <= data[pos + 1] <= 0xD7:
                pos += 1


def _without_jfif(data):
    for marker, start, end in _segments(data):
        if marker == 0xE0:
            return data[:start] + data[end:]
    raise AssertionError("no APP0")


def adobe_rgb_jpeg(data):
    """``data`` (a JFIF JPEG) with its APP0 replaced by an Adobe APP14,
    transform 0: its components are then read as R, G, B."""
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + \
        bytes([0, 100, 0, 0, 0, 0, 0])
    rest = _without_jfif(data)
    return rest[:2] + adobe + rest[2:]


def rgb_ids_jpeg(data):
    """``data`` without its APP0 and with component ids 'R', 'G', 'B'."""
    out = bytearray(_without_jfif(data))
    for marker, start, end in _segments(bytes(out), every_scan=True):
        if marker in (0xC0, 0xC1, 0xC2):
            for k in range(3):
                out[start + 10 + 3 * k] = b"RGB"[k]
        elif marker == 0xDA:
            for k in range(out[start + 4]):
                out[start + 5 + 2 * k] = b"RGB"[out[start + 5 + 2 * k] - 1]
    return bytes(out)


@pytest.mark.parametrize("variant", ["adobe", "ids"])
@pytest.mark.parametrize("opts", [{"subsampling": 0},
                                  {"subsampling": 2, "progressive": True}])
def test_jpeg_rgb_colour_space_equals_pil(variant, opts):
    img = _photo((19, 21), 3, seed=4)
    data = _pil_jpeg(img, **opts)
    data = adobe_rgb_jpeg(data) if variant == "adobe" else rgb_ids_jpeg(data)
    want = _pil(data)
    _assert_same(jpeg.decode_jpeg(data), want)
    # no colour conversion: the planes come back as they were coded
    assert not np.array_equal(want, _pil(_pil_jpeg(img, **opts)))


def _canonical_codes(bits, vals):
    """symbol -> (code, length) of a DHT table."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _pil_tables():
    """The DQT and DHT segments of PIL's default RGB JPEG, and its
    Huffman tables as {(class, id): codes}."""
    data = _pil_jpeg(np.zeros((8, 8, 3), np.uint8))
    dqt, dht, huff = b"", b"", {}
    for marker, start, end in _segments(data):
        if marker == 0xDB:
            dqt += data[start:end]
        elif marker == 0xC4:
            dht += data[start:end]
            body = data[start + 4:end]
            bits = list(body[1:17])
            huff[(body[0] >> 4, body[0] & 15)] = _canonical_codes(
                bits, list(body[17:17 + sum(bits)]))
    return dqt, dht, huff


def sampled_jpeg(img, factors, interleaved=True):
    """A baseline YCbCr JPEG of ``img`` (H, W, 3) with any sampling
    ``factors`` [(h, v)] * 3, in one interleaved scan or a scan per
    component, written here from the specification: box-averaged planes,
    a float DCT, PIL's quality-75 tables and its Huffman tables. Only the
    decoder's reading of it is under test."""
    dqt, dht, huff = _pil_tables()
    qt = [np.zeros(64) for _ in range(2)]
    for t in range(2):
        seg = dqt[69 * t + 5:69 * t + 69]
        qt[t][[jpeg_natural(i) for i in range(64)]] = list(seg)
    height, width = img.shape[:2]
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    mpr, rows = -(-width // (8 * mh)), -(-height // (8 * mv))
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"), np.float64)
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    basis *= np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    blocks = []
    for c, (h, v) in enumerate(factors):
        fy, fx = mv // v, mh // h
        dh, dw = -(-height * v // mv), -(-width * h // mh)
        full = np.pad(ycc[..., c], ((0, dh * fy - height),
                                    (0, dw * fx - width)), mode="edge")
        plane = full.reshape(dh, fy, dw, fx).mean(axis=(1, 3))
        plane = np.pad(plane, ((0, rows * v * 8 - dh),
                               (0, mpr * h * 8 - dw)), mode="edge") - 128
        coefs = np.einsum("ij,ajbk,lk->aibl", basis,
                          plane.reshape(rows * v, 8, mpr * h, 8), basis)
        q = qt[min(c, 1)].reshape(8, 8)
        blocks.append(np.round(coefs.transpose(0, 2, 1, 3) / q)
                      .astype(int).reshape(rows * v, mpr * h, 64))
    def entropy_coded(order):
        """The scan data of (component, block) pairs in ``order``."""
        bits, preds = [], [0, 0, 0]

        def put(code, length):
            bits.extend((code >> (length - 1 - i)) & 1 for i in range(length))

        def put_value(val):
            size = int(abs(val)).bit_length()
            return size, (val if val >= 0 else val + (1 << size) - 1)

        for c, blk in order:
            dc_t, ac_t = huff[(0, min(c, 1))], huff[(1, min(c, 1))]
            zz = [blk[jpeg_natural(i)] for i in range(64)]
            size, val = put_value(zz[0] - preds[c])
            preds[c] = zz[0]
            put(*dc_t[size])
            if size:
                put(val, size)
            run = 0
            for a in zz[1:]:
                if a == 0:
                    run += 1
                    continue
                while run > 15:
                    put(*ac_t[0xF0])
                    run -= 16
                size, val = put_value(a)
                put(*ac_t[(run << 4) | size])
                put(val, size)
                run = 0
            if run:
                put(*ac_t[0])
        bits.extend([1] * (-len(bits) % 8))
        data = np.packbits(np.asarray(bits, np.uint8)).tobytes()
        return data.replace(b"\xff", b"\xff\x00")

    def sos(comps):
        return b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps),
                                          len(comps)) + \
            b"".join(bytes([c + 1, 0x11 * min(c, 1)]) for c in comps) + \
            bytes([0, 63, 0])

    if interleaved:  # one scan, MCU by MCU
        order = [(c, blocks[c][my * v + y, mx * h + x])
                 for my in range(rows) for mx in range(mpr)
                 for c, (h, v) in enumerate(factors)
                 for y in range(v) for x in range(h)]
        scans = sos([0, 1, 2]) + entropy_coded(order)
    else:  # a scan per component, block by block over its own blocks
        scans = b""
        for c, (h, v) in enumerate(factors):
            wb = -(-width * h // (8 * mh))
            hb = -(-height * v // (8 * mv))
            scans += sos([c]) + entropy_coded(
                [(c, blocks[c][y, x]) for y in range(hb) for x in range(wb)])
    sof = struct.pack(">HBHHB", 17, 8, height, width, 3) + b"".join(
        bytes([c + 1, (h << 4) | v, min(c, 1)])
        for c, (h, v) in enumerate(factors))
    return b"\xff\xd8" + dqt + b"\xff\xc0" + sof + dht + scans + \
        b"\xff\xd9"


def jpeg_natural(i):
    """The natural (row-major) index of zigzag position ``i``."""
    order = sorted(((r + c, (r if (r + c) % 2 else c), r * 8 + c)
                    for r in range(8) for c in range(8)))
    return order[i][2]


@pytest.mark.parametrize("factors", [
    [(1, 2), (1, 1), (1, 1)],   # h1v2: 4:4:0
    [(2, 1), (1, 1), (1, 1)],   # h2v1: 4:2:2
    [(2, 2), (1, 1), (1, 1)],   # h2v2: 4:2:0
    [(2, 2), (1, 2), (2, 1)],   # h2v1 and h1v2 in one file
    [(4, 1), (1, 1), (1, 1)],   # h4v1 (4:1:1): plain replication
    [(1, 1), (2, 2), (1, 1)],   # the luma upsampled, a chroma plane not
], ids=lambda f: "_".join(f"{h}x{v}" for h, v in f))
@pytest.mark.parametrize("interleaved", [True, False],
                         ids=["interleaved", "a_scan_per_component"])
def test_jpeg_sampling_factors_equal_pil(factors, interleaved):
    for i, shape in enumerate(((1, 1), (2, 3), (5, 4), (13, 17), (33, 30))):
        img = _photo(shape, 3, seed=i)
        data = sampled_jpeg(img, factors, interleaved)
        want = _pil(data)
        assert want.shape == shape + (3,)
        assert np.abs(want.astype(int) - img).mean() < 20  # a fair copy
        _assert_same(jpeg.decode_jpeg(data), want)


def _generator_image(shape, seed):
    """The JAX generator's first image for ``seed`` (its draws)."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    label = int(rng.integers(4))
    img = rng.integers(0, 96, size=(h, w, c)).astype(np.uint8)
    qh, qw = h // 2, w // 2
    top, left = (label // 2) * qh, (label % 2) * qw
    img[top:top + qh, left:left + qw] = np.minimum(
        img[top:top + qh, left:left + qw] + 140, 255)
    return img


@pytest.mark.parametrize("shape", [(224, 224, 3), (1, 1, 3), (8, 8, 3),
                                   (13, 17, 3), (225, 223, 3), (17, 9, 3),
                                   (1, 1), (13, 17), (225, 223)])
def test_encode_jpeg_writes_pil_bytes(shape):
    if len(shape) == 3:
        img = _generator_image(shape, seed=sum(shape))
    else:
        img = _photo(shape, 1, seed=sum(shape))
    assert jpeg.encode_jpeg(img) == _pil_jpeg(img)


def _zip_digests(path):
    with zipfile.ZipFile(path) as z:
        return {name: hashlib.sha256(z.read(name)).hexdigest()
                for name in z.namelist()}


def test_generator_jpeg_zip_equals_jax(tmp_path):
    n, shape, seed = GENERATOR_CASES[0]
    jp, pp = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jstream.generate_streaming_image_zip(jp, n, shape, seed=seed,
                                         fmt="jpeg")
    pstream.generate_streaming_image_zip(pp, n, shape, seed=seed,
                                         fmt="jpeg")
    assert _zip_digests(pp) == _zip_digests(jp)
    j = jstream.StreamingImageDataset(jp)
    p = pstream.StreamingImageDataset(pp)
    for a, b in zip(p.iter_batches(3, augment=True, seed=2),
                    j.iter_batches(3, augment=True, seed=2)):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    # PIL knows no "JPG" format name, so neither generator writes one
    with pytest.raises(KeyError):
        jstream.generate_streaming_image_zip(jp, 1, fmt="jpg")
    with pytest.raises(NotPorted, match="jpg"):
        pstream.generate_streaming_image_zip(pp, 1, fmt="jpg")


def _layout_members(kind):
    """Six images with labels: JPEG (RGB) or palette PNG members."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(6):
        if kind == "jpeg":
            data = _pil_jpeg(_photo((11, 14), 3, seed=i),
                             progressive=bool(i % 2))
        else:
            img = rng.integers(0, 256, (11, 14, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).convert("P").save(buf, format="PNG")
            data = buf.getvalue()
        out.append((f"im/{i}.{'jpg' if kind == 'jpeg' else 'png'}", data,
                    ["b", "10", "a", "2"][i % 4]))
    return out


def _write_layout(tmp_path, layout, members):
    rows = "path,label\n" + "".join(f"{n},{lab}\n" for n, _, lab in members)
    if layout == "zip":
        path = tmp_path / "d.zip"
        with zipfile.ZipFile(path, "w") as z:
            for name, data, _ in members:
                z.writestr(name, data)
            z.writestr("labels.csv", rows)
    else:
        path = tmp_path / "d"
        (path / "im").mkdir(parents=True)
        for name, data, _ in members:
            (path / name).write_bytes(data)
        (path / "labels.csv").write_text(rows)
    return str(path)


@pytest.mark.parametrize("layout", ["zip", "dir"])
@pytest.mark.parametrize("kind", ["jpeg", "palette"])
def test_layouts_with_jpeg_and_palette_members_load_as_jax(tmp_path, kind,
                                                           layout):
    path = _write_layout(tmp_path, layout, _layout_members(kind))
    j = jds.load_image_classification_dataset(path)
    p = pds.load_image_classification_dataset(path)
    assert p.class_names == j.class_names == ["10", "2", "a", "b"]
    np.testing.assert_array_equal(p.labels, j.labels)
    _assert_same(p.images, j.images)
    js, ps = (jstream.StreamingImageDataset(path),
              pstream.StreamingImageDataset(path))
    assert ps.image_shape == js.image_shape
    for a, b in zip(ps.iter_batches(4, augment=True),
                    js.iter_batches(4, augment=True)):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()


def test_sixteen_bit_greyscale_loads_its_high_byte_in_the_port(tmp_path):
    """Queue C 22: the JAX loaders cast PIL's uint16 array with
    ``astype(np.uint8)``, keeping the low byte (31010 loads as 34); the
    port keeps the high byte (121), as PIL reads 16-bit RGB."""
    rng = np.random.default_rng(22)
    grey = rng.integers(0, 1 << 16, (5, 7, 1))
    grey[0, 0, 0] = 31010
    data = write_png(grey, 16, 0, 0)
    members = [(f"im/{i}.png", data, "x") for i in range(2)]
    path = _write_layout(tmp_path, "zip", members)
    j = jds.load_image_classification_dataset(path)
    p = pds.load_image_classification_dataset(path)
    assert j.images[0, 0, 0, 0] == 34 and p.images[0, 0, 0, 0] == 121
    np.testing.assert_array_equal(j.images[0], (grey & 0xFF).astype(np.uint8))
    np.testing.assert_array_equal(p.images[0], (grey >> 8).astype(np.uint8))
    jb = next(jstream.StreamingImageDataset(path).iter_batches(2))
    pb = next(pstream.StreamingImageDataset(path).iter_batches(2))
    np.testing.assert_array_equal(jb["x"], j.images)
    np.testing.assert_array_equal(pb["x"], p.images)


def _patched(data, marker=None, precision=None):
    """``data`` with its frame marker and/or sample precision changed
    (the refusal comes from the header: the scan is never read)."""
    out = bytearray(data)
    for m, start, _ in _segments(data):
        if m in (0xC0, 0xC1, 0xC2):
            if marker is not None:
                out[start + 1] = marker
            if precision is not None:
                out[start + 4] = precision
    return bytes(out)


def test_refusals_name_themselves():
    img = _photo((9, 9), 3, seed=1)
    base = _pil_jpeg(img)
    cmyk = io.BytesIO()
    Image.fromarray(np.concatenate([img, img[..., :1]], axis=2),
                    "CMYK").save(cmyk, format="JPEG")
    cases = [(cmyk.getvalue(), "CMYK"),
             (_patched(base, marker=0xC9), "arithmetic"),
             (_patched(base, marker=0xC3), "lossless"),
             (_patched(base, marker=0xC5), "hierarchical"),
             (_patched(base, precision=12), "12-bit")]
    for data, name in cases:
        with pytest.raises(NotPorted, match=name):
            image.decode_image(data)
    assert _pil(cmyk.getvalue()).shape == (9, 9, 4)  # PIL reads CMYK
    for fmt in ("BMP", "GIF"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        with pytest.raises(NotPorted, match=fmt):
            image.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="cannot identify"):
        image.decode_image(b"\x00" * 32)
    with pytest.raises(ValueError, match="ends"):
        jpeg.decode_jpeg(base[:len(base) // 2])
    with pytest.raises(ValueError, match="greyscale or RGB"):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    # past PIL's decompression-bomb bound: refused from the header alone
    huge = bytearray(base)
    for m, start, _ in _segments(base):
        if m == 0xC0:
            huge[start + 5:start + 9] = struct.pack(">HH", 65500, 65500)
    with pytest.raises(ValueError, match="decompression-bomb"):
        image.decode_image(bytes(huge))
    with pytest.raises(ValueError, match="decompression-bomb"):
        image.decode_image(png.SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 65500, 65500, 8, 0, 0, 0, 0)) + _chunk(b"IEND",
                                                              b""))


def test_threads_decode_and_encode_together():
    """The loader's worker threads call the codec at once (the GIL is
    released inside it): every result equals the single-threaded one."""
    from concurrent.futures import ThreadPoolExecutor

    imgs = [_photo((40 + i, 37), 3, seed=i) for i in range(8)]
    files = [_pil_jpeg(img, progressive=bool(i % 2))
             for i, img in enumerate(imgs)]
    want = [jpeg.decode_jpeg(f) for f in files]
    want_bytes = [jpeg.encode_jpeg(img) for img in imgs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            got = list(ex.map(jpeg.decode_jpeg, files * 8, timeout=60))
            got_bytes = list(ex.map(jpeg.encode_jpeg, imgs * 8, timeout=60))
    finally:
        sys.setswitchinterval(interval)
    for i, arr in enumerate(got):
        _assert_same(arr, want[i % len(files)])
    assert got_bytes == want_bytes * 8


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(client, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(client.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        jpeg.decode_jpeg(_pil_jpeg(_photo((8, 8), 1, seed=0)))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        image.decode_image(_pil_jpeg(_photo((8, 8), 1, seed=0)))


# ---- the chip run's fixtures


def fixture_files():
    """name -> bytes: one small file per decoder branch."""
    files = {}
    for color, (_, depths) in PNG_TYPES.items():
        for depth in depths:
            for interlace in (0, 1):
                files[f"png_c{color}_d{depth}_i{interlace}.png"] = \
                    _png_case(color, depth, interlace, (13, 17),
                              1000 + 10 * color + depth + interlace)
    grey, rgb = _photo((13, 17), 1, seed=8), _photo((13, 17), 3, seed=9)
    for name, img, opts in (
            ("grey", grey, {}), ("grey_q100", grey, {"quality": 100}),
            ("grey_progressive", grey, {"progressive": True}),
            ("rgb_420", rgb, {}), ("rgb_422", rgb, {"subsampling": 1}),
            ("rgb_444", rgb, {"subsampling": 0}),
            ("rgb_q10", rgb, {"quality": 10}),
            ("rgb_optimized", rgb, {"optimize": True}),
            ("rgb_restart", rgb, {"restart_marker_blocks": 2}),
            ("rgb_progressive", rgb, {"progressive": True}),
            ("rgb_progressive_restart", rgb, {"progressive": True,
                                              "restart_marker_rows": 1}),
            ("rgb_1x1", rgb[:1, :1], {})):
        files[f"jpeg_{name}.jpg"] = _pil_jpeg(img, **opts)
    files["jpeg_adobe_rgb.jpg"] = adobe_rgb_jpeg(
        _pil_jpeg(rgb, subsampling=0))
    files["jpeg_rgb_ids.jpg"] = rgb_ids_jpeg(_pil_jpeg(rgb, subsampling=0))
    files["jpeg_generator_64.jpg"] = _pil_jpeg(
        _generator_image((64, 64, 3), seed=3))
    return files


def fixture_arrays(files):
    return {name: _pil(data) for name, data in files.items()}


def generator_digests(tmp):
    """Each generator case's member digests, from JAX's generator."""
    out = []
    for n, shape, seed in GENERATOR_CASES:
        path = Path(tmp) / f"gen_{seed}.zip"
        jstream.generate_streaming_image_zip(str(path), n, shape, seed=seed,
                                             fmt="jpeg")
        out.append({"n": n, "shape": list(shape), "seed": seed,
                    "fmt": "jpeg", "sha256": _zip_digests(path)})
    return out


def write_fixtures(tmp):
    FIXTURES.mkdir(parents=True, exist_ok=True)
    files = fixture_files()
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)
    buf = io.BytesIO()
    np.savez_compressed(buf, **fixture_arrays(files))
    (FIXTURES / ARRAYS).write_bytes(buf.getvalue())
    (FIXTURES / DIGESTS).write_text(
        json.dumps(generator_digests(tmp), indent=1, sort_keys=True) + "\n")


def test_chip_fixtures_are_current(tmp_path):
    files = fixture_files()
    on_disk = {p.name for p in FIXTURES.iterdir()}
    assert on_disk == set(files) | {ARRAYS, DIGESTS}
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 256 * 1024
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    with np.load(FIXTURES / ARRAYS) as z:
        stored = {k: z[k] for k in z.files}
    want = fixture_arrays(files)
    assert set(stored) == set(want)
    for name in want:
        _assert_same(stored[name], want[name])
        _assert_same(image.decode_image(files[name]), want[name])
    assert json.loads((FIXTURES / DIGESTS).read_text()) == \
        generator_digests(tmp_path)


def test_port_generator_matches_the_recorded_digests(tmp_path):
    for case in json.loads((FIXTURES / DIGESTS).read_text()):
        path = tmp_path / f"p_{case['seed']}.zip"
        pstream.generate_streaming_image_zip(
            str(path), case["n"], tuple(case["shape"]), seed=case["seed"],
            fmt=case["fmt"])
        assert _zip_digests(path) == case["sha256"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_images.py "
                 "--write")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        write_fixtures(tmp)
