"""Port parity: the image data path (``rafiki_tpu_torch.data.stream``,
``data/dataset.py``'s zip and directory layouts, ``data/png.py``)
against the JAX package.

- The streaming loader reads the JAX generator's ``.npy`` and PNG zips
  (and a directory) with the same index, classes and shape, and yields
  batches whose bytes equal JAX's, augmented or not, epochs 0 and 1.
- ``should_stream``'s threshold and its force switch agree.
- The in-memory zip and directory layouts load as JAX's loader loads
  them, class ids sorted as strings (``"10"`` before ``"2"``).
- The PNG decoder equals PIL (which only this test imports) over
  greyscale, greyscale + alpha, RGB and RGBA with each of the five row
  filters, written by the test itself, and over PIL's own encodings;
  the palette, 16-bit, interlaced and JPEG files it once refused decode
  equal to PIL through ``data/image.py``; BMP and GIF are refused by
  name (``tests/test_torch_images.py`` holds the whole matrix).
- The port's ``generate_fashion_archive`` writes other PNG bytes (its
  own encoder) holding JAX's pixels and labels; its streaming generator
  writes JAX's JPEG bytes.

Every comparison is exact: the data path has no arithmetic to round.
"""

import io
import struct
import zipfile
import zlib

import numpy as np
import pytest
from PIL import Image

from rafiki_tpu.data import dataset as jds
from rafiki_tpu.data import stream as jstream
from rafiki_tpu_torch.data import dataset as pds
from rafiki_tpu_torch.data import image
from rafiki_tpu_torch.data import png
from rafiki_tpu_torch.data import stream as pstream
from rafiki_tpu_torch.serving.decode_engine import NotPorted


@pytest.fixture(scope="module", params=["npy", "png"])
def archive(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / f"data_{request.param}.zip"
    jstream.generate_streaming_image_zip(str(path), 20, (12, 10, 3),
                                         n_classes=4, seed=3,
                                         fmt=request.param)
    return str(path)


def _batches(ds, epoch, augment, shuffle=True):
    return list(ds.iter_batches(8, epoch=epoch, shuffle=shuffle, seed=5,
                                augment=augment))


def test_streaming_index_and_batches_equal_jax(archive):
    j = jstream.StreamingImageDataset(archive, n_workers=2,
                                      prefetch_batches=1)
    p = pstream.StreamingImageDataset(archive, n_workers=3,
                                      prefetch_batches=2)
    assert (p.names, p.classes, p.n, p.n_classes, p.image_shape) == \
        (j.names, j.classes, j.n, j.n_classes, j.image_shape)
    np.testing.assert_array_equal(p.labels, j.labels)
    for epoch in (0, 1):
        for augment, shuffle in ((True, True), (False, False)):
            jb, pb = (_batches(j, epoch, augment, shuffle),
                      _batches(p, epoch, augment, shuffle))
            assert len(pb) == len(jb) == 3  # 20 rows: the last one partial
            for a, b in zip(pb, jb):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype and \
                        a[k].tobytes() == b[k].tobytes(), (epoch, k)


def test_streaming_reads_a_directory_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = ["path,label"]
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)).save(
            tmp_path / f"{i}.png")
        rows.append(f"{i}.png,{['b', 'a', '10', '2'][i % 4]}")
    (tmp_path / "labels.csv").write_text("\n".join(rows))
    j = jstream.StreamingImageDataset(str(tmp_path))
    p = pstream.StreamingImageDataset(str(tmp_path))
    assert p.classes == j.classes == ["10", "2", "a", "b"]
    for a, b in zip(_batches(p, 1, True), _batches(j, 1, True)):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("force", [False, True])
def test_should_stream_threshold_and_force_match_jax(tmp_path, monkeypatch,
                                                     force):
    assert pstream.STREAM_THRESHOLD_MB == jstream.STREAM_THRESHOLD_MB
    f = tmp_path / "d.zip"
    f.write_bytes(b"\0" * 3000)
    monkeypatch.setenv("RAFIKI_FORCE_STREAMING", "1" if force else "0")
    for mb in (0.001, 3000 / 2 ** 20, 0.003, 1.0):
        monkeypatch.setattr(jstream, "STREAM_THRESHOLD_MB", mb)
        monkeypatch.setattr(pstream, "STREAM_THRESHOLD_MB", mb)
        want = jstream.should_stream(str(f))
        assert pstream.should_stream(str(f)) == want
        assert want == (force or 3000 >= mb * 2 ** 20)
    assert pstream.dataset_size_bytes(str(tmp_path)) == 3000


def _write_layout(tmp_path, kind, names):
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (6, 5), np.uint8) for _ in names]
    rows = ["image,label"] + [f"im/{i}.png,{n}" for i, n in enumerate(names)]
    if kind == "zip":
        path = tmp_path / "d.zip"
        with zipfile.ZipFile(path, "w") as z:
            for i, im in enumerate(imgs):
                buf = io.BytesIO()
                Image.fromarray(im).save(buf, format="PNG")
                z.writestr(f"im/{i}.png", buf.getvalue())
            z.writestr("labels.csv", "\n".join(rows) + "\n")
    else:
        path = tmp_path / "d"
        (path / "im").mkdir(parents=True)
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(path / "im" / f"{i}.png")
        (path / "labels.csv").write_text("\n".join(rows))
    return str(path)


@pytest.mark.parametrize("kind", ["zip", "dir"])
def test_zip_and_dir_layouts_load_as_jax(tmp_path, kind):
    path = _write_layout(tmp_path, kind, ["2", "10", "1", "2", "10", "b"])
    j = jds.load_image_classification_dataset(path)
    p = pds.load_image_classification_dataset(path)
    assert p.class_names == j.class_names == ["1", "10", "2", "b"]
    assert p.n_classes == j.n_classes == 4
    np.testing.assert_array_equal(p.labels, j.labels)
    np.testing.assert_array_equal(p.labels, [2, 1, 0, 2, 1, 3])
    assert p.images.shape == j.images.shape == (6, 6, 5, 1)
    np.testing.assert_array_equal(p.images, j.images)


# ---- the PNG codec

def _filtered_png(img, ftype):
    """A PNG of ``img`` whose every row uses filter ``ftype``, written
    here from the PNG specification (not by PIL)."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for r in range(h):
        cur = rows[r]
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
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body))

    return png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, color, 0, 0, 0)) + \
        chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_equals_pil(channels, ftype):
    rng = np.random.default_rng(channels * 10 + ftype)
    shape = (7, 9) if channels == 1 else (7, 9, channels)
    img = rng.integers(0, 256, shape, np.uint8)
    img[2:4] = 250  # runs, where the predictors wrap around 255
    data = _filtered_png(img, ftype)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_codec_round_trips_with_pil(mode):
    rng = np.random.default_rng(7)
    n = len(mode)
    img = rng.integers(0, 256, (16, 13) if n == 1 else (16, 13, n),
                       np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")  # PIL's filters
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)
    mine = png.encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(mine))),
                                  img)


def _adam7_png(img):
    """An Adam7-interlaced 8-bit RGB PNG of ``img``, every row filter
    type 0, written here from the PNG specification (PIL writes none)."""
    h, w = img.shape[:2]
    raw = bytearray()
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        for row in img[y0::dy, x0::dx]:
            if row.size:
                raw += b"\0" + row.tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body))

    return png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 1)) + \
        chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


def _once_refused(kind):
    """The files this codec refused before it read them: palette and
    16-bit greyscale PNG and JPEG written by PIL, an Adam7 PNG by
    :func:`_adam7_png`."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 8, 3), np.uint8)
    buf = io.BytesIO()
    if kind == "palette":
        Image.fromarray(img).convert("P").save(buf, format="PNG")
    elif kind == "16-bit":
        Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16)) \
            .save(buf, format="PNG")
    elif kind == "interlaced":
        return _adam7_png(img)
    else:
        Image.fromarray(img).save(buf, format="JPEG")
    return buf.getvalue()


def test_png_refuses_what_is_not_ported():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 8, 3), np.uint8)
    for fmt in ("BMP", "GIF"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        with pytest.raises(NotPorted, match=fmt):
            image.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(_once_refused("jpeg"))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="cannot identify"):
        image.decode_image(b"not an image at all")


@pytest.mark.parametrize("kind", ["palette", "16-bit", "interlaced",
                                  "jpeg"])
def test_once_refused_formats_decode_equal_to_pil(kind):
    data = _once_refused(kind)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = image.decode_image(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fashion_archive_port_copy_holds_jax_pixels(tmp_path):
    jp, pp = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    want = jds.generate_fashion_archive(jp, 40, seed=2)
    got = pds.generate_fashion_archive(pp, 40, seed=2)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.class_names == want.class_names
    jl = jds.load_image_classification_dataset(jp)
    pl = pds.load_image_classification_dataset(pp)
    np.testing.assert_array_equal(pl.images, jl.images)
    np.testing.assert_array_equal(pl.labels, jl.labels)
    np.testing.assert_array_equal(pl.labels, want.labels)
    assert pl.class_names == jl.class_names
    # each reads the other's archive too
    np.testing.assert_array_equal(
        pds.load_image_classification_dataset(jp).images, jl.images)
    np.testing.assert_array_equal(
        jds.load_image_classification_dataset(pp).images, pl.images)
    with zipfile.ZipFile(jp) as a, zipfile.ZipFile(pp) as b:
        assert a.namelist() == b.namelist()
        assert a.read("labels.csv") == b.read("labels.csv")


@pytest.mark.parametrize("fmt", ["npy", "png", "jpeg"])
def test_streaming_zip_generator_port_copy_holds_jax_pixels(tmp_path, fmt):
    jp, pp = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jstream.generate_streaming_image_zip(jp, 9, (8, 6, 3), n_classes=4,
                                         seed=1, fmt=fmt)
    pstream.generate_streaming_image_zip(pp, 9, (8, 6, 3), n_classes=4,
                                         seed=1, fmt=fmt)
    with zipfile.ZipFile(jp) as a, zipfile.ZipFile(pp) as b:
        assert a.namelist() == b.namelist()
        assert a.read("labels.csv") == b.read("labels.csv")
        if fmt == "jpeg":  # the port's encoder writes PIL's bytes
            for name in a.namelist():
                assert a.read(name) == b.read(name), name
    j = jstream.StreamingImageDataset(jp)
    p = pstream.StreamingImageDataset(pp)
    for a, b in zip(_batches(p, 0, False, False), _batches(j, 0, False,
                                                          False)):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    with pytest.raises(NotPorted, match="bmp"):
        pstream.generate_streaming_image_zip(pp, 1, fmt="bmp")
