"""Constant-memory streaming image loader: the ImageNet-scale input
pipeline of the BatchNorm CNN templates.

The port's own copy of ``rafiki_tpu/data/stream.py``:
``STREAM_THRESHOLD_MB`` (``RAFIKI_STREAM_THRESHOLD_MB``, default 512),
``dataset_size_bytes``, ``should_stream`` (``RAFIKI_FORCE_STREAMING=1``
forces it), ``StreamingImageDataset`` and
``generate_streaming_image_zip``. The same layouts as the in-memory
loader (a ``.zip`` of images + ``labels.csv``, or a directory with
``labels.csv``), read with a bounded footprint:

- the index pass reads only ``labels.csv``; class ids are
  ``data/dataset.py``'s ``_labels_to_ids`` (string-sorted names);
- worker threads decode and augment ahead of the consumer through a
  sliding window of futures, at most ``prefetch_batches × batch_size``
  samples in flight; each thread holds its own ``ZipFile`` handle;
- train-time augmentation is a horizontal flip and a reflect-pad-4
  random crop, drawn from ``np.random.default_rng((seed, epoch,
  index))``: the same numpy calls in the same order as JAX's loader, so
  a batch has the same bytes on both sides whatever the thread
  scheduling;
- batches are shape-static (``batch_size`` rows + a validity mask; the
  last partial batch repeats its first row, masked out).

Members are ``.npy`` arrays, PNGs or JPEGs (the port's own decoders,
``data/image.py``, where JAX calls PIL; other formats raise
``NotPorted``). A 16-bit greyscale PNG keeps its high byte, where JAX's
cast keeps the low one. All images share one shape.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import io
import os
import threading
import zipfile
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from rafiki_tpu_torch.data.dataset import _labels_to_ids, _read_labels_csv
from rafiki_tpu_torch.data.image import decode_uint8
from rafiki_tpu_torch.data.jpeg import encode_jpeg
from rafiki_tpu_torch.data.png import encode_png
from rafiki_tpu_torch.serving.decode_engine import NotPorted

#: PIL's save-format name -> the port's encoder, for the generator
_WRITERS = {"PNG": encode_png, "JPEG": encode_jpeg}

#: datasets at or above this size stream by default in the CNN templates
STREAM_THRESHOLD_MB = float(os.environ.get("RAFIKI_STREAM_THRESHOLD_MB",
                                           "512"))


def dataset_size_bytes(path: str) -> int:
    p = Path(path)
    if p.is_file():
        return p.stat().st_size
    if p.is_dir():
        return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())
    return 0


def should_stream(path: str) -> bool:
    """Stream when the archive is at least ``STREAM_THRESHOLD_MB`` MiB, or
    when ``RAFIKI_FORCE_STREAMING=1``."""
    if os.environ.get("RAFIKI_FORCE_STREAMING") == "1":
        return True
    return dataset_size_bytes(path) >= STREAM_THRESHOLD_MB * 2 ** 20


class StreamingImageDataset:
    """Streaming reader over a zip/dir image-classification dataset."""

    def __init__(self, path: str, n_workers: int = 4,
                 prefetch_batches: int = 4) -> None:
        self.path = str(path)
        self.n_workers = max(1, int(n_workers))
        self.prefetch_batches = max(1, int(prefetch_batches))
        p = Path(self.path)
        self._is_zip = p.is_file() and p.suffix == ".zip"
        if not self._is_zip and not (p.is_dir()
                                     and (p / "labels.csv").exists()):
            raise ValueError(
                f"not a streamable dataset (zip or dir with labels.csv):"
                f" {path!r}")
        self._tl = threading.local()  # per-worker zip handles
        names, labels = self._read_index()
        self.names: List[str] = names
        self.labels, self.classes = _labels_to_ids(labels)
        self.n = len(names)
        self.n_classes = len(self.classes)
        self.image_shape: Tuple[int, ...] = tuple(
            self._decode(self.names[0]).shape)

    @staticmethod
    def is_streamable(path: str) -> bool:
        p = Path(path)
        return (p.is_file() and p.suffix == ".zip") or \
            (p.is_dir() and (p / "labels.csv").exists())

    # ---- io ----
    def _zip(self) -> zipfile.ZipFile:
        zf = getattr(self._tl, "zf", None)
        if zf is None:
            zf = self._tl.zf = zipfile.ZipFile(self.path)
        return zf

    def _read_index(self) -> Tuple[List[str], List[str]]:
        if self._is_zip:
            with self._zip().open("labels.csv") as f:
                rows = _read_labels_csv(f)
        else:
            with open(Path(self.path) / "labels.csv") as f:
                rows = _read_labels_csv(f)
        if not rows:
            raise ValueError(f"{self.path}: empty labels.csv")
        return [r[0] for r in rows], [r[1] for r in rows]

    def _read_bytes(self, name: str) -> bytes:
        if self._is_zip:
            return self._zip().read(name)
        return (Path(self.path) / name).read_bytes()

    def _decode(self, name: str) -> np.ndarray:
        data = self._read_bytes(name)
        if name.endswith(".npy"):
            arr = np.asarray(np.load(io.BytesIO(data), allow_pickle=False),
                             np.uint8)
        else:
            arr = decode_uint8(data)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    # ---- augmentation ----
    @staticmethod
    def _augment(img: np.ndarray, rng: np.random.Generator,
                 pad: int = 4) -> np.ndarray:
        h, w = img.shape[:2]
        if rng.random() < 0.5:
            img = img[:, ::-1]  # horizontal flip
        padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                        mode="reflect")
        top = int(rng.integers(0, 2 * pad + 1))
        left = int(rng.integers(0, 2 * pad + 1))
        return padded[top:top + h, left:left + w]

    def _load_one(self, i: int, epoch: int, seed: int,
                  augment: bool) -> np.ndarray:
        img = self._decode(self.names[i])
        if augment:
            rng = np.random.default_rng((seed, epoch, i))
            img = self._augment(img, rng)
        return np.ascontiguousarray(img)

    # ---- iteration ----
    def _ordered_samples(self, order: Sequence[int], epoch: int,
                         seed: int, augment: bool,
                         batch_size: int) -> Iterator[Tuple[int,
                                                            np.ndarray]]:
        window = max(self.n_workers, self.prefetch_batches * batch_size)
        with cf.ThreadPoolExecutor(self.n_workers) as ex:
            pending: "collections.deque" = collections.deque()
            it = iter(order)

            def submit_next() -> bool:
                try:
                    i = next(it)
                except StopIteration:
                    return False
                pending.append((i, ex.submit(self._load_one, int(i),
                                             epoch, seed, augment)))
                return True

            for _ in range(window):
                if not submit_next():
                    break
            while pending:
                i, fut = pending.popleft()
                submit_next()
                yield int(i), fut.result()

    def iter_batches(self, batch_size: int, epoch: int = 0,
                     shuffle: bool = True, seed: int = 0,
                     augment: bool = False,
                     drop_remainder: bool = False
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Shape-static batches ``{"x": uint8 (B,H,W,C), "y": int32,
        "mask": bool}``; the final partial batch pads by repeating its
        first row, masked out."""
        rng = np.random.default_rng((seed, epoch))
        order = rng.permutation(self.n) if shuffle else np.arange(self.n)
        buf_x: List[np.ndarray] = []
        buf_y: List[int] = []

        def emit(valid: int) -> Dict[str, np.ndarray]:
            x = np.stack(buf_x + [buf_x[0]] * (batch_size - valid))
            y = np.asarray(buf_y + [buf_y[0]] * (batch_size - valid),
                           np.int32)
            mask = np.arange(batch_size) < valid
            return {"x": x, "y": y, "mask": mask}

        for i, img in self._ordered_samples(order, epoch, seed, augment,
                                            batch_size):
            buf_x.append(img)
            buf_y.append(int(self.labels[i]))
            if len(buf_x) == batch_size:
                yield emit(batch_size)
                buf_x, buf_y = [], []
        if buf_x and not drop_remainder:
            yield emit(len(buf_x))


def generate_streaming_image_zip(path: str, n: int,
                                 image_shape: Tuple[int, int, int]
                                 = (32, 32, 3),
                                 n_classes: int = 4, seed: int = 0,
                                 fmt: str = "png") -> None:
    """Synthetic class-separable zip in the streamable layout (images +
    ``labels.csv``): one bright quadrant per class over noise, the same
    draws as JAX's generator. ``fmt`` is ``npy`` (raw arrays,
    decode-cheap) or, in any case, as PIL takes a format name, ``png``
    (the port's encoder: other bytes, the same pixels) or ``jpeg`` (the
    port's encoder: the bytes PIL writes). JAX's other PIL formats raise
    ``NotPorted``; so does ``jpg``, which is no PIL format name (JAX's
    generator raises ``KeyError`` for it)."""
    writer = _WRITERS.get(fmt.upper()) if fmt != "npy" else None
    if fmt != "npy" and writer is None:
        raise NotPorted(f"writing {fmt!r} images is not ported (png, "
                        "jpeg, npy)")
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        rows = ["path,label"]
        for i in range(n):
            label = int(rng.integers(n_classes))
            img = rng.integers(0, 96, size=(h, w, c)).astype(np.uint8)
            qh, qw = h // 2, w // 2
            top, left = (label // 2) * qh, (label % 2) * qw
            img[top:top + qh, left:left + qw] = np.minimum(
                img[top:top + qh, left:left + qw] + 140, 255)
            name = f"img{i:06d}.{fmt}"
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, img, allow_pickle=False)
                data = buf.getvalue()
            else:
                data = writer(img)
            zf.writestr(name, data)
            rows.append(f"{name},c{label}")
        zf.writestr("labels.csv", "\n".join(rows))
