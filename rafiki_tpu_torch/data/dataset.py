"""The dataset formats the templates read.

The port's own copies, from ``rafiki_tpu/data/dataset.py``, of:

- ``ImageClassificationDataset`` and ``load_image_classification_dataset``
  for the canonical ``.npz`` (uint8 ``images`` [N,H,W,C] or [N,H,W],
  ``labels`` [N], scalar ``n_classes``, optional ``class_names``). The
  ``.zip`` archive and directory layouts raise ``NotImplementedError``;
- ``TextClassificationDataset`` and ``load_text_classification_dataset``:
  ``.jsonl`` with a ``{"n_classes": N}`` meta first line, then one
  ``{"text": ..., "label": int}`` object per line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ImageClassificationDataset:
    images: np.ndarray   # uint8 [N, H, W, C]
    labels: np.ndarray   # int64 [N]
    n_classes: int
    class_names: Optional[List[str]] = None

    def __len__(self) -> int:
        return int(self.images.shape[0])

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])  # type: ignore[return-value]

    @staticmethod
    def load(path: str) -> "ImageClassificationDataset":
        with np.load(path, allow_pickle=False) as z:
            images = z["images"]
            labels = z["labels"].astype(np.int64)
            n_classes = int(z["n_classes"])
            class_names = (list(map(str, z["class_names"]))
                           if "class_names" in z else None)
        if images.ndim == 3:  # grayscale without channel dim
            images = images[..., None]
        return ImageClassificationDataset(images, labels, n_classes,
                                          class_names)


def load_image_classification_dataset(path: str
                                      ) -> ImageClassificationDataset:
    """Load an image-classification ``.npz``. The JAX package's ``.zip``
    archive and ``labels.csv`` directory layouts are not ported."""
    p = Path(path)
    if p.is_file() and p.suffix == ".npz":
        return ImageClassificationDataset.load(path)
    if (p.is_file() and p.suffix == ".zip") or \
            (p.is_dir() and (p / "labels.csv").exists()):
        raise NotImplementedError(
            f"{path!r}: only the .npz image layout is ported (the .zip "
            "archive and the labels.csv directory are not)")
    raise ValueError(f"unrecognized image dataset at {path!r}")


@dataclass
class TextClassificationDataset:
    """Labeled text (the LM templates read ``texts`` and ignore
    ``labels``)."""

    texts: List[str]
    labels: np.ndarray  # int64 [N]
    n_classes: int

    @staticmethod
    def load(path: str) -> "TextClassificationDataset":
        texts: List[str] = []
        labels: List[int] = []
        with open(path) as f:
            meta = json.loads(f.readline())
            for line in f:
                d = json.loads(line)
                texts.append(str(d["text"]))
                labels.append(int(d["label"]))
        return TextClassificationDataset(
            texts, np.asarray(labels, np.int64), int(meta["n_classes"]))


def load_text_classification_dataset(path: str) -> TextClassificationDataset:
    return TextClassificationDataset.load(path)
