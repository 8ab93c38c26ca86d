"""The dataset formats the templates read.

The port's own copies, from ``rafiki_tpu/data/dataset.py``, of:

- ``ImageClassificationDataset`` (with ``save``) and
  ``load_image_classification_dataset`` for every layout: the canonical
  ``.npz`` (uint8 ``images`` [N,H,W,C] or [N,H,W], ``labels`` [N], scalar
  ``n_classes``, optional ``class_names``), a ``.zip`` of images plus a
  ``labels.csv``, and a directory with a ``labels.csv``
  (``_load_zip_dataset``, ``_load_dir_dataset``, ``_read_labels_csv``,
  ``_stack_images``, ``_labels_to_ids``). Members are decoded by the
  port's own codecs (``data/image.py``: PNG and JPEG) where JAX calls
  PIL; other formats raise ``NotPorted``. Each array is cast to uint8 as
  JAX casts it, except a 16-bit greyscale PNG: the port keeps its high
  byte (as PIL reads 16-bit RGB), where JAX's ``astype(np.uint8)`` keeps
  the low byte and so loads such a set as noise. Class ids come from
  ``sorted(set(names))``, a sort of strings: ``"10"`` before ``"2"``;
- ``generate_image_classification_dataset``, ``FASHION_CLASSES`` and
  ``generate_fashion_archive`` (the FashionMNIST-layout zip: 28×28
  greyscale PNGs under ``images/`` and a ``labels.csv`` of the published
  class names; the PNGs are the port's encoder's, the pixels JAX's);
- ``TextClassificationDataset`` and ``load_text_classification_dataset``:
  ``.jsonl`` with a ``{"n_classes": N}`` meta first line, then one
  ``{"text": ..., "label": int}`` object per line;
- ``CorpusDataset`` (POS tagging): a ``.jsonl`` whose first line is
  ``{"tag_names": [...]}``, then one ``{"tokens": [...], "tags": [...]}``
  object per sentence;
- ``TabularDataset`` and ``load_tabular_dataset``: the canonical
  ``.npz`` (f32 ``features`` [N, D], ``labels`` [N], scalar
  ``n_classes``, 0 for regression; optional ``feature_names``) and a
  ``.csv`` (last column the label, header optional; integral labels are
  class ids, other numbers a regression target, strings class names
  sorted into ids) (``_load_csv_tabular``);
- ``generate_corpus_dataset`` and ``generate_tabular_dataset``, the
  synthetic POS corpus and table: the same draws as JAX's, so one seed
  writes the same bytes.
"""

from __future__ import annotations

import csv
import io
import json
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rafiki_tpu_torch.data.image import decode_uint8
from rafiki_tpu_torch.data.png import encode_png


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

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        kwargs: Dict[str, np.ndarray] = dict(
            images=self.images, labels=self.labels,
            n_classes=np.asarray(self.n_classes))
        if self.class_names is not None:
            kwargs["class_names"] = np.asarray(self.class_names)
        np.savez_compressed(p, **kwargs)

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
    """Load any supported image-classification dataset layout: ``.npz``,
    ``.zip`` of images + ``labels.csv``, or a directory with
    ``labels.csv``."""
    p = Path(path)
    if p.is_file() and p.suffix == ".npz":
        return ImageClassificationDataset.load(path)
    if p.is_file() and p.suffix == ".zip":
        return _load_zip_dataset(p)
    if p.is_dir() and (p / "labels.csv").exists():
        return _load_dir_dataset(p)
    raise ValueError(f"unrecognized image dataset at {path!r}")


def _read_labels_csv(fp) -> List[Tuple[str, str]]:
    rows = list(csv.reader(io.TextIOWrapper(fp) if hasattr(fp, "read1")
                           else fp))
    if rows and rows[0] and rows[0][0].strip().lower() in ("path", "image"):
        rows = rows[1:]
    return [(r[0].strip(), r[1].strip()) for r in rows if len(r) >= 2]


def _stack_images(arrs: Sequence[np.ndarray]) -> np.ndarray:
    shape = arrs[0].shape
    if any(a.shape != shape for a in arrs):
        raise ValueError("all images in a dataset must share one shape")
    out = np.stack(arrs).astype(np.uint8)
    if out.ndim == 3:
        out = out[..., None]
    return out


def _labels_to_ids(names: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    classes = sorted(set(names))
    index = {c: i for i, c in enumerate(classes)}
    return np.asarray([index[n] for n in names], dtype=np.int64), classes


def _load_zip_dataset(p: Path) -> ImageClassificationDataset:
    with zipfile.ZipFile(p) as z:
        with z.open("labels.csv") as f:
            pairs = _read_labels_csv(io.TextIOWrapper(f))
        images = [decode_uint8(z.read(rel)) for rel, _ in pairs]
    labels, classes = _labels_to_ids([lab for _, lab in pairs])
    return ImageClassificationDataset(_stack_images(images), labels,
                                      len(classes), classes)


def _load_dir_dataset(p: Path) -> ImageClassificationDataset:
    with open(p / "labels.csv") as f:
        pairs = _read_labels_csv(f)
    images = [decode_uint8((p / rel).read_bytes()) for rel, _ in pairs]
    labels, classes = _labels_to_ids([lab for _, lab in pairs])
    return ImageClassificationDataset(_stack_images(images), labels,
                                      len(classes), classes)


def generate_image_classification_dataset(
        path: str, n_examples: int = 1024, image_size: int = 28,
        n_channels: int = 1, n_classes: int = 10, noise: float = 0.25,
        seed: int = 0, class_seed: int = 7) -> ImageClassificationDataset:
    """Learnable synthetic image dataset (FashionMNIST-shaped by default):
    class ``c`` is a fixed low-frequency template (upsampled 7×7 normal
    grids drawn from ``class_seed``) plus noise drawn from ``seed``,
    clipped to fixed bounds and quantized to uint8. The same draws as
    JAX's generator, so the same bytes."""
    rng = np.random.default_rng(seed)
    h = w = image_size
    template_rng = np.random.default_rng(class_seed + n_classes * 1000
                                         + image_size)
    coarse = template_rng.normal(0.0, 1.0,
                                 size=(n_classes, 7, 7, n_channels))
    reps = int(np.ceil(h / 7))
    templates = np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)
    templates = templates[:, :h, :w, :]
    labels = rng.integers(0, n_classes, size=n_examples).astype(np.int64)
    x = templates[labels] + rng.normal(0.0, noise * 2.0,
                                       size=(n_examples, h, w, n_channels))
    bound = 3.0 + 3.0 * noise * 2.0
    x = np.clip((x + bound) / (2.0 * bound), 0.0, 1.0)
    images = (x * 255).astype(np.uint8)
    ds = ImageClassificationDataset(images, labels, n_classes,
                                    [f"class_{i}" for i in range(n_classes)])
    if path:
        ds.save(path)
    return ds


#: FashionMNIST's published class names, as the archive's labels.csv
#: writes them
FASHION_CLASSES = ["t_shirt_top", "trouser", "pullover", "dress", "coat",
                   "sandal", "shirt", "sneaker", "bag", "ankle_boot"]


def generate_fashion_archive(path: str, n_examples: int = 512,
                             seed: int = 0) -> ImageClassificationDataset:
    """The FashionMNIST-layout zip with synthetic content: 28×28
    greyscale PNGs ``images/{i:05d}.png`` and a ``labels.csv`` of
    ``FASHION_CLASSES`` names, every class present (seeds are redrawn as
    JAX redraws them). Returns the dataset with its labels mapped to the
    loader's name-sorted class ids."""
    if n_examples < len(FASHION_CLASSES):
        raise ValueError(
            f"n_examples={n_examples} cannot cover all "
            f"{len(FASHION_CLASSES)} fashion classes")
    s = seed
    while True:
        ds = generate_image_classification_dataset(
            "", n_examples=n_examples, image_size=28, n_channels=1,
            n_classes=len(FASHION_CLASSES), seed=s)
        if len(set(ds.labels.tolist())) == len(FASHION_CLASSES):
            break
        s += 1000003
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        rows = ["path,label"]
        for i in range(n_examples):
            rel = f"images/{i:05d}.png"
            z.writestr(rel, encode_png(ds.images[i, :, :, 0]))
            rows.append(f"{rel},{FASHION_CLASSES[int(ds.labels[i])]}")
        z.writestr("labels.csv", "\n".join(rows) + "\n")
    order = {c: i for i, c in enumerate(sorted(FASHION_CLASSES))}
    remapped = np.asarray([order[FASHION_CLASSES[int(label)]]
                           for label in ds.labels], np.int64)
    return ImageClassificationDataset(ds.images, remapped,
                                      len(FASHION_CLASSES),
                                      sorted(FASHION_CLASSES))


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


@dataclass
class CorpusDataset:
    """Token/tag corpus: sentences of (tokens, tags)."""

    sentences: List[Tuple[List[str], List[str]]]
    tag_names: List[str]

    def __len__(self) -> int:
        return len(self.sentences)

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            f.write(json.dumps({"tag_names": self.tag_names}) + "\n")
            for tokens, tags in self.sentences:
                f.write(json.dumps({"tokens": tokens, "tags": tags}) + "\n")

    @staticmethod
    def load(path: str) -> "CorpusDataset":
        with open(path) as f:
            meta = json.loads(f.readline())
            sentences = []
            for line in f:
                d = json.loads(line)
                if len(d["tokens"]) != len(d["tags"]):
                    raise ValueError("tokens/tags length mismatch")
                sentences.append((d["tokens"], d["tags"]))
        return CorpusDataset(sentences, meta["tag_names"])


@dataclass
class TabularDataset:
    """Feature-vector table: f32 ``features`` [N, D], int64 class ids
    (f32 targets when ``n_classes`` is 0, a regression)."""

    features: np.ndarray
    labels: np.ndarray
    n_classes: int
    feature_names: Optional[List[str]] = None

    def __len__(self) -> int:
        return int(self.features.shape[0])

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        kwargs: Dict[str, np.ndarray] = dict(
            features=self.features.astype(np.float32), labels=self.labels,
            n_classes=np.asarray(self.n_classes))
        if self.feature_names is not None:
            kwargs["feature_names"] = np.asarray(self.feature_names)
        np.savez_compressed(p, **kwargs)

    @staticmethod
    def load(path: str) -> "TabularDataset":
        with np.load(path, allow_pickle=False) as z:
            feats = z["features"].astype(np.float32)
            n_classes = int(z["n_classes"])
            labels = (z["labels"].astype(np.int64) if n_classes
                      else z["labels"].astype(np.float32))
            names = (list(map(str, z["feature_names"]))
                     if "feature_names" in z else None)
        return TabularDataset(feats, labels, n_classes, names)


def load_tabular_dataset(path: str) -> TabularDataset:
    p = Path(path)
    if p.suffix == ".npz":
        return TabularDataset.load(path)
    if p.suffix == ".csv":
        return _load_csv_tabular(p)
    raise ValueError(f"unrecognized tabular dataset at {path!r}")


def _load_csv_tabular(p: Path) -> TabularDataset:
    with open(p) as f:
        rows = list(csv.reader(f))
    names: Optional[List[str]] = None
    try:
        float(rows[0][0])
    except (ValueError, IndexError):
        names, rows = rows[0][:-1], rows[1:]
    feats = np.asarray([[float(v) for v in r[:-1]] for r in rows],
                       np.float32)
    raw = [r[-1].strip() for r in rows]
    try:
        as_float = np.asarray([float(v) for v in raw])
        if np.allclose(as_float, np.round(as_float)):
            labels = as_float.astype(np.int64)
            return TabularDataset(feats, labels,
                                  int(labels.max()) + 1, names)
        return TabularDataset(feats, as_float.astype(np.float32), 0, names)
    except ValueError:  # string class labels
        labels, classes = _labels_to_ids(raw)
        return TabularDataset(feats, labels, len(classes), names)


def generate_corpus_dataset(path: str, n_sentences: int = 400,
                            vocab_size: int = 200, n_tags: int = 8,
                            max_len: int = 12, seed: int = 0,
                            class_seed: int = 7) -> CorpusDataset:
    """Synthetic POS-style corpus: every word type ``w{i}`` has one tag
    (a lexicon drawn from ``class_seed``, each tag owning at least one
    word) and tags follow a first-order Dirichlet transition matrix;
    sentences of 3..``max_len`` tokens are drawn from ``seed``."""
    if vocab_size < n_tags:
        raise ValueError("vocab_size must be >= n_tags")
    rng = np.random.default_rng(seed)
    struct_rng = np.random.default_rng(class_seed + vocab_size)
    word_tag = struct_rng.integers(0, n_tags, size=vocab_size)
    word_tag[:n_tags] = np.arange(n_tags)
    trans = struct_rng.dirichlet(np.ones(n_tags) * 0.3, size=n_tags)
    tag_names = [f"TAG{i}" for i in range(n_tags)]
    words_by_tag = [np.where(word_tag == t)[0] for t in range(n_tags)]
    sentences = []
    for _ in range(n_sentences):
        length = int(rng.integers(3, max_len + 1))
        tags: List[int] = []
        toks: List[str] = []
        t = int(rng.integers(0, n_tags))
        for _ in range(length):
            tags.append(t)
            w = int(rng.choice(words_by_tag[t]))
            toks.append(f"w{w}")
            t = int(rng.choice(n_tags, p=trans[t]))
        sentences.append((toks, [tag_names[i] for i in tags]))
    ds = CorpusDataset(sentences, tag_names)
    if path:
        ds.save(path)
    return ds


def generate_tabular_dataset(path: str, n_examples: int = 1024,
                             n_features: int = 16, n_classes: int = 3,
                             noise: float = 0.1, seed: int = 0,
                             class_seed: int = 7) -> TabularDataset:
    """Synthetic table: standard-normal features, labels from a depth-3
    axis-aligned teacher tree drawn from ``class_seed`` (3 feature
    thresholds, 8 leaves), a ``noise`` share of them redrawn uniformly."""
    rng = np.random.default_rng(seed)
    teacher_rng = np.random.default_rng(class_seed + n_features * 100)
    x = rng.normal(0.0, 1.0, size=(n_examples, n_features)).astype(
        np.float32)
    feat = teacher_rng.integers(0, n_features, size=3)
    thr = teacher_rng.normal(0.0, 0.5, size=3)
    leaf_class = teacher_rng.integers(0, n_classes, size=8)
    bits = ((x[:, feat] > thr).astype(np.int64) *
            np.asarray([4, 2, 1])).sum(axis=1)
    labels = leaf_class[bits]
    flip = rng.random(n_examples) < noise
    labels = np.where(flip, rng.integers(0, n_classes, size=n_examples),
                      labels).astype(np.int64)
    ds = TabularDataset(x, labels, n_classes,
                        [f"f{i}" for i in range(n_features)])
    if path:
        ds.save(path)
    return ds
