"""The text corpus format the LM templates read.

The port's own copy of ``TextClassificationDataset`` and
``load_text_classification_dataset`` from ``rafiki_tpu/data/dataset.py``:
``.jsonl`` with a ``{"n_classes": N}`` meta first line, then one
``{"text": ..., "label": int}`` object per line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

import numpy as np


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
