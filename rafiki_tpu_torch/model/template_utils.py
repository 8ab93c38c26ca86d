"""Shared helpers for the port's templates.

The port's own copies of ``same_tree_shapes``, ``bucketed_forward`` and
``conform_images`` from ``rafiki_tpu/model/template_utils.py``. Param
trees are nested dicts of arrays, so ``same_tree_shapes`` walks them
without ``jax.tree_util``; ``bucketed_forward`` keeps the fixed 64-row
buckets (a serving batch of any size runs the same few shapes), and an
empty input returns ``(0, out_dim)`` where JAX probed the forward's
output shape with ``jax.eval_shape``. Beside them, two helpers the
classifier templates share: ``eval_buckets`` (the padded validation
stream a gang scores) and ``refuse_regression``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def same_tree_shapes(a: Any, b: Any) -> bool:
    """True iff two nested-dict trees share keys and leaf shapes (the
    gate of every warm start: only identical architectures share
    params)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) \
                or a.keys() != b.keys():
            return False
        return all(same_tree_shapes(a[k], b[k]) for k in a)
    return np.shape(a) == np.shape(b)


def bucketed_forward(forward: Callable[..., np.ndarray],
                     *xs: np.ndarray, bucket: int = 64,
                     out_dim: int) -> np.ndarray:
    """Run ``forward(*chunks) -> (bucket, out_dim)`` over per-example
    arrays ``xs`` in zero-padded buckets of ``bucket`` rows and return the
    real rows' outputs, concatenated."""
    n = len(xs[0])
    if n == 0:
        return np.zeros((0, out_dim), np.float32)
    out = []
    for i in range(0, n, bucket):
        chunks = [x[i:i + bucket] for x in xs]
        pad = bucket - len(chunks[0])
        if pad:
            chunks = [np.concatenate(
                [c, np.zeros((pad, *c.shape[1:]), c.dtype)])
                for c in chunks]
        out.append(np.asarray(forward(*chunks))[:bucket - pad])
    return np.concatenate(out)


def eval_buckets(x: np.ndarray, y: np.ndarray, bucket: int = 256
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """The validation stream a gang scores: ``{"x", "y", "mask"}`` in
    zero-padded buckets of ``bucket`` rows, the padding masked out (the
    buckets ``evaluate()`` predicts in)."""
    for i in range(0, len(x), bucket):
        xb, yb = x[i:i + bucket], y[i:i + bucket]
        mask = np.ones(bucket, dtype=bool)
        pad = bucket - len(xb)
        if pad:
            mask[len(xb):] = False
            xb = np.concatenate([xb, np.zeros((pad, *xb.shape[1:]),
                                              xb.dtype)])
            yb = np.concatenate([yb, np.zeros(pad, yb.dtype)])
        yield {"x": xb, "y": yb, "mask": mask}


def refuse_regression(template: str, n_classes: int) -> None:
    """The classifier templates' refusal of a regression table."""
    if n_classes == 0:
        raise ValueError(f"{template} is a classifier; dataset is "
                         "regression (n_classes=0)")


def conform_images(x: np.ndarray,
                   image_shape: Optional[Sequence[int]]) -> np.ndarray:
    """Pad/center-crop query images [N,H,W,C] to the train-time
    ``image_shape`` (H,W,C); a grayscale query against an RGB model is
    repeated over the channels, other channel mismatches raise."""
    if image_shape is None:
        return x
    h, w, c = (int(v) for v in image_shape)
    if x.shape[-1] != c:
        if x.shape[-1] == 1:  # grayscale query against RGB-trained model
            x = np.repeat(x, c, axis=-1)
        else:
            raise ValueError(
                f"query has {x.shape[-1]} channels, model trained with {c}")
    # pad up
    ph, pw = max(0, h - x.shape[1]), max(0, w - x.shape[2])
    if ph or pw:
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)))
    # center-crop down
    if x.shape[1] > h or x.shape[2] > w:
        oh = (x.shape[1] - h) // 2
        ow = (x.shape[2] - w) // 2
        x = x[:, oh:oh + h, ow:ow + w, :]
    return x
