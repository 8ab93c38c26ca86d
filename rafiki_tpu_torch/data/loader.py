"""Minibatch iteration with static batch shapes.

The port's own copy of ``batch_iterator`` from
``rafiki_tpu/data/loader.py``: the same seeded permutation, so a port run
and a JAX run see the same batches in the same order.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yield one shuffled epoch of equal-length batches with a ``mask`` of
    valid rows (the JAX function's defaults: shuffle, one epoch, keep the
    remainder).

    All values in ``arrays`` must share leading dimension N. Every yielded
    batch has leading dimension ``batch_size``; padding rows repeat row 0
    and are masked out.
    """
    n = len(next(iter(arrays.values())))
    for a in arrays.values():
        if len(a) != n:
            raise ValueError("all arrays must share leading dimension")
    idx = np.random.default_rng(seed).permutation(n)
    for start in range(0, n, batch_size):
        take = idx[start:start + batch_size]
        mask = np.ones(batch_size, dtype=bool)
        if len(take) < batch_size:
            mask[len(take):] = False
            take = np.concatenate(
                [take, np.zeros(batch_size - len(take), dtype=take.dtype)])
        out = {k: v[take] for k, v in arrays.items()}
        out["mask"] = mask
        yield out
