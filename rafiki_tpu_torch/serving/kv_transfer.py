"""The worker role, and the leaf layout of a KV snapshot on the wire.

The port's own copies of ``normalize_role`` and ``leaf_signature`` from
``rafiki_tpu/serving/kv_transfer.py``, plus the helpers that lay a port
cache out as the JAX engine lays out its flax ``cache`` collection:

- :func:`cache_leaves` lists a port cache's tensors in ``jax.tree_util``
  order. Flax names the decoder blocks ``block_{i}`` and ``jax.tree_util``
  sorts dict keys as strings, so the layers come in lexicographic order
  (``block_0, block_1, block_10, block_11, ..., block_2, ...``) and each
  layer's leaves as ``k, k_scale, v, v_scale``. A blob listed in numeric
  layer order would install into a JAX engine of depth 11 or more with
  its layers swapped, and nothing would raise (every layer has the same
  shapes): :func:`cache_from_leaves` is the inverse, used for every
  import.
- :func:`dtype_name` names a leaf's element type as numpy does
  (``float32``, ``int8``, ``bfloat16``), whether it is a numpy array or a
  torch tensor (a bf16 leaf travels as a torch tensor: the param-store
  codec writes it under the name ``"bfloat16"`` over its ``uint16``
  bits).

The KV shipment blobs of disaggregated prefill (``make_kv_blob``,
``check_kv_blob``) wait for the slice that ports KV shipment; until then a
worker with a role other than ``unified`` refuses to boot.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

#: worker role knob values (the disaggregation switch). ``unified`` (the
#: default) is one worker that prefills AND decodes.
ROLES = ("unified", "prefill", "decode")

_TORCH_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8"}


def normalize_role(value: Any) -> str:
    """``None``/empty → ``unified``; anything else must name a member of
    :data:`ROLES` — a typo'd role silently serving unified would defeat
    the placement policy."""
    if value is None:
        return "unified"
    s = str(value).strip().lower()
    if not s:
        return "unified"
    if s not in ROLES:
        raise ValueError(f"unknown worker role {value!r} "
                         f"(one of: {', '.join(ROLES)})")
    return s


def dtype_name(a: Any) -> str:
    """A leaf's element type by its numpy name, for numpy arrays and
    torch tensors alike."""
    if isinstance(a, torch.Tensor):
        return _TORCH_NAMES[a.dtype]
    return str(np.asarray(a).dtype)


def leaf_signature(leaves: Sequence[Any]) -> List[List[Any]]:
    """Per-leaf ``[trailing-shape, dtype]`` signature. The leading axis
    (pages shipped / rows covered) varies per request; everything after
    it is model geometry and must match the receiving engine exactly."""
    return [[list(a.shape[1:]), dtype_name(a)] for a in leaves]


def _layer_order(depth: int) -> List[int]:
    """Layer indices in the order ``jax.tree_util`` visits ``block_{i}``
    keys: sorted as strings."""
    return sorted(range(depth), key=lambda i: f"block_{i}")


def cache_leaves(cache: Sequence[Dict[str, torch.Tensor]]
                 ) -> List[torch.Tensor]:
    """A port cache (one ``{"k", "v"[, "k_scale", "v_scale"]}`` dict per
    layer, in layer order) flattened in ``jax.tree_util`` order."""
    return [cache[i][name] for i in _layer_order(len(cache))
            for name in sorted(cache[i])]


def cache_from_leaves(leaves: Sequence[Any], like: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """The inverse of :func:`cache_leaves`: ``leaves`` in ``jax.tree_util``
    order regrouped into per-layer dicts in layer order, with the leaf
    names of ``like`` (a cache of the receiving engine's geometry)."""
    out: List[Dict[str, Any]] = [{} for _ in like]
    it = iter(leaves)
    for i in _layer_order(len(like)):
        for name in sorted(like[i]):
            out[i][name] = next(it)
    return out
