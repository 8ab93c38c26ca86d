"""KV-page shipment blobs, the worker role, and the leaf layout of a KV
snapshot on the wire.

The port's own copies of ``normalize_role``, ``leaf_signature``,
``make_kv_blob`` and ``check_kv_blob`` (with ``KV_BLOB_VERSION`` and the
``LAYOUT_*`` names) from ``rafiki_tpu/serving/kv_transfer.py``, plus the
helpers that lay a port cache out as the JAX engine lays out its flax
``cache`` collection:

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

A KV shipment blob (disaggregated prefill/decode) is the JAX engine's:
a self-describing dict whose ``leaves`` are a prefilled slot's pages
(``paged``) or rows (``rows``) in ``jax.tree_util`` order, every cache
leaf uniformly (int8 pools ship with their scale rows). The receiving
engine validates it with :func:`check_kv_blob` before any cache write, so
a mismatched layout, page size, signature or adapter is a ``ValueError``
the worker degrades on (a local re-prefill), never a wrong install. A
blob made by either package installs into the other's engine through
either param-store codec.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

KV_BLOB_VERSION = 1

#: blob["layout"] values: ``paged`` leaves are whole pool pages
#: ``(n_pages, page_size, ...)``; ``rows`` leaves are exact logical rows
#: ``(covered, ...)`` sliced from a contiguous cache
LAYOUT_PAGED = "paged"
LAYOUT_ROWS = "rows"

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
        return _TORCH_NAMES.get(a.dtype, str(a.dtype).replace("torch.", ""))
    return str(np.asarray(a).dtype)


def leaf_signature(leaves: Sequence[Any]) -> List[List[Any]]:
    """Per-leaf ``[trailing-shape, dtype]`` signature. The leading axis
    (pages shipped / rows covered) varies per request; everything after
    it is model geometry and must match the receiving engine exactly."""
    return [[list(a.shape[1:]), dtype_name(a)] for a in leaves]


def leaf_nbytes(a: Any) -> int:
    """A leaf's byte count, numpy array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return int(a.numel() * a.element_size())
    return int(np.asarray(a).nbytes)


def make_kv_blob(covered: int, layout: str, page_size: int,
                 leaves: Sequence[Any], adapter_id: int = 0
                 ) -> Dict[str, Any]:
    """Package extracted KV rows for the hub. ``covered`` is the count of
    prefilled logical positions (``0..covered-1``); ``leaves`` are the
    cache's leaves in ``jax.tree_util`` order (:func:`cache_leaves`;
    empty for a single-token prompt, which has nothing prefilled): numpy
    arrays, or CPU torch tensors for bf16 (the param-store codec writes
    those as ``bfloat16``)."""
    if layout not in (LAYOUT_PAGED, LAYOUT_ROWS):
        raise ValueError(f"unknown KV blob layout {layout!r}")
    arrs = list(leaves)
    return {"v": KV_BLOB_VERSION, "covered": int(covered),
            "layout": layout, "page_size": int(page_size),
            "adapter_id": int(adapter_id),
            "sig": leaf_signature(arrs), "leaves": arrs,
            "nbytes": int(sum(leaf_nbytes(a) for a in arrs))}


def check_kv_blob(blob: Any, *, layout: str, page_size: int,
                  expect_sig: Sequence[Sequence[Any]], prompt_len: int,
                  adapter_id: int = 0,
                  expect_leading: Optional[int] = None) -> Dict[str, Any]:
    """Validate a shipped blob against the receiving engine before any
    cache write: raises ``ValueError`` with the JAX package's reason on
    any mismatch, else returns the blob. The decode worker catches the
    raise and re-prefills locally (token-exact, just slower). Leaves are
    looked at through their ``shape``/``dtype`` only, so a device-staged
    leaf (``stage_kv_blob``) is not copied back to be checked."""
    if not isinstance(blob, dict):
        raise ValueError("KV blob is not a mapping")
    if int(blob.get("v", -1)) != KV_BLOB_VERSION:
        raise ValueError(f"KV blob version {blob.get('v')!r} != "
                         f"{KV_BLOB_VERSION}")
    if blob.get("layout") != layout:
        raise ValueError(f"KV blob layout {blob.get('layout')!r} does "
                         f"not match this engine's ({layout!r})")
    if layout == LAYOUT_PAGED and int(blob.get("page_size", 0)) \
            != int(page_size):
        raise ValueError(
            f"KV blob page_size {blob.get('page_size')!r} != engine "
            f"page_size {page_size}")
    if int(blob.get("adapter_id", 0)) != int(adapter_id):
        # the KV is a function of the adapter that computed it
        raise ValueError(
            f"KV blob adapter {blob.get('adapter_id')!r} != request "
            f"adapter {adapter_id}")
    covered = int(blob.get("covered", -1))
    if covered < 0 or covered > max(0, int(prompt_len) - 1):
        raise ValueError(
            f"KV blob covers {covered} positions but the prompt has "
            f"{prompt_len} tokens (at most prompt_len - 1 can be "
            "prefilled)")
    leaves = blob.get("leaves")
    if not isinstance(leaves, (list, tuple)):
        raise ValueError("KV blob has no leaves list")
    if covered > 0:
        sig = [[list(e[0]), str(e[1])] for e in blob.get("sig") or []]
        want = [[list(e[0]), str(e[1])] for e in expect_sig]
        if sig != want:
            raise ValueError(
                "KV blob leaf signature does not match this engine's "
                "cache (different model geometry / dtype / int8 "
                "setting)")
        if len(leaves) != len(want):
            # counted before the per-leaf zip below (zip truncates)
            raise ValueError(
                f"KV blob ships {len(leaves)} leaves but its "
                f"signature names {len(want)} (truncated shipment)")
        for a, (shape, dtype) in zip(leaves, blob["sig"]):
            if getattr(a, "shape", None) is None:
                a = np.asarray(a)
            if list(a.shape[1:]) != list(shape) or \
                    dtype_name(a) != str(dtype):
                raise ValueError("KV blob leaf does not match its own "
                                 "signature (corrupt shipment)")
            if expect_leading is not None and \
                    a.shape[0] != int(expect_leading):
                raise ValueError(
                    f"KV blob leaf ships {a.shape[0]} "
                    f"pages/rows, engine expects {expect_leading} "
                    f"for {covered} covered positions")
    return blob


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
