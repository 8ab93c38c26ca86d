"""Sharding vocabulary: a (data, model) mesh and the partition specs.

The port's own copy of ``rafiki_tpu/parallel/sharding.py``:
:data:`DATA_AXIS`, :data:`MODEL_AXIS`, :func:`make_mesh` (with JAX's
errors), :func:`pad_batch_to_axis`, :func:`fsdp_param_spec`,
:func:`tp_param_spec`, :func:`combine_specs`, :func:`param_shardings`,
:func:`shard_batch` and :func:`replicate_tree`.

A mesh here is a grid of ``torch.device`` s that ONE process drives (the
JAX package drives its mesh from one process too): a leaf's shard at
position ``(i, j)`` is a tensor on ``mesh.device(i, j)``, and the
collectives are the explicit functions of
:mod:`rafiki_tpu_torch.parallel.collectives`. A partition spec is JAX's
``PartitionSpec`` as a tuple: one entry per leading dim, an axis name or
None, no trailing Nones (``()`` is replicated).

Unlike a JAX mesh, a device may appear more than once: ``make_mesh(
["cuda:0"] * 4, model=2)`` is a (2, 2) mesh whose four shards share one
card, which is how a mesh is held on a host with one card (the shards'
collectives are then sums and concatenations on that card). Every
device of a mesh is of one type: a mesh that mixes CPU and CUDA devices
raises.

JAX's ``overlap_compiler_options`` has no counterpart: it returns ``{}``
off the TPU, so the ``overlap_collectives`` knob is accepted and changes
nothing, as in JAX on a CPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A (data, model) grid of devices; ``devices[i][j]`` holds position
    ``(i, j)``, the flat position ``i · model + j``."""

    def __init__(self, devices: Sequence[Sequence[Any]]) -> None:
        self.devices: List[List[torch.device]] = [
            [torch.device(d) for d in row] for row in devices]
        kinds = {d.type for row in self.devices for d in row}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{sorted(kinds)}")
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.devices),
                                      MODEL_AXIS: len(self.devices[0])}
        self.axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    def positions(self) -> List[Tuple[int, int]]:
        """Every ``(i, j)`` in flat order."""
        return [(i, j) for i in range(self.shape[DATA_AXIS])
                for j in range(self.shape[MODEL_AXIS])]

    def flat_devices(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, "
                f"devices={[str(d) for d in self.flat_devices()]})")


def make_mesh(devices: Sequence[Any], data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A (data, model) mesh over ``devices`` in row-major order. JAX
    defaults ``devices`` to every local device; the port's caller names
    them (a device may repeat, see the module docstring)."""
    devs = list(devices)
    n = len(devs)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data * model} != {n} devices")
    return Mesh([devs[i * model:(i + 1) * model] for i in range(data)])


def pad_batch_to_axis(x: Any, mesh: Mesh, axis: Optional[str] = None
                      ) -> Any:
    """Tile/slice ``x``'s leading dim up to the next multiple of a mesh
    axis size (default ``data``), as JAX's does (numpy or torch)."""
    n = mesh.shape[DATA_AXIS if axis is None else axis]
    b = x.shape[0]
    if b % n == 0:
        return x
    target = -(-b // n) * n
    reps = -(-target // b)
    if isinstance(x, torch.Tensor):
        return torch.cat([x] * reps, dim=0)[:target]
    return np.concatenate([x] * reps, axis=0)[:target]


def _canonical(spec: List[Optional[str]]) -> Spec:
    while spec and spec[-1] is None:  # no trailing Nones
        spec.pop()
    return tuple(spec)


def fsdp_param_spec(path: str, shape: Sequence[int], mesh: Mesh,
                    min_size: int = 2 ** 16, base: Spec = ()) -> Spec:
    """FSDP-style spec: shard a weight's largest divisible dim over
    ``data`` (ties to the lower dim); tensors under ``min_size``
    elements stay as ``base`` has them. Dims ``base`` shards are
    skipped."""
    taken: List[Optional[str]] = list(base)
    taken += [None] * (len(shape) - len(taken))
    n_data = mesh.shape[DATA_AXIS]
    if math.prod(shape) >= min_size:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if taken[i] is None and shape[i] % n_data == 0:
                taken[i] = DATA_AXIS
                break
    return _canonical(taken)


def tp_param_spec(path: str, shape: Sequence[int], mesh: Mesh,
                  rules: Dict[str, int]) -> Spec:
    """Tensor-parallel spec from substring rules: the first rule whose
    key is in ``path`` names the dim sharded over ``model`` (negative
    dims allowed); replicated when that dim does not divide."""
    if not shape:
        return ()
    n_model = mesh.shape[MODEL_AXIS]
    for frag, dim in rules.items():
        if frag in path:
            d = dim % len(shape)
            if shape[d] % n_model == 0:
                spec: List[Optional[str]] = [None] * len(shape)
                spec[d] = MODEL_AXIS
                return tuple(spec)
    return ()


def combine_specs(a: Spec, b: Spec) -> Spec:
    """Merge two specs dim-wise (ValueError on a conflict)."""
    la, lb = list(a), list(b)
    n = max(len(la), len(lb))
    la += [None] * (n - len(la))
    lb += [None] * (n - len(lb))
    out: List[Optional[str]] = []
    for x, y in zip(la, lb):
        if x is not None and y is not None and x != y:
            raise ValueError(f"conflicting specs {a} vs {b}")
        out.append(x if x is not None else y)
    return tuple(out)


def leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of a nested-dict tree in sorted-key order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def param_shardings(params: Any, mesh: Mesh,
                    tp_rules: Optional[Dict[str, int]] = None,
                    fsdp: bool = False,
                    min_size: int = 2 ** 16) -> Dict[str, Spec]:
    """Per-leaf specs of a nested-dict tree, keyed by its ``/``-joined
    path (JAX returns a tree of ``NamedSharding`` s over the same
    specs): ``tp_rules`` over ``model``, then with ``fsdp`` large
    leaves over ``data``."""
    specs: Dict[str, Spec] = {}
    for path, leaf in leaf_paths(params):
        p = "/".join(path)
        shape = tuple(getattr(leaf, "shape", ()))
        spec: Spec = ()
        if tp_rules:
            spec = tp_param_spec(p, shape, mesh, tp_rules)
        if fsdp and shape:
            spec = fsdp_param_spec(p, shape, mesh, min_size, base=spec)
        specs[p] = spec
    return specs


def shard_bounds(shape: Sequence[int], spec: Spec, mesh: Mesh, i: int,
                 j: int) -> List[List[int]]:
    """``[start, stop]`` per dim of position ``(i, j)``'s shard."""
    full = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, full):
        if axis is None:
            out.append([0, int(dim)])
            continue
        n = mesh.shape[axis]
        k = i if axis == DATA_AXIS else j
        step = int(dim) // n
        out.append([k * step, (k + 1) * step])
    return out


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """A shard's shape (JAX's ``NamedSharding.shard_shape``)."""
    return tuple(b - a for a, b in shard_bounds(shape, spec, mesh, 0, 0))


def shard_batch(batch: Dict[str, Any], mesh: Mesh
                ) -> List[Dict[str, torch.Tensor]]:
    """A host batch with its leading dim split over ``data``: one dict
    per data row, on that row's first device (its model positions share
    it: JAX replicates the batch over ``model``)."""
    n = mesh.shape[DATA_AXIS]
    out = []
    for i in range(n):
        dev = mesh.device(i, 0)
        part = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            step = t.shape[0] // n
            part[k] = t[i * step:(i + 1) * step].to(dev)
        out.append(part)
    return out


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Every leaf of ``tree`` as a replicated sharded leaf on ``mesh``."""
    from rafiki_tpu_torch.parallel.collectives import ShardedLeaf

    if isinstance(tree, dict):
        return {k: replicate_tree(v, mesh) for k, v in tree.items()}
    return ShardedLeaf.from_full(torch.as_tensor(tree), mesh, ())
