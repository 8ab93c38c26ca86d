"""Sharding vocabulary: a mesh of named axes and the partition specs.

The port's own copy of ``rafiki_tpu/parallel/sharding.py``:
:data:`DATA_AXIS`, :data:`MODEL_AXIS`, :func:`make_mesh` (with JAX's
errors), :func:`make_sp_mesh` (``LlamaLoRA.train``'s ``(data, sp[,
model])`` meshes), :func:`pad_batch_to_axis`, :func:`fsdp_param_spec`,
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
#: the sequence axis of ``LlamaLoRA``'s ``sequence_parallel`` meshes
#: (JAX's train loop names it ``"sp"``)
SP_AXIS = "sp"

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A grid of devices with named axes, positions in row-major order:
    ``devices`` is nested one level per axis (``devices[i][j]`` on a
    (data, model) mesh, ``devices[i][s][j]`` on (data, sp, model)), and
    the flat position of coordinates ``(c_0, c_1, ...)`` is
    ``Σ c_a · Π_{b > a} size_b``. ``axis_names`` defaults to
    ``(data, model)``, JAX's ``make_mesh`` axes; ``LlamaLoRA``'s
    ``sequence_parallel`` meshes are ``(data, sp)`` and ``(data, sp,
    model)``."""

    def __init__(self, devices: Sequence[Any],
                 axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS)
                 ) -> None:
        names = tuple(axis_names)
        sizes: List[int] = []
        level: Any = devices
        for _ in names:
            sizes.append(len(level))
            level = level[0]
        flat: List[Any] = [devices]
        for _ in names:
            flat = [x for row in flat for x in row]
        self._flat = [torch.device(d) for d in flat]
        if len(self._flat) != math.prod(sizes):
            raise ValueError(f"devices do not form a {sizes} grid")
        kinds = {d.type for d in self._flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{sorted(kinds)}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.devices = _nested(self._flat, sizes)

    @property
    def size(self) -> int:
        return len(self._flat)

    def axis_size(self, axis: str) -> int:
        """The axis's size, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coords(self, p: int) -> Tuple[int, ...]:
        """Flat position ``p``'s coordinates, one per axis."""
        out = []
        for n in reversed(list(self.shape.values())):
            p, c = divmod(p, n)
            out.append(c)
        return tuple(reversed(out))

    def coord(self, p: int, axis: str) -> int:
        """Position ``p``'s coordinate on ``axis`` (0 on an axis the mesh
        does not have)."""
        if axis not in self.shape:
            return 0
        return self.coords(p)[self.axis_names.index(axis)]

    def flat(self, coords: Sequence[int]) -> int:
        """The flat position of ``coords``."""
        p = 0
        for c, n in zip(coords, self.shape.values()):
            p = p * n + int(c)
        return p

    def along(self, p: int, axis: str) -> List[int]:
        """The positions that differ from ``p`` only on ``axis``, in the
        axis's order (``[p]`` for an axis the mesh does not have)."""
        if axis not in self.shape:
            return [p]
        a = self.axis_names.index(axis)
        c = list(self.coords(p))
        out = []
        for k in range(self.shape[axis]):
            c[a] = k
            out.append(self.flat(c))
        return out

    def device(self, *coords: int) -> torch.device:
        return self._flat[self.flat(coords)]

    def positions(self) -> List[Tuple[int, ...]]:
        """Every position's coordinates in flat order."""
        return [self.coords(p) for p in range(self.size)]

    def flat_devices(self) -> List[torch.device]:
        return list(self._flat)

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, devices={[str(d) for d in self._flat]})"


def _nested(flat: List[Any], sizes: Sequence[int]) -> List[Any]:
    if len(sizes) == 1:
        return list(flat)
    step = len(flat) // sizes[0]
    return [_nested(flat[i * step:(i + 1) * step], sizes[1:])
            for i in range(sizes[0])]


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


def make_sp_mesh(devices: Sequence[Any], sp: int, model: int = 1) -> Mesh:
    """``LlamaLoRA.train``'s sequence-parallel mesh: ``devices`` in
    row-major order as ``(data, sp)``, or ``(data, sp, model)`` for
    ``model > 1`` (JAX reshapes the device array to ``(-1, sp[,
    model])``); the caller checks that ``sp · model`` divides them."""
    devs = list(devices)
    per = sp * model
    data = len(devs) // per
    if model > 1:
        grid = [[devs[(i * sp + s) * model:(i * sp + s + 1) * model]
                 for s in range(sp)] for i in range(data)]
        return Mesh(grid, (DATA_AXIS, SP_AXIS, MODEL_AXIS))
    return Mesh([devs[i * sp:(i + 1) * sp] for i in range(data)],
                (DATA_AXIS, SP_AXIS))


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
    n_data = mesh.axis_size(DATA_AXIS)
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
    n_model = mesh.axis_size(MODEL_AXIS)
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


def shard_bounds(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 *coords: int) -> List[List[int]]:
    """``[start, stop]`` per dim of the shard at ``coords`` (one per mesh
    axis, ``(i, j)`` on a (data, model) mesh)."""
    full = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, full):
        if axis is None:
            out.append([0, int(dim)])
            continue
        n = mesh.shape[axis]
        k = coords[mesh.axis_names.index(axis)]
        step = int(dim) // n
        out.append([k * step, (k + 1) * step])
    return out


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """A shard's shape (JAX's ``NamedSharding.shard_shape``)."""
    return tuple(b - a for a, b in shard_bounds(
        shape, spec, mesh, *([0] * len(mesh.axis_names))))


def shard_batch(batch: Dict[str, Any], mesh: Mesh
                ) -> List[Dict[str, torch.Tensor]]:
    """A host batch with its leading dim split over ``data``: one dict
    per data row, on that row's first device (its model positions share
    it: JAX replicates the batch over ``model``)."""
    n = mesh.shape[DATA_AXIS]
    out = []
    for i in range(n):
        dev = mesh.device(i, *([0] * (len(mesh.axis_names) - 1)))
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
