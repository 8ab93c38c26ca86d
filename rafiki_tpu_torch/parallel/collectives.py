"""Collectives over a mesh one process drives, and the sharded leaf.

JAX lets XLA insert a mesh's collectives (``psum``, all-gather,
reduce-scatter) into one jitted program. In the port one process holds
every shard of a mesh (:class:`~rafiki_tpu_torch.parallel.sharding.Mesh`)
and calls the collectives itself, as functions from the shards of a
group (the positions along one mesh axis, one tensor each) to theirs:

- :func:`all_reduce`: each member gets the sum of the group's tensors;
  its autograd rule is an all-reduce of the cotangents;
- :func:`all_gather`: each member gets the concatenation along ``dim``;
  its autograd rule is a reduce-scatter of the cotangents;
- :func:`reduce_scatter`: member ``k`` gets the ``k``-th chunk along
  ``dim`` of the sum; its autograd rule is an all-gather;
- :func:`all_to_all`: member ``k`` gets the ``k``-th chunk along
  ``split_dim`` of every member's tensor, concatenated along
  ``concat_dim`` in member order (``jax.lax.all_to_all(..., tiled=True)``);
  its autograd rule is the inverse all-to-all;
- :func:`ppermute`: a rotation of the group by ``shift`` (member ``k``
  gets member ``k - shift``'s tensor: JAX's ``ppermute`` over the ring
  ``[(j, j + 1)]`` for ``shift`` 1); its autograd rule is the reverse
  rotation.

The sum runs once per distinct device of the group, in member order, and
members on one device share its result: where a mesh's shards sit on one
card, a collective is a sum or a concatenation there (a rotation there
copies nothing: it relabels the members' tensors). Where they sit on
different cards, ``Tensor.to`` moves the data by peer copies.

:class:`ShardedLeaf` is a leaf of a sharded tree: its global shape, its
spec and one tensor per mesh position. :func:`to_positions` and
:func:`from_positions` split a global tensor into its positions' slices
by a spec and join them back, inside autograd (JAX's ``device_put`` to a
``NamedSharding`` and the global array a ``shard_map`` returns).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from rafiki_tpu_torch.parallel.sharding import Mesh, Spec, shard_bounds


def _device_slots(devices: Sequence[torch.device]
                  ) -> Tuple[List[torch.device], List[int]]:
    """The group's distinct devices in first-seen order, and each
    member's index among them."""
    distinct: List[torch.device] = []
    slot: List[int] = []
    for d in devices:
        if d not in distinct:
            distinct.append(d)
        slot.append(distinct.index(d))
    return distinct, slot


def _sum_on(tensors: Sequence[torch.Tensor], dev: torch.device
            ) -> torch.Tensor:
    """The members' sum on ``dev``, in member order and in their dtype
    (as NCCL and XLA add a bf16 reduction in bf16)."""
    out = tensors[0].to(dev)
    for t in tensors[1:]:
        out = out + t.to(dev)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *tensors):
        distinct, _ = _device_slots(devices)
        ctx.devices = list(devices)
        return tuple(_sum_on(tensors, d) for d in distinct)

    @staticmethod
    def backward(ctx, *grads):
        # (autograd hands a zero cotangent for an unused output)
        return (None,) + tuple(_sum_on(grads, d) for d in ctx.devices)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *tensors):
        distinct, _ = _device_slots(devices)
        ctx.dim, ctx.devices = dim, list(devices)
        ctx.sizes = [t.shape[dim] for t in tensors]
        return tuple(torch.cat([t.to(d) for t in tensors], dim)
                     for d in distinct)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_reduce_scatter_fwd(
            grads, ctx.devices, ctx.dim, ctx.sizes))


def _reduce_scatter_fwd(tensors: Sequence[torch.Tensor],
                        devices: Sequence[torch.device], dim: int,
                        sizes: Sequence[int]) -> List[torch.Tensor]:
    out, start = [], 0
    for dev, n in zip(devices, sizes):
        out.append(_sum_on([t.narrow(dim, start, n) for t in tensors], dev))
        start += n
    return out


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *tensors):
        n = len(devices)
        size = tensors[0].shape[dim]
        if size % n:
            raise ValueError(f"reduce_scatter: dim {dim} of size {size} "
                             f"does not divide over {n} members")
        ctx.dim, ctx.devices = dim, list(devices)
        ctx.in_devices = [t.device for t in tensors]
        return tuple(_reduce_scatter_fwd(tensors, devices, dim,
                                         [size // n] * n))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(torch.cat([g.to(d) for g in grads],
                                              ctx.dim)
                                    for d in ctx.in_devices)


def all_reduce(tensors: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Each member's copy of the sum of ``tensors`` (member ``k`` on
    ``devices[k]``)."""
    if len(tensors) == 1:
        return [tensors[0].to(devices[0])]
    _, slot = _device_slots(devices)
    outs = _AllReduce.apply(list(devices), *tensors)
    return [outs[s] for s in slot]


def all_gather(tensors: Sequence[torch.Tensor],
               devices: Sequence[torch.device], dim: int
               ) -> List[torch.Tensor]:
    """Each member's copy of ``tensors`` concatenated along ``dim``."""
    if len(tensors) == 1:
        return [tensors[0].to(devices[0])]
    _, slot = _device_slots(devices)
    outs = _AllGather.apply(dim, list(devices), *tensors)
    return [outs[s] for s in slot]


def reduce_scatter(tensors: Sequence[torch.Tensor],
                   devices: Sequence[torch.device], dim: int
                   ) -> List[torch.Tensor]:
    """Member ``k``'s ``k``-th chunk along ``dim`` of the sum of
    ``tensors`` (the dim must divide by the group's size)."""
    if len(tensors) == 1:
        return [tensors[0].to(devices[0])]
    return list(_ReduceScatter.apply(dim, list(devices), *tensors))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, devices, *tensors):
        ctx.dims, ctx.devices = (split_dim, concat_dim), list(devices)
        return tuple(_all_to_all_fwd(tensors, devices, split_dim,
                                     concat_dim))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        return (None, None, None) + tuple(_all_to_all_fwd(
            grads, ctx.devices, concat_dim, split_dim))


def _all_to_all_fwd(tensors: Sequence[torch.Tensor],
                    devices: Sequence[torch.device], split_dim: int,
                    concat_dim: int) -> List[torch.Tensor]:
    n = len(tensors)
    size = tensors[0].shape[split_dim]
    if size % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {size} "
                         f"does not divide over {n} members")
    chunks = [t.tensor_split(n, dim=split_dim) for t in tensors]
    return [torch.cat([c[k].to(dev) for c in chunks], concat_dim)
            for k, dev in enumerate(devices)]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shift, devices, *tensors):
        ctx.shift, ctx.devices = shift, list(devices)
        return tuple(_rotate(tensors, devices, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_rotate(grads, ctx.devices,
                                            -ctx.shift))


def _rotate(tensors: Sequence[torch.Tensor],
            devices: Sequence[torch.device], shift: int
            ) -> List[torch.Tensor]:
    """Member ``k`` gets member ``(k - shift) mod n``'s tensor, moved to
    its device (the same tensor where the two share one)."""
    n = len(tensors)
    return [tensors[(k - shift) % n].to(devices[k]) for k in range(n)]


def all_to_all(tensors: Sequence[torch.Tensor],
               devices: Sequence[torch.device], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Member ``k``'s concatenation along ``concat_dim`` of the ``k``-th
    chunk along ``split_dim`` of every member's tensor (the dim must
    divide by the group's size)."""
    if len(tensors) == 1:
        return [tensors[0].to(devices[0])]
    return list(_AllToAll.apply(split_dim, concat_dim, list(devices),
                                *tensors))


def ppermute(tensors: Sequence[torch.Tensor],
             devices: Sequence[torch.device], shift: int = 1
             ) -> List[torch.Tensor]:
    """The group rotated by ``shift``: member ``k`` gets member ``k -
    shift``'s tensor (a ring hop for ``shift`` 1)."""
    if len(tensors) == 1:
        return [tensors[0].to(devices[0])]
    return list(_Ppermute.apply(shift, list(devices), *tensors))


def axis_groups(mesh: Mesh, axis: Union[str, Sequence[str]]
                ) -> List[List[int]]:
    """The groups of positions that differ only along ``axis`` (a name
    or several), each in flat order; an axis the mesh does not have
    leaves every position alone on it."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    idx = [mesh.axis_names.index(a) for a in names if a in mesh.shape]
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for p in range(mesh.size):
        c = list(mesh.coords(p))
        for a in idx:
            c[a] = 0
        groups.setdefault(tuple(c), []).append(p)
    return list(groups.values())


def owners(mesh: Mesh, share: Sequence[str] = ()) -> List[int]:
    """Each position's owner: the first position that holds its tensor,
    where the positions that differ only along the axes in ``share`` and
    sit on one device hold one tensor between them (without ``share``,
    every position owns its own)."""
    idx = [mesh.axis_names.index(a) for a in share if a in mesh.shape]
    first: Dict[Tuple, int] = {}
    out = []
    for p, dev in enumerate(mesh.flat_devices()):
        c = list(mesh.coords(p))
        for a in idx:
            c[a] = 0
        out.append(first.setdefault((dev, tuple(c)), p))
    return out


def on_axis(mesh: Mesh, axis: Union[str, Sequence[str]],
            op: Callable[..., List[torch.Tensor]],
            xs: Sequence[torch.Tensor], *args: Any,
            owner: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """``op`` (:func:`all_reduce`, :func:`all_gather`, ...) run over each
    group of positions along ``axis`` (the positions that differ only
    there: for ``model`` on a (data, model) mesh one group per data row)
    on ``xs``, one tensor per mesh position in flat order; returns each
    position's result. ``axis`` may name several axes (JAX's ``psum``
    over a tuple of axes). With ``owner`` (:func:`owners`: positions that
    share one tensor of ``xs``) a group whose members' owners are those
    of a group already run shares its results instead of running
    ``op`` again."""
    devs = mesh.flat_devices()
    out = list(xs)
    done: Dict[Tuple, List[torch.Tensor]] = {}
    for ps in axis_groups(mesh, axis):
        key = tuple(owner[p] for p in ps) if owner is not None \
            else tuple(ps)
        if key not in done:
            done[key] = op([xs[p] for p in ps], [devs[p] for p in ps],
                           *args)
        for p, r in zip(ps, done[key]):
            out[p] = r
    return out


class ShardedLeaf:
    """A leaf of a sharded tree: ``shape`` (global), ``spec`` (JAX's
    ``PartitionSpec`` as a tuple), ``mesh`` and ``shards``, one tensor
    per mesh position in flat order (replicas are separate tensors, as
    each device holds its own, except that positions may share one:
    ``owner[p]`` is the first position holding ``shards[p]``, by
    default ``p`` itself; :meth:`owned` lists each distinct tensor's
    owner)."""

    def __init__(self, shape: Sequence[int], spec: Spec, mesh: Mesh,
                 shards: List[Any],
                 owner: Optional[Sequence[int]] = None) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.shards = shards
        self.owner = list(owner) if owner is not None \
            else list(range(mesh.size))

    def owned(self) -> List[int]:
        """The positions that own their tensor, in flat order."""
        return [p for p, o in enumerate(self.owner) if o == p]

    @property
    def dtype(self) -> torch.dtype:
        dt = self.shards[0].dtype  # host views hold a numpy dtype
        return dt if isinstance(dt, torch.dtype) else \
            torch.from_numpy(np.empty(0, dt)).dtype

    def bounds(self, p: int) -> List[List[int]]:
        """``[start, stop]`` per dim of flat position ``p``'s shard."""
        return shard_bounds(self.shape, self.spec, self.mesh,
                            *self.mesh.coords(p))

    def replica_id(self, p: int) -> int:
        """0 for the first position holding its slice, 1, 2, ... for the
        later ones (JAX's ``Shard.replica_id``)."""
        mine = self.bounds(p)
        return sum(self.bounds(q) == mine for q in range(p))

    @classmethod
    def from_full(cls, full: Any, mesh: Mesh, spec: Spec,
                  dtype: Optional[torch.dtype] = None,
                  on_host: bool = False,
                  share: Sequence[str] = ()) -> "ShardedLeaf":
        """Slice ``full`` (a tensor or numpy array) into ``mesh``'s
        shards by ``spec``: on each position's device, cast to ``dtype``
        (None: as it is), or with ``on_host`` as views of ``full``
        itself. Positions that differ only on the axes named in
        ``share`` (which ``spec`` must not name) and sit on one device
        hold one tensor between them (:func:`owners`)."""
        own = owners(mesh, share)
        leaf = cls(tuple(full.shape), spec, mesh, [], own)
        for p, dev in enumerate(mesh.flat_devices()):
            if own[p] != p:
                leaf.shards.append(leaf.shards[own[p]])
                continue
            idx = tuple(slice(a, b) for a, b in leaf.bounds(p))
            part = full[idx]
            if not on_host:
                part = torch.as_tensor(part).to(
                    dev, dtype=dtype, copy=True).contiguous()
            leaf.shards.append(part)
        return leaf

    def full(self, device: Any = "cpu",
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The global tensor assembled from replica-0 shards on
        ``device``."""
        out = torch.empty(self.shape, dtype=dtype or self.dtype,
                          device=device)
        for p, t in enumerate(self.shards):
            if self.replica_id(p):
                continue
            idx = tuple(slice(a, b) for a, b in self.bounds(p))
            out[idx] = torch.as_tensor(t).to(device, out.dtype)
        return out


def to_positions(x: torch.Tensor, mesh: Mesh, spec: Spec
                 ) -> List[torch.Tensor]:
    """A global tensor as one slice per mesh position by ``spec``, each
    on its position's device; differentiable (views where the device is
    the tensor's)."""
    out = []
    for p, dev in enumerate(mesh.flat_devices()):
        idx = tuple(slice(a, b) for a, b in shard_bounds(
            x.shape, spec, mesh, *mesh.coords(p)))
        out.append(x[idx].to(dev))
    return out


def from_positions(xs: Sequence[torch.Tensor], mesh: Mesh, spec: Spec,
                   device: Any = None) -> torch.Tensor:
    """The global tensor of per-position slices ``xs`` laid out by
    ``spec`` (the inverse of :func:`to_positions`; each slice is taken
    from the first position holding it), on ``device`` (default: the
    first position's); differentiable."""
    dev = torch.device(device) if device is not None else xs[0].device
    parts: Dict[Tuple, torch.Tensor] = {}
    for p, t in enumerate(xs):
        key = tuple(tuple(b) for b in shard_bounds(
            [t.shape[d] * _splits(spec, d, mesh) for d in range(t.dim())],
            spec, mesh, *mesh.coords(p)))
        parts.setdefault(key, t)

    def join(keys: List[Tuple], dim: int) -> torch.Tensor:
        if dim == xs[0].dim():
            return parts[keys[0]].to(dev)
        starts = sorted({k[dim][0] for k in keys})
        pieces = [join([k for k in keys if k[dim][0] == s0], dim + 1)
                  for s0 in starts]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    return join(list(parts), 0)


def _splits(spec: Spec, dim: int, mesh: Mesh) -> int:
    axis = spec[dim] if dim < len(spec) else None
    return 1 if axis is None else mesh.shape[axis]
