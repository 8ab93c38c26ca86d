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
  ``dim`` of the sum; its autograd rule is an all-gather.

The sum runs once per distinct device of the group, in member order, and
members on one device share its result: where a mesh's shards sit on one
card, a collective is a sum or a concatenation there. Where they sit on
different cards, ``Tensor.to`` moves the data by peer copies.

:class:`ShardedLeaf` is a leaf of a sharded tree: its global shape, its
spec and one tensor per mesh position.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.parallel.sharding import (DATA_AXIS, MODEL_AXIS, Mesh,
                                                Spec, shard_bounds)


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


def on_axis(mesh: Mesh, axis: str, op: Callable[..., List[torch.Tensor]],
            xs: Sequence[torch.Tensor], *args: Any) -> List[torch.Tensor]:
    """``op`` (:func:`all_reduce`, :func:`all_gather`, ...) run over each
    group of positions along ``axis`` (for ``model`` one group per data
    row, for ``data`` one per model column) on ``xs``, one tensor per
    mesh position in flat order; returns each position's result."""
    dp, mp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    devs = mesh.flat_devices()
    if axis == MODEL_AXIS:
        groups = [[i * mp + j for j in range(mp)] for i in range(dp)]
    else:
        groups = [[i * mp + j for i in range(dp)] for j in range(mp)]
    out = list(xs)
    for ps in groups:
        for p, r in zip(ps, op([xs[p] for p in ps], [devs[p] for p in ps],
                               *args)):
            out[p] = r
    return out


class ShardedLeaf:
    """A leaf of a sharded tree: ``shape`` (global), ``spec`` (JAX's
    ``PartitionSpec`` as a tuple), ``mesh`` and ``shards``, one tensor
    per mesh position in flat order (replicas are separate tensors, as
    each device holds its own)."""

    def __init__(self, shape: Sequence[int], spec: Spec, mesh: Mesh,
                 shards: List[Any]) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        dt = self.shards[0].dtype  # host views hold a numpy dtype
        return dt if isinstance(dt, torch.dtype) else \
            torch.from_numpy(np.empty(0, dt)).dtype

    def bounds(self, p: int) -> List[List[int]]:
        """``[start, stop]`` per dim of flat position ``p``'s shard."""
        mp = self.mesh.shape[MODEL_AXIS]
        return shard_bounds(self.shape, self.spec, self.mesh, p // mp,
                            p % mp)

    def replica_id(self, p: int) -> int:
        """0 for the first position holding its slice, 1, 2, ... for the
        later ones (JAX's ``Shard.replica_id``)."""
        mine = self.bounds(p)
        return sum(self.bounds(q) == mine for q in range(p))

    @classmethod
    def from_full(cls, full: Any, mesh: Mesh, spec: Spec,
                  dtype: Optional[torch.dtype] = None,
                  on_host: bool = False) -> "ShardedLeaf":
        """Slice ``full`` (a tensor or numpy array) into ``mesh``'s
        shards by ``spec``: on each position's device, cast to ``dtype``
        (None: as it is), or with ``on_host`` as views of ``full``
        itself."""
        leaf = cls(tuple(full.shape), spec, mesh, [])
        for p, dev in enumerate(mesh.flat_devices()):
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
