"""Device slots: the cards of one host, partitioned among worker processes.

The port's own copy of the slot half of ``rafiki_tpu/parallel/mesh.py``
(``DeviceSpec``, ``partition_devices``, ``SubMesh``, ``SubMeshAllocator``
with ``reserve``) over CUDA device indices. Where the JAX package tiles a TPU slice into
ICI-contiguous boxes by chip coordinates, a host's CUDA cards are split
in index order into equal runs of ``slot_size`` (the cards of one H100
host are joined all to all by NVLink, so any run is as close as any
other). In place of ``submesh_env_vars``, :func:`slot_env_vars` gives a
child process its slot's ``CUDA_VISIBLE_DEVICES``, and, where several
slots name one card (``devices=[spec] * 2``: two workers on one H100),
its share of that card's memory as ``RAFIKI_DEVICE_HBM_BYTES``, the
limit the worker's admission plans against (a TPU slot is a chip of its
own, so the JAX package has no such case). ``SubMesh.mesh`` builds a
``parallel/sharding.py`` mesh over a slot's cards.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence


@dataclass(frozen=True)
class DeviceSpec:
    """One card as the device probe reports it (or a virtual CPU slot
    when a CPU stack is asked for): its CUDA index, name and memory."""

    id: int
    name: str = ""
    memory_bytes: int = 0
    platform: str = "cpu"

    @staticmethod
    def from_probe(d: Dict[str, Any]) -> "DeviceSpec":
        return DeviceSpec(id=int(d["id"]), name=str(d.get("name", "")),
                          memory_bytes=int(d.get("memory_bytes", 0)),
                          platform=str(d.get("platform", "cpu")))


def partition_devices(devices: Sequence[DeviceSpec],
                      slot_size: int) -> List[List[DeviceSpec]]:
    """Split ``devices`` (sorted by index) into consecutive runs of
    ``slot_size``; ``slot_size`` must divide the device count."""
    n = len(devices)
    if slot_size <= 0 or n % slot_size != 0:
        raise ValueError(f"slot_size {slot_size} must divide {n} devices")
    ordered = sorted(devices, key=lambda d: d.id)
    return [ordered[i:i + slot_size] for i in range(0, n, slot_size)]


@dataclass
class SubMesh:
    """A worker-owned run of devices."""

    index: int
    devices: List[DeviceSpec]
    #: the bytes this slot may plan to hold on each of its cards when a
    #: card is shared with other slots (its memory over the number of
    #: slots naming it); 0 when no card is shared or its size is unknown
    hbm_share_bytes: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    def torch_devices(self) -> List[Any]:
        """The slot's cards as ``torch.device`` s (a CPU slot's as the
        CPU)."""
        import torch

        return [torch.device("cuda", d.id) if d.platform == "cuda"
                else torch.device("cpu") for d in self.devices]

    def mesh(self, axes: Optional[Dict[str, int]] = None,
             model: Optional[int] = None) -> Any:
        """A mesh over this slot: ``axes`` maps axis names to their sizes
        in order, as JAX's does (default: all ``data``; e.g. ``{"data":
        1, "sp": 2, "model": 2}``), or ``model`` gives the model axis and
        the rest is ``data``."""
        import numpy as np

        from rafiki_tpu_torch.parallel.sharding import (DATA_AXIS,
                                                        MODEL_AXIS, Mesh)

        if model is not None:
            axes = {DATA_AXIS: self.size // max(1, model),
                    MODEL_AXIS: model}
        axes = axes or {DATA_AXIS: self.size}
        if math.prod(axes.values()) != self.size:
            raise ValueError(f"axes {axes} do not cover {self.size} devices")
        grid = np.empty(self.size, dtype=object)
        grid[:] = self.torch_devices()
        return Mesh(grid.reshape(tuple(axes.values())).tolist(),
                    tuple(axes))


def _share_of(devices: Sequence[DeviceSpec],
              sharing: Dict[int, int]) -> int:
    """A slot's planning limit per card: the least of its cards' memory
    over the number of slots naming each; 0 when none is shared."""
    if all(sharing[d.id] == 1 for d in devices):
        return 0
    shares = [d.memory_bytes // sharing[d.id] for d in devices]
    return min(shares) if all(shares) else 0


class SubMeshAllocator:
    """Thread-safe allocator of device slots to worker processes: the
    services manager acquires a slot for each train or inference worker
    and releases it when the process exits."""

    def __init__(self, devices: Sequence[DeviceSpec],
                 slot_size: int) -> None:
        parts = partition_devices(devices, slot_size)
        sharing: Dict[int, int] = {}
        for devs in parts:
            for d in devs:
                sharing[d.id] = sharing.get(d.id, 0) + 1
        self._slots = [SubMesh(i, devs, _share_of(devs, sharing))
                       for i, devs in enumerate(parts)]
        self._free = list(range(len(self._slots)))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    @property
    def n_slots(self) -> int:
        return len(self._slots)

    def acquire(self, timeout: Optional[float] = None) -> Optional[SubMesh]:
        """The lowest free slot, waiting up to ``timeout`` seconds for a
        release (None: forever); None when none came free."""
        with self._cv:
            if not self._cv.wait_for(lambda: bool(self._free),
                                     timeout=timeout):
                return None
            return self._slots[self._free.pop(0)]

    def reserve(self, device_ids: Sequence[int]) -> Optional[SubMesh]:
        """Take the free slot made of exactly ``device_ids`` (in any
        order), or None when no free slot matches. The boot reconciler
        re-reserves the slot an adopted worker still drives: an
        ``acquire()`` could hand its cards to a new spawn."""
        want = sorted(int(i) for i in device_ids)
        with self._cv:
            for idx in list(self._free):
                if sorted(d.id for d in self._slots[idx].devices) == want:
                    self._free.remove(idx)
                    return self._slots[idx]
            return None

    def release(self, submesh: SubMesh) -> None:
        with self._cv:
            if submesh.index in self._free:
                raise ValueError(f"slot {submesh.index} already free")
            self._free.append(submesh.index)
            self._free.sort()
            self._cv.notify()

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)


def slot_env_vars(platform: str, slot: Optional[SubMesh]) -> Dict[str, str]:
    """Env vars that confine a child process to ``slot``'s cards:
    ``CUDA_VISIBLE_DEVICES`` with the slot's indices on ``cuda`` (plus
    ``RAFIKI_DEVICE_HBM_BYTES``, the slot's share, where it shares a
    card), and an empty ``CUDA_VISIBLE_DEVICES`` (no card at all) for a
    CPU stack's virtual slots and for control-plane children (``slot``
    None)."""
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r} (cuda|cpu)")
    if platform == "cpu" or slot is None:
        return {"CUDA_VISIBLE_DEVICES": ""}
    env = {"CUDA_VISIBLE_DEVICES": ",".join(str(d.id)
                                            for d in slot.devices)}
    if slot.hbm_share_bytes:
        env["RAFIKI_DEVICE_HBM_BYTES"] = str(slot.hbm_share_bytes)
    return env
