"""Sharded checkpoints: one file per shard, no whole-tree host blob.

The port's own copy of ``rafiki_tpu/store/sharded_ckpt.py``
(``ShardedCheckpointer``, ``ShardedCheckpointRef``), over the port's
sharded trees: nested dicts whose leaves are
:class:`~rafiki_tpu_torch.parallel.collectives.ShardedLeaf` s (a global
shape, a spec, one tensor per mesh position), plain tensors or numpy
arrays (one full-extent shard each).

The format is JAX's, byte for byte: ``<root>/<name>/manifest.json`` (the
same ``_FORMAT`` string; per leaf its path, global shape, dtype name and
the sorted unique shard bounds) and ``L{leaf:04d}.S{shard:03d}.bin``,
each shard's raw C-order bytes. It names no framework type, so either
package restores what the other wrote, into any mesh. A bf16 leaf is
written as its bits (``"bfloat16"`` in the manifest, as ml_dtypes names
it in JAX).

- ``save`` streams: one shard is copied to the host, written and
  dropped at a time; the manifest is written last, as the commit marker.
- ``save_async`` copies every shard to the host before it returns (the
  train step updates the shards in place next), then writes on a
  background thread; ``wait`` joins it and raises a failure it parked.
- ``restore`` builds each leaf of a template: a ``ShardedLeaf`` template
  restores into its mesh and spec, each position reading only the
  saved shards that overlap its bounds; any other leaf restores as a
  host array.

One process drives a mesh in the port, so the multi-process fences of
JAX's ``save`` (``sync_fn``, ``jax.process_count() > 1``) have nothing
to fence: ``process_index`` defaults to 0 and ``sync_fn`` is called only
when given. ``owns(shard)`` picks the shards a simulated process writes,
as in JAX; a shard is a :class:`Shard` (position, device, replica id).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from rafiki_tpu_torch.parallel.collectives import ShardedLeaf
from rafiki_tpu_torch.parallel.sharding import leaf_paths

_MANIFEST = "manifest.json"
_FORMAT = "rafiki-sharded-ckpt-v1"

Bounds = List[List[int]]


class Shard(NamedTuple):
    """One position's shard of a sharded leaf, as ``owns`` sees it."""
    position: int
    device: torch.device
    replica_id: int


def _dtype_name(leaf: Any) -> str:
    dt = getattr(leaf, "dtype", np.float64)
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def _host_array(x: Any) -> np.ndarray:
    """``x`` as a C-order numpy array (bf16 as its int16 bits); a tensor
    is copied (the caller's step updates it in place), a host array is
    only read."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return np.ascontiguousarray(t.numpy())
    return np.ascontiguousarray(np.asarray(x))


def _full_bounds(shape: Tuple[int, ...]) -> Bounds:
    return [[0, int(d)] for d in shape]


def _global_bounds(leaf: ShardedLeaf) -> List[Bounds]:
    """Sorted unique shard bounds over every position of the leaf's
    mesh."""
    uniq = {tuple(map(tuple, leaf.bounds(p)))
            for p in range(len(leaf.shards))}
    return [list(map(list, b)) for b in sorted(uniq)]


def _read_block(path: str, dtype: str, shape: List[int]) -> np.ndarray:
    """A shard file mapped read-only (only the slices the caller copies
    out are read)."""
    dt = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    if int(np.prod(shape)) * np.dtype(dt).itemsize != os.path.getsize(path):
        raise ValueError(f"{path}: size does not match its bounds "
                         f"{shape} (partial/corrupt checkpoint)")
    if not int(np.prod(shape)):
        return np.empty(shape, dt)
    return np.memmap(path, dt, mode="r", shape=tuple(shape))


def _as_output(arr: np.ndarray, dtype: str, device: Any = None) -> Any:
    """A restored block: numpy for a host leaf, a tensor on ``device``
    for a shard (bf16 from its int16 bits either way)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(arr).view(torch.bfloat16)
        return t if device is None else t.to(device)
    if device is None:
        return arr
    return torch.from_numpy(arr).to(device)


class ShardedCheckpointer:
    """Directory-per-checkpoint sharded save/restore under ``root``."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._async_lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None

    # ---- paths ----
    def _dir(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in name)
        return os.path.join(self.root, safe)

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self._dir(name), _MANIFEST))

    def delete(self, name: str) -> None:
        self.wait(reraise=False)  # never race an in-flight writer
        shutil.rmtree(self._dir(name), ignore_errors=True)

    # ---- save ----
    def _plan(self, tree: Any) -> Dict[str, Any]:
        """The manifest, from the leaves' global shapes and specs only
        (no data touched)."""
        manifest: Dict[str, Any] = {"format": _FORMAT, "leaves": []}
        for li, (path, leaf) in enumerate(leaf_paths(tree)):
            shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
            if isinstance(leaf, ShardedLeaf):
                bounds = _global_bounds(leaf)
            else:  # host array / plain tensor: one full-extent shard
                bounds = [_full_bounds(shape)]
            manifest["leaves"].append({
                "path": list(path), "shape": list(shape),
                "dtype": _dtype_name(leaf),
                "shards": [{"bounds": b,
                            "file": f"L{li:04d}.S{si:03d}.bin"}
                           for si, b in enumerate(bounds)]})
        return manifest

    def _owned_blocks(self, tree: Any, manifest: Dict[str, Any],
                      owns: Optional[Callable[[Shard], bool]],
                      process_index: int
                      ) -> Iterator[Tuple[str, Callable[[], np.ndarray]]]:
        """(file name, host-copy thunk) for every shard this process
        writes (default: each slice's replica 0)."""
        if owns is None:
            def owns(shard: Shard) -> bool:
                return shard.replica_id == 0

        for li, (path, leaf) in enumerate(leaf_paths(tree)):
            entry = manifest["leaves"][li]
            fname_by_bounds = {tuple(map(tuple, s["bounds"])): s["file"]
                               for s in entry["shards"]}
            if isinstance(leaf, ShardedLeaf):
                emitted = set()
                devices = leaf.mesh.flat_devices()
                for p in range(len(leaf.shards)):
                    key = tuple(map(tuple, leaf.bounds(p)))
                    shard = Shard(p, devices[p], leaf.replica_id(p))
                    if key in emitted or not owns(shard):
                        continue
                    emitted.add(key)
                    yield (fname_by_bounds[key],
                           lambda x=leaf.shards[p]: _host_array(x))
            elif process_index == 0:
                yield (entry["shards"][0]["file"],
                       lambda x=leaf: _host_array(x))

    def _prepare_dir(self, name: str, process_index: int) -> str:
        d = self._dir(name)
        if os.path.exists(d) and process_index == 0:
            shutil.rmtree(d, ignore_errors=True)  # no stale shard files
        os.makedirs(d, exist_ok=True)
        return d

    def _commit(self, d: str, manifest: Dict[str, Any],
                process_index: int) -> None:
        if process_index == 0:
            tmp = os.path.join(d, _MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(d, _MANIFEST))  # commit marker

    def save(self, name: str, tree: Any,
             owns: Optional[Callable[[Shard], bool]] = None,
             process_index: int = 0,
             sync_fn: Optional[Callable[[str], None]] = None) -> int:
        """Write ``tree`` streaming (one shard on the host at a time);
        returns the bytes this (simulated) process wrote. Only process 0
        writes host leaves and the manifest; ``sync_fn(tag)``, when
        given, fences the directory's preparation, the shard writes and
        the commit, as JAX's does across processes."""
        self.wait(reraise=False)
        manifest = self._plan(tree)
        d = self._prepare_dir(name, process_index)
        if sync_fn is not None:
            sync_fn(f"sharded-ckpt-prepared-{name}")
        written = 0
        for fname, thunk in self._owned_blocks(tree, manifest, owns,
                                               process_index):
            data = thunk()  # ONE shard on the host
            with open(os.path.join(d, fname), "wb") as f:
                f.write(data.tobytes())
            written += data.nbytes
        if sync_fn is not None:
            sync_fn(f"sharded-ckpt-written-{name}")
        self._commit(d, manifest, process_index)
        if sync_fn is not None:
            sync_fn(f"sharded-ckpt-committed-{name}")
        return written

    def save_async(self, name: str, tree: Any) -> None:
        """Copy the shards to the host now (the caller's next step
        updates them in place), write them on a background thread (one
        in flight; a new save joins the previous). A failed async save
        is raised by the next ``wait()`` and logged by quiet waiters."""
        self.wait(reraise=False, log=True)
        manifest = self._plan(tree)
        blocks = [(fname, thunk())
                  for fname, thunk in self._owned_blocks(tree, manifest,
                                                         None, 0)]

        def run() -> None:
            try:
                d = self._prepare_dir(name, 0)
                for fname, data in blocks:
                    with open(os.path.join(d, fname), "wb") as f:
                        f.write(data.tobytes())
                self._commit(d, manifest, 0)
            except BaseException as e:  # noqa: BLE001 — held for wait()
                # wait() joins the thread before it reads the error
                self._pending_error = e

        with self._async_lock:
            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()

    def wait(self, reraise: bool = True, log: bool = False) -> None:
        """Join any in-flight async save. ``reraise=False`` swallows a
        parked failure (logging it with ``log``): cleanup and presence
        probes must not raise an earlier trial's write error."""
        with self._async_lock:
            t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._pending_error is not None:
            e, self._pending_error = self._pending_error, None
            if reraise:
                raise e
            if log:
                logging.getLogger(__name__).warning(
                    "async sharded checkpoint save failed", exc_info=e)

    def copy(self, src: str, dst: str) -> bool:
        """Directory-level checkpoint copy (the resume pre-seed)."""
        self.wait(reraise=False)
        if not self.exists(src):
            return False
        self.delete(dst)
        shutil.copytree(self._dir(src), self._dir(dst))
        return True

    # ---- restore ----
    def _manifest(self, name: str) -> Dict[str, Any]:
        with open(os.path.join(self._dir(name), _MANIFEST)) as f:
            return json.load(f)

    def manifest_shapes(self, name: str) -> Dict[Tuple[str, ...],
                                                 Tuple[int, ...]]:
        """leaf path → shape, from the manifest alone (no data read)."""
        return {tuple(e["path"]): tuple(e["shape"])
                for e in self._manifest(name)["leaves"]}

    def restore(self, name: str, template: Any) -> Any:
        """``template``'s structure with every leaf read back: a
        ``ShardedLeaf`` into its mesh and spec (each position's shard on
        its device), any other leaf as a host array (numpy; a bf16 leaf
        as a CPU tensor). Dtypes are the manifest's."""
        d = self._dir(name)
        self.wait(reraise=False)
        manifest = self._manifest(name)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{d}: unknown checkpoint format")
        by_path = {tuple(e["path"]): e for e in manifest["leaves"]}

        def read(entry: Dict[str, Any], bounds: Bounds) -> np.ndarray:
            # the requested slice from the overlapping shard files; the
            # same topology reads exactly one file
            starts = [a for a, _ in bounds]
            stops = [b for _, b in bounds]
            dtype = entry["dtype"]
            out = np.empty([b - a for a, b in bounds],
                           np.int16 if dtype == "bfloat16"
                           else np.dtype(dtype))
            filled = 0
            for sh in entry["shards"]:
                b = sh["bounds"]
                lo = [max(a, bb[0]) for a, bb in zip(starts, b)]
                hi = [min(s, bb[1]) for s, bb in zip(stops, b)]
                if any(l >= h for l, h in zip(lo, hi)):
                    continue
                block = _read_block(os.path.join(d, sh["file"]), dtype,
                                    [bb[1] - bb[0] for bb in b])
                src = tuple(slice(l - bb[0], h - bb[0])
                            for l, h, bb in zip(lo, hi, b))
                dst = tuple(slice(l - a, h - a)
                            for l, h, a in zip(lo, hi, starts))
                out[dst] = block[src]
                filled += int(np.prod([h - l for l, h in zip(lo, hi)]))
            if filled != out.size:
                raise ValueError(
                    f"{'/'.join(entry['path'])}: shard files cover "
                    f"{filled}/{out.size} of the requested slice "
                    "(partial/corrupt checkpoint)")
            return out

        def build(node: Any, path: Tuple[str, ...]) -> Any:
            if isinstance(node, dict):
                return {k: build(v, path + (str(k),))
                        for k, v in node.items()}
            entry = by_path.get(path)
            if entry is None:
                raise KeyError(f"checkpoint {name!r} is missing leaf "
                               f"{'/'.join(path)}")
            shape = tuple(entry["shape"])
            want = tuple(getattr(node, "shape", shape))
            if want != shape:
                raise ValueError(f"{'/'.join(path)}: checkpoint shape "
                                 f"{shape} != template shape {want}")
            if isinstance(node, ShardedLeaf):
                devices = node.mesh.flat_devices()
                return ShardedLeaf(shape, node.spec, node.mesh, [
                    _as_output(read(entry, node.bounds(p)),
                               entry["dtype"], devices[p])
                    for p in range(len(node.shards))])
            return _as_output(read(entry, _full_bounds(shape)),
                              entry["dtype"])

        return build(template, ())

    def total_bytes(self, name: str) -> int:
        """On-disk payload size (shard files, not the manifest)."""
        d = self._dir(name)
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d) if f.endswith(".bin"))


class ShardedCheckpointRef:
    """Lazy handle to a sharded checkpoint, passed where a host params
    tree would go (``TrainContext.shared_params``): the template calls
    :meth:`restore` with its own template. :meth:`matches` is the
    manifest-only shape probe a template decides a warm start with."""

    def __init__(self, checkpointer: ShardedCheckpointer,
                 name: str) -> None:
        self.checkpointer = checkpointer
        self.name = name

    def restore(self, template: Any) -> Any:
        return self.checkpointer.restore(self.name, template)

    def matches(self, template: Any) -> bool:
        """True iff the checkpoint's leaf paths and shapes equal the
        template's, read from the manifest alone."""
        try:
            saved = self.checkpointer.manifest_shapes(self.name)
        except (OSError, ValueError, KeyError):
            return False
        want = {path: tuple(int(s) for s in getattr(leaf, "shape", ()))
                for path, leaf in leaf_paths(template)}
        return saved == want

    def exists(self) -> bool:
        return self.checkpointer.exists(self.name)
