"""Host-RAM KV page tier: a second page pool behind the device allocator.

The port's own copy of ``rafiki_tpu/serving/kv_tier.py`` (``_Ticket``,
``HostPageTier``). A paged engine reserves each request's worst-case
pages at admission, so the pool on the card caps how many requests can be
admitted at once. With the tier, cold pages spill to a host page pool and
come back ahead of the step that needs them: the admission budget becomes
device pages plus host pages, while the decode calls only ever touch
pages on the card.

Division of labor, as in JAX:

- the :class:`~rafiki_tpu_torch.serving.decode_engine.DecodeEngine` owns
  the POLICY (which slots park, which pages evict, when a parked slot
  resumes). It runs on the step thread and never blocks on a transfer,
  except on a prefetch miss, where :meth:`HostPageTier.fetch` waits out
  pending evictions of the pages it needs (the time it waits is
  :attr:`HostPageTier.wait_s`);
- :class:`HostPageTier` owns the MECHANISM: the host pool (one buffer per
  cache leaf, page-major like the device pool: ``(pages, page_size,
  kv_heads, head_dim)``, plus the int8 pools' scale rows; allocated on
  the first eviction, when the leaves' shapes are known), its free list,
  and a transfer thread that drains evictions (device -> host) and stages
  prefetches (host -> device).

On a CUDA device the host pool is pinned and every copy is asynchronous,
enqueued by the transfer thread on a side CUDA stream of the tier's own.
The pool on the card is written in place (there is no buffer donation to
order writes, as JAX has), so the ordering is explicit:

- an eviction's gather runs on the step thread's stream, before the freed
  pages can be reused, and the step thread records an event after it; the
  side stream waits on that event before it copies, and the gathered
  tensor is marked as used by the side stream (``record_stream``), so the
  caching allocator cannot hand its memory to a later step while the
  copy still reads it;
- a prefetch allocates its staged device tensors on the side stream and
  copies the pages into them; the transfer thread waits for the copies
  (the only blocking waits live on that thread), and the engine marks the
  staged tensors as used by its own stream before it copies them into the
  pool;
- a host page read on the step thread's stream (a prefetch miss uploads
  straight from the pinned pool) leaves an event behind, and an eviction
  that later writes that page waits on it first.

Each transfer is one ``torch._foreach_copy_`` call: one copy per cache
leaf and per run of consecutive host ids, straight between the pinned
pool's rows and the device tensor.

A copy on the card that fails raises where the engine next needs it: a
failed prefetch raises from :meth:`take_staged` (JAX reads it as a miss),
and a failed eviction is retried once, synchronously, by :meth:`fetch`,
which raises if the retry fails too (JAX behaviour). On the CPU the same
class copies synchronously on its thread, with no streams.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)


class _Ticket:
    """One queued transfer: completion event and what the transfer thread
    needs to run it."""

    __slots__ = ("kind", "key", "host_ids", "payload", "done", "at",
                 "failed", "ready")

    def __init__(self, kind: str, key: Any, host_ids: List[int],
                 payload: Any, ready: Any = None) -> None:
        self.kind = kind            # "evict" | "prefetch"
        self.key = key
        self.host_ids = host_ids
        self.payload = payload
        #: CUDA event recorded after the gather that produced ``payload``
        self.ready = ready
        self.done = threading.Event()
        self.at = time.monotonic()
        #: the transfer raised; for evictions the retained ``payload``
        #: lets :meth:`HostPageTier.fetch` retry the copy — the host pool
        #: bytes for ``host_ids`` are not valid until it does
        self.failed = False


def _runs(ids: Sequence[int]) -> List[Tuple[int, int, int]]:
    """``(start, end, first_id)`` of each run of consecutive ids: one
    contiguous copy per run instead of one per page."""
    out, a = [], 0
    for j in range(1, len(ids) + 1):
        if j == len(ids) or ids[j] != ids[j - 1] + 1:
            out.append((a, j, int(ids[a])))
            a = j
    return out


def _run_views(ids: Sequence[int], rows: Sequence[torch.Tensor],
               pool: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Matching views, per leaf and per run of consecutive ``ids``: the
    rows ``a:b`` of ``rows`` (one row per id, in order) beside the pool's
    rows ``h0:h0 + b - a``."""
    runs = _runs(ids)
    return ([r[a:b] for r in rows for a, b, _h0 in runs],
            [p[h0:h0 + b - a] for p in pool for a, b, h0 in runs])


def _as_tensor(a: Any) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are, anything else through
    numpy (the JAX tier's tests hand it numpy arrays)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


class HostPageTier:
    """Host page pool and asynchronous transfer worker.

    ``n_pages`` host pages, each of the device pool's page geometry.
    ``stats`` is the owning engine's StatsMap: the tier feeds the
    ``kv_host_pages_used/total``, ``kv_evictions_total`` and
    ``kv_transfer_bytes_total`` gauges (the engine counts prefetch hits
    and misses). ``observe_transfer`` (wired by the worker) receives each
    completed transfer's wall seconds. ``device`` is the engine's: a CUDA
    device pins the pool and moves pages on a side stream.

    Measurements, beside the JAX tier's counters: :attr:`copy_bytes` and
    :attr:`copy_s` per direction (``d2h``, ``h2d``; on a CUDA device the
    side-stream copies' device time, on the CPU their wall time), and
    :attr:`wait_s`, the seconds callers of :meth:`fetch` waited for
    pending evictions."""

    def __init__(self, n_pages: int, stats: Any,
                 observe_transfer: Optional[Callable[[float], None]]
                 = None, device: Any = None) -> None:
        if int(n_pages) < 1:
            raise ValueError("host tier needs >= 1 host page")
        self.n_pages = int(n_pages)
        self.stats = stats
        self.observe_transfer = observe_transfer
        self.device = torch.device("cpu" if device is None else device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.n_pages))
        self._pool: Optional[List[torch.Tensor]] = None
        #: host page id -> the eviction ticket that is (or was) writing
        #: it; fetch/prefetch wait on these before reading the pool
        self._writers: Dict[int, _Ticket] = {}
        #: host page id -> CUDA event after the last read of its pool
        #: rows on the step thread's stream; an eviction into the page
        #: waits on it before overwriting
        self._readers: Dict[int, Any] = {}
        #: staged prefetches: key -> (host_ids, device leaves, ticket)
        self._staged: Dict[Any, Tuple[Tuple[int, ...], Any, _Ticket]] = {}
        #: failed prefetch copies on a CUDA device, raised by take_staged
        self._staging_errors: Dict[Any, BaseException] = {}
        #: park keys with a live prefetch interest: a prefetch that
        #: completes after its key died must not store under it (keys are
        #: never reused, so the staged tensors would be held forever)
        self._want: set = set()
        self._q: "collections.deque[_Ticket]" = collections.deque()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        self.copy_bytes = {"d2h": 0, "h2d": 0}
        self.copy_s = {"d2h": 0.0, "h2d": 0.0}
        self.wait_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="kv-host-tier", daemon=True)
        self._thread.start()

    # ---- allocator (step thread) ----
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` host pages, or None when the tier is too full (the
        engine's combined-budget reservation makes None unreachable for
        growth inside a reservation; the tier still refuses rather than
        corrupting its free list).

        The ids come off the top of the free list and are returned in
        ascending order: the engine evicts a parked slot's pages tail
        first, so its later evictions get lower ids, and the slot's host
        pages in logical order form runs, which :meth:`fetch` and the
        prefetch copy a run at a time."""
        with self._lock:
            if len(self._free) < n:
                return None
            ids = [self._free.pop() for _ in range(n)][::-1]
            self.stats.set("kv_host_pages_used",
                           self.n_pages - len(self._free))
        return ids

    def free(self, host_ids: Sequence[int]) -> None:
        with self._lock:
            for h in host_ids:
                self._writers.pop(int(h), None)
                self._free.append(int(h))
            self.stats.set("kv_host_pages_used",
                           self.n_pages - len(self._free))

    # ---- eviction (device -> host) ----
    def evict_submit(self, host_ids: List[int], device_leaves: Any,
                     ready: Any = None) -> None:
        """Queue a device -> host page copy. ``device_leaves`` are
        already-gathered per-leaf tensors shaped ``(len(host_ids),
        page_size, ...)``; ``ready`` (CUDA) is an event the step thread
        recorded after the gather. The step thread returns at once; the
        copy runs on the transfer thread."""
        t = _Ticket("evict", None, [int(h) for h in host_ids],
                    device_leaves, ready)
        with self._lock:
            for h in t.host_ids:
                self._writers[h] = t
            if self._stop:
                # close() raced a still-stepping engine: nothing will run
                # this ticket, so fetch() recovers it synchronously
                t.failed = True
                t.done.set()
                return
            self._q.append(t)
            self._cv.notify()

    # ---- prefetch / fetch (host -> device) ----
    def prefetch_submit(self, key: Any, host_ids: Sequence[int]) -> None:
        """Ask the transfer thread to stage ``key``'s host pages on the
        device ahead of the unpark that will need them. Idempotent per
        (key, ids); a staging for other ids is dropped."""
        ids = tuple(int(h) for h in host_ids)
        if not ids:
            return
        with self._lock:
            if self._stop:
                return
            self._want.add(key)
            cur = self._staged.get(key)
            if cur is not None and cur[0] == ids:
                return
            if cur is not None:
                self._staged.pop(key, None)
            if any(t.kind == "prefetch" and t.key == key for t in self._q):
                return
            self._q.append(_Ticket("prefetch", key, list(ids), None))
            self._cv.notify()

    def take_staged(self, key: Any, host_ids: Sequence[int]
                    ) -> Optional[Any]:
        """The staged leaves for ``key`` if the prefetcher got there
        first, for the same pages (a prefetch hit); None is a miss, and
        the caller falls back to :meth:`fetch`. On a CUDA device a staging
        copy that failed raises here."""
        ids = tuple(int(h) for h in host_ids)
        with self._lock:
            cur = self._staged.pop(key, None)
            err = self._staging_errors.pop(key, None)
            self._want.discard(key)
        if err is not None:
            raise RuntimeError(f"kv host tier: staging pages {list(ids)} "
                               "on the device failed") from err
        if cur is None or cur[0] != ids or not cur[2].done.is_set():
            return None
        return cur[1]

    def drop_staged(self, key: Any) -> None:
        with self._lock:
            self._staged.pop(key, None)
            self._staging_errors.pop(key, None)
            self._want.discard(key)

    def fetch(self, host_ids: Sequence[int], device: Any = None
              ) -> List[torch.Tensor]:
        """The given pages' content, waiting out any pending eviction
        writes first: host tensors, or with a CUDA ``device`` new device
        tensors, copied asynchronously on the caller's stream straight
        from the pinned pool's rows; an event recorded after the copies
        keeps a later eviction from overwriting the pages under them."""
        ids = [int(h) for h in host_ids]
        t0 = time.perf_counter()
        with self._lock:
            waits = [self._writers[h] for h in ids if h in self._writers]
        for t in waits:
            t.done.wait()
        for t in {id(t): t for t in waits if t.failed}.values():
            self._recover_failed(t)
        self.wait_s += time.perf_counter() - t0
        with self._lock:
            # re-read after the waits: the first eviction creates the pool
            # on the transfer thread
            pool = self._pool
        if pool is None:
            raise RuntimeError("host tier fetch before any eviction")
        dev = torch.device("cpu" if device is None else device)
        if dev.type != "cuda":
            idx = torch.as_tensor(ids, dtype=torch.long)
            return [leaf.index_select(0, idx) for leaf in pool]
        out = [torch.empty((len(ids),) + tuple(leaf.shape[1:]),
                           dtype=leaf.dtype, device=dev) for leaf in pool]
        torch._foreach_copy_(*_run_views(ids, out, pool), non_blocking=True)
        read = torch.cuda.Event()
        read.record(torch.cuda.current_stream(dev))
        with self._lock:
            for h in ids:
                self._readers[h] = read
        return out

    def _recover_failed(self, t: _Ticket) -> None:
        """Retry a failed eviction copy synchronously from the ticket's
        retained payload. Raises if the content cannot be recovered: a
        lost page must be loud (the engine's step-level error recovery
        resets rather than resuming a stream from garbage KV). Held under
        the tier lock: two fetchers must not both run the copy."""
        with self._lock:
            if not t.failed:
                return  # another fetcher already recovered it
            if t.payload is None:
                raise RuntimeError(
                    "kv host tier: evicted page content lost "
                    f"(pages {t.host_ids})")
            leaves = [_as_tensor(a) for a in t.payload]
            pool = self._ensure_pool(leaves)
            if t.ready is not None:
                torch.cuda.current_stream(self.device).wait_event(t.ready)
            moved = self._copy_into_pool(pool, t.host_ids, leaves)
            t.payload = None
            t.failed = False
            self.stats.inc("kv_evictions_total", len(t.host_ids))
            self.stats.inc("kv_transfer_bytes_total", moved)

    @staticmethod
    def _copy_into_pool(pool: List[torch.Tensor], host_ids: List[int],
                        leaves: List[torch.Tensor]) -> int:
        """Synchronous copy of ``leaves`` into the pool rows ``host_ids``
        (any device); returns the bytes moved."""
        rows, pool_rows = _run_views(host_ids, leaves, pool)
        for dst, src in zip(pool_rows, rows):
            dst.copy_(src)
        return int(sum(a.numel() * a.element_size() for a in leaves))

    # ---- lifecycle ----
    def reset(self) -> None:
        with self._lock:
            self._q.clear()
            self._staged.clear()
            self._staging_errors.clear()
            self._want.clear()
            self._writers.clear()
            self._free = list(range(self.n_pages))
            self.stats.set("kv_host_pages_used", 0)

    def close(self) -> None:
        with self._lock:
            self._stop = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify()
        for t in pending:
            # never-run work must not strand a fetch() on its done event:
            # a failed eviction recovers synchronously from its payload;
            # an unstaged prefetch is a miss
            t.failed = True
            t.done.set()

    # ---- the transfer thread ----
    def _ensure_pool(self, leaves: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        if self._pool is None:
            self._pool = [
                torch.empty((self.n_pages,) + tuple(a.shape[1:]),
                            dtype=a.dtype, pin_memory=self._cuda)
                for a in leaves]
        return self._pool

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=1.0)
                if self._stop:
                    return
                t = self._q.popleft()
            try:
                self._execute(t)
            except Exception as e:  # noqa: BLE001 — a failed transfer
                # must not kill the transfer thread. A failed prefetch is
                # a miss on the CPU and raises from take_staged on a CUDA
                # device; a failed eviction is retried by fetch from the
                # retained payload (the pool bytes are garbage until then)
                t.failed = True
                if t.kind == "prefetch" and self._cuda:
                    with self._lock:
                        if t.key in self._want:
                            self._staging_errors[t.key] = e
                log.warning("kv host tier transfer failed", exc_info=True)
            finally:
                t.done.set()

    def _execute(self, t: _Ticket) -> None:
        t0 = time.monotonic()
        if t.kind == "evict":
            self._evict(t)
        elif not self._prefetch(t):
            return
        if self.observe_transfer is not None:
            try:
                self.observe_transfer(time.monotonic() - t0)
            except Exception:  # noqa: BLE001 — observability must never
                pass           # kill transfers

    def _evict(self, t: _Ticket) -> None:
        """Copy the ticket's gathered leaves into the pool rows of its
        host pages: on a CUDA device on the side stream, after the gather
        and after any pending read of those rows; on the CPU
        synchronously."""
        leaves = [_as_tensor(a) for a in t.payload]
        with self._lock:
            pool = self._ensure_pool(leaves)
            readers = {id(e): e for e in (self._readers.pop(h, None)
                                          for h in t.host_ids)
                       if e is not None}
        moved = int(sum(a.numel() * a.element_size() for a in leaves))
        if self._cuda and leaves and leaves[0].is_cuda:
            s = self._stream
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(s):
                if t.ready is not None:
                    s.wait_event(t.ready)
                for e in readers.values():
                    s.wait_event(e)
                start.record(s)
                rows, pool_rows = _run_views(t.host_ids, leaves, pool)
                torch._foreach_copy_(pool_rows, rows, non_blocking=True)
                for src in leaves:
                    # the step thread dropped its reference: without this
                    # the allocator could reuse the gathered tensor's
                    # memory for a later step while the copy still reads it
                    src.record_stream(s)
                end.record(s)
            end.synchronize()  # the transfer thread's own wait
            self.copy_s["d2h"] += start.elapsed_time(end) / 1e3
        else:
            s0 = time.perf_counter()
            self._copy_into_pool(pool, t.host_ids, leaves)
            self.copy_s["d2h"] += time.perf_counter() - s0
        # release the gathered tensors now: the writers map holds the
        # ticket until the host pages free, and keeping them would pin
        # every evicted page's bytes on the device
        t.payload = None
        self.copy_bytes["d2h"] += moved
        self.stats.inc("kv_evictions_total", len(t.host_ids))
        self.stats.inc("kv_transfer_bytes_total", moved)

    def _prefetch(self, t: _Ticket) -> bool:
        """Stage ``t.key``'s pages; False when skipped (stale key)."""
        with self._lock:
            if t.key not in self._want:
                return False  # the park this prefetch served is gone
            ws = {id(w): w for h in t.host_ids
                  for w in (self._writers.get(h),) if w is not None}
            if any(not w.done.is_set() or w.failed for w in ws.values()):
                # a writer queued behind this prefetch (FIFO: anything
                # ahead already ran) means the pages were freed and
                # reallocated, so the key is stale; waiting for it here
                # would deadlock the only thread that can run it. A failed
                # writer needs fetch()'s recovery. The unpark's own fetch
                # covers either case.
                return False
            pool = self._pool
            if pool is None:
                return False
        ids = t.host_ids
        if self._cuda:
            s = self._stream
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(s):
                staged = [torch.empty((len(ids),) + tuple(leaf.shape[1:]),
                                      dtype=leaf.dtype, device=self.device)
                          for leaf in pool]
                start.record(s)
                torch._foreach_copy_(*_run_views(ids, staged, pool),
                                     non_blocking=True)
                end.record(s)
            end.synchronize()  # the transfer thread's own wait
            secs = start.elapsed_time(end) / 1e3
        else:
            s0 = time.perf_counter()
            idx = torch.as_tensor(ids, dtype=torch.long)
            staged = [leaf.index_select(0, idx) for leaf in pool]
            secs = time.perf_counter() - s0
        moved = int(sum(a.numel() * a.element_size() for a in staged))
        self.copy_bytes["h2d"] += moved
        self.copy_s["h2d"] += secs
        self.stats.inc("kv_transfer_bytes_total", moved)
        with self._lock:
            if t.key in self._want:
                self._staged[t.key] = (tuple(ids), staged, t)
        return True
