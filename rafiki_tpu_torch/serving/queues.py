"""Query/prediction queues between the Predictor and inference workers.

The port's own copy of ``rafiki_tpu/serving/queues.py`` (``pack_message``,
``unpack_message``, ``EXPIRY_SKEW_TOLERANCE_S``, ``QueueHub``,
``InProcQueueHub``, ``KVQueueHub``): the predictor pushes each query
batch onto every worker's query queue and gathers replies; workers
block-pop, predict, and push predictions back. The wire is the JAX
package's: a port worker serves the unchanged JAX ``Predictor``.

Two hubs, one interface: ``InProcQueueHub`` (threads in one process —
tests and the single-host fast path) and ``KVQueueHub`` (the native
``rafiki-kvd`` server — multi-process deployments). Replies land on a
per-query-id queue so the predictor can gather exactly the replicas it
scattered to, concurrently across outstanding queries.

Messages are msgpack-serialized pytrees (same codec as the ParamStore) so
query arrays cross process boundaries without JSON inflation.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

from rafiki_tpu_torch.store.param_store import (params_from_bytes,
                                                 params_to_bytes)


#: tolerance a worker adds to a query's deadline_ts before dropping it
#: as expired — covers predictor↔worker wall-clock skew.
#: Lives here (the shared data-plane module) because both sides size
#: against it: workers pad the drop test, the predictor pads reply-queue
#: TTLs so skew-window stragglers still get collected.
EXPIRY_SKEW_TOLERANCE_S = 3.0


def pack_message(msg: Dict[str, Any]) -> bytes:
    return params_to_bytes(msg)


def unpack_message(data: bytes) -> Dict[str, Any]:
    return params_from_bytes(data)


class QueueHub:
    """Scatter/gather data plane between one predictor and its workers."""

    def push_query(self, worker_id: str, data: bytes) -> None:
        raise NotImplementedError

    def pop_query(self, worker_id: str,
                  timeout: float) -> Optional[bytes]:
        raise NotImplementedError

    def push_prediction(self, query_id: str, data: bytes) -> None:
        raise NotImplementedError

    def pop_prediction(self, query_id: str,
                       timeout: float) -> Optional[bytes]:
        raise NotImplementedError

    def put_worker_stats(self, worker_id: str, stats: Dict[str, Any]
                         ) -> None:
        """Workers publish their counters (dropped-expired queries,
        decode-engine stats) here; the predictor's /health aggregates
        them — the first diagnostic when 'the predictor only sees
        timeouts' (silent drops were invisible)."""
        raise NotImplementedError

    def get_worker_stats(self, worker_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def pop_kv(self, worker_id: str, timeout: float) -> Optional[bytes]:
        """Pop a KV-page shipment a JAX prefill-role worker pushed to
        ``worker_id`` (its own channel beside the query queue). The port
        serves such requests by local prefill and drops the shipment."""
        raise NotImplementedError


class _KeyQueue:
    """One deque + its OWN condvar. A shared hub-wide condition would
    notify_all() every waiter (workers blocked on queries, predictor
    threads blocked on unrelated replies) for every push — a thundering
    herd that measurably lost to the socket-based kv hub under
    multi-client load."""

    __slots__ = ("dq", "cv", "last_used", "waiters")

    def __init__(self) -> None:
        self.dq: collections.deque = collections.deque()
        self.cv = threading.Condition()
        self.last_used = 0.0
        self.waiters = 0  # parked poppers — sweeping their entry would
        #                   orphan them (a later push notifies a NEW obj)


#: reply queues are per-query-id and transient; entries idle this long
#: with nothing queued are swept (abandoned after a gather deadline)
_IDLE_TTL_S = 120.0
_SWEEP_EVERY = 1024  # hub ops between sweeps


class InProcQueueHub(QueueHub):
    def __init__(self) -> None:
        self._queues: Dict[str, _KeyQueue] = {}
        self._meta = threading.Lock()  # guards the key → queue dict
        self._ops = 0
        self._stats: Dict[str, Dict[str, Any]] = {}  # worker counters

    def _get(self, key: str, *, as_waiter: bool = False) -> _KeyQueue:
        import time

        with self._meta:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _KeyQueue()
            if as_waiter:
                # registered BEFORE _meta is released: waiters is read by
                # the sweep under _meta, so a popper that has fetched
                # the queue can never be invisible to them (the window
                # between fetch and a later increment under q.cv orphaned
                # poppers on deleted entries)
                q.waiters += 1
            q.last_used = time.monotonic()
            self._ops += 1
            if self._ops % _SWEEP_EVERY == 0:
                cutoff = q.last_used - _IDLE_TTL_S
                dead = [k for k, v in self._queues.items()
                        if not v.waiters and v.last_used < cutoff
                        # reply queues (p:*) expire even NON-empty: a
                        # reply pushed after its gather gave up would
                        # never be popped
                        and (not v.dq or k.startswith("p:"))]
                for k in dead:  # e.g. replies that arrived after their
                    del self._queues[k]  # query's gather deadline
            return q

    def _push(self, key: str, data: bytes) -> None:
        q = self._get(key)
        with q.cv:
            q.dq.append(data)
            q.cv.notify()

    def _pop(self, key: str, timeout: float) -> Optional[bytes]:
        q = self._get(key, as_waiter=True)
        try:
            with q.cv:
                ok = q.cv.wait_for(lambda: bool(q.dq), timeout=timeout)
                if not ok:
                    return None
                return q.dq.popleft()
        finally:
            with self._meta:  # all waiters transitions happen under _meta
                q.waiters -= 1

    def push_query(self, worker_id: str, data: bytes) -> None:
        self._push(f"q:{worker_id}", data)

    def pop_query(self, worker_id: str, timeout: float) -> Optional[bytes]:
        return self._pop(f"q:{worker_id}", timeout)

    def push_prediction(self, query_id: str, data: bytes) -> None:
        self._push(f"p:{query_id}", data)

    def pop_prediction(self, query_id: str,
                       timeout: float) -> Optional[bytes]:
        return self._pop(f"p:{query_id}", timeout)

    def put_worker_stats(self, worker_id: str, stats) -> None:
        with self._meta:
            self._stats[worker_id] = dict(stats)

    def get_worker_stats(self, worker_id: str):
        with self._meta:
            return self._stats.get(worker_id)

    def pop_kv(self, worker_id: str, timeout: float) -> Optional[bytes]:
        return self._pop(f"kv:{worker_id}", timeout)


class KVQueueHub(QueueHub):
    """Queues on the native kv server. Blocking pops hold a socket, so each
    hub keeps one client per calling thread (thread-local).

    Crash-survivable by construction: every thread-local client carries
    the reconnect layer (``retry_window_s``, see
    :class:`~rafiki_tpu_torch.native.client.KVClient`), and every queue push
    mints a dedup id so the retry of a push whose ack was lost — a
    connection drop, a kvd kill -9 and supervised respawn — can never
    double-deliver. Reads retry transparently;
    in-flight blocking pops resume on the new socket. When the window
    closes a ``ConnectionError`` surfaces and the caller degrades
    (predictor: structured 503; workers: pause the serve loop)."""

    #: default reconnect window: long enough to ride out a supervised
    #: kvd respawn + WAL replay (~1-2s observed), short enough that a
    #: truly dead data plane surfaces as a structured failure, not a
    #: hang
    RETRY_WINDOW_S = 8.0

    def __init__(self, host: str, port: int,
                 retry_window_s: Optional[float] = None) -> None:
        self._host, self._port = host, port
        self.retry_window_s = (self.RETRY_WINDOW_S
                               if retry_window_s is None
                               else float(retry_window_s))
        self._tl = threading.local()

    def _client(self):
        from rafiki_tpu_torch.native.client import KVClient

        c = getattr(self._tl, "client", None)
        if c is None:
            c = KVClient(self._host, self._port,
                         retry_window_s=self.retry_window_s)
            self._tl.client = c
        return c

    @staticmethod
    def _dedup_id() -> str:
        import uuid

        return uuid.uuid4().hex

    def push_query(self, worker_id: str, data: bytes) -> None:
        self._client().lpush_dedup(f"q:queries:{worker_id}",
                                   self._dedup_id(), data)

    def pop_query(self, worker_id: str, timeout: float) -> Optional[bytes]:
        if timeout <= 0:  # non-blocking drain (BRPOP 0 means block forever)
            return self._client().rpop(f"q:queries:{worker_id}")
        got = self._client().brpop(f"q:queries:{worker_id}", timeout)
        return None if got is None else got[1]

    #: push-time TTL on reply queues: every reply key is mortal even
    #: when the scatter-time TTL already fired and was purged before a
    #: very late push (e.g. a worker stuck in a >30s XLA recompile
    #: inside its expiry-skew window) recreated the key
    REPLY_TTL_S = 120.0

    def push_prediction(self, query_id: str, data: bytes) -> None:
        c = self._client()
        c.lpush_dedup(f"q:preds:{query_id}", self._dedup_id(), data)
        c.expire(f"q:preds:{query_id}", self.REPLY_TTL_S)

    def pop_prediction(self, query_id: str,
                       timeout: float) -> Optional[bytes]:
        if timeout <= 0:
            return self._client().rpop(f"q:preds:{query_id}")
        got = self._client().brpop(f"q:preds:{query_id}", timeout)
        return None if got is None else got[1]

    #: stats keys expire so a DEAD worker's last counters cannot pose
    #: as current health forever (live workers republish well inside
    #: this window)
    STATS_TTL_S = 120.0

    def put_worker_stats(self, worker_id: str, stats) -> None:
        c = self._client()
        c.set(f"stats:{worker_id}", pack_message(dict(stats)))
        c.expire(f"stats:{worker_id}", self.STATS_TTL_S)

    def get_worker_stats(self, worker_id: str):
        raw = self._client().get(f"stats:{worker_id}")
        return None if raw is None else unpack_message(raw)

    def pop_kv(self, worker_id: str, timeout: float) -> Optional[bytes]:
        if timeout <= 0:
            return self._client().rpop(f"q:kv:{worker_id}")
        got = self._client().brpop(f"q:kv:{worker_id}", timeout)
        return None if got is None else got[1]
