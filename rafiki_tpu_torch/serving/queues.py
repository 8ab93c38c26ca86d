"""Query/prediction queues between the Predictor and inference workers.

The port's own copy of ``rafiki_tpu/serving/queues.py``
(``EXPIRY_SKEW_TOLERANCE_S``, ``pack_message``, ``unpack_message``,
``QueueHub``, ``InProcQueueHub``, ``KVQueueHub``): the predictor pushes
each query batch onto every worker's query queue and gathers replies;
workers block-pop, predict, and push predictions back. Both hubs carry
the whole surface the predictor and the services manager call: query
depth, reply-queue discard and TTL, worker stats, pool membership, KV
shipments and shared blobs. The wire and the key names are the JAX
package's, so a port worker serves a JAX predictor and the reverse.

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

    def query_depth(self, worker_id: str) -> int:
        raise NotImplementedError

    def discard_prediction_queue(self, query_id: str) -> None:
        """Drop a query's reply queue after the gather finishes. Late
        replies (a worker answering after the deadline) would otherwise
        accumulate forever in the backing store."""
        raise NotImplementedError

    def arm_reply_ttl(self, query_id: str, ttl_s: float) -> None:
        """Condemn a query's reply queue ``ttl_s`` from now, armed at
        SCATTER time. Belt to discard's suspenders: a worker inside the
        expiry skew window may push a reply AFTER the gather discarded
        the queue, recreating it — the pre-armed TTL collects that
        straggler. Backends with their own sweep may no-op."""

    def put_worker_stats(self, worker_id: str, stats: Dict[str, Any]
                         ) -> None:
        """Workers publish their counters (dropped-expired queries,
        decode-engine stats) here; the predictor's /health aggregates
        them — the first diagnostic when 'the predictor only sees
        timeouts' (silent drops were invisible)."""
        raise NotImplementedError

    def get_worker_stats(self, worker_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def put_pool_members(self, pool_id: str,
                         members: Dict[str, Any]) -> None:
        """The control plane publishes a job's live worker-id set here
        (``{"workers": [...], "version": ...}``) whenever the pool
        changes — autoscale up/down, manual scale. The predictor polls
        it (rate-limited) and applies the diff to its breaker board +
        router table, so membership follows the worker set without a
        predictor rebuild. Deliberately durable (no TTL): membership is
        configuration, not liveness — health stays the breakers' job."""
        raise NotImplementedError

    def get_pool_members(self, pool_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    # ---- disaggregated prefill/decode: KV page shipments ----
    def push_kv(self, worker_id: str, data: bytes) -> None:
        """Ship a finished KV-page blob to ``worker_id``'s shipment
        queue (prefill-role worker → decode-role worker; see
        ``serving/kv_transfer.py``). A dedicated channel, not the
        query queue: the decode loop drains it non-blockingly between
        steps and a burst of multi-MB blobs must never delay control
        or query messages behind it."""
        raise NotImplementedError

    def pop_kv(self, worker_id: str, timeout: float) -> Optional[bytes]:
        raise NotImplementedError

    def kv_depth(self, worker_id: str) -> int:
        """Unconsumed shipments queued for ``worker_id`` (obs only)."""
        raise NotImplementedError

    # ---- cross-worker shared blobs (prefix snapshots) ----
    def put_blob(self, key: str, data: bytes) -> None:
        """Durable named blob (e.g. a job's shared-prefix KV snapshot,
        ``prefix:<pool>:<adapter>``): prefilled ONCE, imported by every
        replica instead of each re-running the prefill forward."""
        raise NotImplementedError

    def get_blob(self, key: str) -> Optional[bytes]:
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
        self._pools: Dict[str, Dict[str, Any]] = {}  # pool memberships
        self._blobs: Dict[str, bytes] = {}  # shared prefix snapshots
        #: armed reply-queue TTLs (key → monotonic deadline): unlike the
        #: idle sweep, an armed TTL fires even while late pushes keep
        #: refreshing last_used (an abandoned STREAM's worker keeps
        #: pushing deltas long after the client went away)
        self._ttls: Dict[str, float] = {}

    def _get(self, key: str, *, as_waiter: bool = False) -> _KeyQueue:
        import time

        with self._meta:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _KeyQueue()
            if as_waiter:
                # registered BEFORE _meta is released: waiters is read by
                # discard/sweep under _meta, so a popper that has fetched
                # the queue can never be invisible to them (the window
                # between fetch and a later increment under q.cv orphaned
                # poppers on deleted entries)
                q.waiters += 1
            q.last_used = time.monotonic()
            self._ops += 1
            if self._ops % _SWEEP_EVERY == 0:
                now = q.last_used  # just-refreshed monotonic time
                cutoff = now - _IDLE_TTL_S
                dead = [k for k, v in self._queues.items()
                        if not v.waiters and v.last_used < cutoff
                        # reply queues (p:*) expire even NON-empty: a
                        # late push after discard recreates the entry
                        # and nothing would ever pop it
                        and (not v.dq or k.startswith("p:"))]
                for k in dead:  # e.g. replies that arrived after their
                    del self._queues[k]  # query's gather deadline
                # armed TTLs fire regardless of last_used (a worker
                # still streaming deltas into an abandoned queue keeps
                # it perpetually 'fresh' for the idle sweep above)
                for k in [k for k, dl in self._ttls.items() if dl < now]:
                    del self._ttls[k]
                    v = self._queues.get(k)
                    if v is not None and not v.waiters:
                        del self._queues[k]
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

    def query_depth(self, worker_id: str) -> int:
        with self._meta:
            q = self._queues.get(f"q:{worker_id}")
        return len(q.dq) if q is not None else 0

    def arm_reply_ttl(self, query_id: str, ttl_s: float) -> None:
        import time

        with self._meta:
            self._ttls[f"p:{query_id}"] = time.monotonic() + float(ttl_s)

    def discard_prediction_queue(self, query_id: str) -> None:
        with self._meta:
            q = self._queues.get(f"p:{query_id}")
            if q is not None and not q.waiters:
                del self._queues[f"p:{query_id}"]

    def put_worker_stats(self, worker_id: str, stats) -> None:
        with self._meta:
            self._stats[worker_id] = dict(stats)

    def get_worker_stats(self, worker_id: str):
        with self._meta:
            return self._stats.get(worker_id)

    def put_pool_members(self, pool_id: str, members) -> None:
        with self._meta:
            self._pools[pool_id] = dict(members)

    def get_pool_members(self, pool_id: str):
        with self._meta:
            return self._pools.get(pool_id)

    def push_kv(self, worker_id: str, data: bytes) -> None:
        self._push(f"kv:{worker_id}", data)

    def pop_kv(self, worker_id: str, timeout: float) -> Optional[bytes]:
        return self._pop(f"kv:{worker_id}", timeout)

    def kv_depth(self, worker_id: str) -> int:
        with self._meta:
            q = self._queues.get(f"kv:{worker_id}")
        return len(q.dq) if q is not None else 0

    def put_blob(self, key: str, data: bytes) -> None:
        with self._meta:
            self._blobs[key] = bytes(data)

    def get_blob(self, key: str) -> Optional[bytes]:
        with self._meta:
            return self._blobs.get(key)


class KVQueueHub(QueueHub):
    """Queues on the native kv server. Blocking pops hold a socket, so each
    hub keeps one client per calling thread (thread-local).

    Crash-survivable by construction: every thread-local client carries
    the reconnect layer (``retry_window_s``, see
    :class:`~rafiki_tpu_torch.native.client.KVClient`), and every queue push
    mints a dedup id so the retry of a push whose ack was lost — a
    connection drop, a kvd kill -9 and supervised respawn — can never
    double-deliver. Reads and ``put_blob`` retry transparently;
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

    def drop_conn(self) -> None:
        """Force-close the calling thread's client socket (chaos /
        tests): the next hub op finds a dead transport and exercises
        the reconnect + idempotent-replay path."""
        c = getattr(self._tl, "client", None)
        if c is not None:
            c.drop_conn()

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
    #: very late push (e.g. a worker stuck in a >30s recompile
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

    def query_depth(self, worker_id: str) -> int:
        return self._client().llen(f"q:queries:{worker_id}")

    def discard_prediction_queue(self, query_id: str) -> None:
        self._client().delete(f"q:preds:{query_id}")

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

    def arm_reply_ttl(self, query_id: str, ttl_s: float) -> None:
        # kvd TTLs deliberately survive deletion/recreation (see
        # kv_server.cc) — one EXPIRE at scatter covers the whole
        # query lifetime including post-discard stragglers
        self._client().expire(f"q:preds:{query_id}", ttl_s)

    def put_pool_members(self, pool_id: str, members) -> None:
        # no TTL: membership is durable configuration written by the
        # (lease-fenced, single-writer) admin — a stale-looking list is
        # still the last truth; worker HEALTH stays the breakers' job
        self._client().set(f"pool:{pool_id}", pack_message(dict(members)))

    def get_pool_members(self, pool_id: str):
        raw = self._client().get(f"pool:{pool_id}")
        return None if raw is None else unpack_message(raw)

    #: KV shipments expire unconsumed: a blob whose decode worker died
    #: (or re-prefilled locally after its wait window) must not sit in
    #: the kv store forever — the decode side re-prefills token-exactly
    #: either way, so a swept shipment costs latency, never correctness
    KV_SHIP_TTL_S = 60.0

    def push_kv(self, worker_id: str, data: bytes) -> None:
        c = self._client()
        c.lpush_dedup(f"q:kv:{worker_id}", self._dedup_id(), data)
        c.expire(f"q:kv:{worker_id}", self.KV_SHIP_TTL_S)

    def pop_kv(self, worker_id: str, timeout: float) -> Optional[bytes]:
        if timeout <= 0:
            return self._client().rpop(f"q:kv:{worker_id}")
        got = self._client().brpop(f"q:kv:{worker_id}", timeout)
        return None if got is None else got[1]

    def kv_depth(self, worker_id: str) -> int:
        return self._client().llen(f"q:kv:{worker_id}")

    def put_blob(self, key: str, data: bytes) -> None:
        # durable like pool membership: a shared-prefix snapshot is
        # configuration-scale state (prefilled once per deploy)
        self._client().set(f"blob:{key}", data)

    def get_blob(self, key: str) -> Optional[bytes]:
        return self._client().get(f"blob:{key}")
