"""Request tracing: trace ids and a bounded per-process span ring.

The port's own copy of ``rafiki_tpu/obs/trace.py`` (``mint_trace_id``,
``sanitize_trace_id``, ``TraceBuffer``). One trace id is minted at the
predictor (or honored from an inbound ``X-Rafiki-Trace-Id`` header),
rides in the scatter payload to the workers, and every process appends
its own spans (queued, admitted, prefill, first_token, decode marks,
done / expired / rejected) to its local ring; ``GET /debug/requests``
serves the ring. Timestamps are monotonic process uptime seconds
(``uptime_s`` per record, ``t`` per span).
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

#: inbound trace ids are untrusted header bytes: bound the length and
#: alphabet so a hostile client can't stuff the ring with megabyte ids
_TRACE_ID_OK = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.:-")
_TRACE_ID_MAX = 128


def mint_trace_id() -> str:
    return uuid.uuid4().hex


def sanitize_trace_id(trace_id: Optional[str]) -> str:
    """A safe trace id: the inbound one when it is well-formed, else
    empty (caller mints). Never raises — a garbage header must degrade
    to a fresh id, not 500 the request."""
    if not isinstance(trace_id, str):
        return ""
    tid = trace_id.strip()
    if not tid or len(tid) > _TRACE_ID_MAX or \
            any(c not in _TRACE_ID_OK for c in tid):
        return ""
    return tid


class TraceBuffer:
    """Bounded ring of request trace records (newest win; churn evicts
    oldest). O(1) span append via a trace-id index; every read returns
    JSON-safe copies so HTTP handlers never alias live mutable state."""

    def __init__(self, maxlen: int = 256) -> None:
        self.maxlen = max(1, int(maxlen))
        self._lock = threading.Lock()
        self._ring: "collections.deque[Dict[str, Any]]" = \
            collections.deque()
        self._index: Dict[str, Dict[str, Any]] = {}
        self._t0 = time.monotonic()

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def start(self, trace_id: str, request_id: str = "",
              span: str = "queued", **attrs: Any) -> str:
        """Open a record for ``trace_id`` with its first span. Returns
        the trace id (convenience for ``start(mint_trace_id(), ...)``
        call sites)."""
        now = self._now()
        rec = {"trace_id": str(trace_id),
               "request_id": str(request_id),
               "uptime_s": now,
               "spans": [dict(attrs, name=span, t=now)]}
        with self._lock:
            if len(self._ring) >= self.maxlen:
                old = self._ring.popleft()
                # only unindex if the slot still points at the evictee
                if self._index.get(old["trace_id"]) is old:
                    del self._index[old["trace_id"]]
            self._ring.append(rec)
            self._index[rec["trace_id"]] = rec
        return rec["trace_id"]

    def add_span(self, trace_id: str, name: str, **attrs: Any) -> None:
        """Append a span to ``trace_id``'s record, creating the record
        if it was evicted (late spans under churn must not be lost —
        a fragment beats nothing when debugging)."""
        with self._lock:
            rec = self._index.get(str(trace_id))
        if rec is None:
            self.start(str(trace_id), span=name, **attrs)
            return
        span = dict(attrs, name=name, t=self._now())
        with self._lock:
            rec["spans"].append(span)

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._index.get(str(trace_id))
            return None if rec is None else _copy(rec)

    def recent(self, n: int = 32) -> List[Dict[str, Any]]:
        """The most recent ``n`` records, newest first (the
        ``/debug/requests`` payload)."""
        n = max(0, int(n))
        with self._lock:
            tail = list(self._ring)[-n:] if n else []
        return [_copy(r) for r in reversed(tail)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def _copy(rec: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(rec)
    out["spans"] = [dict(s) for s in rec["spans"]]
    return out
