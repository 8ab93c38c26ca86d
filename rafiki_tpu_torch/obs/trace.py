"""Request tracing: trace ids and a bounded per-process span ring.

The port's own copy of ``mint_trace_id`` and ``TraceBuffer`` from
``rafiki_tpu/obs/trace.py``. A trace id minted at the predictor rides in
the scatter payload; the worker appends its spans (queued, admitted,
prefill, first_token, decode marks, done / expired / rejected) to its
own ring, keyed by that id. Timestamps are monotonic process uptime
seconds (``uptime_s`` per record, ``t`` per span).
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


def mint_trace_id() -> str:
    return uuid.uuid4().hex


class TraceBuffer:
    """Bounded ring of request trace records (newest win; churn evicts
    oldest). O(1) span append via a trace-id index; every read returns
    copies, never live mutable state."""

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
        """Open a record for ``trace_id`` with its first span; returns the
        trace id."""
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
        """Append a span to ``trace_id``'s record, creating the record if
        it was evicted (a fragment beats nothing when debugging)."""
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


def _copy(rec: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(rec)
    out["spans"] = [dict(s) for s in rec["spans"]]
    return out
