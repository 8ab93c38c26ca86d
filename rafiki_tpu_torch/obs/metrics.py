"""Serving counters for the port.

The port's own copy of ``StatsMap`` from ``rafiki_tpu/obs/metrics.py``
(the port imports nothing of the JAX package, even its JAX-free modules).
The registry, histograms and Prometheus rendering wait for the slice that
ports the worker.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, Mapping, MutableMapping, Optional


class StatsMap(MutableMapping):
    """A locked dict of numeric counters/gauges with a race-free
    snapshot. Reads keep dict ergonomics (``stats["steps"]``,
    ``dict(stats)``); writes go through :meth:`inc`/:meth:`set`/
    :meth:`max_set`. Iteration and :meth:`snapshot` copy under the lock,
    so publishing a snapshot never races a concurrent mutation."""

    def __init__(self, initial: Optional[Mapping[str, Any]] = None
                 ) -> None:
        self._lock = threading.Lock()
        self._d: Dict[str, Any] = dict(initial or {})

    def inc(self, key: str, n: float = 1) -> float:
        with self._lock:
            v = self._d.get(key, 0) + n
            self._d[key] = v
            return v

    def set(self, key: str, v: Any) -> None:
        with self._lock:
            self._d[key] = v

    def max_set(self, key: str, v: Any) -> None:
        """Keep the running maximum (high-water marks)."""
        with self._lock:
            self._d[key] = max(self._d.get(key, v), v)

    def reset(self, keep: Optional[Mapping[str, Any]] = None) -> None:
        """Zero every key in place (the key set survives), then overlay
        ``keep`` (capacity gauges that describe configuration, not
        traffic)."""
        with self._lock:
            for k in self._d:
                self._d[k] = 0
            if keep:
                self._d.update(keep)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._d)

    def __getitem__(self, key: str) -> Any:
        with self._lock:
            return self._d[key]

    def __setitem__(self, key: str, v: Any) -> None:
        self.set(key, v)

    def __delitem__(self, key: str) -> None:
        with self._lock:
            del self._d[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __repr__(self) -> str:
        return f"StatsMap({self.snapshot()!r})"
