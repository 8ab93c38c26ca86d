"""HTTP surfacing for the obs plane: ``/metrics`` and ``/debug/requests``.

The port's own copy of ``rafiki_tpu/obs/http.py``:

- :func:`mount_obs_routes` adds the two routes to a service that already
  listens (the admin app, the predictor service);
- :class:`ObsServer` is the standalone sidecar of the HTTP-less
  processes (the inference and train workers): the worker loop stays a
  queue consumer, scrapes and timeline pulls ride a daemon-threaded
  server on an ephemeral port, which the worker writes to its
  ``obs_port_file``.

One difference from JAX: a worker that exits takes its ``obs_port_file``
with it (:func:`remove_port_file`). The JAX workers leave theirs, so
after a train job has finished the JAX doctor reports every one of its
workers' files as stale drift.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

from rafiki_tpu_torch.obs.metrics import PROM_CONTENT_TYPE, MetricsRegistry
from rafiki_tpu_torch.obs.trace import TraceBuffer
from rafiki_tpu_torch.utils.http import JsonHttpService, RawResponse

#: default /debug/requests page size (override with ?n=K)
DEBUG_REQUESTS_DEFAULT_N = 32


def mount_obs_routes(http: JsonHttpService, registry: MetricsRegistry,
                     traces: Optional[TraceBuffer] = None) -> None:
    """Mount ``GET /metrics`` (Prometheus text) and
    ``GET /debug/requests?n=K`` (JSON trace records, newest first)."""

    def _metrics(_m, _b, _h) -> Tuple[int, Any]:
        return 200, RawResponse(
            registry.render_prometheus().encode("utf-8"),
            PROM_CONTENT_TYPE)

    def _debug_requests(m, _b, _h) -> Tuple[int, Any]:
        try:
            n = int(m.get("n", DEBUG_REQUESTS_DEFAULT_N))
        except (TypeError, ValueError):
            return 400, {"error": "n must be an integer"}
        if n < 0:
            return 400, {"error": "n must be >= 0"}
        recs = traces.recent(n) if traces is not None else []
        return 200, {"requests": recs, "count": len(recs)}

    http.route("GET", "/metrics", _metrics)
    http.route("GET", "/debug/requests", _debug_requests)



class ObsServer:
    """Sidecar observability endpoint for HTTP-less processes.

    Serves ``/metrics``, ``/debug/requests`` and a trivial ``/health``
    on a daemon-threaded server; the owning loop never blocks on it and
    ``stop()`` is idempotent."""

    def __init__(self, registry: MetricsRegistry,
                 traces: Optional[TraceBuffer] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.registry = registry
        self.traces = traces
        # the sidecar counts its own scrapes too (http_requests_total on
        # a worker is the scrape count: a cheap liveness probe)
        self.http = JsonHttpService(host, port, registry=registry)
        mount_obs_routes(self.http, registry, traces)
        self.http.route("GET", "/health",
                        lambda _m, _b, _h: (200, {"ok": True}))
        self._started = False

    def start(self) -> Tuple[str, int]:
        host, port = self.http.start()
        self._started = True
        return host, port

    @property
    def port(self) -> int:
        return self.http.port

    def stop(self) -> None:
        if self._started:
            self.http.stop()
            self._started = False


def remove_port_file(path: Optional[str], port: int) -> None:
    """Delete a sidecar's port file when it still names ``port``: a
    replacement spawned with the same config may have written its own
    port there already."""
    if not path:
        return
    try:
        with open(path) as f:
            if f.read().strip() != str(port):
                return
        os.unlink(path)
    except (OSError, ValueError):
        pass
