"""HTTP surfacing for the obs plane: ``/metrics`` and ``/debug/requests``.

The port's own copy of ``mount_obs_routes`` from
``rafiki_tpu/obs/http.py``: it adds the two routes to a service that
already listens (the admin app, the predictor service). The standalone
sidecar (``ObsServer``) that HTTP-less workers would run is not ported:
the port's workers refuse ``obs_port`` / ``obs_port_file`` by name.
"""

from __future__ import annotations

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

