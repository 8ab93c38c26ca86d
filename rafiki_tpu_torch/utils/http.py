"""Minimal JSON-over-HTTP service kit (stdlib only).

The port's own copy of ``rafiki_tpu/utils/http.py``: the server half
(``RawResponse``, ``StreamResponse``, ``JsonHttpService``,
``http_error``) and the client half (``HttpStatusError``,
``json_request``, ``STREAM_BUDGET_S``, ``sse_request``). A route table of
``(method, path_pattern) -> handler(match, body_json, headers) -> (status,
json)`` served by a threading ``http.server``; path patterns use
``<name>`` segments, e.g. ``/train_jobs/<id>/stop``. The wire is the JAX
package's, so a port client talks to a JAX server and the reverse.
"""

from __future__ import annotations

import json
import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

Handler = Callable[[Dict[str, str], Any, Dict[str, str]],
                   Tuple[int, Any]]


class RawResponse:
    """Non-JSON handler payload (static HTML/JS for the dashboard)."""

    def __init__(self, data: bytes, content_type: str) -> None:
        self.data = data
        self.content_type = content_type


class StreamResponse:
    """Incremental handler payload: an iterator of already-encoded
    chunks written to the socket as they are produced (server-sent
    events for streaming generation). The connection closes when the
    iterator ends — ``Connection: close`` instead of chunked framing
    keeps the client side a dumb line reader."""

    def __init__(self, chunks: Any,
                 content_type: str = "text/event-stream") -> None:
        self.chunks = chunks  # iterator of bytes
        self.content_type = content_type


def _compile(pattern: str) -> re.Pattern:
    regex = re.sub(r"<([a-zA-Z_][a-zA-Z0-9_]*)>", r"(?P<\1>[^/]+)", pattern)
    return re.compile("^" + regex + "$")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    #: the listen backlog. socketserver's default of 5 reset connections
    #: when 16 closed-loop clients connected to a busy Predictor at once
    request_queue_size = 128


class JsonHttpService:
    """A threading HTTP server over a JSON route table.

    Handlers receive the path-pattern groups MERGED with URL query
    parameters (path segments win on a name clash), the parsed JSON
    body, and the request headers.

    ``registry`` (a duck-typed ``rafiki_tpu_torch.obs.metrics.MetricsRegistry``)
    auto-instruments every surface that passes one: a
    ``http_requests_total`` counter and an ``http_request_seconds``
    handler-latency histogram — the time INSIDE the handler, so a
    long-lived SSE stream does not read as one enormous request.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Any = None) -> None:
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        self._host = host
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._req_counter = None
        self._req_hist = None
        if registry is not None:
            self._req_counter = registry.counter(
                "http_requests_total", "HTTP requests served")
            self._req_hist = registry.histogram(
                "http_request_seconds", "handler latency (seconds)")

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method.upper(), _compile(pattern), handler))

    # ---- lifecycle ----
    def start(self) -> Tuple[str, int]:
        routes = self._routes
        req_counter, req_hist = self._req_counter, self._req_hist

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: Any) -> None:
                pass  # quiet; service logs go through the app layer

            def _dispatch(self, method: str) -> None:
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length else b""
                    body = json.loads(raw) if raw else None
                except Exception:
                    self._reply(400, {"error": "malformed JSON body"})
                    return
                path, _, query = self.path.partition("?")
                for m, pat, handler in routes:
                    if m != method:
                        continue
                    match = pat.match(path)
                    if match:
                        params = match.groupdict()
                        if query:
                            from urllib.parse import parse_qsl

                            for k, v in parse_qsl(query):
                                # path segments win: a ?id=... must not
                                # shadow a /things/<id> capture
                                params.setdefault(k, v)
                        import time as _time

                        t0 = _time.monotonic()
                        try:
                            status, payload = handler(
                                params, body,
                                dict(self.headers.items()))
                        except _HttpError as e:
                            status, payload = e.status, {"error": e.message}
                        except Exception:
                            status = 500
                            payload = {"error": "internal error",
                                       "detail": traceback.format_exc(
                                           limit=5)}
                        if req_counter is not None:
                            req_counter.inc()
                            req_hist.observe(_time.monotonic() - t0)
                        self._reply(status, payload)
                        return
                self._reply(404, {"error": f"no route {method} {path}"})

            def _reply(self, status: int, payload: Any) -> None:
                if isinstance(payload, StreamResponse):
                    self.send_response(status)
                    self.send_header("Content-Type", payload.content_type)
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.close_connection = True
                    try:
                        for chunk in payload.chunks:
                            self.wfile.write(chunk)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away mid-stream
                    return
                if isinstance(payload, RawResponse):  # e.g. dashboard HTML
                    data, ctype = payload.data, payload.content_type
                else:
                    data = json.dumps(payload).encode("utf-8")
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                self._dispatch("GET")

            def do_POST(self) -> None:
                self._dispatch("POST")

            def do_PUT(self) -> None:
                self._dispatch("PUT")

            def do_DELETE(self) -> None:
                self._dispatch("DELETE")

        self._server = _Server((self._host, self._port), _Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._host, self._port

    def serve_forever(self) -> None:
        """Blocking variant for service main()s."""
        if self._server is None:
            self.start()
        assert self._thread is not None
        self._thread.join()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @property
    def port(self) -> int:
        return self._port


class _HttpError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


def http_error(status: int, message: str) -> _HttpError:
    return _HttpError(status, message)


# ---- client side -----------------------------------------------------------

class HttpStatusError(RuntimeError):
    """A non-2xx HTTP response, with the status code and decoded JSON
    payload attached. Subclasses RuntimeError so every existing caller
    that catches the old convention keeps working; new callers (the
    client SDK's structured-503 retry) can inspect ``status`` and
    ``payload`` (e.g. ``payload.get("retry_after_s")``) instead of
    parsing the message string."""

    def __init__(self, method: str, url: str, status: int,
                 payload: Any) -> None:
        detail = payload.get("error", payload) \
            if isinstance(payload, dict) else payload
        super().__init__(f"{method} {url} -> {status}: {detail}")
        self.status = int(status)
        self.payload = payload if isinstance(payload, dict) else {}

    @property
    def shed(self) -> bool:
        """True for an SLO *shed* 503 (overload backpressure on a
        best-effort class: honor ``retry_after_s`` and come back) as
        opposed to a breaker fast-fail 503 (the fleet is down/dead —
        retrying sooner than its ``retry_after_s`` probes the same
        outage). Both carry ``retry_after_s``; only sheds carry
        ``shed: true``."""
        return bool(self.payload.get("shed"))

    @property
    def data_plane_down(self) -> bool:
        """True for the data-plane-down 503: the predictor could not
        reach the kvd (param blobs + queues). Shed-like semantics —
        the supervisor respawns the kvd with WAL replay in seconds, so
        honoring ``retry_after_s`` and retrying once is expected to
        succeed."""
        return bool(self.payload.get("data_plane_down"))

    @property
    def retry_after_s(self) -> Optional[float]:
        """The server's structured retry hint, when present and
        numeric."""
        v = self.payload.get("retry_after_s")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        return None


def _open_request(method: str, url: str, body: Any,
                  headers: Optional[Dict[str, str]], timeout: float,
                  accept: Optional[str] = None):
    """Open a JSON-bodied request, translating HTTPError into
    :class:`HttpStatusError` (a RuntimeError, the convention shared by
    every client in this repo). Returns the live response object
    (caller closes)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode("utf-8") if body is not None else None
    req = urllib.request.Request(url, data=data, method=method.upper())
    req.add_header("Content-Type", "application/json")
    if accept:
        req.add_header("Accept", accept)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            payload = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            payload = {"error": raw.decode("utf-8", "replace")}
        raise HttpStatusError(method, url, e.code, payload) from None


def json_request(method: str, url: str, body: Any = None,
                 headers: Optional[Dict[str, str]] = None,
                 timeout: float = 30.0) -> Any:
    """Tiny JSON HTTP client (urllib; no external deps in the hot path)."""
    with _open_request(method, url, body, headers, timeout) as resp:
        raw = resp.read()
    return json.loads(raw) if raw else None


#: default whole-stream budget for SSE generation streams. Lives here —
#: next to the transport both ends use — so the client SDK can size its
#: per-event socket timeout without importing the server-side predictor
#: module (Predictor.STREAM_TIMEOUT aliases this).
STREAM_BUDGET_S = 300.0


def sse_request(method: str, url: str, body: Any = None,
                headers: Optional[Dict[str, str]] = None,
                timeout: float = 30.0,
                read_timeout: Optional[float] = None):
    """Yield decoded JSON payloads from a server-sent-events endpoint.

    Matches the minimal SSE dialect :class:`StreamResponse` producers
    emit: ``data: <json>\\n\\n`` per event, connection close = end of
    stream. ``timeout`` bounds connection establishment (and each event
    wait unless ``read_timeout`` is given); ``read_timeout`` bounds the
    wait for EACH event once the stream is up — a generation may
    legitimately idle near the server's whole-stream budget, but a down
    host must still fail fast at connect time."""
    resp = _open_request(method, url, body, headers, timeout,
                         accept="text/event-stream")
    try:
        if read_timeout is not None and read_timeout != timeout:
            # the urlopen timeout rode onto the connected socket; now
            # that the response is live, re-bound it for event reads.
            # CPython: HTTPResponse.fp is a buffered reader over a
            # SocketIO holding the raw socket — reach it defensively
            # (the else-branch below keeps the long bound on any
            # non-CPython/refactored layout)
            sock = getattr(getattr(resp, "fp", None), "raw", None)
            sock = getattr(sock, "_sock", None)
            if hasattr(sock, "settimeout"):
                sock.settimeout(read_timeout)
            else:
                # introspection failed (non-CPython, internals
                # refactor): reads would stay bounded by the SHORT
                # connect timeout and a legitimately idle generation
                # would die mid-stream. Fall back to the
                # pre-introspection behavior — re-open the request
                # with the long bound as the socket timeout for the
                # whole stream. No event has been consumed yet, and a
                # duplicated request beats a stream that cannot run
                # longer than the connect bound.
                import logging

                logging.getLogger(__name__).warning(
                    "sse_request could not re-bound the socket for "
                    "event reads (HTTPResponse internals changed?); "
                    "re-opening the stream with the %.0fs bound for "
                    "the whole request", max(timeout, read_timeout))
                resp.close()
                resp = _open_request(method, url, body, headers,
                                     max(timeout, read_timeout),
                                     accept="text/event-stream")
        for line in resp:  # socket timeout applies per readline
            line = line.strip()
            if line.startswith(b"data:"):
                yield json.loads(line[5:].strip().decode("utf-8"))
    finally:
        resp.close()
