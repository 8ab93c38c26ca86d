"""The JSON-over-HTTP client the port's services speak.

The port's own copy of ``json_request`` and ``HttpStatusError`` from
``rafiki_tpu/utils/http.py`` (stdlib ``urllib``). The JAX module's
server half (``JsonHttpService``) and its SSE client are not ported: the
port talks to services the JAX stack runs, such as the advisor service.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional


class HttpStatusError(RuntimeError):
    """A non-2xx HTTP response, with the status code and the decoded JSON
    payload attached."""

    def __init__(self, method: str, url: str, status: int,
                 payload: Any) -> None:
        detail = payload.get("error", payload) \
            if isinstance(payload, dict) else payload
        super().__init__(f"{method} {url} -> {status}: {detail}")
        self.status = int(status)
        self.payload = payload if isinstance(payload, dict) else {}


def json_request(method: str, url: str, body: Any = None,
                 headers: Optional[Dict[str, str]] = None,
                 timeout: float = 30.0) -> Any:
    """One JSON request; returns the decoded reply (None when empty) and
    raises :class:`HttpStatusError` for a non-2xx status."""
    data = json.dumps(body).encode("utf-8") if body is not None else None
    req = urllib.request.Request(url, data=data, method=method.upper())
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            payload = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            payload = {"error": raw.decode("utf-8", "replace")}
        raise HttpStatusError(method, url, e.code, payload) from None
    return json.loads(raw) if raw else None
