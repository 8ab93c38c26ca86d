"""The port's JSON HTTP kit against the JAX package's.

One route table is served by the port's ``JsonHttpService`` and by the
JAX one; the same requests get the same statuses and bodies (routing
with path captures and query merging, ``http_error``, handler crashes,
malformed bodies, unknown routes), and the same server-sent-event
streams. The clients cross over: the JAX ``json_request`` /
``sse_request`` talk to the port server and the port's to the JAX
server. ``HttpStatusError``'s structured 503 reading, the Prometheus
text of ``/metrics`` and ``/debug/requests`` (``mount_obs_routes``)
are held to the JAX package's as well.
"""

import json
import time

import pytest

from rafiki_tpu.obs import MetricsRegistry as JRegistry
from rafiki_tpu.obs import TraceBuffer as JTraces
from rafiki_tpu.obs import mount_obs_routes as jmount
from rafiki_tpu.utils import http as jhttp
from rafiki_tpu_torch.obs.http import mount_obs_routes as pmount
from rafiki_tpu_torch.obs.metrics import MetricsRegistry as PRegistry
from rafiki_tpu_torch.obs.trace import TraceBuffer as PTraces
from rafiki_tpu_torch.obs.trace import sanitize_trace_id
from rafiki_tpu_torch.utils import http as phttp

KITS = {"port": phttp, "jax": jhttp}


def _routes(kit):
    svc = kit.JsonHttpService()

    def echo(m, body, headers):
        return 200, {"match": m, "body": body,
                     "trace": {k.lower(): v for k, v in headers.items()
                               }.get("x-rafiki-trace-id")}

    def teapot(_m, _b, _h):
        raise kit.http_error(418, "short and stout")

    def boom(_m, _b, _h):
        raise ValueError("handler bug")

    def created(_m, body, _h):
        return 201, {"n": len(body or [])}

    def raw(_m, _b, _h):
        return 200, kit.RawResponse(b"<p>hi</p>", "text/html")

    def stream(m, _b, _h):
        n = int(m.get("n", 3))

        def chunks():
            for i in range(n):
                yield b"data: " + json.dumps({"i": i}).encode() + b"\n\n"
        return 200, kit.StreamResponse(chunks())

    svc.route("GET", "/things/<id>", echo)
    svc.route("POST", "/things/<id>/act", echo)
    svc.route("PUT", "/things", created)
    svc.route("DELETE", "/things/<id>", echo)
    svc.route("GET", "/teapot", teapot)
    svc.route("GET", "/boom", boom)
    svc.route("GET", "/raw", raw)
    svc.route("POST", "/stream", stream)
    return svc


@pytest.fixture(scope="module")
def servers():
    out = {}
    for name, kit in KITS.items():
        svc = _routes(kit)
        host, port = svc.start()
        out[name] = (svc, f"http://{host}:{port}")
    yield {k: url for k, (_s, url) in out.items()}
    for svc, _ in out.values():
        svc.stop()


def _call(kit, method, url, body=None, headers=None):
    """(status, payload) through ``kit``'s client."""
    try:
        return 200, kit.json_request(method, url, body, headers=headers,
                                     timeout=30.0)
    except kit.HttpStatusError as e:
        return e.status, e.payload


REQUESTS = [
    ("GET", "/things/7", None, None),
    ("GET", "/things/7?id=shadow&x=1", None, None),
    ("POST", "/things/a-b/act?y=2", {"k": [1, 2.5, None]}, None),
    ("PUT", "/things", [1, 2, 3], None),
    ("DELETE", "/things/9", None, {"X-Rafiki-Trace-Id": "t-1"}),
    ("GET", "/teapot", None, None),
    ("GET", "/nowhere", None, None),
    ("POST", "/things/7", {"a": 1}, None),
]


@pytest.mark.parametrize("client", sorted(KITS))
@pytest.mark.parametrize("req", REQUESTS,
                         ids=[f"{m} {p}" for m, p, _b, _h in REQUESTS])
def test_routes_answer_as_the_jax_service(servers, client, req):
    method, path, body, headers = req
    kit = KITS[client]
    want = _call(jhttp, method, servers["jax"] + path, body, headers)
    got = _call(kit, method, servers["port"] + path, body, headers)
    assert got == want
    if path.startswith("/things/7?"):
        # path segments win over a same-named query parameter
        assert got[1]["match"] == {"id": "7", "x": "1"}
    if path == "/nowhere":
        assert got[0] == 404


def test_handler_crash_and_malformed_body(servers):
    import urllib.error
    import urllib.request

    for base in (servers["port"], servers["jax"]):
        status, payload = _call(phttp, "GET", base + "/boom")
        assert status == 500 and payload["error"] == "internal error"
        assert "handler bug" in payload["detail"]
        req = urllib.request.Request(base + "/things/1/act", data=b"{oops",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        assert json.loads(ei.value.read()) == {"error":
                                               "malformed JSON body"}


def test_raw_response(servers):
    import urllib.request

    for base in (servers["port"], servers["jax"]):
        with urllib.request.urlopen(base + "/raw", timeout=30) as r:
            assert r.read() == b"<p>hi</p>"
            assert r.headers["Content-Type"] == "text/html"


@pytest.mark.parametrize("server", sorted(KITS))
@pytest.mark.parametrize("client", sorted(KITS))
def test_sse_streams_cross_over(servers, server, client):
    events = list(KITS[client].sse_request(
        "POST", servers[server] + "/stream?n=4", {}, timeout=30.0,
        read_timeout=60.0))
    assert events == [{"i": i} for i in range(4)]


def test_http_status_error_reads_structured_503s():
    cases = [
        {"error": "shed: batch backlog", "shed": True,
         "retry_after_s": 1.5},
        {"error": "down", "data_plane_down": True, "retry_after_s": 2},
        {"error": "fleet", "retry_after_s": True},
        "plain text",
    ]
    for payload in cases:
        p = phttp.HttpStatusError("POST", "http://x/predict", 503, payload)
        j = jhttp.HttpStatusError("POST", "http://x/predict", 503, payload)
        assert (str(p), p.status, p.payload, p.shed, p.data_plane_down,
                p.retry_after_s) == (str(j), j.status, j.payload, j.shed,
                                     j.data_plane_down, j.retry_after_s)
    assert phttp.STREAM_BUDGET_S == jhttp.STREAM_BUDGET_S


def _fill(registry, traces):
    c = registry.counter("requests_served", "answered")
    c.inc(3)
    registry.gauge("depth", "queue depth", fn=lambda: 7)
    g = registry.gauge("stage", labels={"job": "j1"})
    g.set(2)
    h = registry.histogram("request_seconds", "latency")
    for v in (0.002, 0.03, 0.7, 4.0, 200.0):
        h.observe(v)
    registry.register_stats(lambda: {"x_total": 4, "y": 1.5,
                                     "skip": "text"}, prefix="kvd_")
    traces.start("tid-1", request_id="q1", span="received", n=2)
    traces.add_span("tid-1", "done", latency_s=0.5)


def test_metrics_and_debug_routes_equal_the_jax_ones():
    import urllib.request

    bodies = {}
    for name, (kit, reg, tr, mount) in {
            "port": (phttp, PRegistry(), PTraces(8), pmount),
            "jax": (jhttp, JRegistry(), JTraces(8), jmount)}.items():
        _fill(reg, tr)
        svc = kit.JsonHttpService(registry=reg)
        mount(svc, reg, tr)
        host, port = svc.start()
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=30) as r:
                text = r.read().decode()
            recs = kit.json_request(
                "GET", f"http://{host}:{port}/debug/requests?n=5")
            bad = _call(kit, "GET",
                        f"http://{host}:{port}/debug/requests?n=-1")
        finally:
            svc.stop()
        # the scrapes themselves are counted, after this one rendered
        bodies[name] = (text, [[s["name"] for s in r["spans"]]
                               for r in recs["requests"]], bad)
        assert reg.snapshot()["requests_served"] == 3
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"][1] == [["received", "done"]]


@pytest.mark.parametrize("tid", ["abc-123", "a" * 129, "bad id", None, 7,
                                 " t:1.2_x "])
def test_sanitize_trace_id_equals_jax(tid):
    from rafiki_tpu.obs import sanitize_trace_id as jsan

    assert sanitize_trace_id(tid) == jsan(tid)


def test_a_burst_of_connections_is_queued_not_reset():
    """The listen backlog holds a burst of clients connecting at once
    (socketserver's default of 5 reset connections when 16 closed-loop
    clients met a busy Predictor); 64 concurrent requests to a slow
    handler are all answered."""
    import threading

    from rafiki_tpu_torch.utils.http import JsonHttpService, json_request

    svc = JsonHttpService()

    def slow(_m, _b, _h):
        time.sleep(0.2)
        return 200, {"ok": True}

    svc.route("POST", "/slow", slow)
    host, port = svc.start()
    errors = []

    def call():
        try:
            json_request("POST", f"http://{host}:{port}/slow", {},
                         timeout=60)
        except Exception as e:  # counted: the assertion below
            errors.append(repr(e))

    try:
        assert svc._server.request_queue_size >= 64
        threads = [threading.Thread(target=call) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        svc.stop()
    assert not errors, errors[:3]
