"""The workers' obs sidecar in the port against the JAX package's.

- ``ObsServer`` serves the JAX sidecar's routes with the same statuses
  and bodies over the same registry and trace content: ``/metrics``
  (Prometheus text), ``/debug/requests?n=K``, ``/health``, a bad ``n``
  and an unknown route.
- The inference worker's sidecar carries ``POST /drain`` (after
  ``tests/test_chaos.py:462``): a request in flight when the drain comes
  is answered, one that arrives after it gets the structured
  ``draining`` rejection, the serve loop exits, and the published stats
  carry ``obs_port``. As a process (``main``), the worker writes its
  ``obs_port_file``, drains through it and exits 0, taking the file
  with it.
- The train worker's sidecar serves its trial timelines and counters.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from rafiki_tpu.obs import MetricsRegistry as JRegistry
from rafiki_tpu.obs import ObsServer as JObsServer
from rafiki_tpu.obs import TraceBuffer as JTraces
from rafiki_tpu.serving.queues import InProcQueueHub as JHub
from rafiki_tpu.serving.queues import pack_message as jpack
from rafiki_tpu.serving.queues import unpack_message as junpack
from rafiki_tpu.utils import http as jhttp
from rafiki_tpu_torch.obs.http import ObsServer, remove_port_file
from rafiki_tpu_torch.obs.metrics import MetricsRegistry
from rafiki_tpu_torch.obs.trace import TraceBuffer
from rafiki_tpu_torch.utils import http as phttp
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_torch_http import _call, _fill
from test_torch_worker import _lm_worker, _port_store, lm_blob  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _scrape(host, port):
    with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                timeout=30) as r:
        return r.headers.get("Content-Type"), r.read().decode()


def test_obs_server_serves_the_jax_sidecars_routes():
    seen = {}
    for name, (kit, server, reg, tr) in {
            "port": (phttp, ObsServer, MetricsRegistry(), TraceBuffer(8)),
            "jax": (jhttp, JObsServer, JRegistry(), JTraces(8))}.items():
        tr._now = lambda: 1.25  # the spans' process-uptime stamps
        _fill(reg, tr)
        obs = server(reg, tr)
        host, port = obs.start()
        assert obs.port == port
        base = f"http://{host}:{port}"
        try:
            # /metrics first: later requests add their own latencies
            seen[name] = [
                _scrape(host, port),
                _call(kit, "GET", f"{base}/debug/requests?n=5"),
                _call(kit, "GET", f"{base}/debug/requests?n=-1"),
                _call(kit, "GET", f"{base}/debug/requests?n=x"),
                _call(kit, "GET", f"{base}/health"),
                _call(kit, "GET", f"{base}/drain")[0],
            ]
        finally:
            obs.stop()
            obs.stop()  # idempotent
    assert seen["port"] == seen["jax"]
    ctype, text = seen["port"][0]
    assert ctype.startswith("text/plain") and "requests_served 3" in text
    assert seen["port"][1][1]["count"] == 1
    assert seen["port"][4] == (200, {"ok": True})
    assert seen["port"][5] == 404


def test_inference_worker_drains_through_its_sidecar(lm_blob):  # noqa: F811
    """``POST /drain`` while a request is in flight: it is answered in
    full, a request queued after the drain gets the ``draining``
    rejection, and the loop exits."""
    hub = JHub()
    w = _lm_worker(InferenceWorker, _port_store(lm_blob), "paged8",
                   steps_per_sync=1)
    w.hub = hub
    host, port = w.serve_obs()
    step = w.engine.step
    drained = []

    def step_then_drain():
        n = step()
        if not drained:
            drained.append(phttp.json_request(
                "POST", f"http://{host}:{port}/drain", {}, timeout=10.0))
            hub.push_query("w0", jpack({"id": "b", "queries": ["tok3"]}))
        return n

    w.engine.step = step_then_drain
    hub.push_query("w0", jpack({"id": "a", "queries": ["tok1 tok2"]}))
    th = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.05})
    th.start()
    try:
        th.join(timeout=60)
        assert not th.is_alive()  # the loop exits once drained
        assert drained == [{"ok": True, "draining": True}]
        a = junpack(hub.pop_prediction("a", 1.0))
        b = junpack(hub.pop_prediction("b", 1.0))
        assert len(a["predictions"]) == 1 and not a.get("error")
        assert len(a["predictions"][0].split(" ")) == 6
        assert b["draining"] and b["error"] == "worker draining"
        stats = hub.get_worker_stats("w0")
        assert stats["draining"] is True and stats["drain_rejected"] == 1
        assert stats["obs_port"] == port
        # the sidecar scrapes the worker's own registry
        _ctype, text = _scrape(host, port)
        assert "drain_rejected 1" in text
    finally:
        w.stop()
        w.stop_obs()


TOY = '''
import numpy as np


class SidecarToy:
    @staticmethod
    def get_knob_config():
        return {}

    def __init__(self, device=None, **knobs):
        self._w = 0.0

    def predict(self, queries):
        return [[self._w, float(np.sum(q))] for q in queries]

    def load_parameters(self, params):
        self._w = float(params["w"])
'''


def test_inference_worker_main_drains_and_exits_zero(tmp_path):
    """The worker as a process over the port's kvd: it writes its
    ``obs_port_file``, serves a request, drains through the sidecar,
    exits 0 and deletes the file."""
    import numpy as np

    from rafiki_tpu_torch.native.client import KVServer
    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.serving.queues import KVQueueHub
    from rafiki_tpu_torch.store.param_store import ParamStore

    (tmp_path / "toy.py").write_text(TOY)
    with KVServer() as kv:
        store = ParamStore.from_uri(f"kv://{kv.host}:{kv.port}")
        store.save("t0", {"w": np.asarray(2.5)})
        port_file = tmp_path / "w0.obs_port"
        cfg = {"model_file": str(tmp_path / "toy.py"),
               "model_class": "SidecarToy", "trial_id": "t0", "knobs": {},
               "param_store_uri": f"kv://{kv.host}:{kv.port}",
               "kv_host": kv.host, "kv_port": kv.port, "worker_id": "w0",
               "device": "cpu", "obs_port_file": str(port_file)}
        (tmp_path / "cfg.json").write_text(json.dumps(cfg))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT))
        proc = subprocess.Popen(
            [sys.executable, "-m", "rafiki_tpu_torch.worker.inference",
             "--config", str(tmp_path / "cfg.json")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 120
            while not (port_file.exists() and port_file.read_text()):
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline
                time.sleep(0.05)
            port = int(port_file.read_text())
            base = f"http://127.0.0.1:{port}"
            assert phttp.json_request("GET", f"{base}/health") == \
                {"ok": True}
            hub = KVQueueHub(kv.host, kv.port)
            preds, _info = Predictor(hub, ["w0"], gather_timeout=60.0) \
                .predict([[1.0, 2.0]], timeout=60.0)
            assert preds == [[2.5, 3.0]]
            assert phttp.json_request("POST", f"{base}/drain", {}) == \
                {"ok": True, "draining": True}
            assert proc.wait(timeout=60) == 0
            out = proc.stdout.read()
            assert "inference worker w0 drained cleanly" in out
            assert f"obs on 127.0.0.1:{port}" in out
            assert not port_file.exists()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_remove_port_file_keeps_a_successors_file(tmp_path):
    f = tmp_path / "w.obs_port"
    f.write_text("4242")
    remove_port_file(str(f), 4243)  # a replacement wrote its own port
    assert f.read_text() == "4242"
    remove_port_file(str(f), 4242)
    assert not f.exists()
    remove_port_file(str(f), 4242)  # gone already: no error
    remove_port_file(None, 1)


def test_train_worker_sidecar_serves_its_trial_timelines():
    from rafiki_tpu_torch.worker.train import TrainWorker

    w = TrainWorker.__new__(TrainWorker)
    # only what the sidecar reads: the registry and the trace ring
    w.metrics, w.traces = MetricsRegistry(), TraceBuffer(8)
    w._obs_server = None
    w.metrics.counter("trials_completed", "done").inc(2)
    w.traces.start("tid", request_id="trial-1", span="trial_start")
    host, port = w.serve_obs()
    try:
        _ctype, text = _scrape(host, port)
        assert "trials_completed 2" in text
        recs = phttp.json_request(
            "GET", f"http://{host}:{port}/debug/requests")["requests"]
        assert [r["request_id"] for r in recs] == ["trial-1"]
        with pytest.raises(phttp.HttpStatusError) as ei:
            phttp.json_request("POST", f"http://{host}:{port}/drain", {})
        assert ei.value.status == 404  # no drain on a train worker
    finally:
        w.stop_obs()
        w.stop_obs()
