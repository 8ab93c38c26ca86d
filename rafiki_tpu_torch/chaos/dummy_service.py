"""A drainable stub worker for chaos / rolling-restart harness tests.

The port's own copy of ``rafiki_tpu/chaos/dummy_service.py`` (``main``).
``ServicesManager.rolling_restart`` orchestrates drain → exit → respawn
over real child processes. Exercising that orchestration with a real
inference worker means training + loading a model per test — minutes of
setup to test process plumbing. This stub speaks exactly the two
protocols the manager relies on and nothing else:

- it writes its obs port to ``obs_port_file`` (like a real worker's
  sidecar) and serves ``POST /drain``;
- on drain it exits 0 after ``drain_linger_s`` (simulating "finish
  in-flight work, then leave").

Run: ``python -m rafiki_tpu_torch.chaos.dummy_service --config cfg.json`` with
``{"worker_id", "obs_port_file", "drain_linger_s"}``.
"""

from __future__ import annotations

import json
import threading
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    import argparse

    from rafiki_tpu_torch.utils.http import JsonHttpService

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    linger = float(cfg.get("drain_linger_s", 0.0))
    done = threading.Event()

    def _drain(_m, _b, _h):
        # reply first, exit after: the draining worker must stay
        # reachable long enough to acknowledge the drain request
        threading.Timer(max(0.05, linger), done.set).start()
        return 200, {"ok": True, "draining": True}

    http = JsonHttpService("127.0.0.1", int(cfg.get("obs_port", 0)))
    http.route("POST", "/drain", _drain)
    http.route("GET", "/health",
               lambda _m, _b, _h: (200, {"ok": True}))
    _, port = http.start()
    if cfg.get("obs_port_file"):
        with open(cfg["obs_port_file"], "w") as f:
            f.write(str(port))
    print(f"dummy service {cfg.get('worker_id', '?')} on :{port}",
          flush=True)
    done.wait()
    http.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
