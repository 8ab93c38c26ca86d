"""The advisor as an HTTP service, and its client.

The port's own copy of ``rafiki_tpu/advisor/service.py``:
``AdvisorService`` (a ``BaseAdvisor`` behind the propose / feedback /
trial_errored / status routes and their batched forms, on the port's
``JsonHttpService``), ``AdvisorClient`` (the same verbs over HTTP) and
``main``, the process the port's services manager spawns for each
sub-train-job. The JSON is the JAX package's, so a port train worker
drives a JAX advisor service and the reverse. Host-side: no ``torch``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple

from rafiki_tpu_torch.advisor.base import (BaseAdvisor, Proposal,
                                           TrialResult, make_advisor)
from rafiki_tpu_torch.model.knob import knob_config_from_json
from rafiki_tpu_torch.utils.http import JsonHttpService, json_request


class AdvisorService:
    """Wraps a BaseAdvisor behind the propose/feedback wire protocol."""

    def __init__(self, advisor: BaseAdvisor, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.advisor = advisor
        self.http = JsonHttpService(host, port)
        self.http.route("POST", "/proposal", self._propose)
        self.http.route("POST", "/proposal_batch", self._propose_batch)
        self.http.route("POST", "/feedback", self._feedback)
        self.http.route("POST", "/feedback_batch", self._feedback_batch)
        self.http.route("POST", "/trial_errored", self._trial_errored)
        self.http.route("GET", "/status", self._status)

    def start(self) -> Tuple[str, int]:
        return self.http.start()

    def stop(self) -> None:
        self.http.stop()

    # ---- routes ----
    def _propose(self, _m: Dict[str, str], _body: Any,
                 _h: Dict[str, str]) -> Tuple[int, Any]:
        return 200, self.advisor.propose().to_json()

    def _propose_batch(self, _m: Dict[str, str], body: Any,
                       _h: Dict[str, str]) -> Tuple[int, Any]:
        # one advisor-side lock acquisition: the batch is atomic even
        # with multiple gang workers hitting the same service
        batch = self.advisor.propose_batch(int(body.get("k", 1)))
        return 200, {"proposals": [p.to_json() for p in batch]}

    def _feedback(self, _m: Dict[str, str], body: Any,
                  _h: Dict[str, str]) -> Tuple[int, Any]:
        self.advisor.feedback(TrialResult.from_json(body))
        return 200, {"ok": True}

    def _feedback_batch(self, _m: Dict[str, str], body: Any,
                        _h: Dict[str, str]) -> Tuple[int, Any]:
        self.advisor.feedback_batch(
            [TrialResult.from_json(r) for r in body.get("results", [])])
        return 200, {"ok": True}

    def _trial_errored(self, _m: Dict[str, str], body: Any,
                       _h: Dict[str, str]) -> Tuple[int, Any]:
        self.advisor.trial_errored(int(body["trial_no"]))
        return 200, {"ok": True}

    def _status(self, _m: Dict[str, str], _body: Any,
                _h: Dict[str, str]) -> Tuple[int, Any]:
        best = self.advisor.best
        return 200, {
            "finished": self.advisor.finished,
            "n_results": len(self.advisor.results),
            "best": best.to_json() if best else None,
        }


class AdvisorClient:
    """HTTP client mirroring the ``BaseAdvisor`` surface for remote
    workers."""

    def __init__(self, base_url: str, timeout: float = 60.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def propose(self) -> Proposal:
        return Proposal.from_json(json_request(
            "POST", f"{self.base_url}/proposal", {}, timeout=self.timeout))

    def propose_batch(self, k: int) -> list:
        body = json_request("POST", f"{self.base_url}/proposal_batch",
                            {"k": k}, timeout=self.timeout)
        return [Proposal.from_json(p) for p in body.get("proposals", [])]

    def feedback(self, result: TrialResult) -> None:
        json_request("POST", f"{self.base_url}/feedback", result.to_json(),
                     timeout=self.timeout)

    def feedback_batch(self, results: list) -> None:
        json_request("POST", f"{self.base_url}/feedback_batch",
                     {"results": [r.to_json() for r in results]},
                     timeout=self.timeout)

    def trial_errored(self, trial_no: int) -> None:
        json_request("POST", f"{self.base_url}/trial_errored",
                     {"trial_no": trial_no}, timeout=self.timeout)

    def status(self) -> Dict[str, Any]:
        return json_request("GET", f"{self.base_url}/status",
                            timeout=self.timeout)


def main(argv: Optional[list] = None) -> int:
    """Service entrypoint: ``python -m rafiki_tpu_torch.advisor.service``.

    The port's ServicesManager spawns this with the knob config and budget as a
    JSON file path (env-var-sized configs don't survive exec portably).
    """
    import json as _json

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="path to JSON {knob_config, advisor_type, "
                             "total_trials, time_budget_s, seed}")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default="",
                        help="write the bound port here (service discovery)")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        cfg = _json.load(f)
    port_file = args.port_file or cfg.get("port_file", "")
    advisor = make_advisor(
        knob_config_from_json(cfg["knob_config"]),
        cfg.get("advisor_type", "auto"),
        total_trials=cfg.get("total_trials"),
        time_budget_s=cfg.get("time_budget_s"),
        seed=cfg.get("seed", 0))
    service = AdvisorService(advisor, args.host, args.port)
    host, port = service.start()
    if port_file:
        with open(port_file, "w") as f:
            f.write(str(port))
    print(f"advisor service on {host}:{port}", flush=True)
    service.http.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
