"""The advisor service's client.

The port's own copy of ``AdvisorClient`` from
``rafiki_tpu/advisor/service.py``: the propose / feedback /
trial_errored / status verbs (and their batched forms) over HTTP, with
the JAX package's JSON. The advisor service itself keeps running in the
JAX stack (``python -m rafiki_tpu.advisor.service``); a port train
worker drives it through this client.
"""

from __future__ import annotations

from typing import Any, Dict

from rafiki_tpu_torch.advisor.base import Proposal, TrialResult
from rafiki_tpu_torch.utils.http import json_request


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
