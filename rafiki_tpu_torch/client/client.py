"""Client SDK: the user-facing mirror of the Admin REST API.

The port's own copy of ``rafiki_tpu/client/client.py`` (``Client``,
``StreamInterrupted``): ``login``, ``create_model`` (a template class
shipped as its module's source), ``create_dataset``,
``create_train_job``, ``wait_until_train_job_finished``,
``get_best_trials_of_train_job``, ``create_inference_job``, and
``predict`` / ``predict_stream`` against the deployed predictor, with
the structured-503 retries. The wire is the JAX package's, so the port
client drives a JAX admin and the reverse.
"""

from __future__ import annotations

import base64
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from rafiki_tpu_torch.utils.http import HttpStatusError, json_request

#: cap on how long predict() sleeps honoring a 503's retry_after_s —
#: a server bug must not park the caller for an hour
MAX_RETRY_AFTER_S = 30.0


@dataclass
class StreamInterrupted:
    """Typed terminal event for a stream that ended with a *resumable*
    error: the predictor lost every healthy worker mid-stream and hands
    back the query id plus the text delivered so far. Pass ``partial``
    back as ``resume=`` (or let ``predict_stream(auto_resume=...)`` do
    it) to continue the stream without re-paying the delivered tokens.

    Duck-dict compatible (``ev.get("done")``, ``ev["error"]``) so event
    loops written against plain dict events keep working."""

    error: str
    partial: List[Optional[str]]
    qid: str = ""
    trace_id: str = ""
    retry_after_s: float = 0.0
    raw: Dict[str, Any] = field(default_factory=dict)
    done: bool = True
    resumable: bool = True

    def get(self, key: str, default: Any = None) -> Any:
        return self.raw.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self.raw[key]

    def __contains__(self, key: str) -> bool:
        return key in self.raw


class Client:
    def __init__(self, admin_url: str = "http://127.0.0.1:3000",
                 timeout: float = 120.0) -> None:
        self.admin_url = admin_url.rstrip("/")
        self.timeout = timeout
        self._token: Optional[str] = None

    # ---- plumbing ----
    def _call(self, method: str, path: str,
              body: Any = None) -> Any:
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        return json_request(method, f"{self.admin_url}{path}", body,
                            headers=headers, timeout=self.timeout)

    # ---- auth ----
    def login(self, email: str, password: str) -> Dict[str, Any]:
        out = json_request("POST", f"{self.admin_url}/tokens",
                           {"email": email, "password": password},
                           timeout=self.timeout)
        self._token = out["token"]
        return out

    def create_user(self, email: str, password: str,
                    user_type: str = "APP_DEVELOPER") -> Dict[str, Any]:
        return self._call("POST", "/users",
                          {"email": email, "password": password,
                           "user_type": user_type})

    # ---- models ----
    def create_model(self, name: str, task: str, model_class: Any,
                     access_right: str = "PRIVATE") -> Dict[str, Any]:
        """``model_class`` is a model template class (its module source
        is shipped); raw source bytes go through
        :meth:`create_model_raw`."""
        if isinstance(model_class, (bytes, bytearray)):
            raise TypeError("pass (bytes, class_name) via create_model_raw")
        from rafiki_tpu_torch.model.base import serialize_model_class

        model_bytes = serialize_model_class(model_class)
        return self.create_model_raw(name, task, model_class.__name__,
                                     model_bytes, access_right)

    def create_model_raw(self, name: str, task: str, class_name: str,
                         model_bytes: bytes,
                         access_right: str = "PRIVATE") -> Dict[str, Any]:
        return self._call("POST", "/models", {
            "name": name, "task": task, "model_class": class_name,
            "model_bytes": base64.b64encode(model_bytes).decode(),
            "access_right": access_right})

    def get_models(self, task: Optional[str] = None) -> List[Dict]:
        out = self._call("GET", "/models")
        return [m for m in out if task is None or m["task"] == task]

    # ---- datasets ----
    def create_dataset(self, name: str, task: str,
                       uri: str) -> Dict[str, Any]:
        return self._call("POST", "/datasets",
                          {"name": name, "task": task, "uri": uri})

    # ---- train jobs ----
    def create_train_job(self, app: str, task: str, train_dataset_id: str,
                         val_dataset_id: str,
                         budget: Optional[Dict[str, Any]] = None,
                         model_ids: Optional[List[str]] = None,
                         train_args: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        return self._call("POST", "/train_jobs", {
            "app": app, "task": task,
            "train_dataset_id": train_dataset_id,
            "val_dataset_id": val_dataset_id,
            "budget": budget or {"TRIAL_COUNT": 5},
            "model_ids": model_ids, "train_args": train_args})

    def get_train_job(self, job_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/train_jobs/{job_id}")

    def get_train_job_of_app(self, app: str) -> Dict[str, Any]:
        return self._call("GET", f"/train_jobs/app/{app}")

    def stop_train_job(self, job_id: str) -> None:
        self._call("POST", f"/train_jobs/{job_id}/stop")

    def wait_until_train_job_finished(self, job_id: str,
                                      timeout: float = 1800.0,
                                      poll_s: float = 1.0
                                      ) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.get_train_job(job_id)
            if job["status"] in ("STOPPED", "ERRORED"):
                return job
            time.sleep(poll_s)
        raise TimeoutError(f"train job {job_id} still running")

    def get_trials_of_train_job(self, job_id: str) -> List[Dict]:
        return self._call("GET", f"/train_jobs/{job_id}/trials")

    def get_best_trials_of_train_job(self, job_id: str,
                                     max_count: int = 2) -> List[Dict]:
        return self._call("GET", f"/train_jobs/{job_id}/best_trials",
                          {"max_count": max_count})

    def get_trial_logs(self, trial_id: str) -> List[Dict]:
        return self._call("GET", f"/trials/{trial_id}/logs")

    # ---- inference jobs ----
    def create_inference_job(self, train_job_id: str,
                             max_workers: int = 2,
                             budget: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, Any]:
        """``budget={"MULTI_ADAPTER": 1}`` deploys the best-N LM trials
        as ONE stacked-adapter worker (route requests with
        ``sampling={"adapter_id": i}``, i = i-th best trial) instead of
        N full replicas."""
        body: Dict[str, Any] = {"train_job_id": train_job_id,
                                "max_workers": max_workers}
        if budget:
            body["budget"] = budget
        return self._call("POST", "/inference_jobs", body)

    def get_inference_job(self, job_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/inference_jobs/{job_id}")

    def get_inference_job_health(self, job_id: str) -> Dict[str, Any]:
        """The predictor's live ``/health`` (req/s, latency
        percentiles, per-worker engine/drop counters), proxied through
        the admin — the dashboard's data source, usable from scripts."""
        return self._call("GET", f"/inference_jobs/{job_id}/health")

    def stop_inference_job(self, job_id: str) -> None:
        self._call("POST", f"/inference_jobs/{job_id}/stop")

    def rolling_restart_inference_job(self, job_id: str,
                                      drain_timeout: float = 120.0,
                                      expected_workers: int = 2
                                      ) -> Dict[str, Any]:
        """Cycle the job's workers one at a time with graceful drain —
        a deploy/restart that never drops a stream. Returns the
        old→new service id pairs. The endpoint is synchronous and can
        legitimately block ~``expected_workers × drain_timeout`` while
        long streams finish, so the socket timeout is sized to that
        (plus respawn slack) instead of the unary default — a
        premature client timeout would tempt a retry the server
        rejects with 409 (one rolling restart at a time)."""
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        sock = max(self.timeout,
                   max(1, int(expected_workers)) * drain_timeout + 60.0)
        return json_request(
            "POST",
            f"{self.admin_url}/inference_jobs/{job_id}/rolling_restart",
            {"drain_timeout": drain_timeout}, headers=headers,
            timeout=sock)

    def scale_inference_job(self, job_id: str, workers: int,
                            drain_timeout: float = 120.0
                            ) -> Dict[str, Any]:
        """Manually scale the job's worker pool to exactly ``workers``
        replicas: ups spawn from the job's template and join the
        routing pool once warmed, downs drain newest-first (streams
        fail over with forced prefixes — never dropped). Synchronous:
        the socket timeout is sized to the drain/warm budget like
        :meth:`rolling_restart_inference_job`."""
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        sock = max(self.timeout, drain_timeout * 2 + 240.0)
        return json_request(
            "POST",
            f"{self.admin_url}/inference_jobs/{job_id}/scale",
            {"workers": int(workers), "drain_timeout": drain_timeout},
            headers=headers, timeout=sock)

    def get_inference_job_autoscaler(self, job_id: str
                                     ) -> Dict[str, Any]:
        """The job's routing pool + autoscaler state (bounds, pending
        warmups/drains, cooldown)."""
        return self._call("GET",
                          f"/inference_jobs/{job_id}/autoscaler")

    def backup(self, path: str) -> Dict[str, Any]:
        """Snapshot the admin's MetaStore to ``path`` ON THE ADMIN
        HOST (SQLite online backup — consistent under live traffic).
        Run before risky operations; see docs/operations.md "Admin
        death & recovery"."""
        return self._call("POST", "/system/backup", {"path": path})

    # ---- online prediction ----
    def predict(self, predictor_url: str, queries: Sequence[Any],
                timeout: Optional[float] = None,
                sampling: Optional[Dict[str, Any]] = None,
                trace_id: Optional[str] = None,
                slo: Optional[str] = None,
                retry_on_503: bool = True) -> List[Any]:
        """``sampling`` (generation jobs): {temperature, top_k, top_p,
        seed, eos_id, max_new, adapter_id} forwarded to the decode
        loop; omit for greedy defaults. ``max_new`` is clamped by the
        worker's configured cap. ``trace_id`` rides as
        ``X-Rafiki-Trace-Id`` so this request's timeline can be pulled
        from the predictor's and workers' ``/debug/requests``.

        ``slo`` (``interactive``/``batch``/``background``): the
        request's admission class; omit for the job's default.
        Best-effort classes admit after interactive, may be preempted
        (resuming token-exact), and may be SHED under overload.

        Three distinct structured 503s, all retried ONCE after
        honoring the server's ``retry_after_s`` (capped at
        ``MAX_RETRY_AFTER_S``): a *shed* 503
        (``HttpStatusError.shed`` — overload backpressure on a
        best-effort class; retrying after the hint is expected to
        work), a *data-plane-down* 503
        (``HttpStatusError.data_plane_down`` — the kvd is being
        respawned with WAL replay; shed-like, the honored retry is
        expected to land), and a breaker *fast-fail* 503 (fleet
        down/draining; retrying probes the outage). When the retry
        also fails the typed
        :class:`~rafiki_tpu_torch.utils.http.HttpStatusError` surfaces with
        ``.shed``/``.data_plane_down``/``.retry_after_s`` so callers
        can schedule their own backoff. Disable with
        ``retry_on_503=False``."""
        body: Dict[str, Any] = {"queries": _jsonable(queries)}
        if timeout is not None:
            body["timeout"] = timeout
        if sampling:
            body["sampling"] = sampling
        if slo is not None:
            body["slo"] = slo
        # the socket must outlive the server-side gather deadline, or a
        # slow-but-working predictor (first-request compile) looks dead
        sock_timeout = self.timeout if timeout is None else \
            max(self.timeout, timeout + 30.0)
        url = f"{predictor_url.rstrip('/')}/predict"
        headers = _trace_headers(trace_id)
        try:
            out = json_request("POST", url, body, headers=headers,
                               timeout=sock_timeout)
        except HttpStatusError as e:
            # shed 503s and breaker fast-fail 503s both carry the
            # structured retry hint; e.shed tells them apart when the
            # retry below also fails and the error reaches the caller
            retry_after = e.retry_after_s
            if not (retry_on_503 and e.status == 503
                    and retry_after is not None):
                raise
            time.sleep(min(max(0.0, retry_after), MAX_RETRY_AFTER_S))
            out = json_request("POST", url, body, headers=headers,
                               timeout=sock_timeout)
        return out["predictions"]

    def predict_stream(self, predictor_url: str, queries: Sequence[Any],
                       timeout: Optional[float] = None,
                       sampling: Optional[Dict[str, Any]] = None,
                       trace_id: Optional[str] = None,
                       resume: Optional[Sequence[Optional[str]]] = None,
                       auto_resume: int = 1,
                       slo: Optional[str] = None):
        """Streaming generation: yields the predictor's SSE events —
        ``{"delta": {qi: text}}`` per new-token batch (append to query
        qi's output), rarely ``{"replace": {qi: text}}`` (authoritative
        text diverged from the streamed prefix — overwrite, don't
        append), then one ``{"done": True, "predictions": [...]}`` (or
        done+error). Every stream ends with a done event. Only
        meaningful against generation (decode-loop) inference jobs.

        **Resumable errors**: when the predictor loses every healthy
        worker mid-stream it ends the stream with a *resumable* event
        carrying the delivered text. Up to ``auto_resume`` times, this
        generator transparently re-requests with that partial as
        ``resume`` (after honoring ``retry_after_s``) and the stream
        continues where it stopped — no text re-delivered or lost.
        When resumes are exhausted (or ``auto_resume=0``) the terminal
        event is a typed :class:`StreamInterrupted` instead of a bare
        error string, so callers can resume on their own schedule.
        ``resume`` seeds the first request (continuing an earlier
        interrupted stream).

        ``slo``: admission class (omit for the job default). A shed /
        fast-fail 503 at stream open is retried ONCE after honoring
        ``retry_after_s``; a second refusal raises the typed
        :class:`~rafiki_tpu_torch.utils.http.HttpStatusError` whose
        ``.shed`` distinguishes overload backpressure from a dead
        fleet."""
        from rafiki_tpu_torch.utils.http import STREAM_BUDGET_S, sse_request

        # a request queued behind busy decode slots can legitimately
        # produce no deltas until near the server's WHOLE-stream budget
        # — so with no explicit timeout, size the per-EVENT wait to the
        # server's stream budget (every stream ends with a terminal
        # done event within it), not the unary self.timeout. Connection
        # establishment keeps the short self.timeout: a down host must
        # fail fast, not after the stream budget.
        server_budget = STREAM_BUDGET_S if timeout is None else timeout
        partial = list(resume) if resume else None
        resumes_left = max(0, int(auto_resume))
        retry_503_left = 1
        while True:
            body: Dict[str, Any] = {"queries": _jsonable(queries)}
            if timeout is not None:
                body["timeout"] = timeout
            if sampling:
                body["sampling"] = sampling
            if slo is not None:
                body["slo"] = slo
            if partial and any(p for p in partial):
                body["resume"] = [p if isinstance(p, str) else None
                                  for p in partial]
            resumed_here = False
            try:
                for ev in sse_request(
                        "POST",
                        f"{predictor_url.rstrip('/')}/predict_stream",
                        body, headers=_trace_headers(trace_id),
                        timeout=self.timeout,
                        read_timeout=max(self.timeout,
                                         server_budget + 30.0)):
                    if not (isinstance(ev, dict) and ev.get("done")
                            and ev.get("resumable")):
                        yield ev
                        continue
                    partial = list(ev.get("partial") or [])
                    if resumes_left > 0:
                        # resume even with NO delivered text: an empty
                        # resume is just a fresh request after
                        # retry_after_s — the stream twin of predict()'s
                        # structured-503 retry
                        resumes_left -= 1
                        resumed_here = True
                        time.sleep(min(
                            max(0.0,
                                float(ev.get("retry_after_s") or 0)),
                            MAX_RETRY_AFTER_S))
                        break  # re-request with the partial as resume
                    yield StreamInterrupted(
                        error=str(ev.get("error") or ""),
                        partial=partial, qid=str(ev.get("qid") or ""),
                        trace_id=str(ev.get("trace_id") or ""),
                        retry_after_s=float(ev.get("retry_after_s")
                                            or 0),
                        raw=ev)
            except HttpStatusError as e:
                # the stream never opened: a shed 503 (overload
                # backpressure — e.shed) or a breaker fast-fail 503.
                # One honored retry, like predict(); the second
                # refusal raises the typed error for the caller.
                if not (e.status == 503 and retry_503_left > 0
                        and e.retry_after_s is not None):
                    raise
                retry_503_left -= 1
                time.sleep(min(max(0.0, e.retry_after_s),
                               MAX_RETRY_AFTER_S))
                continue
            if not resumed_here:
                return


def _trace_headers(trace_id: Optional[str]) -> Optional[Dict[str, str]]:
    return {"X-Rafiki-Trace-Id": trace_id} if trace_id else None


def _jsonable(queries: Sequence[Any]) -> List[Any]:
    import numpy as np

    out = []
    for q in queries:
        if isinstance(q, np.ndarray) or hasattr(q, "tolist"):
            out.append(np.asarray(q).tolist())
        else:
            out.append(q)
    return out
