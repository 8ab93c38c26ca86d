"""Admin: the control-plane brain behind the REST API.

The port's own copy of ``rafiki_tpu/admin/admin.py`` (``Admin``,
``AuthError``): auth (in-process session tokens), model upload, the
dataset registry, the train- and inference-job lifecycle; it spawns
services through the port's ``ServicesManager``. A monitor thread reaps
dead services and finalizes train jobs whose workers have all exited
(stopping their advisors and freeing their slots), and ticks the
inference-pool autoscaler (``ServicesManager.autoscale_tick``). The
MetaStore backup, the rolling restart and the manual scale of an
inference job are served.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.admin.services_manager import ServicesManager
from rafiki_tpu_torch.constants import (ServiceType, SubTrainJobStatus,
                                        TrainJobStatus, UserType)
from rafiki_tpu_torch.store.meta_store import MetaStore


class AuthError(Exception):
    pass


class Admin:
    def __init__(self, meta_store: MetaStore,
                 services_manager: ServicesManager,
                 superadmin_email: str = "superadmin@rafiki",
                 superadmin_password: str = "rafiki") -> None:
        self.meta = meta_store
        self.services = services_manager
        self._tokens: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        if self.meta.get_user_by_email(superadmin_email) is None:
            self.meta.create_user(superadmin_email, superadmin_password,
                                  UserType.SUPERADMIN)

    # ---- lifecycle ----
    def start_monitor(self, interval_s: float = 0.5) -> None:
        # lease renewal lives on the ServicesManager's OWN heartbeat
        # thread (started at acquire_lease time, before reconcile —
        # and idempotent here): it never takes op_lock, so a spawn's
        # 180s port-wait cannot starve the heartbeat past the TTL and
        # hand the stack to a concurrent boot
        self.services.start_lease_heartbeat()

        def loop() -> None:
            while not self._monitor_stop.wait(interval_s):
                try:
                    # a fenced admin must stop respawning/finalizing:
                    # the children now belong to the new admin
                    if self.services.fenced:
                        continue
                    self.services.poll()
                    # the inference-pool autoscaler: grow on sustained
                    # admission stalls, shrink through the drain path
                    # (rate-limited; a no-op without a live pool)
                    self.services.autoscale_tick()
                    self._finalize_finished_train_jobs()
                except Exception:  # keep the monitor alive — but a
                    # broken poll loop must be visible, not silent
                    import logging

                    logging.getLogger(__name__).warning(
                        "service monitor tick failed", exc_info=True)

        self._monitor = threading.Thread(target=loop, daemon=True)
        self._monitor.start()

    def stop(self) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        self.services.stop_all()  # also stops the lease heartbeat

    def _finalize_finished_train_jobs(self) -> None:
        running = [s for s in self.services.services.values()
                   if s.service_type == ServiceType.TRAIN_WORKER]
        busy_jobs = set()
        for s in running:
            row = self.meta.get_service(s.service_id)
            if row and row.get("train_job_id"):
                busy_jobs.add(row["train_job_id"])
        # a queued (slot-starved) worker respawn keeps its job busy —
        # finalizing here would drop the healing on the floor
        busy_jobs |= self.services.pending_respawn_job_ids()
        for svc in list(self.services.services.values()):
            if svc.service_type != ServiceType.ADVISOR:
                continue
            row = self.meta.get_service(svc.service_id)
            job_id = row.get("train_job_id") if row else None
            if job_id and job_id not in busy_jobs:
                self.services.stop_service(svc.service_id)
                for sub in self.meta.get_sub_train_jobs_of_train_job(job_id):
                    self.meta.update_sub_train_job(
                        sub["id"], status=SubTrainJobStatus.STOPPED)
                self.meta.update_train_job(job_id,
                                           status=TrainJobStatus.STOPPED,
                                           stopped_at=time.time())
                # natural completion is the COMMON finalization path —
                # it must sweep leaked mid-train ckpts too, not just
                # explicit stop_train_job
                self._sweep_trial_checkpoints(job_id)

    # ---- auth ----
    def login(self, email: str, password: str) -> Dict[str, Any]:
        user = self.meta.authenticate_user(email, password)
        if user is None:
            raise AuthError("invalid email or password")
        token = secrets.token_hex(16)
        with self._lock:
            self._tokens[token] = user["id"]
        return {"token": token, "user_id": user["id"],
                "user_type": user["user_type"]}

    def authorize(self, token: str) -> Dict[str, Any]:
        with self._lock:
            user_id = self._tokens.get(token)
        user = self.meta.get_user(user_id) if user_id else None
        if user is None or user.get("banned"):
            raise AuthError("invalid or expired token")
        return user

    def create_user(self, email: str, password: str,
                    user_type: str) -> Dict[str, Any]:
        u = self.meta.create_user(email, password, user_type)
        return {k: u[k] for k in ("id", "email", "user_type")}

    # ---- control-plane backup ----
    def backup(self, path: str) -> Dict[str, Any]:
        """Online MetaStore snapshot (consistent under concurrent
        writers): the step before risky operations."""
        return self.meta.backup(path)

    # ---- models ----
    def create_model(self, user_id: str, name: str, task: str,
                     model_class: str, model_bytes: bytes,
                     access_right: str = "PRIVATE") -> Dict[str, Any]:
        from rafiki_tpu_torch.model.base import load_model_class

        load_model_class(model_bytes, model_class)  # validate importable
        m = self.meta.create_model(user_id, name, task, model_class,
                                   model_bytes, access_right=access_right)
        return _model_public(m)

    def get_models(self, user_id: str,
                   task: Optional[str] = None) -> List[Dict[str, Any]]:
        return [_model_public(m)
                for m in self.meta.get_available_models(task=task,
                                                        user_id=user_id)]

    # ---- datasets ----
    def create_dataset(self, user_id: str, name: str, task: str,
                       uri: str) -> Dict[str, Any]:
        return self.meta.create_dataset(user_id, name, task, uri)

    def get_datasets(self, user_id: str,
                     task: Optional[str] = None) -> List[Dict[str, Any]]:
        return self.meta.get_datasets(user_id, task=task)

    # ---- train jobs ----
    def create_train_job(self, user_id: str, app: str, task: str,
                         train_dataset_id: str, val_dataset_id: str,
                         budget: Dict[str, Any],
                         model_ids: Optional[List[str]] = None,
                         train_args: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        latest = self.meta.get_latest_train_job_of_app(user_id, app)
        version = (latest["app_version"] + 1) if latest else 1
        # datasets may be registered ids or raw host paths; reject
        # anything that is neither HERE, at the API boundary — otherwise
        # a typo'd dataset id only fails later inside a worker
        import os

        for ds_id in (train_dataset_id, val_dataset_id):
            if self.meta.get_dataset(ds_id) is None and \
                    not os.path.exists(ds_id):
                raise ValueError(
                    f"dataset {ds_id!r} is neither a registered dataset "
                    "id nor an existing path")
        train_uri = self._resolve_dataset(train_dataset_id)
        val_uri = self._resolve_dataset(val_dataset_id)

        if model_ids is None:
            models = self.meta.get_available_models(task=task,
                                                    user_id=user_id)
            model_ids = [m["id"] for m in models]
        if not model_ids:
            raise ValueError(f"no models available for task {task!r}")

        job = self.meta.create_train_job(
            user_id, app, version, task, budget,
            train_uri, val_uri, train_args=train_args)
        for mid in model_ids:
            self.meta.create_sub_train_job(job["id"], mid)
        try:
            self.services.create_train_services(job["id"])
        except ValueError:
            # pre-spawn validation failed (e.g. typo'd knob_overrides):
            # don't leave a zombie RUNNING job (or STARTED sub-jobs — the
            # monitor's finalize path never runs for a job with no
            # services) behind the 400 response
            for sub in self.meta.get_sub_train_jobs_of_train_job(job["id"]):
                self.meta.update_sub_train_job(sub["id"], status="ERRORED")
            self.meta.update_train_job(job["id"], status="ERRORED")
            raise
        return self.get_train_job(job["id"])

    def _resolve_dataset(self, dataset_id_or_uri: str) -> str:
        ds = self.meta.get_dataset(dataset_id_or_uri)
        return ds["uri"] if ds is not None else dataset_id_or_uri

    def get_train_job(self, job_id: str) -> Dict[str, Any]:
        job = self.meta.get_train_job(job_id)
        if job is None:
            raise KeyError(f"no train job {job_id!r}")
        job["sub_train_jobs"] = \
            self.meta.get_sub_train_jobs_of_train_job(job_id)
        job["n_trials"] = len(self.meta.get_trials_of_train_job(job_id))
        return job

    def get_train_jobs(self, user_id: str) -> List[Dict[str, Any]]:
        """All of a user's train jobs, newest first (dashboard listing)."""
        return self.meta.get_train_jobs_of_user(user_id)

    def get_train_job_of_app(self, user_id: str, app: str,
                             app_version: int = -1) -> Dict[str, Any]:
        if app_version < 0:
            job = self.meta.get_latest_train_job_of_app(user_id, app)
        else:
            jobs = self.meta.get_train_jobs_of_app(user_id, app)
            job = next((j for j in jobs
                        if j["app_version"] == app_version), None)
        if job is None:
            raise KeyError(f"no train job for app {app!r}")
        return self.get_train_job(job["id"])

    def stop_train_job(self, job_id: str) -> None:
        # mark STOPPED FIRST: the monitor's respawner checks job status,
        # so a worker that crashes in this very window is not replaced
        # behind our back (the service snapshot below would miss it)
        self.meta.update_train_job(job_id, status=TrainJobStatus.STOPPED,
                                   stopped_at=time.time())
        for svc in list(self.services.services.values()):
            row = self.meta.get_service(svc.service_id)
            if row and row.get("train_job_id") == job_id:
                self.services.stop_service(svc.service_id)
        for sub in self.meta.get_sub_train_jobs_of_train_job(job_id):
            self.meta.update_sub_train_job(sub["id"],
                                           status=SubTrainJobStatus.STOPPED)
        self._sweep_trial_checkpoints(job_id)

    def _sweep_trial_checkpoints(self, job_id: str) -> None:
        """Drop ``ckpt-<trial_id>`` working blobs once the job is done.
        Mid-train checkpoints of preempted trials that were never resumed
        (respawn budget exhausted, job stopped) and of failed resumes
        otherwise live forever in the ParamStore; after job
        finalization nothing will ever resume them. ALL trials are swept
        — including RUNNING zombies whose worker was SIGKILLed (the
        state a preemption leaves behind): the job's worker pool is gone,
        so no claimant remains. Final trial params (key = trial_id) are
        artifacts and are kept — deployment reads them."""
        from rafiki_tpu_torch.store.param_store import ParamStore

        try:
            store = ParamStore.from_uri(self.services.param_store_uri)
            for t in self.meta.get_trials_of_train_job(job_id):
                store.delete(f"ckpt-{t['id']}")
                store.delete(f"ckpt-{t['id']}-meta")
        except Exception:  # a kv hiccup must not turn a
            # clean job stop into a 500; the leak is bounded and logged
            import logging

            logging.getLogger(__name__).warning(
                "trial checkpoint sweep failed for job %s", job_id,
                exc_info=True)

    def get_trials(self, job_id: str) -> List[Dict[str, Any]]:
        return self.meta.get_trials_of_train_job(job_id)

    def get_best_trials(self, job_id: str,
                        max_count: int = 2) -> List[Dict[str, Any]]:
        return self.meta.get_best_trials_of_train_job(job_id,
                                                      max_count=max_count)

    def get_trial_logs(self, trial_id: str) -> List[Dict[str, Any]]:
        return self.meta.get_trial_logs(trial_id)

    # ---- inference jobs ----
    def create_inference_job(self, user_id: str, train_job_id: str,
                             max_workers: int = 2,
                             budget: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, Any]:
        """``budget`` options: ``STEPS_PER_SYNC`` (decode-loop dispatch
        amortization), ``MULTI_ADAPTER`` (serve the best-N LM trials as
        one stacked-adapter worker instead of N replicas),
        ``ADAPTIVE_GATHER`` (latency/accuracy gather controller),
        ``MAX_NEW_TOKENS`` / ``SYSTEM_PREFIX`` (decode-loop generation
        cap / shared-prefix KV cache), ``SPECULATE_K`` (speculative
        decoding: prompt-lookup drafting at depth K),
        ``DRAFT_TRIAL_ID`` (a completed same-template trial to use as
        the draft MODEL instead of prompt lookup), the disaggregated and
        host-tier keys, and the autoscaler keys ``AUTOSCALE`` /
        ``MIN_WORKERS`` / ``MAX_WORKERS`` / ``AUTOSCALE_COOLDOWN_S``,
        each validated as JAX does before anything spawns. The port
        refuses ``PAGED_KERNEL=false`` by name (``NotPorted``)."""
        job = self.meta.create_inference_job(user_id, train_job_id,
                                             budget=budget)
        self.services.create_inference_services(job["id"],
                                                max_workers=max_workers)
        return self.get_inference_job(job["id"])

    def get_inference_job(self, job_id: str) -> Dict[str, Any]:
        job = self.meta.get_inference_job(job_id)
        if job is None:
            raise KeyError(f"no inference job {job_id!r}")
        host = job.get("predictor_host") or ""
        job["predictor_url"] = f"http://{host}" if host else None
        return job

    def get_inference_jobs(self, user_id: str) -> List[Dict[str, Any]]:
        jobs = self.meta.get_inference_jobs(user_id)
        for job in jobs:
            host = job.get("predictor_host") or ""
            job["predictor_url"] = f"http://{host}" if host else None
        return jobs

    def get_inference_job_health(self, job_id: str) -> Dict[str, Any]:
        """Server-side proxy to the predictor's ``GET /health`` (req/s
        counters + latency percentiles): the dashboard cannot fetch the
        predictor's port directly from the browser (cross-origin)."""
        from rafiki_tpu_torch.utils.http import json_request

        job = self.get_inference_job(job_id)
        if not job.get("predictor_url"):
            return {"ok": False, "error": "no predictor"}
        try:
            return json_request("GET", f"{job['predictor_url']}/health",
                                timeout=5)
        except Exception as e:  # unreachable/500/garbage
            # predictor all map to a structured "down" answer, never a
            # 500 from the admin itself
            return {"ok": False, "error": str(e)}

    def rolling_restart_inference_job(self, job_id: str,
                                      drain_timeout: float = 120.0
                                      ) -> Dict[str, Any]:
        """Cycle the job's workers with zero dropped streams: each is
        drained (finishes in-flight work while the predictor routes
        around it), stopped, and respawned before the next one goes."""
        job = self.meta.get_inference_job(job_id)
        if job is None:
            raise KeyError(f"no inference job {job_id!r}")
        if job["status"] != "RUNNING":
            raise ValueError(
                f"inference job {job_id} is {job['status']}, not "
                "RUNNING — nothing to restart")
        return self.services.rolling_restart(job_id,
                                             drain_timeout=drain_timeout)

    def scale_inference_job(self, job_id: str, workers: int,
                            drain_timeout: float = 120.0
                            ) -> Dict[str, Any]:
        """Manually scale a RUNNING inference job's worker pool to an
        exact replica count: ups spawn from the job's template and join
        the routing pool once warmed; downs drain newest-first (the
        predictor fails their streams over with forced prefixes — a
        shrink never drops a stream)."""
        job = self.meta.get_inference_job(job_id)
        if job is None:
            raise KeyError(f"no inference job {job_id!r}")
        if job["status"] != "RUNNING":
            raise ValueError(
                f"inference job {job_id} is {job['status']}, not "
                "RUNNING — nothing to scale")
        return self.services.scale_inference_job(
            job_id, workers, drain_timeout=drain_timeout)

    def get_inference_job_autoscaler(self, job_id: str
                                     ) -> Dict[str, Any]:
        """The job's routing pool + autoscaler state (bounds, tick
        counters, in-flight warmups/drains)."""
        if self.meta.get_inference_job(job_id) is None:
            raise KeyError(f"no inference job {job_id!r}")
        return self.services.scaleout_status(job_id)

    def stop_inference_job(self, job_id: str) -> None:
        # STOPPED first — same respawn-race reasoning as stop_train_job
        self.meta.update_inference_job(job_id, status="STOPPED",
                                       stopped_at=time.time())
        for svc in list(self.services.services.values()):
            row = self.meta.get_service(svc.service_id)
            if row and row.get("inference_job_id") == job_id:
                self.services.stop_service(svc.service_id)


def _model_public(m: Dict[str, Any]) -> Dict[str, Any]:
    return {k: m[k] for k in
            ("id", "name", "task", "model_class", "access_right",
             "created_at")}
