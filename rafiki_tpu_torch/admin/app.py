"""Admin REST API over the JSON HTTP kit.

The port's own copy of ``rafiki_tpu/admin/app.py`` (``AdminApp`` with the
JAX route table, and ``main``): tokens, users, models, datasets, train
jobs, trials, inference jobs, ``/health``, ``/metrics`` and the operator
dashboard (the port's own copy of ``dashboard.html``), the rolling
restart, the manual scale and the autoscaler's state
(``/inference_jobs/<id>/scale``, ``/inference_jobs/<id>/autoscaler``,
the ``admin_autoscale_*`` gauges and the ``/health`` scaling block) and
``/system/backup``. Model bytes travel base64-encoded in JSON
(``model.base.serialize_model_class``).

``python -m rafiki_tpu_torch.admin.app --config cfg.json`` is the stack's
process: it takes the admin lease and starts its heartbeat, reconciles
what a previous admin left (or reaps it, with ``"cold_start"``), boots
the port's kvd unless it adopted one, arms the ``RAFIKI_CHAOS`` admin
and kvd kill timers when the env asks for them, starts the monitor and
serves the API. On a host without a CUDA device it raises, unless the
config asks for a CPU stack (``"platform": "cpu"``, with ``"cpu_slots"``
virtual slots).
"""

from __future__ import annotations

import base64
from typing import Any, Dict, Optional, Tuple

from rafiki_tpu_torch.admin.admin import Admin, AuthError
from rafiki_tpu_torch.obs.metrics import PROM_CONTENT_TYPE, MetricsRegistry
from rafiki_tpu_torch.obs.trace import TraceBuffer, mint_trace_id
from rafiki_tpu_torch.serving.decode_engine import NotPorted
from rafiki_tpu_torch.utils.http import JsonHttpService, RawResponse


class AdminApp:
    def __init__(self, admin: Admin, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.admin = admin
        # control-plane metrics: live gauges evaluated at scrape time
        # against the ServicesManager (no second bookkeeping), plus the
        # HTTP request counter/latency the service kit wires itself
        self.metrics = MetricsRegistry()
        self.traces = TraceBuffer(256)
        svcs = admin.services
        self.metrics.gauge("admin_services",
                           "live managed service processes",
                           fn=lambda: len(svcs.services))
        self.metrics.gauge("admin_free_slots",
                           "unallocated device slots",
                           fn=lambda: svcs.allocator.free_count())
        self.metrics.gauge(
            "admin_respawns_done", "self-healing worker respawns",
            fn=lambda: svcs.respawn_stats()["respawns_done"])
        self.metrics.gauge(
            "admin_pending_respawns", "slot-starved respawns queued",
            fn=lambda: svcs.respawn_stats()["pending_respawns"])
        # the recovery plane: what the boot reconciler did, where the
        # lease stands, the kvd's respawns
        for key, what in (
                ("services_adopted",
                 "live services adopted by the boot reconciler"),
                ("orphans_reaped",
                 "stopped-job survivors killed by the boot reconciler"),
                ("services_crashed",
                 "service rows found dead at boot (CRASHED)"),
                ("lease_takeovers",
                 "expired-lease takeovers performed by this admin")):
            self.metrics.gauge(f"admin_{key}", what,
                               fn=lambda k=key: svcs.recovery[k])
        self.metrics.gauge(
            "admin_lease_generation",
            "fencing generation of the held admin lease",
            fn=lambda: svcs.lease_generation)
        # the scale-out plane: autoscaler actions
        self.metrics.gauge(
            "admin_autoscale_ups",
            "inference-pool replicas added by autoscale/manual scale",
            fn=lambda: svcs.scaling["autoscale_ups"])
        self.metrics.gauge(
            "admin_autoscale_downs",
            "inference-pool replicas drained out by autoscale/manual "
            "scale", fn=lambda: svcs.scaling["autoscale_downs"])
        self.metrics.gauge(
            "admin_autoscale_blocked",
            "autoscale-up decisions skipped for want of a device slot",
            fn=lambda: svcs.scaling["autoscale_blocked"])
        self.metrics.gauge(
            "kvd_respawns", "kvd respawns with WAL replay",
            fn=lambda: svcs.recovery["kvd_respawns"])
        self.metrics.gauge(
            "kvd_replay_seconds", "the last kvd boot's WAL replay time",
            fn=lambda: svcs.recovery["kvd_replay_seconds"])
        self.metrics.gauge(
            "kvd_up", "1 while the data plane answers STATS",
            fn=lambda: svcs.kvd_stats().get("up", 0))
        self.http = JsonHttpService(host, port, registry=self.metrics)
        r = self.http.route
        # /metrics is numeric-only and stays open like /health; the
        # trace ring carries job ids/app names — USER-owned metadata —
        # so unlike the (by-design unauthenticated) worker/predictor
        # surfaces, the admin's /debug/requests sits behind auth
        r("GET", "/metrics", self._metrics)
        r("GET", "/debug/requests", self._auth(self._debug_requests))
        r("POST", "/tokens", self._login)
        r("GET", "/health", self._health)
        r("GET", "/", self._dashboard)
        r("GET", "/train_jobs", self._auth(self._get_train_jobs))
        r("POST", "/users", self._auth(self._create_user))
        r("POST", "/models", self._auth(self._create_model))
        r("GET", "/models", self._auth(self._get_models))
        r("POST", "/datasets", self._auth(self._create_dataset))
        r("GET", "/datasets", self._auth(self._get_datasets))
        r("POST", "/train_jobs", self._auth(self._create_train_job))
        r("GET", "/train_jobs/app/<app>", self._auth(self._get_job_of_app))
        r("GET", "/train_jobs/<id>", self._auth(self._get_train_job))
        r("POST", "/train_jobs/<id>/stop", self._auth(self._stop_train_job))
        r("GET", "/train_jobs/<id>/trials", self._auth(self._get_trials))
        r("GET", "/train_jobs/<id>/best_trials",
          self._auth(self._get_best_trials))
        r("GET", "/trials/<id>/logs", self._auth(self._get_trial_logs))
        r("POST", "/inference_jobs", self._auth(self._create_inference_job))
        r("GET", "/inference_jobs", self._auth(self._get_inference_jobs))
        r("GET", "/inference_jobs/<id>", self._auth(self._get_inference_job))
        r("GET", "/inference_jobs/<id>/health",
          self._auth(self._get_inference_job_health))
        r("POST", "/inference_jobs/<id>/stop",
          self._auth(self._stop_inference_job))
        r("POST", "/inference_jobs/<id>/rolling_restart",
          self._auth(self._rolling_restart))
        r("POST", "/inference_jobs/<id>/scale",
          self._auth(self._scale_inference_job))
        r("GET", "/inference_jobs/<id>/autoscaler",
          self._auth(self._get_autoscaler))
        r("POST", "/system/backup", self._auth(self._backup))

    def start(self) -> Tuple[str, int]:
        return self.http.start()

    def stop(self) -> None:
        self.http.stop()
        self.admin.stop()

    # ---- middleware ----
    def _auth(self, handler):
        def wrapped(m: Dict[str, str], body: Any,
                    headers: Dict[str, str]) -> Tuple[int, Any]:
            hdrs = {k.lower(): v for k, v in headers.items()}
            token = (hdrs.get("authorization") or "").removeprefix(
                "Bearer ").strip()
            try:
                user = self.admin.authorize(token)
            except AuthError as e:
                return 401, {"error": str(e)}
            try:
                return handler(m, body or {}, user)
            except (KeyError, ValueError, NotPorted) as e:
                return 400, {"error": str(e)}

        return wrapped

    # ---- routes ----
    def _metrics(self, _m, _b, _h) -> Tuple[int, Any]:
        return 200, RawResponse(
            self.metrics.render_prometheus().encode("utf-8"),
            PROM_CONTENT_TYPE)

    def _debug_requests(self, m, _b, _user) -> Tuple[int, Any]:
        from rafiki_tpu_torch.obs.http import DEBUG_REQUESTS_DEFAULT_N

        n = int(m.get("n", DEBUG_REQUESTS_DEFAULT_N))  # a bad n is a
        # ValueError -> the _auth wrapper's 400, same as other routes
        if n < 0:
            return 400, {"error": "n must be >= 0"}
        recs = self.traces.recent(n)
        return 200, {"requests": recs, "count": len(recs)}

    def _dashboard(self, _m, _b, _h) -> Tuple[int, Any]:
        """Operator dashboard (SURVEY.md §1 layer 1): a self-contained
        HTML+JS page over this very REST API — jobs → trials → loss
        curves from ``/trials/<id>/logs``."""
        import importlib.resources

        try:
            html = (importlib.resources.files("rafiki_tpu_torch.admin")
                    / "dashboard.html").read_bytes()
        except (FileNotFoundError, ModuleNotFoundError):
            return 404, {"error": "dashboard.html not packaged"}
        return 200, RawResponse(html, "text/html; charset=utf-8")

    def _get_train_jobs(self, _m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_train_jobs(user["id"])

    def _health(self, _m, _b, _h) -> Tuple[int, Any]:
        svc = self.admin.services
        # respawn_stats/degraded_jobs are lock-protected: the monitor
        # thread mutates the underlying dicts while this thread reads
        # jobs whose self-healing is exhausted/lost (job id → reason):
        # a job quietly running under-replicated must be visible here,
        # not just in a warning log. Fetched FIRST — degraded_jobs()
        # prunes STOPPED jobs, and the count must describe the same
        # pruned view the map shows (a monitor alerting on the counter
        # must find its job in the list)
        degraded = svc.degraded_jobs()
        return 200, {"ok": True,
                     "n_services": len(svc.services),
                     "free_slots": svc.allocator.free_count(),
                     "platform": svc.platform,
                     **svc.respawn_stats(),
                     "degraded_jobs": len(degraded),
                     "degraded": degraded,
                     # autoscaler action counters (per-job detail at
                     # GET /inference_jobs/<id>/autoscaler)
                     "scaling": svc.scaling.snapshot(),
                     "recovery": {**svc.recovery.snapshot(),
                                  "lease_generation":
                                      svc.lease_generation,
                                  "fenced": bool(svc.fenced)},
                     # kvd persistence (feeds the dashboard's
                     # data-plane banner)
                     "data_plane": svc.data_plane_status()}

    def _login(self, _m, body, _h) -> Tuple[int, Any]:
        try:
            return 200, self.admin.login(body["email"], body["password"])
        except AuthError as e:
            return 401, {"error": str(e)}

    def _create_user(self, _m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.create_user(body["email"], body["password"],
                                           body.get("user_type",
                                                    "APP_DEVELOPER"))

    def _create_model(self, _m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.create_model(
            user["id"], body["name"], body["task"], body["model_class"],
            base64.b64decode(body["model_bytes"]),
            access_right=body.get("access_right", "PRIVATE"))

    def _get_models(self, _m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.get_models(user["id"],
                                          task=body.get("task"))

    def _create_dataset(self, _m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.create_dataset(user["id"], body["name"],
                                              body["task"], body["uri"])

    def _get_datasets(self, _m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.get_datasets(user["id"],
                                            task=body.get("task"))

    def _create_train_job(self, _m, body, user) -> Tuple[int, Any]:
        job = self.admin.create_train_job(
            user["id"], body["app"], body["task"],
            body["train_dataset_id"], body["val_dataset_id"],
            body.get("budget", {"TRIAL_COUNT": 5}),
            model_ids=body.get("model_ids"),
            train_args=body.get("train_args"))
        # job lifecycle lands in the admin's own /debug/requests ring
        self.traces.start(mint_trace_id(), request_id=str(job["id"]),
                          span="create_train_job", app=body["app"])
        return 200, job

    def _get_train_job(self, m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_train_job(m["id"])

    def _get_job_of_app(self, m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.get_train_job_of_app(
            user["id"], m["app"], int(body.get("app_version", -1)))

    def _stop_train_job(self, m, _b, user) -> Tuple[int, Any]:
        self.admin.stop_train_job(m["id"])
        return 200, {"ok": True}

    def _get_trials(self, m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_trials(m["id"])

    def _get_best_trials(self, m, body, user) -> Tuple[int, Any]:
        return 200, self.admin.get_best_trials(
            m["id"], max_count=int(body.get("max_count", 2)))

    def _get_trial_logs(self, m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_trial_logs(m["id"])

    def _create_inference_job(self, _m, body, user) -> Tuple[int, Any]:
        try:
            budget = body.get("budget")
            job = self.admin.create_inference_job(
                user["id"], body["train_job_id"],
                max_workers=int(body.get("max_workers", 2)),
                budget=budget if isinstance(budget, dict) else None)
        except NotPorted as e:
            return 400, {"error": str(e)}
        except RuntimeError as e:
            return 409, {"error": str(e)}
        self.traces.start(mint_trace_id(), request_id=str(job["id"]),
                          span="create_inference_job")
        return 200, job

    def _get_inference_job(self, m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_inference_job(m["id"])

    def _get_inference_jobs(self, _m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_inference_jobs(user["id"])

    def _get_inference_job_health(self, m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_inference_job_health(m["id"])

    def _stop_inference_job(self, m, _b, user) -> Tuple[int, Any]:
        self.admin.stop_inference_job(m["id"])
        return 200, {"ok": True}

    def _backup(self, _m, body, user) -> Tuple[int, Any]:
        """Online MetaStore snapshot to a server-side path — the
        "before risky ops" half of the recovery runbook. Superadmin
        only: the path lands on the admin host's filesystem."""
        from rafiki_tpu_torch.constants import UserType

        if user.get("user_type") not in (UserType.SUPERADMIN,
                                         UserType.ADMIN):
            return 403, {"error": "backup requires an admin user"}
        path = str(body.get("path") or "")
        if not path:
            return 400, {"error": "body must name a backup 'path'"}
        try:
            return 200, {"ok": True, **self.admin.backup(path)}
        except OSError as e:
            return 500, {"error": f"backup failed: {e}"}

    def _scale_inference_job(self, m, body, user) -> Tuple[int, Any]:
        """Manual pool scaling: ``{"workers": N}`` grows from the
        job's template / drains newest-first down to N with zero
        dropped streams."""
        if "workers" not in (body or {}):
            return 400, {"error": "body must name 'workers' (the "
                                  "target replica count)"}
        try:
            return 200, self.admin.scale_inference_job(
                m["id"], int(body["workers"]),
                drain_timeout=float(body.get("drain_timeout", 120.0)))
        except RuntimeError as e:
            # no free slot / conflicting operation: a conflict with
            # current capacity, not a server bug
            return 409, {"error": str(e)}

    def _get_autoscaler(self, m, _b, user) -> Tuple[int, Any]:
        return 200, self.admin.get_inference_job_autoscaler(m["id"])

    def _rolling_restart(self, m, body, user) -> Tuple[int, Any]:
        """Zero-downtime worker cycling: drain→stop→respawn each of the
        job's workers one at a time (deploys/config reloads that must
        not drop a stream)."""
        try:
            return 200, self.admin.rolling_restart_inference_job(
                m["id"], drain_timeout=float(
                    (body or {}).get("drain_timeout", 120.0)))
        except RuntimeError as e:
            # already-in-progress / no free slot: a conflict with the
            # current state, not a server bug — 409 like the other
            # resource-conflict paths
            return 409, {"error": str(e)}


def main(argv: Optional[list] = None) -> int:
    """Service entrypoint: ``python -m rafiki_tpu_torch.admin.app
    --config cfg.json``. The config is the JAX admin's JSON (``workdir``,
    ``db_path``, ``host``, ``port``, ``slot_size``, ``workers``,
    ``port_file``, ``lease_ttl_s``, ``lease_wait_s``, ``cold_start``)
    plus ``platform``: absent or ``"cuda"`` probes the host's cards (and
    raises without one); ``"cpu"`` asks for a CPU stack over
    ``cpu_slots`` virtual slots (default 1). ``RAFIKI_CHAOS`` in the env
    arms the admin's own kill timer (``kill_admin_after_s``) and the
    kvd's (``kill_kvd_after_s``)."""
    import argparse
    import json
    import signal
    import time

    from rafiki_tpu_torch.admin.services_manager import (LeaseHeldError,
                                                         ServicesManager)
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec
    from rafiki_tpu_torch.store.meta_store import MetaStore

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="JSON: {workdir, db_path, host, port, "
                             "slot_size, port_file, lease_ttl_s, "
                             "cold_start, platform, cpu_slots}")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    platform = cfg.get("platform") or None
    devices = None
    if platform == "cpu":
        devices = [DeviceSpec(id=i)
                   for i in range(int(cfg.get("cpu_slots", 1)))]
    meta = MetaStore(cfg["db_path"])
    manager = ServicesManager(meta, cfg["workdir"],
                              slot_size=int(cfg.get("slot_size", 1)),
                              platform=platform, devices=devices,
                              default_workers=int(cfg.get("workers", 1)))
    # single-writer fencing: a LIVE admin's lease refuses this boot; an
    # expired one is taken over at a bumped generation. A crash-restart
    # lands within the dead holder's TTL, so retry for lease_wait_s
    ttl_s = float(cfg.get("lease_ttl_s", 15.0))
    wait_s = float(cfg.get("lease_wait_s", ttl_s + 5.0))
    lease_deadline = time.monotonic() + wait_s
    while True:
        try:
            lease = manager.acquire_lease(ttl_s=ttl_s)
            break
        except LeaseHeldError as e:
            if time.monotonic() < lease_deadline:
                time.sleep(0.25)
                continue
            print(json.dumps({"error": "admin_lease_held",
                              "detail": str(e), "lease": e.lease}),
                  flush=True)
            return 3
    if lease.get("took_over"):
        print(f"took over expired admin lease (generation "
              f"{lease['generation']})", flush=True)
    # the heartbeat before the reconcile: reconciling can outlast the TTL
    # (kill graces, health probes), and an unrenewed lease would let a
    # concurrent boot take over mid-reconcile
    manager.start_lease_heartbeat()
    if cfg.get("cold_start"):
        # the operator's opt-out of adoption (`stack start --cold`): kill
        # every recorded survivor and boot from a clean slate
        reaped = manager.reap_stale_services()
        print(f"cold start: reaped {reaped} stale service row(s)",
              flush=True)
    else:
        # crash-only boot: adopt the survivors, crash and respawn the
        # dead, reap the orphans; the rows are the source of truth. Only
        # then the data plane, which is a no-op over an adopted kvd
        recovery = manager.reconcile()
        print("reconciled: "
              f"{recovery['services_adopted']} adopted, "
              f"{recovery['services_crashed']} crashed, "
              f"{recovery['orphans_reaped']} orphans reaped, "
              f"{recovery['kv_adopted']} kvd adopted", flush=True)
    manager.start_data_plane()

    # deterministic chaos: the admin-suicide and data-plane kill timers
    # when RAFIKI_CHAOS asks for them (the "SIGKILL mid-load" drills).
    # The kvd killer takes a CALLABLE pid, so it hits whatever kvd is
    # live when it fires (the supervisor may have respawned it since)
    from rafiki_tpu_torch.chaos import (ChaosConfig, arm_admin_kill,
                                        arm_kvd_kill)

    chaos_cfg = ChaosConfig.from_env()
    if chaos_cfg is not None:
        arm_admin_kill(chaos_cfg)
        arm_kvd_kill(chaos_cfg,
                     lambda: (manager._kv_proc.pid
                              if manager._kv_proc is not None else 0))
    admin = Admin(meta, manager)
    admin.start_monitor()
    app = AdminApp(admin, cfg.get("host", "127.0.0.1"),
                   int(cfg.get("port", 0)))
    host, port = app.start()
    if cfg.get("port_file"):
        with open(cfg["port_file"], "w") as f:
            f.write(str(port))
    print(f"admin on {host}:{port} ({manager.platform}, "
          f"{manager.allocator.n_slots} slots)", flush=True)

    # graceful shutdown: SIGTERM/SIGINT unblock serve_forever so the
    # finally clause stops the monitor, every child service and the kvd
    def _on_term(_signum, _frame):
        app.http.stop()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    try:
        app.http.serve_forever()
    finally:
        app.stop()
        print("admin stopped cleanly", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
