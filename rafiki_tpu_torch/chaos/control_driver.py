"""A minimal REAL control-plane process for admin-kill drills.

The port's own copy of ``rafiki_tpu/chaos/control_driver.py`` (``main``,
``_report``), over the port's ``ServicesManager`` and its kvd.
The crash-recovery machinery (``ServicesManager.reconcile`` + the admin
lease) is exercised in-process by tier-1 tests, but the headline drill —
``kill -9`` the control plane under load, boot a second one, measure
time-to-reconverge — needs an actual process to kill. Booting the full
admin REST app for that means training a model to have something to
serve; this driver is the lighter harness: it builds a
:class:`ServicesManager` on a workdir, acquires the admin lease, starts
the kvd data plane, spawns N drainable dummy services against a RUNNING
inference job, writes a JSON ready-report, then loops ``poll()`` +
lease renewal until killed. A second boot with ``"mode": "reconcile"``
adopts the first driver's survivors and reports what it found.

Run: ``python -m rafiki_tpu_torch.chaos.control_driver --config cfg.json``
with ``{workdir, db_path, n_services, ready_file,
mode: "boot"|"reconcile", lease_ttl_s}``. The recovery drills of
``tests/test_torch_chaos.py`` run it as a process.
"""

from __future__ import annotations

import json
import time
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    import argparse

    from rafiki_tpu_torch.admin.services_manager import (LeaseHeldError,
                                                         ServicesManager)
    from rafiki_tpu_torch.constants import ServiceType
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec
    from rafiki_tpu_torch.store.meta_store import MetaStore

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    t0 = time.monotonic()
    workdir = cfg["workdir"]
    n_services = int(cfg.get("n_services", 2))
    mode = cfg.get("mode", "boot")

    meta = MetaStore(cfg["db_path"])
    # virtual CPU devices: the drill is about process plumbing, not
    # chips — one slot per dummy service
    mgr = ServicesManager(
        meta, workdir, slot_size=1, platform="cpu",
        devices=[DeviceSpec(id=i) for i in range(max(1, n_services))])
    ttl_s = float(cfg.get("lease_ttl_s", 10.0))
    try:
        if mode == "reconcile":
            # restart-after-crash: the dead admin's lease expires one
            # TTL after its last heartbeat — retry like a supervisor
            # would instead of failing fast (the fail-fast path is for
            # DUPLICATE admins; a second live driver keeps renewing and
            # keeps this one out no matter how long we retry)
            deadline = time.monotonic() + ttl_s + 60.0
            while True:
                try:
                    lease = mgr.acquire_lease(ttl_s=ttl_s)
                    break
                except LeaseHeldError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.25)
        else:
            lease = mgr.acquire_lease(ttl_s=ttl_s)
    except LeaseHeldError as e:
        _report(cfg, {"error": "admin_lease_held", "detail": str(e)})
        return 3

    # heartbeat before reconcile, same as the real admin: a reconcile
    # longer than the TTL must not look like a dead holder
    mgr.start_lease_heartbeat()
    report = {"mode": mode, "pid_self": _pid(),
              "lease_generation": lease["generation"],
              "took_over": bool(lease.get("took_over"))}
    if mode == "reconcile":
        recovery = mgr.reconcile()
        report.update(recovery)
        report["adopted_pids"] = sorted(
            s.proc.pid for s in mgr.services.values())
        mgr.start_data_plane()  # no-op when the kvd was adopted
        report["kv_port"] = mgr.kv_port
    else:
        mgr.start_data_plane()
        # one RUNNING inference job to own the dummy "workers" (the
        # reconciler only adopts services whose job is still live)
        user = meta.create_user(f"drill-{_pid()}@chaos", "pw", "ADMIN")
        tj = meta.create_train_job(
            user["id"], f"chaos-drill-{_pid()}", 1,
            "LANGUAGE_MODELING", {"TRIAL_COUNT": 1}, "d1", "d2")
        ij = meta.create_inference_job(user["id"], tj["id"])
        meta.update_inference_job(ij["id"], status="RUNNING")
        pids = []
        for i in range(n_services):
            wid = f"drill-{i}"
            svc = mgr._spawn(
                "rafiki_tpu_torch.chaos.dummy_service",
                {"worker_id": wid, "drain_linger_s": 0.2,
                 "obs_port_file": f"{workdir}/{wid}.obs_port"},
                ServiceType.INFERENCE_WORKER,
                slot=mgr.allocator.acquire(timeout=5.0),
                inference_job_id=ij["id"])
            pids.append(svc.proc.pid)
        # ready only once every dummy wrote its obs port (adoptable)
        deadline = time.monotonic() + 60
        import os.path

        while time.monotonic() < deadline and not all(
                os.path.exists(f"{workdir}/drill-{i}.obs_port")
                for i in range(n_services)):
            time.sleep(0.05)
        report.update({"spawned_pids": sorted(pids),
                       "kv_port": mgr.kv_port,
                       "inference_job_id": ij["id"]})
    report["boot_s"] = round(time.monotonic() - t0, 3)
    _report(cfg, report)
    print(f"control driver ready ({mode}): {report}", flush=True)

    # run until SIGTERM: poll children like the real admin monitor
    # (the lease heartbeat rides its own thread, started above)
    import signal
    import threading

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.wait(0.5):
        if mgr.fenced:
            break  # a newer driver took over
        mgr.poll()
    mgr.stop_all()
    return 0


def _pid() -> int:
    import os

    return os.getpid()


def _report(cfg: dict, report: dict) -> None:
    path = cfg.get("ready_file")
    if path:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        import os

        os.replace(tmp, path)


if __name__ == "__main__":
    raise SystemExit(main())
