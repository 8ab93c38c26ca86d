"""The port's crash-only control plane against the JAX package's.

The cases of ``tests/test_admin_recovery.py`` that need no fault
injection, run on the port's ``ServicesManager`` over port children:

- the service row carries the full spawn recipe and the pid's kernel
  start time; a fresh manager on the same MetaStore adopts every
  survivor (same pids, slots re-reserved, the kvd by ``PING``), crashes
  and respawns the dead under the budget kept in the store, reaps the
  survivors of stopped jobs, never adopts or kills a recycled pid, and
  a cold start reaps instead of adopting; a fenced admin's ``stop_all``
  spares the children the new admin adopted;
- the kvd killed with SIGKILL is respawned by the monitor on its port
  with the WAL replayed (blob and queued messages), and a spent budget
  ends degraded; a rolling restart drains drainable port children
  through their obs sidecars and replaces them one at a time;
- the online backup (the store, ``/system/backup``, the CLI), and a
  backup made by either package opens in the other's MetaStore; the
  doctor's drift audit, equal to the JAX doctor's on one workdir;
- the admin's ``main`` in a subprocess, killed with SIGKILL and started
  again: it reconciles before it boots the data plane, so exactly one
  kvd serves (the recorded one) and no row stays RUNNING for a dead pid;
- a Llama stream through the port's Predictor and worker while the
  admin dies: the restarted admin adopts the kvd and the stream ends
  token-exact against the JAX engine's no-fault tokens; a concurrent
  admin is fenced.

The drainable children are a stub on the port's HTTP kit (its obs
sidecar's ``/health`` and ``/drain`` only), written to the test's
directory: the process plumbing needs no model.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from rafiki_tpu.admin.doctor import audit_workdir as jaudit_workdir
from rafiki_tpu.store.meta_store import MetaStore as JMetaStore
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.app import AdminApp
from rafiki_tpu_torch.admin.doctor import audit_workdir, render_text
from rafiki_tpu_torch.admin.proc import (AdoptedProcess, identity_matches,
                                         proc_start_time)
from rafiki_tpu_torch.admin.services_manager import (AdminFencedError,
                                                     LeaseHeldError,
                                                     ServicesManager)
from rafiki_tpu_torch.cli import main as cli_main
from rafiki_tpu_torch.client import Client
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType
from rafiki_tpu_torch.native.client import KVClient
from rafiki_tpu_torch.parallel.mesh import DeviceSpec
from rafiki_tpu_torch.serving.queues import (KVQueueHub, pack_message,
                                             unpack_message)
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.utils.http import HttpStatusError, json_request

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

#: a drainable child on the port's HTTP kit: it writes its port to
#: obs_port_file, answers GET /health and POST /drain, and exits 0
#: drain_linger_s after a drain (the JAX package's chaos/dummy_service)
STUB = '''
import argparse
import json
import threading

from rafiki_tpu_torch.utils.http import JsonHttpService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    with open(ap.parse_args().config) as f:
        cfg = json.load(f)
    done = threading.Event()

    def drain(_m, _b, _h):
        threading.Timer(max(0.05, float(cfg.get("drain_linger_s", 0))),
                        done.set).start()
        return 200, {"ok": True, "draining": True}

    http = JsonHttpService("127.0.0.1", 0)
    http.route("POST", "/drain", drain)
    http.route("GET", "/health", lambda _m, _b, _h: (200, {"ok": True}))
    _, port = http.start()
    with open(cfg["obs_port_file"], "w") as f:
        f.write(str(port))
    done.wait()
    http.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
'''

#: the stub's module name: "rafiki" in its command line, as the
#: identity check requires of every service the admin adopts or kills
STUB_MODULE = "rafiki_stub_worker"


@pytest.fixture()
def stub(tmp_path, monkeypatch):
    """The stub's module on the children's PYTHONPATH."""
    d = tmp_path / "stubs"
    d.mkdir()
    (d / f"{STUB_MODULE}.py").write_text(STUB)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(d), os.environ.get("PYTHONPATH")) if p))
    return d


def _mgr(meta, path, n_devices=2):
    return ServicesManager(meta, str(path), slot_size=1, platform="cpu",
                           devices=[DeviceSpec(id=i)
                                    for i in range(n_devices)])


def _running_inference_job(meta):
    user = meta.create_user(f"op{time.time_ns()}@x", "pw", "ADMIN")
    tj = meta.create_train_job(user["id"], f"app{time.time_ns()}", 1,
                               "LANGUAGE_MODELING", {"TRIAL_COUNT": 1},
                               "d1", "d2")
    ij = meta.create_inference_job(user["id"], tj["id"])
    meta.update_inference_job(ij["id"], status="RUNNING")
    return ij


def _spawn_stub(mgr, wd, ij_id, wid, slot=True):
    return mgr._spawn(
        STUB_MODULE,
        {"worker_id": wid, "drain_linger_s": 0.2,
         "obs_port_file": str(Path(wd) / f"{wid}.obs_port")},
        ServiceType.INFERENCE_WORKER,
        slot=mgr.allocator.acquire(timeout=5.0) if slot else None,
        inference_job_id=ij_id)


def _wait_ports(wd, wids, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all((Path(wd) / f"{w}.obs_port").exists() for w in wids):
            return
        time.sleep(0.05)
    raise TimeoutError(f"obs ports never appeared for {wids}")


def _dead_pid():
    proc = subprocess.Popen(["/bin/true"])
    proc.wait()
    return proc.pid


# ---- durable spawn state, adoption, crash and respawn, orphans

def test_spawn_records_durable_state(tmp_path, stub):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr = _mgr(meta, tmp_path / "wd")
    try:
        svc = _spawn_stub(mgr, tmp_path / "wd", ij["id"], "dw-0")
        row = meta.get_service(svc.service_id)
        spec = row["spawn_spec"]
        assert spec["module"] == STUB_MODULE
        assert spec["service_type"] == ServiceType.INFERENCE_WORKER
        assert spec["needs_slot"] is True
        assert spec["config"]["worker_id"] == "dw-0"
        assert spec["meta_kwargs"]["inference_job_id"] == ij["id"]
        assert row["start_time"] == proc_start_time(svc.proc.pid) > 0
        assert identity_matches(svc.proc.pid, row["start_time"])
        mgr.start_data_plane()
        kv_row = meta.get_service(mgr._kv_service_id)
        assert kv_row["start_time"] == proc_start_time(
            mgr._kv_proc.pid) > 0
        assert kv_row["spawn_spec"]["service_type"] == \
            ServiceType.DATA_PLANE
        assert kv_row["spawn_spec"]["config"]["data_dir"] == str(
            tmp_path / "wd" / "kvd-data")
    finally:
        mgr.stop_all()


def test_worker_spawn_configs_name_their_obs_port_file(tmp_path):
    """An inference worker's config carries ``workdir/<worker
    id>.obs_port``, as the JAX manager writes it (a train worker's:
    ``tests/test_torch_admin.py``'s toy job)."""
    from test_torch_admin import _lm_job

    meta = MetaStore(str(tmp_path / "meta.db"))
    mgr = _mgr(meta, tmp_path / "wd")
    _job, _m, trials = _lm_job(meta)
    cfg = mgr._inference_worker_config("ij12345678", 1, trials[0], {})
    assert cfg["worker_id"] == "iw-ij123456-1"
    assert cfg["obs_port_file"] == str(tmp_path / "wd" /
                                       "iw-ij123456-1.obs_port")


def test_reconcile_adopts_live_services_and_kv(tmp_path, stub):
    """A manager abandoned with its children running: a fresh one on the
    same store adopts every survivor (same pids, slots re-reserved, the
    kvd adopted, healing re-armed), and a rolling restart works over the
    adopted handles."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr1 = _mgr(meta, tmp_path / "wd")
    mgr1.start_data_plane()
    kv_pid = mgr1._kv_proc.pid
    old = [_spawn_stub(mgr1, tmp_path / "wd", ij["id"], f"dw-{i}")
           for i in range(2)]
    _wait_ports(tmp_path / "wd", ["dw-0", "dw-1"])
    old_pids = sorted(s.proc.pid for s in old)

    mgr2 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "wd")
    try:
        rec = mgr2.reconcile()
        assert (rec["services_adopted"], rec["kv_adopted"],
                rec["services_crashed"]) == (2, 1, 0)
        assert rec["last_recovery_at"] > 0
        assert sorted(s.proc.pid for s in mgr2.services.values()) == \
            old_pids
        assert all(s.adopted and s.alive()
                   for s in mgr2.services.values())
        assert mgr2.allocator.free_count() == 0
        assert mgr2.kv_port == mgr1.kv_port and \
            mgr2._kv_proc.pid == kv_pid
        assert set(mgr2._respawn_specs) == {s.service_id for s in old}
        mgr2.start_data_plane()  # a no-op over the adopted kvd
        assert mgr2._kv_proc.pid == kv_pid
        out = mgr2.rolling_restart(ij["id"], drain_timeout=30.0)
        assert len(out["restarted"]) == 2
        assert all(r["drained"] for r in out["restarted"])
        assert all(s.alive() for s in mgr2.services.values())
        assert mgr2.respawn_stats()["rolling_restarts_done"] == 2
    finally:
        mgr2.stop_all()
    assert not identity_matches(kv_pid, 0)


def test_reconcile_respawns_crashed_under_persisted_budget(tmp_path, stub):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    wd = tmp_path / "wd"
    wd.mkdir()

    def dead_worker_row(wid):
        spec = {"module": STUB_MODULE,
                "config": {"worker_id": wid, "drain_linger_s": 0.1,
                           "obs_port_file": str(wd / f"{wid}.obs_port")},
                "service_type": ServiceType.INFERENCE_WORKER,
                "needs_slot": False,
                "meta_kwargs": {"inference_job_id": ij["id"]}}
        row = meta.create_service(
            ServiceType.INFERENCE_WORKER, inference_job_id=ij["id"],
            pid=_dead_pid(), spawn_spec=spec, start_time=123.0)
        meta.update_service(row["id"], status=ServiceStatus.RUNNING)
        return row

    meta.incr_respawn_count(ServiceType.INFERENCE_WORKER, ij["id"])
    row = dead_worker_row("dw-r")
    mgr = _mgr(meta, wd)
    mgr.max_respawns = 2
    try:
        rec = mgr.reconcile()
        assert rec["services_crashed"] == 1
        assert meta.get_service(row["id"])["status"] == \
            ServiceStatus.CRASHED
        live = [s for s in mgr.services.values() if s.alive()]
        assert len(live) == 1
        lineage = f"{ServiceType.INFERENCE_WORKER}:{ij['id']}"
        assert meta.get_respawn_counts()[lineage] == 2

        for s in live:
            s.proc.terminate()
            s.proc.wait(timeout=10)
        meta2 = MetaStore(str(tmp_path / "meta.db"))
        row2 = dead_worker_row("dw-r2")
        mgr2 = _mgr(meta2, wd)
        mgr2.max_respawns = 2
        try:
            assert mgr2.reconcile()["services_crashed"] >= 1
            assert not [s for s in mgr2.services.values()
                        if s.service_type == ServiceType.INFERENCE_WORKER
                        and s.alive()]
            assert ij["id"] in mgr2.degraded_jobs()
            assert meta2.get_service(row2["id"])["status"] == \
                ServiceStatus.CRASHED
        finally:
            mgr2.stop_all()
    finally:
        mgr.stop_all()


def test_reconcile_reaps_orphans_of_stopped_jobs(tmp_path, stub):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr1 = _mgr(meta, tmp_path / "wd")
    svc = _spawn_stub(mgr1, tmp_path / "wd", ij["id"], "dw-orph")
    _wait_ports(tmp_path / "wd", ["dw-orph"])
    meta.update_inference_job(ij["id"], status="STOPPED")

    mgr2 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "wd")
    try:
        rec = mgr2.reconcile()
        assert (rec["orphans_reaped"], rec["services_adopted"]) == (1, 0)
        assert meta.get_service(svc.service_id)["status"] == \
            ServiceStatus.STOPPED
        svc.proc.wait(timeout=10)
        assert not mgr2.services and mgr2.allocator.free_count() == 2
    finally:
        mgr2.stop_all()


def test_pid_recycle_guard_start_time(tmp_path, stub):
    """A live pid whose recorded start time differs is a recycled pid:
    neither adopted nor killed, its row CRASHED."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr1 = _mgr(meta, tmp_path / "wd")
    svc = _spawn_stub(mgr1, tmp_path / "wd", ij["id"], "dw-rec",
                      slot=False)
    _wait_ports(tmp_path / "wd", ["dw-rec"])
    meta.update_service(svc.service_id, start_time=1.0, spawn_spec=None)
    try:
        mgr2 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "wd")
        rec = mgr2.reconcile()
        assert rec["services_adopted"] == 0 and rec["services_crashed"] >= 1
        assert meta.get_service(svc.service_id)["status"] == \
            ServiceStatus.CRASHED
        assert svc.alive()
        ap = AdoptedProcess(svc.proc.pid, start_time=1.0)
        assert ap.poll() == AdoptedProcess.ADOPTED_EXIT
        ap.kill()
        assert svc.alive()
        mgr2.stop_all()
    finally:
        mgr1.stop_all()


def test_cold_start_reaps_instead_of_adopting(tmp_path, stub, capsys):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr1 = _mgr(meta, tmp_path / "wd")
    svc = _spawn_stub(mgr1, tmp_path / "wd", ij["id"], "dw-cold")
    _wait_ports(tmp_path / "wd", ["dw-cold"])

    mgr2 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "wd")
    try:
        assert mgr2.reap_stale_services() >= 1
        svc.proc.wait(timeout=10)
        assert meta.get_service(svc.service_id)["status"] == \
            ServiceStatus.STOPPED
        assert not mgr2.services
        with pytest.raises(SystemExit) as ei:
            cli_main(["stack", "--help"])
        assert ei.value.code == 0
        assert "--cold" in capsys.readouterr().out
    finally:
        mgr2.stop_all()
        mgr1.stop_all()


def test_fenced_stop_all_spares_adopted_children(tmp_path, stub):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr1 = _mgr(meta, tmp_path / "wd")
    mgr1.acquire_lease(ttl_s=30.0)
    svc = _spawn_stub(mgr1, tmp_path / "wd", ij["id"], "dw-f")
    _wait_ports(tmp_path / "wd", ["dw-f"])

    mgr2 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "wd")
    meta.release_admin_lease(mgr1.lease_holder)
    mgr2.acquire_lease(ttl_s=30.0)
    try:
        assert mgr2.reconcile()["services_adopted"] == 1
        assert mgr1.renew_lease() is False
        for call in (lambda: mgr1.rolling_restart(ij["id"]),
                     mgr1.start_data_plane):
            with pytest.raises(AdminFencedError):
                call()
        mgr1.stop_all()
        time.sleep(0.2)
        assert svc.alive(), "the fenced admin killed an adopted child"
        assert mgr2.services and all(s.alive()
                                     for s in mgr2.services.values())
    finally:
        mgr2.stop_all()
    svc.proc.wait(timeout=10)
    assert not identity_matches(svc.proc.pid, 0)


# ---- rolling restart, kvd supervision

def test_rolling_restart_drains_and_replaces_port_children(tmp_path, stub):
    """Each worker is drained through its sidecar, exits 0 and is
    replaced one at a time; slots are conserved and the counter moves."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr = _mgr(meta, tmp_path / "wd")
    try:
        old = [_spawn_stub(mgr, tmp_path / "wd", ij["id"], f"dw-{i}")
               for i in range(2)]
        _wait_ports(tmp_path / "wd", ["dw-0", "dw-1"])
        out = mgr.rolling_restart(ij["id"], drain_timeout=30.0)
        assert len(out["restarted"]) == 2 and out["job_id"] == ij["id"]
        live = [s for s in mgr.services.values()
                if s.service_type == ServiceType.INFERENCE_WORKER]
        assert len(live) == 2 and all(s.alive() for s in live)
        assert not ({s.service_id for s in old}
                    & {s.service_id for s in live})
        assert all(s.proc.returncode == 0 for s in old)
        assert all(meta.get_service(s.service_id)["status"] ==
                   ServiceStatus.STOPPED for s in old)
        assert mgr.respawn_stats()["rolling_restarts_done"] == 2
        assert mgr.allocator.free_count() == 0
        with pytest.raises(KeyError):
            mgr.rolling_restart("no-such-job")
        assert mgr._rolling_lock.acquire(blocking=False)
        try:
            with pytest.raises(RuntimeError, match="already in progress"):
                mgr.rolling_restart(ij["id"])
        finally:
            mgr._rolling_lock.release()
    finally:
        mgr.stop_all()


def test_kvd_kill9_respawns_on_its_port_with_replay(tmp_path):
    """SIGKILL on the kvd: the monitor's next poll respawns it on the
    recorded port, and the WAL restores the blob and the queued
    messages; the budget is written to the store."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    mgr = _mgr(meta, tmp_path / "wd")
    mgr.start_data_plane()
    try:
        host, port, pid = mgr.kv_host, mgr.kv_port, mgr._kv_proc.pid
        old_row = mgr._kv_service_id
        blob = os.urandom(1 << 20)
        c = KVClient(host, port)
        c.set("params:t0", blob)
        c.close()
        hub = KVQueueHub(host, port)
        for i in range(3):
            hub.push_query("w0", pack_message({"id": f"q{i}"}))
        os.kill(pid, signal.SIGKILL)
        mgr._kv_proc.wait()
        mgr.poll()
        assert mgr.recovery["kvd_respawns"] == 1
        assert (mgr.kv_host, mgr.kv_port) == (host, port)
        assert mgr._kv_proc.pid != pid and mgr._kv_proc.poll() is None
        assert meta.get_service(old_row)["status"] == ServiceStatus.CRASHED
        assert meta.get_service(mgr._kv_service_id)["status"] == \
            ServiceStatus.RUNNING
        assert meta.get_respawn_counts()[
            f"{ServiceType.DATA_PLANE}:kvd"] == 1
        c = KVClient(host, port)
        assert c.get("params:t0") == blob
        c.close()
        got = [unpack_message(hub.pop_query("w0", 5.0))["id"]
               for _ in range(3)]
        assert got == ["q0", "q1", "q2"]
        status = mgr.data_plane_status()
        assert status["up"] and status["respawns"] == 1
        assert status["replay_seconds"] >= 0.0
        assert "data-plane" not in mgr.degraded_jobs()
    finally:
        mgr.stop_all()


def test_kvd_respawn_budget_exhausted_marks_degraded(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    meta.incr_respawn_count(ServiceType.DATA_PLANE, "kvd")
    mgr = _mgr(meta, tmp_path / "wd")
    mgr.max_respawns = 1
    mgr.start_data_plane()
    pid = mgr._kv_proc.pid
    try:
        os.kill(pid, signal.SIGKILL)
        mgr._kv_proc.wait()
        mgr.poll()
        assert mgr.recovery["kvd_respawns"] == 0
        assert mgr.degraded_jobs()["data-plane"] == \
            "kvd respawn budget exhausted"
        assert mgr._kv_proc is None
        mgr.poll()  # the corpse is no longer supervised
        assert mgr.recovery["kvd_respawns"] == 0
    finally:
        mgr.stop_all()


# ---- backup

def test_metastore_backup_online_and_admin_route(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    user = meta.create_user("u@x", "pw", "ADMIN")
    tj = meta.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                               {"TRIAL_COUNT": 1}, "d1", "d2")
    out = meta.backup(str(tmp_path / "snap.db"))
    assert out["bytes"] > 0 and out["path"] == str(tmp_path / "snap.db")
    copy = MetaStore(str(tmp_path / "snap.db"))
    assert copy.get_train_job(tj["id"])["app"] == "app"
    assert copy.get_user_by_email("u@x") is not None
    mem = MetaStore(":memory:")
    mem.create_user("m@x", "pw", "ADMIN")
    assert mem.backup(str(tmp_path / "mem.db"))["bytes"] > 0
    assert MetaStore(str(tmp_path / "mem.db")).get_user_by_email("m@x")

    app = AdminApp(Admin(meta, _mgr(meta, tmp_path / "wd", n_devices=1)))
    host, port = app.start()
    try:
        c = Client(f"http://{host}:{port}")
        c.login("superadmin@rafiki", "rafiki")
        got = c.backup(str(tmp_path / "snap2.db"))
        assert got["ok"] and got["bytes"] > 0
        assert MetaStore(str(tmp_path / "snap2.db")).get_train_job(
            tj["id"]) is not None
        c.create_user("dev@x", "pw", "APP_DEVELOPER")
        c2 = Client(f"http://{host}:{port}")
        c2.login("dev@x", "pw")
        with pytest.raises(HttpStatusError) as ei:
            c2.backup(str(tmp_path / "nope.db"))
        assert ei.value.status == 403
        with pytest.raises(HttpStatusError) as ei:
            c._call("POST", "/system/backup", {})
        assert ei.value.status == 400
    finally:
        app.stop()


def test_backup_cli(tmp_path, capsys):
    wd = tmp_path / "stack"
    wd.mkdir()
    MetaStore(str(wd / "meta.db")).create_user("u@x", "pw", "ADMIN")
    assert cli_main(["backup", str(tmp_path / "out.db"),
                     "--workdir", str(wd)]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["ok"] and rep["bytes"] > 0
    assert MetaStore(str(tmp_path / "out.db")).get_user_by_email("u@x")
    assert cli_main(["backup", str(tmp_path / "o2.db"),
                     "--workdir", str(tmp_path / "nowhere")]) == 1
    # the read-only open refuses writes
    ro = MetaStore(str(wd / "meta.db"), read_only=True)
    with pytest.raises(Exception, match="readonly"):
        ro.create_user("v@x", "pw", "ADMIN")


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_backups_open_across_packages(tmp_path, writer, reader):
    stores = {"port": MetaStore, "jax": JMetaStore}
    meta = stores[writer](str(tmp_path / "meta.db"))
    user = meta.create_user("u@x", "pw", "ADMIN")
    tj = meta.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                               {"TRIAL_COUNT": 2}, "d1", "d2")
    svc = meta.create_service(ServiceType.DATA_PLANE, pid=7,
                              spawn_spec={"module": "rafiki-kvd"},
                              start_time=3.0)
    out = meta.backup(str(tmp_path / "snap.db"))
    copy = stores[reader](str(tmp_path / "snap.db"))
    assert copy.get_train_job(tj["id"])["budget"] == {"TRIAL_COUNT": 2}
    assert copy.authenticate_user("u@x", "pw")["id"] == user["id"]
    row = copy.get_service(svc["id"])
    assert (row["pid"], row["start_time"], row["spawn_spec"]) == (
        7, 3.0, {"module": "rafiki-kvd"})
    assert out["bytes"] == os.path.getsize(tmp_path / "snap.db")


# ---- doctor

def _drifted_workdir(tmp_path, mgr, meta, ij):
    """One live stub; then a RUNNING row whose pid is dead, a STOPPED row
    whose process lives, and an obs_port file nothing listens on."""
    svc = _spawn_stub(mgr, tmp_path, ij["id"], "dw-a")
    _wait_ports(tmp_path, ["dw-a"])
    clean = audit_workdir(str(tmp_path))
    r1 = meta.create_service(ServiceType.INFERENCE_WORKER,
                             inference_job_id=ij["id"], pid=_dead_pid(),
                             start_time=5.0)
    meta.update_service(r1["id"], status=ServiceStatus.RUNNING)
    row = meta.get_service(svc.service_id)
    meta.update_service(svc.service_id, status=ServiceStatus.STOPPED)
    (tmp_path / "ghost.obs_port").write_text("1")
    return svc, row, clean


def test_doctor_workdir_audit_reports_drift(tmp_path, stub, capsys):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr = _mgr(meta, tmp_path)
    try:
        svc, row, clean = _drifted_workdir(tmp_path, mgr, meta, ij)
        assert clean["ok"] and clean["drift"] == []
        entry = next(s for s in clean["services"]
                     if s["id"] == svc.service_id)
        assert entry["pid_alive"] and entry["identity_ok"]
        assert entry["probe_ok"]
        assert "no drift" in render_text(clean)
        rep = audit_workdir(str(tmp_path))
        assert not rep["ok"]
        text = "\n".join(rep["drift"])
        assert "dead" in text
        assert "still alive (orphaned process)" in text
        assert "ghost.obs_port" in text
        assert cli_main(["doctor", "--workdir", str(tmp_path),
                         "--json"]) == 1
        assert json.loads(capsys.readouterr().out)["drift"] == rep["drift"]
        assert cli_main(["doctor", "--workdir", str(tmp_path)]) == 1
        assert "DRIFT" in capsys.readouterr().out
        meta.update_service(svc.service_id, status=row["status"])
    finally:
        mgr.stop_all()


def test_doctor_reports_equal_across_packages(tmp_path, stub):
    """One drifted workdir with a live kvd: the port's audit equals the
    JAX package's, finding for finding and service by service."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr = _mgr(meta, tmp_path)
    mgr.acquire_lease(ttl_s=30.0)
    mgr.start_data_plane()
    try:
        c = KVClient(mgr.kv_host, mgr.kv_port)
        c.set("params:t0", b"blob")
        c.rpush("q", b"m1", b"m2")
        c.close()
        svc, row, _clean = _drifted_workdir(tmp_path, mgr, meta, ij)
        got, want = audit_workdir(str(tmp_path)), \
            jaudit_workdir(str(tmp_path))
        for rep in (got, want):
            rep.pop("checked_at")
            rep["lease"].pop("heartbeat_age_s")
            for k in ("last_fsync_age_s", "snapshot_age_s"):
                rep["data_plane"].pop(k)
        assert got == want
        assert not got["ok"] and len(got["drift"]) == 3
        assert got["data_plane"]["reachable"]
        assert got["data_plane"]["replay"]["restored_queued_msgs"] == 2
        meta.update_service(svc.service_id, status=row["status"])
    finally:
        mgr.stop_all()


# ---- the admin process: SIGKILL and restart

def _start_admin(work, **extra):
    cfg = {"workdir": str(work), "db_path": str(work / "meta.db"),
           "host": "127.0.0.1", "port": 0, "platform": "cpu",
           "cpu_slots": 2, "port_file": str(work / "admin.port"),
           "lease_ttl_s": 1.0, **extra}
    (work / "admin.port").unlink(missing_ok=True)
    (work / "admin.json").write_text(json.dumps(cfg))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    log = open(work / "admin.log", "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rafiki_tpu_torch.admin.app", "--config",
         str(work / "admin.json")], stdout=log, stderr=subprocess.STDOUT,
        env=env, start_new_session=True)
    log.close()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if (work / "admin.port").exists() and \
                (work / "admin.port").read_text().strip():
            return proc
        assert proc.poll() is None, (work / "admin.log").read_text()[-3000:]
        time.sleep(0.1)
    proc.kill()
    raise AssertionError("admin did not come up")


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


def _kvd_pids(work):
    """Live kvd processes serving ``work``'s data dir."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if cmd and cmd[0].endswith(b"rafiki-kvd") and \
                str(work / "kvd-data").encode() in cmd and _alive(d.name):
            out.append(int(d.name))
    return out


def _stop_admin(proc, work):
    os.kill(proc.pid, signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    assert not _kvd_pids(work)


def test_restarted_admin_adopts_the_surviving_kvd(tmp_path, stub):
    """An admin killed with SIGKILL leaves its kvd and its children
    running. The restarted admin's ``main`` reconciles before it boots
    the data plane: exactly one kvd serves the data dir (the recorded
    pid, answering on the recorded port), the child is adopted, and no
    row stays RUNNING for a dead pid. (The admin that booted a second
    kvd over the same WAL directory failed this.)"""
    proc = _start_admin(tmp_path)
    meta = MetaStore(str(tmp_path / "meta.db"))
    kv_row = next(r for r in meta.get_services("RUNNING")
                  if r["service_type"] == ServiceType.DATA_PLANE)
    ij = _running_inference_job(meta)
    # a child of the dead admin, recorded as it records its own
    mgr = _mgr(meta, tmp_path)
    child = _spawn_stub(mgr, tmp_path, ij["id"], "dw-k", slot=False)
    _wait_ports(tmp_path, ["dw-k"])
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=10)
    assert _kvd_pids(tmp_path) == [kv_row["pid"]]

    proc2 = _start_admin(tmp_path)
    try:
        assert _kvd_pids(tmp_path) == [kv_row["pid"]]
        url = f"http://127.0.0.1:{(tmp_path / 'admin.port').read_text()}"
        health = json_request("GET", f"{url}/health", timeout=10)
        assert health["recovery"]["kv_adopted"] == 1
        assert health["recovery"]["services_adopted"] == 1
        assert health["recovery"]["lease_takeovers"] == 1
        assert health["data_plane"]["port"] == kv_row["port"]
        assert health["data_plane"]["up"]
        rows = MetaStore(str(tmp_path / "meta.db")).get_services()
        live = [r for r in rows if r["status"] == "RUNNING"]
        assert {r["pid"] for r in live} == {kv_row["pid"], child.proc.pid}
        assert all(_alive(r["pid"]) for r in live)
        assert "reconciled: 1 adopted, 0 crashed, 0 orphans reaped, " \
               "1 kvd adopted" in (tmp_path / "admin.log").read_text()
    finally:
        _stop_admin(proc2, tmp_path)
    child.proc.wait(timeout=10)
    assert meta.get_service(kv_row["id"])["status"] == "STOPPED"


def test_restart_reaps_stale_rows(tmp_path):
    """``tests/test_stack_shutdown.py``'s restart on the port's admin: a
    cold start after SIGKILL reaps every stale row (the old kvd
    included) and only the new admin's children are live."""
    proc = _start_admin(tmp_path)
    meta = MetaStore(str(tmp_path / "meta.db"))
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=10)
    stale = [r for r in meta.get_services()
             if r["status"] not in ("STOPPED", "ERRORED")]
    assert stale, "SIGKILL should have left stale rows"
    proc2 = _start_admin(tmp_path, cold_start=True)
    try:
        rows = MetaStore(str(tmp_path / "meta.db")).get_services()
        for r in stale:
            row = next(x for x in rows if x["id"] == r["id"])
            assert row["status"] == "STOPPED" and not _alive(r["pid"])
        live = [r for r in rows if r["status"] not in ("STOPPED",
                                                       "ERRORED")]
        assert len(live) == 1 and all(_alive(r["pid"]) for r in live)
        assert _kvd_pids(tmp_path) == [live[0]["pid"]]
        assert "cold start: reaped 1 stale service row(s)" in \
            (tmp_path / "admin.log").read_text()
    finally:
        _stop_admin(proc2, tmp_path)


# ---- the Llama drill

class _PacedHub:
    """Delays every reply push, so a 6-token stream spans the admin's
    death, the lease takeover and the reconcile. Timing only: the
    replies' content is untouched."""

    def __init__(self, hub, delay_s):
        self._hub, self._delay = hub, delay_s

    def push_prediction(self, *a, **kw):
        time.sleep(self._delay)
        return self._hub.push_prediction(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._hub, name)


def test_admin_kill_mid_stream_zero_drop_llama(trained_lm, tmp_path):
    """The control plane dies with a stream in flight through the port's
    Predictor and worker, over the kvd it booted. The restarted admin
    adopts that kvd (same pid) and the stream ends token-exact against
    the JAX engine's no-fault tokens: nothing dropped, nothing
    duplicated. A concurrent third admin is fenced the whole time."""
    from test_decode_engine import KNOBS
    from test_torch_worker import _port_store

    from rafiki_tpu.store.param_store import ParamStore as JParamStore
    from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    prompt, max_new = "tok1 tok2 tok3", 6
    eng = trained_lm.make_decode_engine(max_slots=4,
                                        max_new_tokens=max_new)
    eng.submit("r", prompt)
    expected = None
    for _ in range(200):
        eng.step()
        done = dict(eng.poll())
        if "r" in done:
            expected = done["r"]
            break
    assert expected and len(expected.split(" ")) == max_new

    jstore = JParamStore.from_uri("mem://")
    jstore.save("t0", trained_lm.dump_parameters())
    store = _port_store(jstore.backend.get("t0"))

    meta = MetaStore(str(tmp_path / "meta.db"))
    mgr1 = _mgr(meta, tmp_path / "wd")
    mgr1.acquire_lease(ttl_s=1.0)
    mgr1.start_lease_heartbeat()
    mgr1.start_data_plane()
    kv_pid = mgr1._kv_proc.pid
    hub = KVQueueHub(mgr1.kv_host, mgr1.kv_port)
    w = InferenceWorker(LlamaLoRA, "t0", KNOBS, store,
                        _PacedHub(hub, 0.6), "w0", decode_loop=True,
                        max_slots=4, max_new_tokens=max_new,
                        steps_per_sync=1, kv_page_size=8, device="cpu")
    th = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.05},
                          daemon=True)
    th.start()
    events = []

    def collect():
        pred = Predictor(KVQueueHub(mgr1.kv_host, mgr1.kv_port), ["w0"],
                         gather_timeout=120.0)
        for ev in pred.predict_stream([prompt], timeout=120.0):
            events.append(ev)

    t = threading.Thread(target=collect, daemon=True)
    t.start()
    mgr2 = mgr3 = None
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not events:
            time.sleep(0.01)
        assert events, "the stream never started"
        # the admin dies: no stop_all, its heartbeat silenced
        mgr1._stop_lease_heartbeat()
        t_kill = time.monotonic()
        mgr2 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "wd")
        while True:
            try:
                lease = mgr2.acquire_lease(ttl_s=30.0)
                break
            except LeaseHeldError:
                assert time.monotonic() - t_kill < 30
                time.sleep(0.05)
        assert lease["took_over"] and lease["generation"] == 2
        rec = mgr2.reconcile()
        assert (rec["kv_adopted"], rec["services_crashed"]) == (1, 0)
        assert mgr2._kv_proc.pid == kv_pid
        n_at_recovery = len(events)
        mgr3 = _mgr(MetaStore(str(tmp_path / "meta.db")), tmp_path / "w3")
        with pytest.raises(LeaseHeldError):
            mgr3.acquire_lease(ttl_s=30.0)
        t.join(timeout=120)
        assert not t.is_alive(), "the stream never finished"
        final = events[-1]
        assert final.get("done") and "error" not in final, final
        acc = "".join(v for e in events[:-1]
                      for v in e.get("delta", {}).values())
        assert final["predictions"] == [expected]
        assert acc == expected
        assert 0 < n_at_recovery < len(events)
    finally:
        w.stop()
        th.join(timeout=30)
        if mgr2 is not None:
            mgr2.stop_all()
        else:
            mgr1.stop_all()
    assert not identity_matches(kv_pid, 0)
