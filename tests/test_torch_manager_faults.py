"""The port's services manager under store faults and operator stops.

- ``degraded_jobs`` drops a job an operator has STOPPED (an ERRORED one
  stays), and so do ``respawn_stats()["degraded_jobs"]`` and the admin's
  ``/health``, as the reference's ``degraded_jobs`` prunes;
- each MetaStore write or read the manager makes while it heals falls
  back as the reference's does when the store raises
  ``sqlite3.OperationalError("database is locked")``: the boot starts
  with fresh budgets, a worker respawn and a kvd respawn count in memory
  (the kvd's also bumps ``kvd_respawns`` and clears the ``data-plane``
  flag), ``_mark_degraded`` keeps its flag, and a queued respawn whose
  replacement runs leaves its job healthy.

Children are the drainable stub of ``tests/test_torch_recovery.py``.
"""

import os
import signal
import sqlite3

import pytest
import torch

from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.app import AdminApp
from rafiki_tpu_torch.constants import ServiceType
from rafiki_tpu_torch.store.meta_store import MetaStore
from test_torch_recovery import (STUB_MODULE, _mgr,  # noqa: F401
                                 _running_inference_job, stub)

torch.set_num_threads(1)


def _locked(*_a, **_k):
    raise sqlite3.OperationalError("database is locked")


def _stub_spec(wd, ij_id, wid):
    return {"module": STUB_MODULE,
            "config": {"worker_id": wid, "drain_linger_s": 0.1,
                       "obs_port_file": str(wd / f"{wid}.obs_port")},
            "service_type": ServiceType.INFERENCE_WORKER,
            "needs_slot": False,
            "meta_kwargs": {"inference_job_id": ij_id}}


def _live(mgr):
    return [s for s in mgr.services.values() if s.alive()]


def test_degraded_jobs_drop_stopped_jobs(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    stopped = _running_inference_job(meta)
    errored = _running_inference_job(meta)
    mgr = _mgr(meta, tmp_path / "wd")
    app = AdminApp(Admin(meta, mgr))
    try:
        for ij in (stopped, errored):
            mgr._mark_degraded(ServiceType.INFERENCE_WORKER, ij["id"],
                               "respawn budget exhausted")
            assert meta.get_inference_job(ij["id"])["status"] == "ERRORED"
        assert set(mgr.degraded_jobs()) == {stopped["id"], errored["id"]}
        meta.update_inference_job(stopped["id"], status="STOPPED")
        assert mgr.respawn_stats()["degraded_jobs"] == 1
        assert set(mgr.degraded_jobs()) == {errored["id"]}
        code, health = app._health(None, None, None)
        assert code == 200
        assert health["degraded"] == {errored["id"]:
                                      "respawn budget exhausted"}
        assert health["degraded_jobs"] == 1
    finally:
        mgr.stop_all()


def test_boot_with_an_unreadable_budget_table(tmp_path, monkeypatch):
    meta = MetaStore(str(tmp_path / "meta.db"))
    meta.incr_respawn_count(ServiceType.INFERENCE_WORKER, "ij-x")
    monkeypatch.setattr(MetaStore, "get_respawn_counts", _locked)
    mgr = _mgr(meta, tmp_path / "wd")
    try:
        assert mgr._respawn_counts == {}
    finally:
        mgr.stop_all()


def test_worker_respawn_counts_in_memory_when_the_store_fails(
        tmp_path, stub, monkeypatch):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    wd = tmp_path / "wd"
    mgr = _mgr(meta, wd)
    lineage = (ServiceType.INFERENCE_WORKER, ij["id"])
    try:
        monkeypatch.setattr(MetaStore, "incr_respawn_count", _locked)
        mgr._degraded[ij["id"]] = "stale"
        assert mgr._respawn("dead-0", _stub_spec(wd, ij["id"], "dw-a"))
        assert mgr._respawn_counts[lineage] == 1
        assert mgr._respawn("dead-1", _stub_spec(wd, ij["id"], "dw-b"))
        assert mgr._respawn_counts[lineage] == 2
        assert len(_live(mgr)) == 2
        assert ij["id"] not in mgr.degraded_jobs()
    finally:
        mgr.stop_all()


def test_queued_respawn_keeps_its_job_healthy_when_the_store_fails(
        tmp_path, stub, monkeypatch):
    """The queued path of the monitor's poll: the replacement runs, so
    the job is not marked degraded although the budget write failed."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    wd = tmp_path / "wd"
    mgr = _mgr(meta, wd)
    try:
        monkeypatch.setattr(MetaStore, "incr_respawn_count", _locked)
        mgr._pending_respawns.append(
            {"dead_id": "dead-q", "spec": _stub_spec(wd, ij["id"], "dw-q")})
        mgr.poll()
        assert not mgr._pending_respawns
        assert len(_live(mgr)) == 1
        assert ij["id"] not in mgr.degraded_jobs()
        assert meta.get_inference_job(ij["id"])["status"] == "RUNNING"
        assert mgr._respawn_counts[
            (ServiceType.INFERENCE_WORKER, ij["id"])] == 1
    finally:
        mgr.stop_all()


def test_kvd_respawn_counts_in_memory_when_the_store_fails(tmp_path,
                                                           monkeypatch):
    meta = MetaStore(str(tmp_path / "meta.db"))
    mgr = _mgr(meta, tmp_path / "wd")
    mgr.start_data_plane()
    try:
        port, pid = mgr.kv_port, mgr._kv_proc.pid
        mgr._degraded["data-plane"] = "kvd respawn failed: earlier"
        monkeypatch.setattr(MetaStore, "incr_respawn_count", _locked)
        os.kill(pid, signal.SIGKILL)
        mgr._kv_proc.wait()
        mgr.poll()
        assert mgr.recovery["kvd_respawns"] == 1
        assert mgr._respawn_counts[(ServiceType.DATA_PLANE, "kvd")] == 1
        assert mgr.kv_port == port and mgr._kv_proc.poll() is None
        assert "data-plane" not in mgr.degraded_jobs()
    finally:
        mgr.stop_all()


@pytest.mark.parametrize("stype", [ServiceType.INFERENCE_WORKER,
                                   ServiceType.TRAIN_WORKER])
def test_mark_degraded_keeps_its_flag_when_the_store_fails(
        tmp_path, monkeypatch, stype):
    meta = MetaStore(str(tmp_path / "meta.db"))
    ij = _running_inference_job(meta)
    mgr = _mgr(meta, tmp_path / "wd")
    try:
        monkeypatch.setattr(MetaStore, "update_inference_job", _locked)
        monkeypatch.setattr(MetaStore, "update_train_job", _locked)
        mgr._mark_degraded(stype, ij["id"], "respawn budget exhausted")
        assert mgr._degraded[ij["id"]] == "respawn budget exhausted"
    finally:
        mgr.stop_all()
