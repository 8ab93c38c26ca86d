"""Workdir drift audit: MetaStore rows against live pids, slots and ports.

The port's own copy of ``rafiki_tpu/admin/doctor.py`` (``audit_workdir``,
``render_text``, ``_audit_data_plane``, ``_devices``, ``_probe_port``,
``_http_alive``). ``python -m rafiki_tpu_torch.cli doctor --workdir W``
compares the four places control-plane state lives: the MetaStore's
``services`` rows, the process table (``/proc``, each pid checked against
its recorded kernel start time), the recorded device slots and the
``*.obs_port`` sidecar files, and prints every disagreement as a drift
finding. No drift means the recorded world matches the real one: what an
operator needs to see before trusting a restarted control plane.

Read-only: the audit never signals, spawns or writes (the MetaStore is
opened ``mode=ro``), so it is safe against a live stack.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.admin.proc import identity_matches, pid_alive

#: row states that claim a live process
_LIVE_STATES = ("STARTED", "RUNNING")


def audit_workdir(workdir: str,
                  db_path: Optional[str] = None) -> Dict[str, Any]:
    """Audit ``workdir`` and return the drift report (JSON-ready).

    ``report["drift"]`` is the flat list of human-readable findings;
    ``report["ok"]`` is True iff it is empty. Per-service detail rows
    live under ``report["services"]``.
    """
    wd = Path(workdir)
    db = Path(db_path) if db_path else wd / "meta.db"
    report: Dict[str, Any] = {
        "workdir": str(wd), "db_path": str(db), "checked_at": time.time(),
        "services": [], "drift": [], "ok": True}
    drift: List[str] = report["drift"]
    if not db.exists():
        drift.append(f"no MetaStore at {db} — nothing to audit against")
        report["ok"] = False
        return report

    from rafiki_tpu_torch.store.meta_store import MetaStore

    # mode=ro connection: the audit must be INCAPABLE of writing (or
    # schema-migrating) a live stack's database, not merely polite
    meta = MetaStore(str(db), read_only=True)
    rows = meta.get_services()
    claimed_ports: set = set()
    device_owners: Dict[int, str] = {}
    for row in rows:
        pid = int(row.get("pid") or 0)
        start_time = float(row.get("start_time") or 0)
        spec = row.get("spawn_spec") or {}
        status = row["status"]
        alive = pid_alive(pid) if pid > 0 else False
        ident = identity_matches(pid, start_time) if alive else False
        entry = {
            "id": row["id"], "service_type": row["service_type"],
            "status": status, "pid": pid, "pid_alive": alive,
            "identity_ok": ident, "start_time": start_time,
            "port": int(row.get("port") or 0),
            "devices": _devices(row), "has_spawn_spec": bool(spec)}
        label = f"{row['service_type']} {row['id'][:8]}"
        if status in _LIVE_STATES:
            if not ident:
                drift.append(
                    f"{label}: row is {status} but pid {pid} is "
                    + ("a DIFFERENT process (identity mismatch — "
                       "recycled pid?)" if alive else "dead"))
            else:
                # live and ours: check its recorded probe channel and
                # claim its devices for the double-booking check
                port = _probe_port(row, spec, wd)
                entry["probe_port"] = port
                if port:
                    claimed_ports.add(port)
                    entry["probe_ok"] = _http_alive(
                        row.get("host") or "127.0.0.1", port)
                    if not entry["probe_ok"]:
                        drift.append(
                            f"{label}: pid {pid} is alive but port "
                            f"{port} does not answer")
                for dev in entry["devices"]:
                    if dev in device_owners:
                        drift.append(
                            f"{label}: device {dev} is also recorded "
                            f"for {device_owners[dev]} (double-booked "
                            "sub-mesh)")
                    device_owners[dev] = label
        else:  # terminal row
            if ident:
                drift.append(
                    f"{label}: row is {status} but pid {pid} is still "
                    "alive (orphaned process)")
            if status in ("ERRORED", "CRASHED") and not spec and \
                    row["service_type"] in ("TRAIN_WORKER",
                                            "INFERENCE_WORKER"):
                drift.append(
                    f"{label}: crashed worker row has no spawn_spec — "
                    "unrecoverable by the reconciler (pre-recovery row?)")
        report["services"].append(entry)

    # obs_port files with no live owner are stale and can mislead the
    # next drain or adoption
    stale_ports = []
    for pf in sorted(wd.glob("*.obs_port")):
        try:
            port = int(pf.read_text().strip())
        except (OSError, ValueError):
            drift.append(f"{pf.name}: unreadable obs_port file")
            continue
        if port not in claimed_ports and not _http_alive("127.0.0.1",
                                                         port):
            stale_ports.append(pf.name)
    if stale_ports:
        drift.append(
            f"stale obs_port files (no live service on the recorded "
            f"port): {', '.join(stale_ports)}")

    report["data_plane"] = _audit_data_plane(rows, drift)

    lease = meta.get_admin_lease()
    if lease:
        age = time.time() - float(lease.get("heartbeat_at") or 0)
        report["lease"] = {**lease, "heartbeat_age_s": round(age, 1)}
        live_rows = any(s["status"] in _LIVE_STATES
                        for s in report["services"])
        # heartbeat_at is a wall-clock stamp another process wrote: only
        # the wall clock can age it across restarts
        if live_rows and age > 60.0:
            drift.append(
                f"admin lease heartbeat is {age:.0f}s old while "
                "service rows claim to be live — the admin is gone; "
                "restart it (it will re-adopt survivors)")
    report["n_services"] = len(rows)
    report["ok"] = not drift
    return report


def render_text(report: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`audit_workdir`'s report."""
    lines = [f"workdir audit: {report['workdir']}"]
    for s in report.get("services", []):
        mark = "ok " if (s["status"] not in _LIVE_STATES
                         or s["identity_ok"]) else "DRIFT"
        lines.append(
            f"[{mark}] {s['service_type']:<17} {s['id'][:8]} "
            f"{s['status']:<8} pid={s['pid']} "
            f"alive={str(s['pid_alive']).lower()} "
            f"identity={str(s['identity_ok']).lower()}"
            + (f" devices={s['devices']}" if s["devices"] else ""))
    dp = report.get("data_plane")
    if dp:
        rep = dp.get("replay") or {}
        lines.append(
            f"data plane: kvd {dp.get('host')}:{dp.get('port')} "
            f"reachable={str(dp.get('reachable')).lower()} "
            f"wal_bytes={dp.get('wal_bytes')} "
            f"last_fsync_age={dp.get('last_fsync_age_s')}s "
            f"replay_ok={str(rep.get('ok')).lower()} "
            f"replayable_records={rep.get('replayable_records')}")
    lease = report.get("lease")
    if lease:
        lines.append(
            f"lease: holder={str(lease.get('holder', ''))[:12]} "
            f"generation={lease.get('generation')} "
            f"heartbeat_age={lease.get('heartbeat_age_s')}s")
    if report["drift"]:
        lines.append(f"DRIFT ({len(report['drift'])} finding(s)):")
        lines.extend(f"  - {d}" for d in report["drift"])
    else:
        lines.append("no drift: recorded state matches the live world")
    return "\n".join(lines)


def _audit_data_plane(rows: List[Dict[str, Any]],
                      drift: List[str]) -> Optional[Dict[str, Any]]:
    """The kvd data-plane check: reachable on its recorded port,
    WAL/snapshot present under the recorded ``--data-dir``, last-fsync
    age (from the STATS verb), and a DRY-RUN replay integrity verdict
    over the persistence files (read-only; corruption a real boot
    would refuse is drift). Returns the report block, or None when no
    data-plane row exists."""
    live = [r for r in rows
            if r["service_type"] == "DATA_PLANE"
            and r["status"] in _LIVE_STATES]
    if not live:
        dead = [r for r in rows if r["service_type"] == "DATA_PLANE"]
        row = dead[-1] if dead else None
    else:
        row = live[-1]
    if row is None:
        return None
    spec_cfg = (row.get("spawn_spec") or {}).get("config") or {}
    host = row.get("host") or "127.0.0.1"
    port = int(row.get("port") or 0)
    data_dir = str(spec_cfg.get("data_dir") or "")
    block: Dict[str, Any] = {
        "row_id": row["id"], "status": row["status"],
        "host": host, "port": port, "data_dir": data_dir,
        "reachable": False}
    label = f"DATA_PLANE {row['id'][:8]}"
    if port > 0:
        try:
            from rafiki_tpu_torch.native.client import KVClient

            c = KVClient(host, port, connect_timeout=2.0)
            try:
                block["reachable"] = c.ping()
                stats = c.stats()
            finally:
                c.close()
            block["last_fsync_age_s"] = stats.get("last_fsync_age_s")
            block["wal_bytes"] = stats.get("wal_bytes")
            block["snapshot_age_s"] = stats.get("snapshot_age_s")
            block["fsync_policy"] = stats.get("fsync_policy")
            if not stats.get("persist_enabled"):
                drift.append(
                    f"{label}: kvd is serving WITHOUT persistence "
                    "(no --data-dir) — a crash loses every blob and "
                    "queue")
            else:
                age = stats.get("last_fsync_age_s")
                if isinstance(age, (int, float)) and age > 30.0:
                    drift.append(
                        f"{label}: last WAL fsync was {age:.0f}s ago "
                        "under a non-`no` policy — the fsync loop "
                        "looks wedged (host-crash durability window "
                        "is growing)")
        except (OSError, RuntimeError) as e:
            block["probe_error"] = str(e)
            if row["status"] in _LIVE_STATES:
                drift.append(
                    f"{label}: row is {row['status']} but the kvd at "
                    f"{host}:{port} does not answer ({e}) — restart "
                    "the admin (it respawns the kvd with WAL replay)")
    if data_dir:
        from rafiki_tpu_torch.native import wal as kvwal

        replay = kvwal.dry_run_replay(data_dir)
        block["replay"] = replay
        if not replay["ok"]:
            for f in replay["findings"]:
                drift.append(f"{label}: {f}")
    elif row["status"] in _LIVE_STATES:
        drift.append(
            f"{label}: no data_dir recorded in the spawn spec — the "
            "supervisor cannot respawn-with-replay (pre-persistence "
            "row?)")
    return block


def _devices(row: Dict[str, Any]) -> List[int]:
    try:
        return [int(d) for d in json.loads(row.get("devices") or "[]")]
    except (ValueError, TypeError):
        return []


def _probe_port(row: Dict[str, Any], spec: Dict[str, Any],
                wd: Path) -> int:
    port = int(row.get("port") or 0)
    if port > 0:
        return port
    port_file = ((spec.get("config") or {}).get("obs_port_file")
                 if spec else None)
    if port_file and Path(port_file).exists():
        try:
            return int(Path(port_file).read_text().strip())
        except (OSError, ValueError):
            return 0
    return 0


def _http_alive(host: str, port: int) -> bool:
    """TCP-level liveness: any process accepting on the port counts
    (not every service has /health; the audit checks reachability,
    not route tables)."""
    import socket

    try:
        with socket.create_connection((host, port), timeout=2.0):
            return True
    except OSError:
        return False


__all__ = ["audit_workdir", "render_text"]
