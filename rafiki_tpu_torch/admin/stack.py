"""``stack start|stop|status``: the whole local service stack in one
command.

The port's own copy of ``rafiki_tpu/admin/stack.py`` (``stack_command``,
``_pid_alive``, ``_reap_orphans``): one detached admin process,
``python -m rafiki_tpu_torch.admin.app``, which owns the data plane and
spawns the advisors, workers and predictors; its state lives under
``--workdir``: ``admin.json`` (its config), ``admin.pid``, ``admin.url``,
``admin.port``, ``admin.log`` and the meta store ``meta.db``.

- ``start`` writes the config, spawns the admin in a new session with the
  package root on ``PYTHONPATH``, waits for its port file (a lease-fenced
  boot that exits 3 is reported with its own detail), then records the
  pid and url. ``--device cpu`` asks for a CPU stack (``"platform":
  "cpu"``, over the admin's default of one slot); without it the admin
  probes the cards and refuses to start without one. The admin adopts
  what a previous one left running; ``--cold`` (``"cold_start"``) kills
  it instead, for when that state is not to be trusted.
- ``stop`` sends SIGTERM (SIGKILL after 10 s), then kills the services
  the meta store still lists as live whose (pid, start time) identity
  holds, and marks their rows STOPPED: the orphan sweep.
- ``status`` prints the admin's ``/health`` with its url.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from rafiki_tpu_torch.utils.http import json_request

#: the directory that holds ``rafiki_tpu_torch/``
_PACKAGE_ROOT = Path(__file__).resolve().parent.parent.parent


def stack_command(args: argparse.Namespace) -> int:
    workdir = Path(args.workdir).absolute()
    pid_file = workdir / "admin.pid"
    url_file = workdir / "admin.url"

    if args.action == "start":
        if pid_file.exists() and _pid_alive(int(pid_file.read_text())):
            print(f"stack already running (pid {pid_file.read_text()})",
                  file=sys.stderr)
            return 1
        workdir.mkdir(parents=True, exist_ok=True)
        cfg = {"workdir": str(workdir), "db_path": str(workdir / "meta.db"),
               "host": "127.0.0.1", "port": args.port,
               "slot_size": args.slot_size, "workers": args.workers,
               "cold_start": bool(getattr(args, "cold", False)),
               "port_file": str(workdir / "admin.port")}
        if getattr(args, "device", "cuda") == "cpu":
            cfg["platform"] = "cpu"
        cfg_path = workdir / "admin.json"
        cfg_path.write_text(json.dumps(cfg))
        # a stale port file from a killed admin would read as this one up
        (workdir / "admin.port").unlink(missing_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
        with open(workdir / "admin.log", "ab") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "rafiki_tpu_torch.admin.app",
                 "--config", str(cfg_path)],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                start_new_session=True)
        port_file = workdir / "admin.port"
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            if port_file.exists() and port_file.read_text().strip():
                break
            if proc.poll() is not None:
                if proc.returncode == 3:
                    # a lease-fenced boot: its last log line is the detail
                    try:
                        last = (workdir / "admin.log").read_bytes() \
                            .decode(errors="replace").strip() \
                            .splitlines()[-1]
                        err = json.loads(last)
                        print(f"admin refused to start: "
                              f"{err.get('detail', last)}",
                              file=sys.stderr)
                        return 3
                    except (OSError, ValueError, IndexError):
                        pass
                print(f"admin died on startup; see {workdir / 'admin.log'}",
                      file=sys.stderr)
                return 1
            time.sleep(0.1)
        else:
            proc.kill()
            print("admin did not come up in time", file=sys.stderr)
            return 1
        port = int(port_file.read_text().strip())
        url = f"http://127.0.0.1:{port}"
        pid_file.write_text(str(proc.pid))
        url_file.write_text(url)
        print(f"stack up: {url} (pid {proc.pid})")
        print("login: superadmin@rafiki / rafiki")
        return 0

    if args.action == "stop":
        if not pid_file.exists():
            print("stack is not running", file=sys.stderr)
            return 1
        pid = int(pid_file.read_text())
        if _pid_alive(pid):
            os.kill(pid, signal.SIGTERM)
            for _ in range(100):
                if not _pid_alive(pid):
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, signal.SIGKILL)
        pid_file.unlink(missing_ok=True)
        orphans = _reap_orphans(workdir)
        if orphans:
            print(f"killed {orphans} orphaned service processes",
                  file=sys.stderr)
        print("stack stopped")
        return 0

    if args.action == "status":
        if not url_file.exists():
            print("stack is not running")
            return 1
        url = url_file.read_text().strip()
        try:
            health = json_request("GET", f"{url}/health", timeout=5)
        except OSError:
            print(f"stack at {url} is not answering")
            return 1
        print(json.dumps({"url": url, **health}))
        return 0

    print(f"unknown stack action {args.action!r}", file=sys.stderr)
    return 2


def _pid_alive(pid: int) -> bool:
    """Zombie-aware: a killed admin not yet reaped still answers signal 0
    but is dead for every purpose here."""
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    from rafiki_tpu_torch.admin.proc import proc_state

    return proc_state(pid) != "Z"


def _reap_orphans(workdir: Path) -> int:
    """Kill service processes that outlived the admin and mark their
    meta-store rows STOPPED; each kill is gated on the recorded (pid,
    start time) identity, so a recycled pid is never killed."""
    db = workdir / "meta.db"
    if not db.exists():
        return 0
    from rafiki_tpu_torch.admin.proc import identity_matches, terminate_pid
    from rafiki_tpu_torch.store.meta_store import MetaStore

    meta = MetaStore(str(db))
    killed = 0
    for row in meta.get_services():
        if row["status"] in ("STOPPED", "ERRORED", "CRASHED"):
            continue
        pid = int(row.get("pid") or 0)
        start_time = float(row.get("start_time") or 0)
        if pid > 0 and identity_matches(pid, start_time):
            if terminate_pid(pid, start_time):
                killed += 1
        meta.update_service(row["id"], status="STOPPED")
    return killed
