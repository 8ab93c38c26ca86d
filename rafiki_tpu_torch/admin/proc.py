"""Process-identity helpers for the control plane's kill and adopt paths.

The port's own copy of ``rafiki_tpu/admin/proc.py`` (``pid_alive``,
``proc_start_time``, ``proc_state``, ``cmdline_is_ours``,
``identity_matches``, ``terminate_pid``, ``AdoptedProcess``). Every place
the control plane acts on a *recorded* pid faces the same hazard:
between the row being written and the action, the process may have
exited and the kernel may have handed the pid to an unrelated program.
The hardened identity is ``(pid, start_time)`` where ``start_time`` is
field 22 of ``/proc/<pid>/stat`` — the kernel's jiffies-since-boot stamp
of process creation, immutable for the life of the pid and never equal
across a recycle. The meta store records it at spawn; any later kill or
adoption requires it to match.
"""

from __future__ import annotations

import os
from typing import Optional


def pid_alive(pid: int) -> bool:
    """Signal-0 liveness probe (EPERM counts as alive: it exists)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def proc_start_time(pid: int) -> float:
    """Kernel start time of ``pid`` (field 22 of ``/proc/<pid>/stat``,
    jiffies since boot), or 0.0 when the process is gone / unreadable.
    The comm field (2) may contain spaces and parentheses, so parse
    from AFTER the last ``)``."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode(errors="replace")
    except OSError:
        return 0.0
    _, _, rest = stat.rpartition(")")
    fields = rest.split()
    # rest starts at field 3 ("state"); start_time is field 22
    if len(fields) < 20:
        return 0.0
    return float(fields[19])


def proc_state(pid: int) -> str:
    """Single-char process state (``R``/``S``/``Z``/...), or ``""``
    when gone. A zombie still has a /proc entry but is dead for every
    purpose the control plane cares about."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode(errors="replace")
    except OSError:
        return ""
    _, _, rest = stat.rpartition(")")
    fields = rest.split()
    return fields[0] if fields else ""


def cmdline_is_ours(pid: int) -> bool:
    """Weak identity: the process cmdline looks like a rafiki service
    (module path or the kv daemon). Necessary but NOT sufficient — pair
    with :func:`identity_matches` wherever a recorded ``start_time``
    exists."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return False
    return "rafiki" in cmd


def identity_matches(pid: int, start_time: float) -> bool:
    """Hardened pid identity: alive (not a zombie), cmdline ours, and —
    when a start time was recorded at spawn — the kernel start time
    matches exactly. A recycled pid can never pass: even another rafiki
    process on the same pid has a different ``start_time``."""
    if not pid_alive(pid) or proc_state(pid) == "Z":
        return False
    if not cmdline_is_ours(pid):
        return False
    if start_time and proc_start_time(pid) != start_time:
        return False
    return True


def terminate_pid(pid: int, start_time: float = 0.0,
                  grace_s: float = 5.0) -> bool:
    """SIGTERM→wait→SIGKILL a recorded pid, re-checking identity before
    EACH signal (the guard must hold at kill time, not just at scan
    time). Returns True when the process is gone afterwards."""
    import signal
    import time

    if not identity_matches(pid, start_time):
        return not pid_alive(pid) or proc_state(pid) == "Z"
    try:
        os.kill(pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return not pid_alive(pid)
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if not pid_alive(pid) or proc_state(pid) == "Z":
            return True
        time.sleep(0.05)
    if identity_matches(pid, start_time):
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if not pid_alive(pid) or proc_state(pid) == "Z":
            return True
        time.sleep(0.05)
    return False


class AdoptedProcess:
    """Popen-shaped handle over a process this manager did NOT spawn.

    A restarted admin re-adopts the previous admin's surviving children
    by pid; they are not our children, so there is no ``Popen`` and no
    wait status. This mimic covers exactly the surface
    ``ManagedService``/``ServicesManager`` use: ``pid``, ``poll()``,
    ``returncode``, ``terminate()``, ``kill()``, ``wait(timeout)``.
    Liveness is judged through :func:`identity_matches` with the
    recorded start time, so a recycled pid reads as dead rather than as
    somebody else's process. Exit codes of non-children are unknowable;
    an adopted process that vanishes reports :data:`ADOPTED_EXIT`
    (non-zero → the crash/respawn path, the safe default: a clean
    drain is re-spawnable, a missed crash is not healable).
    """

    #: stand-in returncode for adopted processes (never 0: unknown
    #: death must flow into the respawn path, not be read as a drain)
    ADOPTED_EXIT = 97

    def __init__(self, pid: int, start_time: float = 0.0) -> None:
        self.pid = pid
        self.start_time = start_time or proc_start_time(pid)
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if identity_matches(self.pid, self.start_time):
            return None
        self.returncode = self.ADOPTED_EXIT
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        import subprocess
        import time

        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(
                    f"adopted:{self.pid}", timeout)
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]

    def _signal(self, sig: int) -> None:
        if not identity_matches(self.pid, self.start_time):
            self.poll()
            return
        try:
            os.kill(self.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def terminate(self) -> None:
        import signal

        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        import signal

        self._signal(signal.SIGKILL)
