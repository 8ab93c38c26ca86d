"""ServicesManager: spawn and track the stack's service processes on CUDA
device slots.

The port's own copy of ``rafiki_tpu/admin/services_manager.py``:
``ManagedService``, the constructor, the data plane
(``start_data_plane``, ``_boot_data_plane``, on the port's kvd; its
supervision ``_check_data_plane`` and ``_respawn_data_plane``),
``param_store_uri``, the single-writer admin lease (``acquire_lease``,
``start_lease_heartbeat``, ``renew_lease``, ``release_lease``, the fence
check), ``_spawn``, ``create_train_services``, ``wait_train_job``,
``create_inference_services``, the monitor's ``poll`` with its worker
respawn budget, the boot reconciler (``reconcile``, ``_adopt_service``,
``_probe_service``, ``_reconcile_data_plane``, ``recovery_stats``),
``reap_stale_services``, the rolling restart (``_request_drain``,
``rolling_restart``), the scale-out plane (``_pool_hub``,
``_ensure_scaleout``, ``_publish_pool``, ``_scale_up_one``,
``_promote_warmed``, ``_begin_scale_down``, ``_victim_tick``,
``_choose_victim``, ``autoscale_tick``, ``scale_inference_job``,
``_pool_trial_ids``, ``_scale_to``, ``_scale_down_blocking``,
``scaleout_status`` and the ``scaling`` counters), ``stop_service``,
``stop_all``, ``_DeadProc`` and ``_AdoptedKVServer``. The control plane
spawns an advisor plus N train workers per train job, and N inference
workers plus a predictor per inference job, each a ``python -m
rafiki_tpu_torch.<module> --config <json>`` child:

- the card inventory comes from a throwaway probe subprocess
  (``device_probe.py``), so the manager never initializes CUDA itself;
  ``platform=None`` probes and raises when the host has no CUDA device.
  A CPU stack must be asked for (``platform="cpu"`` with virtual
  ``DeviceSpec`` slots): its workers get ``"device": "cpu"``;
- a :class:`SubMeshAllocator` hands each worker a slot, and the slot's
  ``CUDA_VISIBLE_DEVICES`` confines the child to its cards; the advisor
  and the predictor get ``CUDA_VISIBLE_DEVICES=""`` (no card);
- service rows land in the MetaStore with their full spawn recipe and
  the child's kernel start time, as the JAX admin records them: the row,
  not this object's dicts, is the source of truth. ``poll()`` is the
  failure detector.

Crash-only, as the JAX control plane: a restarted admin calls
:meth:`reconcile`, which adopts the previous admin's surviving children
(the pid's identity and a health probe on its recorded port or its
worker's obs sidecar; the slots re-reserved) and its kvd (identity and
``PING``), crashes and respawns the dead under the respawn budget kept in
the MetaStore (a dead kvd on its recorded port with WAL replay), and
reaps the survivors of jobs stopped meanwhile; ``cold_start`` calls
:meth:`reap_stale_services` instead. The monitor respawns a kvd that dies
under it the same way. :meth:`rolling_restart` drains an inference job's
workers one at a time through their obs sidecars (``POST /drain``) and
replaces each on its freed slot.

Scale-out as in JAX: every inference job has a routing pool published to
the hub (``put_pool_members``), grown from the job's replica template
and shrunk through the drain path, membership first; the monitor's
:meth:`autoscale_tick` runs the budget's ``AutoscalePolicy``
(``AUTOSCALE``, ``MIN_WORKERS``, ``MAX_WORKERS``,
``AUTOSCALE_COOLDOWN_S``, validated at create; refused over an
ensemble), and :meth:`scale_inference_job` is the operator's exact
count. Several slots may name one card (``devices=[spec] * 2``): each
worker's ``CUDA_VISIBLE_DEVICES`` is that card, and its
``RAFIKI_DEVICE_HBM_BYTES`` is its slot's share of the card's memory,
which the worker's admission plans against (``slot_env_vars``). Where
the JAX manager drains a leaving worker at once, the port drains it only
once the job's predictor routes without it (``_await_pool_applied``), a
rolling restart takes each worker out of the published pool first and
puts its replacement back once it serves (``_restart_one``), and a
crashed pool member is out of the pool until its respawn boots
(``_unroute_crashed``, ``_rejoin_when_warm``).

The paged gather path (``PAGED_KERNEL=false``) is refused by name with
``NotPorted``. The decode modes are served
with the JAX manager's validations: ``MULTI_ADAPTER`` (the best-N trials
of one model and shape as one stacked worker on one slot),
``SYSTEM_PREFIX``, ``SPECULATE_K`` and ``DRAFT_TRIAL_ID``; so are
disaggregated prefill/decode and the host KV tier: ``WORKER_ROLE`` (one
role for every worker, or one per worker index, comma-separated; an
all-prefill pool is refused), ``KV_WAIT_S`` (with ``WORKER_ROLE``) and
``HOST_KV_PAGES`` (with ``KV_PAGE_SIZE``), passed on as the workers'
``role``, ``kv_wait_s`` and ``host_kv_pages``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.admin.autoscaler import (AutoscaleConfig,
                                               AutoscalePolicy)
from rafiki_tpu_torch.admin.proc import (AdoptedProcess, identity_matches,
                                         proc_start_time, terminate_pid)
from rafiki_tpu_torch.constants import (ServiceStatus, ServiceType,
                                        SubTrainJobStatus, TaskType,
                                        TrainJobStatus)
from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.parallel.mesh import (DeviceSpec, SubMesh,
                                            SubMeshAllocator, slot_env_vars)
from rafiki_tpu_torch.store.meta_store import MetaStore

log = logging.getLogger(__name__)

#: the directory holding ``rafiki_tpu_torch/``
_PACKAGE_ROOT = Path(__file__).resolve().parent.parent.parent

#: service rows in these states are settled history: never adopted,
#: respawned or reaped again
_TERMINAL = (ServiceStatus.STOPPED, ServiceStatus.ERRORED,
             ServiceStatus.CRASHED)

#: worker service types eligible for self-healing respawn
_WORKER_TYPES = (ServiceType.TRAIN_WORKER, ServiceType.INFERENCE_WORKER)

#: the modules the manager spawns, one per service type
SPAWN_TARGETS = {
    ServiceType.ADVISOR: "rafiki_tpu_torch.advisor.service",
    ServiceType.TRAIN_WORKER: "rafiki_tpu_torch.worker.train",
    ServiceType.INFERENCE_WORKER: "rafiki_tpu_torch.worker.inference",
    ServiceType.PREDICTOR: "rafiki_tpu_torch.serving.predictor",
}

def _not_ported(what: str) -> Exception:
    from rafiki_tpu_torch.serving.decode_engine import NotPorted

    return NotPorted(f"{what} is not ported yet")


class LeaseHeldError(RuntimeError):
    """Another live admin holds the single-writer lease for this
    MetaStore — booting a second control plane would double-spawn the
    stack. Carries the holder/generation for a structured error."""

    def __init__(self, lease: Dict[str, Any]) -> None:
        self.lease = dict(lease)
        age = time.time() - float(lease.get("heartbeat_at") or 0)
        super().__init__(
            f"admin lease held by {lease.get('holder', '?')[:12]} "
            f"(generation {lease.get('generation')}, heartbeat "
            f"{age:.1f}s ago) — a live admin owns this MetaStore; "
            "stop it first or wait for its lease to expire")


class AdminFencedError(RuntimeError):
    """This manager LOST the lease (a newer admin took over): every
    mutating operation is refused so the two control planes cannot
    fight over the same processes and cards."""


class ManagedService:
    """One spawned child process + its MetaStore row + its device slot."""

    def __init__(self, service_id: str, service_type: str,
                 proc: subprocess.Popen, slot: Optional[SubMesh] = None,
                 host: str = "", port: int = 0,
                 adopted: bool = False) -> None:
        self.service_id = service_id
        self.service_type = service_type
        self.proc = proc
        self.slot = slot
        self.host = host
        self.port = port
        #: True when the boot reconciler rebuilt this handle around a
        #: surviving pid instead of this manager spawning it
        self.adopted = adopted

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def alive(self) -> bool:
        return self.proc.poll() is None


def probe_devices(timeout: float = 120.0) -> Dict[str, Any]:
    """Run the device probe subprocess; returns {platform, devices}."""
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "rafiki_tpu_torch.admin.device_probe"],
        capture_output=True, text=True, timeout=timeout, check=True,
        env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


class ServicesManager:
    def __init__(self, meta_store: MetaStore, workdir: str,
                 slot_size: int = 1, platform: Optional[str] = None,
                 devices: Optional[List[DeviceSpec]] = None,
                 slot_timeout: float = 30.0,
                 default_workers: int = 1) -> None:
        """``platform``: ``None`` or ``"cuda"`` probe the host's cards
        (``RuntimeError`` without one); ``"cpu"`` is a CPU stack, asked
        for explicitly, over ``devices`` (virtual slots; default one)."""
        self.meta = meta_store
        self.slot_timeout = slot_timeout
        #: train workers per job when the budget names no WORKER_COUNT /
        #: GPU_COUNT
        self.default_workers = max(1, int(default_workers))
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        if platform not in (None, "cuda", "cpu"):
            raise ValueError(f"unknown platform {platform!r} (cuda|cpu)")
        if platform == "cpu":
            devices = devices or [DeviceSpec(id=0)]
        elif devices is None:
            inv = probe_devices()
            if inv["platform"] != "cuda" or not inv["devices"]:
                raise RuntimeError(
                    "no CUDA device is available to the services manager "
                    "(the device probe found none); pass platform='cpu' "
                    "with virtual DeviceSpec slots for a CPU stack")
            devices = [DeviceSpec.from_probe(d) for d in inv["devices"]]
        self.platform = platform or "cuda"
        #: what each spawned worker is told to run on
        self.worker_device = "cuda" if self.platform == "cuda" else "cpu"
        self.devices = devices
        self.allocator = SubMeshAllocator(devices, slot_size)
        #: serializes spawn/stop/poll across the admin + monitor threads
        #: (e.g. the monitor must not reap an advisor between its spawn and
        #: its workers' spawn)
        self.op_lock = threading.RLock()
        self.services: Dict[str, ManagedService] = {}
        self.kv_host: str = ""
        self.kv_port: int = 0
        self._kv_server: Any = None
        #: the kvd's process handle: its Popen, an AdoptedProcess, a
        #: _DeadProc while a respawn is owed, None when unsupervised
        self._kv_proc: Any = None
        self._kv_service_id: Optional[str] = None
        #: where the WAL and snapshot live (recorded in the spawn spec,
        #: so a restarted admin respawns with replay)
        self._kv_data_dir: str = ""
        #: consecutive failed kvd boot attempts (one per monitor tick)
        self._kv_boot_attempts = 0
        #: spawn spec per live worker, so a crashed worker can be
        #: respawned while its job still runs. Lineage = (type, job id):
        #: the budget is shared by a job's workers
        self._respawn_specs: Dict[str, Dict[str, Any]] = {}
        #: in-memory mirror of the MetaStore's respawn budgets, which are
        #: authoritative (increments write through): the budget survives
        #: an admin restart
        self._respawn_counts: Dict[Any, int] = self._load_respawn_counts()
        #: max replacement spawns per (service type, job) lineage
        self.max_respawns = 3
        #: respawns that found no free slot, retried on every poll
        self._pending_respawns: List[Dict[str, Any]] = []
        #: jobs whose self-healing is exhausted (job id → reason)
        self._degraded: Dict[str, str] = {}
        #: completed drain → stop → respawn cycles (rolling_restart)
        self._rolling_restarts = 0
        #: one rolling restart at a time: a second call (an operator
        #: retrying a timed-out request) would drain the fresh
        #: replacements and spawn duplicates sharing one worker id
        self._rolling_lock = threading.Lock()
        #: single-writer admin lease (generation-fenced). Opt-in:
        #: acquire_lease() arms it; a manager that never acquires is
        #: never fenced.
        self.lease_holder = uuid.uuid4().hex
        self.lease_generation = 0
        self.lease_ttl_s = 15.0
        self._lease_held = False
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self.fenced = False
        #: the boot reconciler's and the kvd supervisor's counters, on
        #: the admin's /metrics and /health
        self.recovery = StatsMap({
            "services_adopted": 0, "services_crashed": 0,
            "orphans_reaped": 0, "respawns_queued": 0,
            "kv_adopted": 0, "kvd_respawns": 0,
            "kvd_replay_seconds": 0.0, "lease_takeovers": 0,
            "last_recovery_at": 0.0})
        #: cached kvd STATS under a lock of their own (never op_lock: a
        #: scrape must not wait on a slow spawn)
        self._kvd_stats_cache: Dict[str, Any] = {}
        self._kvd_stats_at = 0.0
        self._kvd_stats_lock = threading.Lock()
        #: scale-out state per inference job: the routing pool, the spawn
        #: template of extra replicas, the autoscale policy (when the
        #: budget armed one), the warming and draining workers. Rebuilt
        #: from the live services and the job budget after an admin
        #: restart (_ensure_scaleout), so adoption keeps scaling
        self._scaleout: Dict[str, Dict[str, Any]] = {}
        self._last_autoscale_tick = 0.0
        self._pool_hub_cache: Any = None
        self._pool_hub_key: Any = None
        #: autoscaler action counters, on the admin's /metrics
        self.scaling = StatsMap({
            "autoscale_ups": 0, "autoscale_downs": 0,
            "autoscale_blocked": 0, "pool_publishes": 0})

    def _load_respawn_counts(self) -> Dict[Any, int]:
        """The MetaStore's lineage budgets, keyed ``(type, job_id)``."""
        out: Dict[Any, int] = {}
        try:
            for lineage, count in self.meta.get_respawn_counts().items():
                stype, _, job_id = lineage.partition(":")
                out[(stype, job_id)] = int(count)
        except Exception:  # noqa: BLE001 — a store hiccup must not break
            # boot; the budgets then start fresh
            log.warning("could not load durable respawn budgets",
                        exc_info=True)
        return out

    # ---- admin lease (single-writer fencing) ----
    def acquire_lease(self, ttl_s: Optional[float] = None
                      ) -> Dict[str, Any]:
        """Claim the MetaStore's single-writer admin lease, or raise
        :class:`LeaseHeldError` when a live admin already owns it. A
        takeover of an EXPIRED lease bumps the generation (counted as
        ``lease_takeovers``)."""
        if ttl_s is not None:
            self.lease_ttl_s = float(ttl_s)
        got = self.meta.acquire_admin_lease(self.lease_holder,
                                            ttl_s=self.lease_ttl_s)
        if got is None:
            raise LeaseHeldError(self.meta.get_admin_lease() or {})
        self._lease_held = True
        self.fenced = False
        self.lease_generation = int(got["generation"])
        if got.get("took_over"):
            self.recovery.inc("lease_takeovers")
        return got

    def start_lease_heartbeat(self,
                              interval_s: Optional[float] = None) -> None:
        """Start the background lease-renewal thread (idempotent; a
        no-op without a held lease). It never touches ``op_lock``, so a
        blocking spawn cannot starve it; it exits on release or fence."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        if not self._lease_held:
            return
        tick = interval_s if interval_s is not None else \
            max(0.2, min(self.lease_ttl_s / 3.0, 5.0))
        self._hb_stop = threading.Event()

        def loop() -> None:
            while not self._hb_stop.wait(tick):
                try:
                    if not self.renew_lease():
                        return  # fenced: nothing left to renew
                except Exception:  # a store hiccup must not kill the
                    # heartbeat — the next tick retries
                    log.warning("lease heartbeat failed", exc_info=True)

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def _stop_lease_heartbeat(self) -> None:
        self._hb_stop.set()
        th = self._hb_thread
        if th is not None and th.is_alive():
            th.join(timeout=5)
        self._hb_thread = None

    def renew_lease(self) -> bool:
        """Heartbeat the held lease. False (and ``self.fenced``) when a
        newer admin took over — from then on every spawn/stop raises."""
        if not self._lease_held or self.fenced:
            return not self.fenced
        if self.meta.renew_admin_lease(self.lease_holder):
            return True
        log.error("admin lease lost (a newer admin took over) — fencing "
                  "this manager: no further spawns/stops")
        self.fenced = True
        return False

    def release_lease(self) -> None:
        """Clean shutdown: expire the lease so the next admin boots
        without waiting out the TTL. Stops the heartbeat first."""
        self._stop_lease_heartbeat()
        if self._lease_held and not self.fenced:
            try:
                self.meta.release_admin_lease(self.lease_holder)
            except Exception:  # shutdown must not die on a store
                # hiccup; the TTL covers the release anyway
                log.warning("admin lease release failed (the TTL will "
                            "expire it)", exc_info=True)
        self._lease_held = False

    def _check_fence(self) -> None:
        if self.fenced:
            raise AdminFencedError(
                "admin lease lost — this manager is fenced; a newer "
                "admin owns the stack now")

    def reap_stale_services(self) -> int:
        """Cold-start cleanup: kill every process a previous admin's
        non-terminal rows still point at and mark the rows STOPPED.
        :meth:`reconcile`, which adopts survivors, is the normal boot;
        this is for an operator who asks for a clean slate. Each kill is
        gated on the recorded (pid, start time) identity, so a recycled
        pid is never killed."""
        reaped = 0
        for row in self.meta.get_services():
            if row["status"] in _TERMINAL or row["id"] in self.services:
                continue
            pid = int(row.get("pid") or 0)
            if pid > 0:
                terminate_pid(pid, float(row.get("start_time") or 0))
            self.meta.update_service(row["id"],
                                     status=ServiceStatus.STOPPED)
            reaped += 1
        return reaped

    # ---- boot reconciler (crash-only control plane) ----
    def reconcile(self) -> Dict[str, Any]:
        """Rebuild the process table from the MetaStore after an admin
        died. For every non-terminal row the previous admin left:

        - **adopt** a survivor: pid alive with its recorded identity
          (cmdline and kernel start time) and answering a health probe
          on its recorded port or its worker's obs sidecar: a
          :class:`ManagedService` is rebuilt around the pid, its slot
          re-reserved and its respawn spec re-armed; nothing restarts;
        - **crash** the dead (or a pid that fails identity or probe):
          the row goes CRASHED, and a worker of a still-RUNNING job goes
          into the respawn path under the budget kept in the MetaStore;
        - **reap** an orphan: a survivor whose job was stopped while no
          admin ran is killed (identity-gated) and marked STOPPED.

        The kvd is adopted the same way (identity and ``PING`` on its
        recorded port), so parameter blobs and in-flight queues survive
        the admin; a dead one is respawned on its port with WAL replay.
        Returns :meth:`recovery_stats`."""
        with self.op_lock:
            return self._reconcile()

    def _reconcile(self) -> Dict[str, Any]:
        self._respawn_counts = self._load_respawn_counts()
        crashed_workers: List[Dict[str, Any]] = []
        for row in self.meta.get_services():
            if row["status"] in _TERMINAL or row["id"] in self.services:
                continue
            stype = row["service_type"]
            if stype == ServiceType.DATA_PLANE:
                self._reconcile_data_plane(row)
                continue
            pid = int(row.get("pid") or 0)
            start_time = float(row.get("start_time") or 0)
            spec = row.get("spawn_spec") or None
            job_id = row.get("train_job_id") or row.get("inference_job_id")
            job = None
            if job_id:
                job = self.meta.get_train_job(job_id) or \
                    self.meta.get_inference_job(job_id)
            job_running = bool(job and job.get("status") == "RUNNING")
            alive = identity_matches(pid, start_time)

            if alive and job_id and not job_running:
                log.info("reaping orphan %s %s (job %s is %s)", stype,
                         row["id"], job_id,
                         job.get("status") if job else "gone")
                terminate_pid(pid, start_time)
                self.meta.update_service(row["id"],
                                         status=ServiceStatus.STOPPED)
                self.recovery.inc("orphans_reaped")
                continue

            probe = self._probe_service(row, spec) if alive else False
            if alive and probe is not False:
                if self._adopt_service(row, spec, pid, start_time):
                    continue
                alive = False  # its slot is gone: crash it

            if alive or identity_matches(pid, start_time):
                # it exists but does not serve: kill it before a
                # replacement claims the same slot
                terminate_pid(pid, start_time)
            self.meta.update_service(row["id"],
                                     status=ServiceStatus.CRASHED)
            self.recovery.inc("services_crashed")
            if job_running and spec and stype in _WORKER_TYPES:
                crashed_workers.append({"dead_id": row["id"],
                                        "spec": spec})

        # the crashed workers take the monitor's respawn path, under the
        # budget that survived the restart
        for item in crashed_workers:
            try:
                if not self._respawn(item["dead_id"], item["spec"]):
                    self._pending_respawns.append(item)
                    self.recovery.inc("respawns_queued")
            except Exception as e:  # reconcile must finish: a failed
                # respawn is a degraded job, not a dead control plane
                log.warning("boot respawn of %s failed: %s",
                            item["dead_id"], e)
                mk = item["spec"].get("meta_kwargs") or {}
                self._mark_degraded(
                    item["spec"]["service_type"],
                    mk.get("train_job_id") or mk.get("inference_job_id"),
                    f"boot respawn failed: {e}")
        self.recovery.set("last_recovery_at", time.time())
        return self.recovery_stats()

    def _adopt_service(self, row: Dict[str, Any],
                       spec: Optional[Dict[str, Any]], pid: int,
                       start_time: float) -> bool:
        """Rebuild a ManagedService around a surviving pid; False when
        its recorded slot cannot be re-reserved (the caller crashes
        it)."""
        stype = row["service_type"]
        slot = None
        if spec and spec.get("needs_slot"):
            try:
                devices = json.loads(row.get("devices") or "[]")
            except ValueError:
                devices = []
            slot = self.allocator.reserve(devices)
            if slot is None:
                log.warning("cannot adopt %s %s: its recorded slot %r is "
                            "no longer free", stype, row["id"], devices)
                return False
        svc = ManagedService(
            row["id"], stype, AdoptedProcess(pid, start_time), slot,
            host=row.get("host") or "127.0.0.1",
            port=int(row.get("port") or 0), adopted=True)
        self.services[row["id"]] = svc
        if spec and stype in _WORKER_TYPES:
            self._respawn_specs[row["id"]] = {
                "module": spec["module"], "config": spec["config"],
                "service_type": stype,
                "needs_slot": bool(spec.get("needs_slot")),
                "meta_kwargs": dict(spec.get("meta_kwargs") or {})}
        self.meta.update_service(row["id"], status=ServiceStatus.RUNNING)
        self.recovery.inc("services_adopted")
        return True

    def _probe_service(self, row: Dict[str, Any],
                       spec: Optional[Dict[str, Any]]) -> Optional[bool]:
        """Health-probe a candidate on its recorded HTTP surface: the
        row's own port (advisor, predictor) or the worker's obs sidecar
        (the port in its ``obs_port_file``). Any HTTP answer, an error
        status too, counts as alive. None: no probe channel recorded,
        the identity alone decides."""
        import urllib.error

        from rafiki_tpu_torch.utils.http import json_request

        host = row.get("host") or "127.0.0.1"
        port = int(row.get("port") or 0)
        if port <= 0:
            port_file = ((spec or {}).get("config") or {}).get(
                "obs_port_file")
            if port_file and Path(port_file).exists():
                try:
                    port = int(Path(port_file).read_text().strip())
                except (OSError, ValueError):
                    port = 0
        if port <= 0:
            return None
        try:
            json_request("GET", f"http://{host}:{port}/health",
                         timeout=3.0)
            return True
        except urllib.error.HTTPError:
            return True  # it answered: alive, with no /health route
        except (OSError, ValueError):
            return False  # refused, timed out or garbage: not serving

    def _reconcile_data_plane(self, row: Dict[str, Any]) -> None:
        """Adopt a surviving kvd (parameter blobs and queues live in its
        memory: killing it would drop every in-flight stream). A dead
        kvd whose row records a data dir is respawned on the same port
        with WAL replay: "row present, process dead" is a recovery case,
        never a cold start."""
        from rafiki_tpu_torch.native.client import KVClient

        pid = int(row.get("pid") or 0)
        start_time = float(row.get("start_time") or 0)
        host = row.get("host") or "127.0.0.1"
        port = int(row.get("port") or 0)
        spec_cfg = (row.get("spawn_spec") or {}).get("config") or {}
        ok = False
        # identity first: a recycled pid must not be PINGed as ours
        if port > 0 and identity_matches(pid, start_time):
            try:
                c = KVClient(host, port, connect_timeout=3.0)
                ok = c.ping()
                c.close()
            except (OSError, RuntimeError):
                ok = False  # refused or garbled: not a live kvd
        if ok:
            self.kv_host, self.kv_port = host, port
            self._kv_data_dir = str(spec_cfg.get("data_dir") or "")
            server = _AdoptedKVServer(host, port,
                                      AdoptedProcess(pid, start_time))
            self._kv_server = server
            self._kv_proc = server._proc
            self._kv_service_id = row["id"]
            self.recovery.inc("kv_adopted")
            log.info("adopted data plane kvd pid %d on %s:%d", pid, host,
                     port)
            return
        if identity_matches(pid, start_time):
            terminate_pid(pid, start_time)
        self.meta.update_service(row["id"], status=ServiceStatus.CRASHED)
        self.recovery.inc("services_crashed")
        if port > 0 and spec_cfg.get("data_dir"):
            # respawn with replay on the recorded address: surviving
            # workers and predictors reconnect to the same host:port,
            # and the WAL restores blobs, membership and queued messages
            self.kv_host, self.kv_port = host, port
            self._kv_data_dir = str(spec_cfg["data_dir"])
            self._kv_service_id = row["id"]
            self._kv_proc = _DeadProc()
            self._respawn_data_plane("dead at admin reconcile")

    def recovery_stats(self) -> Dict[str, Any]:
        """The reconciler's and the lease's counters, for /metrics and
        /health."""
        out = self.recovery.snapshot()
        out["lease_generation"] = self.lease_generation
        out["fenced"] = bool(self.fenced)
        return out

    # ---- data plane ----
    #: kvd WAL fsync policy (overridable via RAFIKI_KVD_FSYNC)
    KVD_FSYNC_DEFAULT = "everysec"

    def start_data_plane(self) -> None:
        """Boot the port's kvd with WAL + snapshot persistence under
        ``workdir/kvd-data`` (a no-op when it already runs or
        :meth:`reconcile` adopted one). The boot recipe persists in the
        row's spawn spec, so the monitor and a restarted admin respawn a
        dead kvd with replay."""
        if self.kv_port:
            return
        self._check_fence()
        data_dir = str(self.workdir / "kvd-data")
        fsync = os.environ.get("RAFIKI_KVD_FSYNC", self.KVD_FSYNC_DEFAULT)
        self._boot_data_plane("127.0.0.1", 0, data_dir, fsync)

    def _boot_data_plane(self, host: str, port: int, data_dir: str,
                         fsync: str) -> None:
        """Spawn a kvd (fresh, or a respawn with replay when ``port`` is
        pinned and the data dir holds a WAL) and record its row and
        spawn spec."""
        from rafiki_tpu_torch.native.client import KVServer

        server = KVServer(host=host, port=port, data_dir=data_dir,
                          fsync=fsync)
        self._kv_server = server
        self._kv_proc = server._proc
        self.kv_host, self.kv_port = server.host, server.port
        self._kv_data_dir = data_dir
        row = self.meta.create_service(
            ServiceType.DATA_PLANE, host=server.host, port=server.port,
            pid=server._proc.pid,
            spawn_spec={"module": "rafiki-kvd",
                        "config": {"data_dir": data_dir, "fsync": fsync,
                                   "host": server.host,
                                   "port": server.port},
                        "service_type": ServiceType.DATA_PLANE,
                        "needs_slot": False, "meta_kwargs": {}},
            start_time=proc_start_time(server._proc.pid))
        self._kv_service_id = row["id"]
        self.meta.update_service(row["id"], status=ServiceStatus.RUNNING)
        # the replay's seconds: half of the recovery latency
        try:
            st = self._fresh_kvd_stats()
            self.recovery.set("kvd_replay_seconds",
                              float(st.get("replay_seconds") or 0.0))
        except (OSError, RuntimeError) as e:
            log.warning("could not read kvd replay stats: %s", e)

    def _respawn_data_plane(self, reason: str) -> bool:
        """Respawn a dead kvd on its recorded host:port and data dir:
        clients reconnect to the same address, and the WAL replay
        restores blobs, pool membership and queued messages. Budgeted
        like worker respawns (the lineage ``(DATA_PLANE, kvd)`` in the
        MetaStore), so a data dir that crashes the kvd every time ends
        degraded instead of in a respawn storm. True when a kvd serves
        again."""
        host, port = self.kv_host, self.kv_port
        data_dir = self._kv_data_dir or str(self.workdir / "kvd-data")
        lineage = (ServiceType.DATA_PLANE, "kvd")
        if self._respawn_counts.get(lineage, 0) >= self.max_respawns:
            log.error("kvd respawn budget exhausted (%s): the stack is "
                      "degraded until an operator intervenes", reason)
            self._degraded["data-plane"] = "kvd respawn budget exhausted"
            self._kv_proc = None  # stop supervising the corpse
            return False
        if self._kv_service_id:
            self.meta.update_service(self._kv_service_id,
                                     status=ServiceStatus.CRASHED)
        log.warning("kvd data plane died (%s): respawning on %s:%d with "
                    "WAL replay from %s", reason, host, port, data_dir)
        fsync = os.environ.get("RAFIKI_KVD_FSYNC", self.KVD_FSYNC_DEFAULT)
        t0 = time.monotonic()
        # one boot attempt per monitor tick: poll() holds op_lock, and a
        # wait-for-the-port loop here would stall every admin operation.
        # A failed attempt leaves the dead handle for the next tick; 20
        # failures in a row end degraded
        try:
            self.kv_host, self.kv_port = "", 0
            self._boot_data_plane(host, port, data_dir, fsync)
        except (OSError, RuntimeError) as e:
            self.kv_host, self.kv_port = host, port
            self._kv_boot_attempts += 1
            if self._kv_boot_attempts >= 20:
                self._degraded["data-plane"] = f"kvd respawn failed: {e}"
                self._kv_proc = None
                log.error("kvd respawn failed %d times, giving up: %s",
                          self._kv_boot_attempts, e)
            else:
                log.warning("kvd respawn attempt %d failed (%s): "
                            "retrying on the next monitor tick",
                            self._kv_boot_attempts, e)
            return False
        self._kv_boot_attempts = 0
        self._respawn_counts[lineage] = self._count_respawn(
            ServiceType.DATA_PLANE, "kvd")
        self.recovery.inc("kvd_respawns")
        self._degraded.pop("data-plane", None)
        log.warning("kvd respawned in %.2fs (pid %d, replay %.3fs)",
                    time.monotonic() - t0, self._kv_proc.pid,
                    float(self.recovery["kvd_replay_seconds"]))
        return True

    def _check_data_plane(self) -> None:
        """Monitor-tick half of kvd supervision: a kvd that died (kill
        -9, OOM) is respawned on its recorded port and replays its WAL.
        Runs under op_lock (poll)."""
        if self._kv_proc is None or self.fenced:
            return
        if self._kv_proc.poll() is None:
            return
        self._respawn_data_plane(
            f"process exited rc={self._kv_proc.returncode}")

    def _fresh_kvd_stats(self) -> Dict[str, Any]:
        from rafiki_tpu_torch.native.client import KVClient

        # op_timeout bounds the read too: a wedged kvd is a caught
        # timeout, not a hung /metrics behind _kvd_stats_lock
        c = KVClient(self.kv_host, self.kv_port, connect_timeout=2.0,
                     op_timeout_s=2.0)
        try:
            return c.stats()
        finally:
            c.close()

    def kvd_stats(self, max_age_s: float = 2.0) -> Dict[str, Any]:
        """Cached kvd ``STATS`` plus ``up`` (at most one socket round
        trip per ``max_age_s``)."""
        with self._kvd_stats_lock:
            now = time.monotonic()
            if now - self._kvd_stats_at < max_age_s:
                return dict(self._kvd_stats_cache)
            st: Dict[str, Any] = {"up": 0}
            if self.kv_port:
                try:
                    st = {**self._fresh_kvd_stats(), "up": 1}
                except (OSError, RuntimeError) as e:
                    log.debug("kvd stats probe failed: %s", e)
            self._kvd_stats_cache, self._kvd_stats_at = st, now
            return dict(st)

    def data_plane_status(self) -> Dict[str, Any]:
        """The /health ``data_plane`` block: up, address, data dir, the
        respawn and replay counters and the persistence stats."""
        st = self.kvd_stats()
        return {"up": bool(st.get("up")), "host": self.kv_host,
                "port": self.kv_port, "data_dir": self._kv_data_dir,
                "respawns": self.recovery["kvd_respawns"],
                "replay_seconds": self.recovery["kvd_replay_seconds"],
                "stats": {k: v for k, v in st.items() if k != "up"}}

    @property
    def param_store_uri(self) -> str:
        if self.kv_port:
            return f"kv://{self.kv_host}:{self.kv_port}"
        return f"file://{self.workdir / 'params'}"

    # ---- process plumbing ----
    def _spawn(self, module: str, config: Dict[str, Any],
               service_type: str, slot: Optional[SubMesh] = None,
               wait_port_file: bool = False, timeout: float = 180.0,
               **meta_kwargs: Any) -> ManagedService:
        self._check_fence()
        tag = f"{service_type.lower()}-{uuid.uuid4().hex[:8]}"
        cfg_path = self.workdir / f"{tag}.json"
        port_file = self.workdir / f"{tag}.port"
        if wait_port_file:
            config = {**config, "port_file": str(port_file)}
        cfg_path.write_text(json.dumps(config))

        env = os.environ.copy()
        # the children import this package from wherever it lies, not
        # from the caller's working directory
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
        # a worker sees only its slot's cards; control-plane children
        # (advisor, predictor; slot None) and a CPU stack's workers see
        # none
        env.update(slot_env_vars(self.platform, slot))
        out = open(self.workdir / f"{tag}.log", "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "--config", str(cfg_path)],
            env=env, stdout=out, stderr=subprocess.STDOUT)
        out.close()

        host, port = "127.0.0.1", 0
        if wait_port_file:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if port_file.exists() and port_file.read_text().strip():
                    port = int(port_file.read_text().strip())
                    break
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"{service_type} died on startup; see "
                        f"{self.workdir / f'{tag}.log'}")
                time.sleep(0.05)
            else:
                proc.kill()
                proc.wait()
                raise TimeoutError(f"{service_type} did not report a port")

        spawn_spec = {"module": module, "config": dict(config),
                      "service_type": service_type,
                      "needs_slot": slot is not None,
                      "meta_kwargs": dict(meta_kwargs), "tag": tag}
        row = self.meta.create_service(
            service_type, host=host, port=port, pid=proc.pid,
            devices=[d.id for d in (slot.devices if slot else [])],
            spawn_spec=spawn_spec,
            start_time=proc_start_time(proc.pid),
            **meta_kwargs)
        svc = ManagedService(row["id"], service_type, proc, slot, host, port)
        self.services[row["id"]] = svc
        if service_type in _WORKER_TYPES:
            self._respawn_specs[row["id"]] = {
                "module": module, "config": dict(config),
                "service_type": service_type, "needs_slot": slot is not None,
                "meta_kwargs": dict(meta_kwargs)}
        self.meta.update_service(row["id"], status=ServiceStatus.RUNNING)
        return svc

    def _model_class(self, model: Dict[str, Any]) -> type:
        from rafiki_tpu_torch.model.base import load_model_class

        return load_model_class(model["model_bytes"], model["model_class"])

    # ---- train jobs ----
    def create_train_services(self, train_job_id: str,
                              n_workers: Optional[int] = None
                              ) -> List[ManagedService]:
        with self.op_lock:
            return self._create_train_services(
                train_job_id,
                self.default_workers if n_workers is None else n_workers)

    def _create_train_services(self, train_job_id: str,
                               n_workers: int) -> List[ManagedService]:
        from rafiki_tpu_torch.model.knob import (FixedKnob,
                                                 knob_config_to_json,
                                                 validate_override_keys)

        job = self.meta.get_train_job(train_job_id)
        if job is None:
            raise KeyError(f"no train job {train_job_id!r}")
        budget = job["budget"]
        train_args = job["train_args"]
        n_workers = int(budget.get("WORKER_COUNT",
                                   budget.get("GPU_COUNT", n_workers)))
        subs = self.meta.get_sub_train_jobs_of_train_job(train_job_id)
        classes = {sub["id"]: self._model_class(
            self.meta.get_model(sub["model_id"])) for sub in subs}
        # validated before anything spawns: a knob_overrides key that
        # matches no model's knob config is a typo
        requested = train_args.get("knob_overrides") or {}
        if requested:
            known: set = set()
            for cls in classes.values():
                known |= set(cls.get_knob_config())
            validate_override_keys(
                known, requested,
                context="knob_overrides for this job's models:")
        gang_size = int(train_args.get("gang_size") or 0)

        spawned: List[ManagedService] = []
        for sub in subs:
            model = self.meta.get_model(sub["model_id"])
            model_file = self.workdir / f"model-{model['id']}.py"
            model_file.write_bytes(model["model_bytes"])
            knob_config = classes[sub["id"]].get_knob_config()
            # job-level pins: only the knobs THIS model has, as FixedKnob
            # in the advisor's space (the worker merges them again)
            overrides = {k: v for k, v in requested.items()
                         if k in knob_config}
            if overrides:
                knob_config = {
                    name: (FixedKnob(overrides[name])
                           if name in overrides else knob)
                    for name, knob in knob_config.items()}
            advisor = self._spawn(
                SPAWN_TARGETS[ServiceType.ADVISOR],
                {"knob_config": knob_config_to_json(knob_config),
                 "advisor_type": train_args.get("advisor", "auto"),
                 "total_trials": budget.get("TRIAL_COUNT"),
                 "time_budget_s": (float(budget["TIME_HOURS"]) * 3600
                                   if budget.get("TIME_HOURS") else None)},
                ServiceType.ADVISOR, wait_port_file=True,
                train_job_id=train_job_id, sub_train_job_id=sub["id"])
            spawned.append(advisor)

            # per-trial torch.profiler traces, opt-in via train_args
            profile_dir = ""
            if train_args.get("profile"):
                profile_dir = str(self.workdir / "profiles" / sub["id"])
            for w in range(n_workers):
                slot = self.allocator.acquire(timeout=0.0)
                if slot is None:
                    break  # no free slot; trials queue on fewer workers
                try:
                    worker = self._spawn(
                        SPAWN_TARGETS[ServiceType.TRAIN_WORKER],
                        {"advisor_url": advisor.url,
                         "model_file": str(model_file),
                         "model_class": model["model_class"],
                         "model_id": model["id"],
                         "train_dataset": job["train_dataset_id"],
                         "val_dataset": job["val_dataset_id"],
                         "param_store_uri": self.param_store_uri,
                         "meta_store_path": self.meta._db_path,
                         "sub_train_job_id": sub["id"],
                         "profile_dir": profile_dir,
                         "knob_overrides": overrides,
                         "gang_size": gang_size,
                         "checkpoint_interval_s": train_args.get(
                             "checkpoint_interval_s", 30.0),
                         "worker_id": f"tw-{sub['id'][:8]}-{w}",
                         # the /metrics + /debug/requests sidecar, on an
                         # ephemeral port written to this file
                         "obs_port_file": str(
                             self.workdir / f"tw-{sub['id'][:8]}-{w}"
                                            ".obs_port"),
                         "device": self.worker_device},
                        ServiceType.TRAIN_WORKER, slot=slot,
                        train_job_id=train_job_id,
                        sub_train_job_id=sub["id"])
                except Exception:
                    # the slot never reached a live service: give it back
                    self.allocator.release(slot)
                    raise
                spawned.append(worker)
            self.meta.update_sub_train_job(
                sub["id"], status=SubTrainJobStatus.RUNNING)
        self.meta.update_train_job(train_job_id,
                                   status=TrainJobStatus.RUNNING)
        return spawned

    def wait_train_job(self, train_job_id: str,
                       timeout: float = 3600.0) -> bool:
        """Block until every train worker of the job exits; stops the
        job's advisors; returns True if it finished in time."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll()
            # re-list each tick: poll() may have respawned a crashed
            # worker, and a queued respawn keeps the job busy too
            workers = [s for s in self.services.values()
                       if s.service_type == ServiceType.TRAIN_WORKER]
            if all(not s.alive() for s in workers) and \
                    train_job_id not in self.pending_respawn_job_ids():
                break
            time.sleep(0.2)
        else:
            return False
        for s in list(self.services.values()):
            if s.service_type == ServiceType.ADVISOR:
                self.stop_service(s.service_id)
        for sub in self.meta.get_sub_train_jobs_of_train_job(train_job_id):
            self.meta.update_sub_train_job(sub["id"],
                                           status=SubTrainJobStatus.STOPPED)
        self.meta.update_train_job(train_job_id,
                                   status=TrainJobStatus.STOPPED)
        return True

    # ---- inference jobs ----
    def create_inference_services(self, inference_job_id: str,
                                  max_workers: int = 2
                                  ) -> List[ManagedService]:
        ijob = self.meta.get_inference_job(inference_job_id)
        if ijob is None:
            raise KeyError(f"no inference job {inference_job_id!r}")
        budget = ijob.get("budget") or {}
        try:
            # every refusal and validation happens HERE, at the API
            # call, before a slot is taken or a process spawned
            from rafiki_tpu_torch.worker.inference import _tristate

            if "PAGED_KERNEL" in budget and \
                    _tristate(budget["PAGED_KERNEL"]) is False:
                raise _not_ported("the paged gather path "
                                  "(PAGED_KERNEL=false)")
            best = self.meta.get_best_trials_of_train_job(
                ijob["train_job_id"], max_count=max_workers)
            if not best:
                raise RuntimeError("no completed trials to deploy")
            best, multi_adapter = self._multi_adapter_trials(best, budget)
            serving = best[:1] if multi_adapter else best
            # the autoscale bounds fail the create call, not a monitor
            # tick hours later
            if AutoscaleConfig.from_budget(budget, len(serving)) \
                    is not None and len(serving) > 1:
                # replicas of DISTINCT best trials are an ensemble:
                # clones of trial 0 would double-weight it in the unary
                # gather, and a scale-down could evict another trial's
                # only replica
                raise ValueError(
                    "AUTOSCALE requires a single-replica deployment "
                    f"(this create would spawn {len(serving)} workers, "
                    "one per DISTINCT best trial): create with "
                    "max_workers=1 (or MULTI_ADAPTER) and let the "
                    "autoscaler grow the pool with clones of the best "
                    "trial")
            plans = [self._inference_worker_config(
                inference_job_id, i, trial, budget,
                n_workers=len(serving))
                for i, trial in enumerate(serving)]
            if multi_adapter:
                # the other best trials ride as stacked adapters 1..N
                plans[0]["extra_adapter_trials"] = [t["id"]
                                                    for t in best[1:]]
            pred_cfg = self._predictor_config(budget)
        except BaseException:
            self.meta.update_inference_job(inference_job_id,
                                           status="ERRORED")
            raise

        # A replica MUST own a device slot: quietly pinning it to the
        # host would serve at CPU speed. Every slot is acquired BEFORE
        # taking op_lock: release paths (poll / stop_service) need that
        # lock, so on a one-card host the finished train job's worker
        # hands its slot back while this call waits.
        slots: List[SubMesh] = []
        for i in range(len(plans)):
            slot = self.allocator.acquire(timeout=self.slot_timeout)
            if slot is None:
                for s in slots:
                    self.allocator.release(s)
                self.meta.update_inference_job(inference_job_id,
                                               status="ERRORED")
                raise RuntimeError(
                    f"no free device slot for inference replica {i} after "
                    f"{self.slot_timeout:.0f}s ({self.allocator.n_slots} "
                    f"slots, {self.allocator.free_count()} free); stop a "
                    "running job or lower the replica count")
            slots.append(slot)

        with self.op_lock:
            try:
                return self._create_inference_services(
                    inference_job_id, plans, slots, pred_cfg)
            except BaseException:
                # slots not yet handed to a spawned service stay ours
                held = {id(s.slot) for s in self.services.values()
                        if s.slot is not None}
                for slot in slots:
                    if id(slot) not in held:
                        self.allocator.release(slot)
                self.meta.update_inference_job(inference_job_id,
                                               status="ERRORED")
                raise

    def _multi_adapter_trials(self, best: List[Dict[str, Any]],
                              budget: Dict[str, Any]):
        """``MULTI_ADAPTER``: the best-N LM trials as ONE worker serving
        N stacked adapters (adapter 0 the best trial), one slot, when at
        least two of them share the primary's model and shape signature
        (the others are dropped with a warning); otherwise a warning and
        plain replicas. Returns ``(trials, multi_adapter)``."""
        if not (bool(budget.get("MULTI_ADAPTER")) and len(best) > 1):
            return best, False

        def model_of(trial: Dict[str, Any]) -> Dict[str, Any]:
            sub = self.meta.get_sub_train_job(trial["sub_train_job_id"])
            return self.meta.get_model(sub["model_id"])

        primary = model_of(best[0])
        if primary["task"] != TaskType.LANGUAGE_MODELING:
            log.warning("MULTI_ADAPTER ignored: task %s is not a language-"
                        "modeling job; deploying plain replicas",
                        primary["task"])
            return best, False
        sig0 = best[0].get("shape_signature")
        same = [best[0]] + [t for t in best[1:]
                            if model_of(t)["id"] == primary["id"]
                            and t.get("shape_signature") == sig0]
        if len(same) < 2:
            log.warning("MULTI_ADAPTER ignored: no other best trial shares "
                        "model %s and shape %r; deploying plain replicas",
                        primary["id"], sig0)
            return best, False
        if len(same) < len(best):
            log.warning("MULTI_ADAPTER: dropping %d best trial(s) with a "
                        "different model or shape; stacking %d trials of "
                        "model %s", len(best) - len(same), len(same),
                        primary["id"])
        return same, True

    @staticmethod
    def _disaggregation_budget(budget: Dict[str, Any], n_workers: int):
        """The disaggregated prefill/decode and host-tier budget keys,
        validated as the JAX manager validates them, with its messages.
        ``WORKER_ROLE``: one role for every worker, or a comma-separated
        role per worker index (``"prefill,decode"``); a pool of prefill
        roles only serves nothing. ``HOST_KV_PAGES`` (>= 1, with
        ``KV_PAGE_SIZE``): each worker's host page tier. ``KV_WAIT_S``
        (>= 0, with ``WORKER_ROLE``): how long a decode worker holds a
        request for its shipment before re-prefilling locally. Returns
        ``(roles, host_kv_pages, kv_wait_s)`` (``[]``, 0, None when
        absent)."""
        from rafiki_tpu_torch.serving.kv_transfer import normalize_role

        roles: List[str] = []
        if budget.get("WORKER_ROLE"):
            try:
                roles = [normalize_role(r) for r in
                         str(budget["WORKER_ROLE"]).split(",")]
            except ValueError as e:
                raise ValueError(f"WORKER_ROLE: {e}") from e
            if len(roles) == 1:
                roles = roles * n_workers
            if len(roles) != n_workers:
                raise ValueError(
                    f"WORKER_ROLE names {len(roles)} roles for "
                    f"{n_workers} workers (one per worker, or a "
                    "single role for all)")
            if all(r == "prefill" for r in roles):
                raise ValueError(
                    "WORKER_ROLE: an all-prefill pool serves nothing "
                    "— at least one worker must be decode or unified")
        host_kv_pages = 0
        if budget.get("HOST_KV_PAGES"):
            host_kv_pages = int(budget["HOST_KV_PAGES"])
            if host_kv_pages < 1:
                raise ValueError(
                    f"HOST_KV_PAGES={host_kv_pages} must be >= 1 "
                    "(host-tier page count)")
            if not budget.get("KV_PAGE_SIZE"):
                raise ValueError(
                    "HOST_KV_PAGES requires KV_PAGE_SIZE in the same "
                    "budget (pages are the host tier's transfer unit)")
        kv_wait_s = None
        if "KV_WAIT_S" in budget:
            kv_wait_s = float(budget["KV_WAIT_S"])
            if kv_wait_s < 0:
                raise ValueError(f"KV_WAIT_S={kv_wait_s} must be >= 0")
            if not roles:
                raise ValueError(
                    "KV_WAIT_S requires WORKER_ROLE in the same "
                    "budget (it tunes the disaggregated decode leg)")
        return roles, host_kv_pages, kv_wait_s

    def _inference_worker_config(self, inference_job_id: str, i: int,
                                 trial: Dict[str, Any],
                                 budget: Dict[str, Any],
                                 n_workers: int = 1) -> Dict[str, Any]:
        """Worker ``i``'s (of ``n_workers``) config for ``trial``, the
        budget's serving options validated as the JAX manager validates
        them."""
        from rafiki_tpu_torch.serving.slo import normalize_slo

        roles, host_kv_pages, kv_wait_s = self._disaggregation_budget(
            budget, n_workers)

        sub = self.meta.get_sub_train_job(trial["sub_train_job_id"])
        model = self.meta.get_model(sub["model_id"])
        model_file = self.workdir / f"model-{model['id']}.py"
        model_file.write_bytes(model["model_bytes"])
        # generative tasks serve through the continuous-batching decode
        # loop, the others through the micro-batcher
        decode_loop = model["task"] == TaskType.LANGUAGE_MODELING
        wid = f"iw-{inference_job_id[:8]}-{i}"
        cfg = {"model_file": str(model_file),
               "model_class": model["model_class"],
               "trial_id": trial["id"], "knobs": trial["knobs"],
               "worker_id": wid, "decode_loop": decode_loop,
               # the obs sidecar (/metrics, /debug/requests, /drain) on
               # an ephemeral port written to this file: the drain and
               # adoption probes find it there
               "obs_port_file": str(self.workdir / f"{wid}.obs_port"),
               "steps_per_sync": int(budget.get("STEPS_PER_SYNC", 4)),
               "pool_id": inference_job_id,
               "device": self.worker_device}
        if budget.get("MAX_NEW_TOKENS"):
            cfg["max_new_tokens"] = int(budget["MAX_NEW_TOKENS"])
        if "SLO_DEFAULT" in budget:
            try:
                cfg["default_slo"] = normalize_slo(budget["SLO_DEFAULT"])
            except ValueError as e:
                raise ValueError(f"SLO_DEFAULT: {e}") from e
        if budget.get("SYSTEM_PREFIX"):
            cfg["system_prefix"] = str(budget["SYSTEM_PREFIX"])
        self._speculation_config(cfg, budget, model, decode_loop)
        if budget.get("KV_PAGE_SIZE"):
            if not decode_loop:
                raise ValueError(
                    "KV_PAGE_SIZE requires a language-modeling "
                    "deployment (the decode loop owns the KV cache); "
                    f"task {model['task']} serves through the "
                    "micro-batcher")
            page = int(budget["KV_PAGE_SIZE"])
            trial_max_len = int(
                (trial.get("knobs") or {}).get("max_len", 0) or 0)
            if page <= 0 or (trial_max_len and trial_max_len % page):
                raise ValueError(
                    f"KV_PAGE_SIZE={page} must be > 0 and divide the "
                    f"trial's max_len ({trial_max_len})")
            cfg["kv_page_size"] = page
            if budget.get("KV_PAGES"):
                pages = int(budget["KV_PAGES"])
                if pages < 2:
                    raise ValueError(
                        f"KV_PAGES={pages} must be >= 2 (page 0 is the "
                        "scratch page; at least one usable page) — omit "
                        "it for the full-coverage default")
                cfg["kv_pages"] = pages
        elif budget.get("KV_PAGES"):
            raise ValueError("KV_PAGES requires KV_PAGE_SIZE in the same "
                             "budget (pages have no size without it)")
        elif "PAGED_KERNEL" in budget:
            raise ValueError("PAGED_KERNEL requires KV_PAGE_SIZE in the "
                             "same budget (it selects the PAGED decode "
                             "path's implementation)")
        if host_kv_pages:
            # the KV_PAGE_SIZE checks above guaranteed a paged decode loop
            cfg["host_kv_pages"] = host_kv_pages
        if roles:
            if not decode_loop:
                raise ValueError(
                    "WORKER_ROLE requires a language-modeling "
                    "deployment (the decode loop owns the KV "
                    f"shipments); task {model['task']} serves "
                    "through the micro-batcher")
            if roles[i] != "unified":
                cfg["role"] = roles[i]
        if kv_wait_s is not None:
            cfg["kv_wait_s"] = kv_wait_s
        return cfg

    def _speculation_config(self, cfg: Dict[str, Any],
                            budget: Dict[str, Any], model: Dict[str, Any],
                            decode_loop: bool) -> None:
        """``SPECULATE_K`` (>= 2) enables prompt-lookup speculation;
        ``DRAFT_TRIAL_ID`` names a completed trial of the same model as
        the draft model (its own knobs shape it). The JAX manager's
        checks, at the create call."""
        if decode_loop and budget.get("SPECULATE_K"):
            spec_k = int(budget["SPECULATE_K"])
            if spec_k < 2:
                raise ValueError(
                    f"SPECULATE_K={spec_k} must be >= 2 (draft window "
                    "depth; 1 would verify nothing)")
            cfg["speculate_k"] = spec_k
            draft_id = str(budget.get("DRAFT_TRIAL_ID") or "")
            if draft_id:
                d_trial = self.meta.get_trial(draft_id)
                if d_trial is None:
                    raise KeyError(
                        f"DRAFT_TRIAL_ID {draft_id!r} names no trial")
                d_sub = self.meta.get_sub_train_job(
                    d_trial["sub_train_job_id"])
                if d_sub and d_sub["model_id"] != model["id"]:
                    raise ValueError(
                        f"DRAFT_TRIAL_ID {draft_id!r} is a different model "
                        f"({d_sub['model_id']}) than the deployed "
                        f"{model['id']} — the draft must share the "
                        "target's template/tokenizer")
                cfg["draft_trial_id"] = draft_id
                cfg["draft_knobs"] = d_trial["knobs"]
        elif budget.get("DRAFT_TRIAL_ID") or budget.get("SPECULATE_K"):
            if not decode_loop:
                raise ValueError(
                    "SPECULATE_K/DRAFT_TRIAL_ID require a language-"
                    "modeling deployment (the decode loop); task "
                    f"{model['task']} serves through the micro-batcher")
            raise ValueError(
                "DRAFT_TRIAL_ID requires SPECULATE_K >= 2 (the draft "
                "window depth) in the same budget")

    def _predictor_config(self, budget: Dict[str, Any]) -> Dict[str, Any]:
        """The predictor's config, the budget's SLO keys validated as
        the JAX manager validates them."""
        from rafiki_tpu_torch.serving.slo import normalize_slo

        cfg: Dict[str, Any] = {
            "host": "127.0.0.1", "port": 0,
            "adaptive_gather": bool(budget.get("ADAPTIVE_GATHER"))}
        if "SLO_DEFAULT" in budget:
            cfg["default_slo"] = normalize_slo(budget["SLO_DEFAULT"])
        depths: Dict[str, int] = {}
        for key, cls in (("SLO_SHED_BATCH_DEPTH", "batch"),
                         ("SLO_SHED_BACKGROUND_DEPTH", "background")):
            if key in budget:
                d = int(budget[key])
                if d < 0:
                    raise ValueError(f"{key}={d} must be >= 0 "
                                     "(fleet queue-backlog cap)")
                depths[cls] = d
        if depths:
            cfg["slo_shed_depths"] = depths
        target = 0.0
        if budget.get("SLO_P95_TARGET_S"):
            target = float(budget["SLO_P95_TARGET_S"])
            if target <= 0:
                raise ValueError(
                    f"SLO_P95_TARGET_S={budget['SLO_P95_TARGET_S']} must "
                    "be > 0 (target interactive TTFT p95, seconds)")
            cfg["brownout_target_p95_s"] = target
        if "SLO_BACKGROUND_MAX_NEW" in budget:
            clamp = int(budget["SLO_BACKGROUND_MAX_NEW"])
            if clamp < 1:
                raise ValueError(
                    f"SLO_BACKGROUND_MAX_NEW={clamp} must be >= 1")
            if not target:
                raise ValueError(
                    "SLO_BACKGROUND_MAX_NEW requires SLO_P95_TARGET_S in "
                    "the same budget (the brownout ladder applies the "
                    "clamp at stage 2)")
            cfg["brownout_clamp_max_new"] = clamp
        return cfg

    def _create_inference_services(self, inference_job_id: str,
                                   plans: List[Dict[str, Any]],
                                   slots: List[SubMesh],
                                   pred_cfg: Dict[str, Any]
                                   ) -> List[ManagedService]:
        if not self.kv_port:
            self.start_data_plane()
        spawned: List[ManagedService] = []
        for cfg, slot in zip(plans, slots):
            cfg = {**cfg, "param_store_uri": self.param_store_uri,
                   "kv_host": self.kv_host, "kv_port": self.kv_port}
            spawned.append(self._spawn(
                SPAWN_TARGETS[ServiceType.INFERENCE_WORKER], cfg,
                ServiceType.INFERENCE_WORKER, slot=slot,
                inference_job_id=inference_job_id))
        predictor = self._spawn(
            SPAWN_TARGETS[ServiceType.PREDICTOR],
            {**pred_cfg, "worker_ids": [c["worker_id"] for c in plans],
             "kv_host": self.kv_host, "kv_port": self.kv_port,
             # the live routing-pool key: the predictor's router follows
             # the memberships published under the job id
             "pool_id": inference_job_id},
            ServiceType.PREDICTOR, wait_port_file=True,
            inference_job_id=inference_job_id)
        spawned.append(predictor)
        self.meta.update_inference_job(
            inference_job_id, status="RUNNING",
            predictor_host=f"{predictor.host}:{predictor.port}")
        # the scale-out state (routing pool, replica template, the
        # autoscale policy when the budget asked for one) and the first
        # published membership for the predictor's router
        self._ensure_scaleout(inference_job_id)
        self._publish_pool(inference_job_id)
        return spawned

    # ---- lifecycle / failure detection ----
    def poll(self) -> None:
        """Reap exited children; release their slots; record status;
        respawn a crashed worker of a running job within its budget."""
        with self.op_lock:
            self._poll()

    def _poll(self) -> None:
        self._check_data_plane()
        if self._pending_respawns:
            still_pending: List[Dict[str, Any]] = []
            for item in self._pending_respawns:
                try:
                    if not self._respawn(item["dead_id"], item["spec"]):
                        still_pending.append(item)
                except Exception as e:  # keep polling, but never drop
                    # healing silently
                    log.warning("queued respawn for %s failed and was "
                                "dropped: %s", item["dead_id"], e)
                    mk = item["spec"]["meta_kwargs"]
                    self._mark_degraded(
                        item["spec"]["service_type"],
                        mk.get("train_job_id")
                        or mk.get("inference_job_id"),
                        f"queued respawn failed: {e}")
            self._pending_respawns = still_pending
        for svc in list(self.services.values()):
            if svc.alive():
                continue
            code = svc.proc.returncode
            status = (ServiceStatus.STOPPED if code == 0
                      else ServiceStatus.ERRORED)
            self.meta.update_service(svc.service_id, status=status)
            if svc.slot is not None:
                self.allocator.release(svc.slot)
                svc.slot = None
            spec = self._respawn_specs.pop(svc.service_id, None)
            del self.services[svc.service_id]
            if status == ServiceStatus.ERRORED and spec is not None:
                # a crashed worker is replaced while its job still runs
                # (rc 0 is a normal completion, no respawn)
                if svc.service_type == ServiceType.INFERENCE_WORKER:
                    self._unroute_crashed(spec)
                try:
                    if not self._respawn(svc.service_id, spec):
                        self._pending_respawns.append(
                            {"dead_id": svc.service_id, "spec": spec})
                except Exception as e:  # the monitor loop must survive
                    log.warning("respawn of %s failed: %s",
                                svc.service_id, e)

    def _respawn(self, dead_service_id: str, spec: Dict[str, Any]) -> bool:
        """Spawn a replacement for a crashed worker. True when the case
        is resolved (respawned, or no longer needed); False = no free
        slot right now, the caller queues a retry."""
        meta_kwargs = spec["meta_kwargs"]
        job_id = meta_kwargs.get("train_job_id") or \
            meta_kwargs.get("inference_job_id")
        stype = spec["service_type"]
        if stype == ServiceType.TRAIN_WORKER:
            job = self.meta.get_train_job(job_id) if job_id else None
        else:
            job = self.meta.get_inference_job(job_id) if job_id else None
        if not job or job["status"] != "RUNNING":
            return True  # parent finished/stopped: nothing to heal
        lineage = (stype, job_id)
        if self._respawn_counts.get(lineage, 0) >= self.max_respawns:
            log.warning("respawn budget exhausted for %s job %s (last "
                        "casualty %s) — a worker config appears to crash "
                        "deterministically", stype, job_id,
                        dead_service_id)
            self._mark_degraded(stype, job_id, "respawn budget exhausted")
            return True
        slot = None
        if spec["needs_slot"]:
            slot = self.allocator.acquire(timeout=0.0)
            if slot is None:
                return False
        port_file = spec["config"].get("obs_port_file")
        if port_file and stype == ServiceType.INFERENCE_WORKER:
            try:
                Path(port_file).unlink()  # a killed worker's stale file
            except OSError:               # must not read as booted
                pass
        try:
            self._spawn(spec["module"], spec["config"], stype, slot=slot,
                        **meta_kwargs)
        except Exception:
            if slot is not None:
                self.allocator.release(slot)
            raise
        if stype == ServiceType.INFERENCE_WORKER:
            self._rejoin_when_warm(job_id, spec)
        self._respawn_counts[lineage] = self._count_respawn(stype, job_id)
        self._degraded.pop(job_id, None)
        return True

    def _unroute_crashed(self, spec: Dict[str, Any]) -> None:
        """Take a crashed worker out of its job's published pool while a
        sibling stays (the caller holds op_lock): the predictor then
        fails the worker's streams over at its next membership read and
        routes no new one there, where it would otherwise go on picking
        the dead worker on its last stats until the stream silence
        window ran out. The JAX manager keeps it in the pool."""
        job_id = spec["meta_kwargs"].get("inference_job_id")
        wid = spec["config"].get("worker_id")
        st = self._scaleout.get(job_id) if job_id else None
        if st is None or wid not in st["pool"] or len(st["pool"]) < 2:
            return
        st["pool"].remove(wid)
        self._publish_pool(job_id)

    def _rejoin_when_warm(self, job_id: str, spec: Dict[str, Any]) -> None:
        """A respawned worker that ``_unroute_crashed`` took out of the
        pool rejoins it as a scale-up does: WARMING until its obs port
        reports (``_promote_warmed``)."""
        wid = spec["config"].get("worker_id")
        st = self._scaleout.get(job_id)
        if st is None or not wid or wid in st["pool"] or any(
                w["wid"] == wid for w in st["warming"]):
            return
        port_file = spec["config"].get("obs_port_file")
        if not port_file:  # nothing to wait on: back in at once
            st["pool"].append(wid)
            self._publish_pool(job_id)
            return
        st["warming"].append({"wid": wid, "port_file": str(port_file),
                              "since": time.monotonic()})

    def _count_respawn(self, stype: str, job_id: str) -> int:
        """The lineage's respawn count after one more respawn, written
        through to the MetaStore (so an admin crash cannot reset the
        budget); a failed write falls back to the in-memory count, so a
        store hiccup never costs the healing that just happened."""
        try:
            return int(self.meta.incr_respawn_count(stype, job_id))
        except Exception as e:  # noqa: BLE001 — see the docstring
            log.warning("respawn budget write-through for %s:%s failed: "
                        "%s", stype, job_id, e)
            return self._respawn_counts.get((stype, job_id), 0) + 1

    def _live_workers_of(self, stype: str, job_id: str
                         ) -> List[ManagedService]:
        key = ("train_job_id" if stype == ServiceType.TRAIN_WORKER
               else "inference_job_id")
        return [svc for sid, svc in self.services.items()
                if svc.service_type == stype and svc.alive()
                and (self._respawn_specs.get(sid) or {}).get(
                    "meta_kwargs", {}).get(key) == job_id]

    def _mark_degraded(self, stype: str, job_id: Optional[str],
                       reason: str) -> None:
        """Record a job whose self-healing is gone; with no worker left
        its row turns ERRORED."""
        if not job_id:
            return
        self._degraded[job_id] = reason
        if self._live_workers_of(stype, job_id):
            return  # under-replicated but still serving
        try:
            if stype == ServiceType.TRAIN_WORKER:
                self.meta.update_train_job(job_id,
                                           status=TrainJobStatus.ERRORED)
            else:
                self.meta.update_inference_job(job_id, status="ERRORED")
        except Exception as e:  # noqa: BLE001 — a store hiccup must not
            # kill the monitor loop; the flag above carries the signal
            log.warning("could not mark job %s ERRORED: %s", job_id, e)

    def degraded_jobs(self) -> Dict[str, str]:
        """Jobs that lost self-healing (job id → reason), for /health.
        Jobs an operator has since STOPPED drop off the list (ERRORED
        ones stay: that verdict is the point of the flag)."""
        with self.op_lock:
            out = dict(self._degraded)
        for jid in list(out):
            job = self.meta.get_train_job(jid) or \
                self.meta.get_inference_job(jid)
            if job is not None and job.get("status") == "STOPPED":
                with self.op_lock:
                    self._degraded.pop(jid, None)
                del out[jid]
        return out

    def respawn_stats(self) -> Dict[str, int]:
        self.degraded_jobs()  # prune STOPPED jobs before counting
        with self.op_lock:
            return {"respawns_done": sum(self._respawn_counts.values()),
                    "pending_respawns": len(self._pending_respawns),
                    "degraded_jobs": len(self._degraded),
                    "rolling_restarts_done": self._rolling_restarts}

    def pending_respawn_job_ids(self) -> set:
        """Jobs with a queued (slot-starved) worker respawn: they count
        as busy, or the finalizer would declare them done."""
        with self.op_lock:
            out = set()
            for item in self._pending_respawns:
                mk = item["spec"]["meta_kwargs"]
                jid = mk.get("train_job_id") or mk.get("inference_job_id")
                if jid:
                    out.add(jid)
            return out

    # ---- graceful drain / rolling restart ----
    def _request_drain(self, config: Dict[str, Any]) -> bool:
        """Ask a worker to drain: ``POST /drain`` on its obs sidecar (the
        port in the ``obs_port_file`` it wrote at boot), else a
        ``{"control": "drain"}`` message on its query queue. False when
        neither channel is there."""
        from rafiki_tpu_torch.utils.http import json_request

        port_file = config.get("obs_port_file")
        if port_file:
            try:
                port = int(Path(port_file).read_text().strip())
                json_request("POST", f"http://127.0.0.1:{port}/drain", {},
                             timeout=5.0)
                return True
            except Exception as e:  # the sidecar may be gone with a
                # hung worker; the queue channel still works
                log.warning("drain via obs sidecar failed (%s); falling "
                            "back to the queue control message", e)
        wid = config.get("worker_id")
        if wid and self.kv_port:
            from rafiki_tpu_torch.serving.queues import (KVQueueHub,
                                                         pack_message)

            KVQueueHub(self.kv_host, self.kv_port).push_query(
                wid, pack_message({"control": "drain"}))
            return True
        log.warning("no drain channel for worker %r",
                    config.get("worker_id"))
        return False

    def rolling_restart(self, inference_job_id: str,
                        drain_timeout: float = 120.0) -> Dict[str, Any]:
        """Drain, stop and respawn each of a live inference job's
        workers one at a time: the draining worker finishes its
        in-flight requests (streams too) while its siblings take the
        traffic, and only then is it replaced on its freed slot. Where
        the pool has another member, the worker leaves the published
        membership first and is drained only once the job's predictor
        routes without it, and its replacement rejoins once it has
        booted (obs port written, fresh stats on the hub) and the
        predictor routes to it again, before the next worker leaves (the
        JAX manager drains at once and goes on when the replacement's
        process starts: a two-worker pool then had both workers out of
        the predictor's routing while the replacement booted, every
        request a 503, and requests routed to a drained worker after it
        exited waited out the gather deadline). A worker that does not
        drain within ``drain_timeout`` is terminated, so the restart
        converges over a hung process. Returns the old → new service id
        pairs."""
        self._check_fence()
        if not self._rolling_lock.acquire(blocking=False):
            raise RuntimeError(
                "a rolling restart is already in progress: wait for it "
                "to finish (retrying a timed-out request would drain the "
                "fresh replacements)")
        try:
            return self._rolling_restart(inference_job_id, drain_timeout)
        finally:
            self._rolling_lock.release()

    def _rolling_restart(self, inference_job_id: str,
                         drain_timeout: float) -> Dict[str, Any]:
        with self.op_lock:
            targets = []
            for sid, svc in list(self.services.items()):
                if svc.service_type != ServiceType.INFERENCE_WORKER:
                    continue
                spec = self._respawn_specs.get(sid)
                if spec and spec["meta_kwargs"].get(
                        "inference_job_id") == inference_job_id:
                    targets.append((sid, svc, spec))
        if not targets:
            raise KeyError("no live inference workers for job "
                           f"{inference_job_id!r}")
        st = self._ensure_scaleout(inference_job_id)
        if st is not None:
            with self.op_lock:
                st["rolling"] = True  # the autoscaler waits it out
        try:
            return {"job_id": inference_job_id,
                    "restarted": [self._restart_one(inference_job_id, st,
                                                    sid, svc, spec,
                                                    drain_timeout)
                                  for sid, svc, spec in targets]}
        finally:
            if st is not None:
                with self.op_lock:
                    st["rolling"] = False

    def _restart_one(self, job_id: str, st: Optional[Dict[str, Any]],
                     sid: str, svc: ManagedService, spec: Dict[str, Any],
                     drain_timeout: float) -> Dict[str, Any]:
        """One step of a rolling restart: membership out (where a
        sibling stays), drain, reap, respawn on the freed slot, and
        membership back in once the replacement serves."""
        wid = spec["config"].get("worker_id")
        with self.op_lock:
            # healing off for this worker only, at its turn: its exit
            # (or the terminate below) must not make the monitor respawn
            # it beside the replacement spawned here
            self._respawn_specs.pop(sid, None)
            pos = None
            if st is not None and wid in st["pool"] \
                    and len(st["pool"]) > 1:
                pos = st["pool"].index(wid)
                st["pool"].remove(wid)
        if pos is not None:
            self._publish_pool(job_id)
            self._await_pool_applied(job_id)
        drain_sent = self._request_drain(spec["config"])
        # wait outside op_lock, so the monitor keeps polling; a worker
        # never asked to drain gets a short grace only
        try:
            svc.proc.wait(timeout=drain_timeout if drain_sent
                          else min(5.0, drain_timeout))
        except subprocess.TimeoutExpired:
            log.warning("worker %s did not drain within %.0fs%s; "
                        "terminating", sid, drain_timeout,
                        "" if drain_sent else " (no drain channel)")
            svc.proc.terminate()
            try:
                svc.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                svc.proc.kill()
                svc.proc.wait()
        with self.op_lock:
            if sid in self.services:  # the monitor may have reaped the
                # rc 0 exit already (a drain is a clean exit)
                self.meta.update_service(sid, status=ServiceStatus.STOPPED)
                if svc.slot is not None:
                    self.allocator.release(svc.slot)
                    svc.slot = None
                del self.services[sid]
            slot = None
            if spec["needs_slot"]:
                slot = self.allocator.acquire(timeout=self.slot_timeout)
                if slot is None:
                    raise RuntimeError(
                        "no free device slot to respawn drained worker "
                        f"{sid}: rolling restart aborted mid-way")
            port_file = spec["config"].get("obs_port_file")
            if port_file:
                try:
                    Path(port_file).unlink()  # a stale file must not
                except OSError:               # read as ready
                    pass
            try:
                # op_lock held across the spawn: a concurrent op must not
                # take the vacated slot mid-restart
                new = self._spawn(spec["module"], spec["config"],
                                  spec["service_type"], slot=slot,
                                  **spec["meta_kwargs"])
            except Exception:
                if slot is not None:
                    self.allocator.release(slot)
                raise
            self._rolling_restarts += 1
            # a fresh healthy worker supersedes a degraded flag
            self._degraded.pop(job_id, None)
        self._wait_ready(new, port_file, self.WARM_PUBLISH_TIMEOUT_S, wid)
        if pos is not None:
            with self.op_lock:
                if wid not in st["pool"]:
                    st["pool"].insert(min(pos, len(st["pool"])), wid)
            self._publish_pool(job_id)
            self._await_pool_applied(job_id)
        return {"old": sid, "new": new.service_id,
                "drained": bool(drain_sent)}

    def _wait_ready(self, svc: ManagedService, port_file: Optional[str],
                    timeout: float, wid: Optional[str] = None) -> None:
        """Wait until a respawned worker has booted (its obs port
        written and, where the hub holds stats under its id, stats that
        no longer say ``draining``: the predictor re-admits it on
        those), exits, or ``timeout`` passes."""
        if not port_file:
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and svc.alive() and \
                not Path(port_file).exists():
            time.sleep(0.05)
        while wid and self.kv_port and time.monotonic() < deadline \
                and svc.alive():
            try:
                stats = self._pool_hub().get_worker_stats(wid)
            except Exception:  # noqa: BLE001 — a hub hiccup: the port
                return         # file already says the worker is up
            if not (isinstance(stats, dict) and stats.get("draining")):
                return
            time.sleep(0.05)

    #: the longest a membership change waits for the job's predictor to
    #: route over it (the predictor re-reads membership on ``/health``
    #: at most every 2 s); past it, or with no predictor answering, the
    #: caller goes on
    POOL_APPLY_TIMEOUT_S = 10.0

    def _await_pool_applied(self, job_id: str) -> bool:
        """Wait until the job's predictor routes over exactly the
        published pool: its ``/health`` (which re-reads the membership)
        lists those workers on its breaker board. False when no
        predictor answers or ``POOL_APPLY_TIMEOUT_S`` passes."""
        from rafiki_tpu_torch.utils.http import json_request

        with self.op_lock:
            st = self._scaleout.get(job_id)
            want = set(st["pool"]) if st is not None else set()
        addr = (self.meta.get_inference_job(job_id) or {}).get(
            "predictor_host")
        if not want or not addr:
            return False
        deadline = time.monotonic() + self.POOL_APPLY_TIMEOUT_S
        while True:
            try:
                health = json_request("GET", f"http://{addr}/health",
                                      timeout=5.0)
            except Exception:  # noqa: BLE001 — no predictor to wait for
                return False
            if set((health or {}).get("breakers") or {}) == want:
                return True
            if time.monotonic() >= deadline:
                log.warning("job %s's predictor did not apply the pool "
                            "%s within %.0fs", job_id, sorted(want),
                            self.POOL_APPLY_TIMEOUT_S)
                return False
            time.sleep(0.1)

    # ---- horizontal scale-out and the autoscaler ----
    #: floor between autoscale evaluations (the monitor ticks faster)
    AUTOSCALE_TICK_EVERY_S = 1.0
    #: a scaled-up worker joins the routing pool when its obs sidecar
    #: reports a port (boot and warmup done), or after this long
    #: regardless: the predictor's breakers gate a worker that still does
    #: not serve, and membership must not hang on a lost port file
    WARM_PUBLISH_TIMEOUT_S = 600.0

    def _pool_hub(self):
        """A cached KVQueueHub on the live data plane (worker stats reads
        and pool-membership publishes)."""
        from rafiki_tpu_torch.serving.queues import KVQueueHub

        key = (self.kv_host, self.kv_port)
        if self._pool_hub_cache is None or self._pool_hub_key != key:
            self._pool_hub_cache = KVQueueHub(self.kv_host, self.kv_port)
            self._pool_hub_key = key
        return self._pool_hub_cache

    @staticmethod
    def _wid_index(wid: str) -> int:
        """The numeric suffix of an ``iw-<job8>-<n>`` worker id (pool
        order and the next index); -1 when there is none."""
        try:
            return int(wid.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return -1

    def _ensure_scaleout(self, job_id: str) -> Optional[Dict[str, Any]]:
        """The job's scale-out state, rebuilt from the live services'
        respawn specs and the job budget when missing (so an adopted
        stack keeps scaling after an admin restart). None when the job
        has no live inference worker to take a pool and a template
        from."""
        with self.op_lock:
            st = self._scaleout.get(job_id)
            if st is not None:
                return st
            workers: List[Any] = []
            for spec in self._respawn_specs.values():
                if spec["service_type"] != ServiceType.INFERENCE_WORKER:
                    continue
                if spec["meta_kwargs"].get("inference_job_id") != job_id:
                    continue
                wid = str(spec["config"].get("worker_id") or "")
                if wid:
                    workers.append((self._wid_index(wid), wid, spec))
            if not workers:
                return None
            workers.sort(key=lambda t: (t[0], t[1]))
            job = self.meta.get_inference_job(job_id)
            budget = (job or {}).get("budget") or {}
            policy = None
            trial_ids = {s["config"].get("trial_id")
                         for _, _, s in workers}
            try:
                cfg_as = AutoscaleConfig.from_budget(budget,
                                                     len(workers))
                if cfg_as is not None and len(trial_ids) > 1:
                    # an ensemble pool (distinct trials) is never
                    # autoscaled: clones would skew the gather and a
                    # shrink could evict a trial's only replica
                    raise ValueError(
                        "pool serves distinct trials (ensemble)")
                if cfg_as is not None:
                    policy = AutoscalePolicy(cfg_as)
            except ValueError as e:
                # validated at create; a rebuilt pool can disagree with
                # the bounds after a manual scale: track the pool without
                # the policy rather than not at all
                log.warning("autoscaler for job %s disabled on rebuild: "
                            "%s", job_id, e)
            # the replica template: a SERVING worker's config (a
            # disaggregated job's worker 0 may be prefill-role, and a
            # clone of it would never answer queries); the fallback
            # strips the role, as a unified clone serves either way
            tmpl_cfg = next((dict(spec["config"])
                             for _i, _w, spec in workers
                             if spec["config"].get("role")
                             != "prefill"), None)
            if tmpl_cfg is None:
                tmpl_cfg = dict(workers[0][2]["config"])
                tmpl_cfg.pop("role", None)
            st = {"pool": [w for _, w, _ in workers],
                  "template": tmpl_cfg,
                  "module": workers[0][2]["module"],
                  "next_index": max(i for i, _, _ in workers) + 1,
                  "pool_version": 0.0, "policy": policy,
                  "warming": [], "victim": None,
                  "drain_timeout": 120.0}
            self._scaleout[job_id] = st
            return st

    def _publish_pool(self, job_id: str) -> None:
        """Write the job's routing-pool membership to the hub (the
        predictor's router applies the diff live). The version is a
        strictly increasing stamp, so a late re-delivery cannot roll the
        pool back."""
        with self.op_lock:
            st = self._scaleout.get(job_id)
            if st is None or not self.kv_port:
                return
            st["pool_version"] = max(time.time(),
                                     st["pool_version"] + 1e-4)
            members = {"workers": list(st["pool"]),
                       "version": st["pool_version"],
                       "published_at": time.time()}
        try:
            self._pool_hub().put_pool_members(job_id, members)
            self.scaling.inc("pool_publishes")
        except Exception:  # noqa: BLE001 — the hub may be mid-restart;
            # the next scale event or tick republishes
            log.warning("pool membership publish failed for job %s",
                        job_id, exc_info=True)

    def _worker_sid(self, job_id: str, wid: str) -> Optional[str]:
        """The service id of the job's worker ``wid`` (the caller holds
        op_lock or tolerates a snapshot)."""
        for sid, spec in self._respawn_specs.items():
            if spec["service_type"] != ServiceType.INFERENCE_WORKER:
                continue
            if spec["meta_kwargs"].get("inference_job_id") != job_id:
                continue
            if spec["config"].get("worker_id") == wid:
                return sid
        return None

    def _scale_up_one(self, job_id: str,
                      slot_timeout: float) -> Optional[str]:
        """Spawn one extra replica from the job's template. It starts
        WARMING and joins the routing pool (and the published
        membership) only once its obs sidecar reports a port: a worker
        still booting must not attract streams. Returns the new worker
        id, or None when no slot came free."""
        with self.op_lock:
            self._check_fence()
            if self._scaleout.get(job_id) is None:
                raise KeyError(f"no scale-out state for job {job_id!r}")
        # the slot is acquired OUTSIDE op_lock: every release path (the
        # monitor's poll, stop_service, a drained victim's reap) takes
        # that lock, so waiting on the allocator under it could never be
        # satisfied by a concurrent release
        slot = self.allocator.acquire(timeout=slot_timeout)
        if slot is None:
            return None
        with self.op_lock:
            st = self._scaleout.get(job_id)
            if st is None:  # the job stopped between the locks
                self.allocator.release(slot)
                return None
            idx = st["next_index"]
            st["next_index"] += 1
            wid = f"iw-{job_id[:8]}-{idx}"
            cfg = dict(st["template"])
            cfg["worker_id"] = wid
            port_file = self.workdir / f"{wid}.obs_port"
            cfg["obs_port_file"] = str(port_file)
            try:
                port_file.unlink()  # a stale file from an earlier life
            except OSError:         # must not promote at once
                pass
            try:
                # op_lock held across the spawn, so the claimed slot
                # cannot be handed out twice
                self._spawn(st["module"], cfg,
                            ServiceType.INFERENCE_WORKER, slot=slot,
                            inference_job_id=job_id)
            except Exception:
                self.allocator.release(slot)
                raise
            st["warming"].append({"wid": wid,
                                  "port_file": str(port_file),
                                  "since": time.monotonic()})
            self.scaling.inc("autoscale_ups")
            return wid

    def _promote_warmed(self, job_id: str,
                        st: Dict[str, Any]) -> None:
        """Move warmed replicas (obs port reported) into the routing
        pool and publish the new membership."""
        changed = False
        with self.op_lock:
            for item in list(st["warming"]):
                ready = Path(item["port_file"]).exists()
                timed_out = (time.monotonic() - item["since"]
                             > self.WARM_PUBLISH_TIMEOUT_S)
                if not ready and not timed_out:
                    continue
                st["warming"].remove(item)
                if item["wid"] not in st["pool"]:
                    st["pool"].append(item["wid"])
                changed = True
        if changed:
            self._publish_pool(job_id)

    def _begin_scale_down(self, job_id: str, wid: str) -> bool:
        """Start a drain-based scale-down of ``wid``: membership FIRST
        (the predictor stops routing there and fails its streams over
        with forced prefixes), then, once the job's predictor routes
        without it (``_await_pool_applied``), the drain request; the
        victim
        finishes its in-flight work and exits 0, and the monitor reaps
        it. Its respawn spec goes first, so a non-zero exit while
        draining is not respawned."""
        with self.op_lock:
            st = self._scaleout.get(job_id)
            if st is None or st.get("victim"):
                return False
            if wid in st["pool"]:
                st["pool"].remove(wid)
            sid = self._worker_sid(job_id, wid)
            spec = self._respawn_specs.pop(sid, None) if sid else None
            cfg = dict((spec or {}).get("config") or {})
            if sid is not None and sid in self.services:
                st["victim"] = {"sid": sid, "wid": wid, "cfg": cfg,
                                "deadline": time.monotonic()
                                + st["drain_timeout"]}
        self._publish_pool(job_id)
        with self.op_lock:
            st = self._scaleout.get(job_id)
            victim = (st or {}).get("victim")
        if not victim:
            return False  # the worker was already gone: the pool shrank
        # drained only once the predictor routes without it: a request
        # routed to an exited victim would wait out the gather deadline
        self._await_pool_applied(job_id)
        self._request_drain(victim["cfg"])
        self.scaling.inc("autoscale_downs")
        return True

    def _victim_tick(self, job_id: str, st: Dict[str, Any]) -> None:
        """Advance an in-flight scale-down: a cleanly drained victim is
        reaped by the monitor's poll (rc 0: STOPPED, slot released); one
        past its drain deadline is terminated, so a stuck scale-down
        converges instead of wedging the autoscaler."""
        with self.op_lock:
            v = st.get("victim")
            if not v:
                return
            if v["sid"] not in self.services:
                st["victim"] = None  # drained and reaped: done
                return
            overdue = time.monotonic() > v["deadline"]
        if overdue:
            log.warning("scale-down victim %s did not drain in time; "
                        "terminating", v["wid"])
            self.stop_service(v["sid"])
            with self.op_lock:
                st["victim"] = None

    @staticmethod
    def _choose_victim(st: Dict[str, Any],
                       stats: Dict[str, Any]) -> Optional[str]:
        """The scale-down victim: the member with the fewest live KV
        pages (the least in-flight state to fail over), ties to the most
        recently added. Prefill-role workers are never victims: the
        autoscaler manages SERVING capacity, and scale-ups clone the
        serving template, so a drained prefill tier would never come
        back."""
        pool = []
        for w in st["pool"]:
            s = stats.get(w)
            if not (isinstance(s, dict) and s.get("role") == "prefill"):
                pool.append(w)
        if len(pool) <= 1:
            return None

        def pages(wid: str) -> float:
            s = stats.get(wid)
            if not isinstance(s, dict):
                return float("inf")
            v = s.get("engine_kv_pages_used", s.get("kv_pages_used"))
            return float(v) if isinstance(v, (int, float)) else \
                float("inf")

        return min(pool, key=lambda w: (pages(w), -pool.index(w)))

    def autoscale_tick(self, force: bool = False) -> List[Dict[str, Any]]:
        """One autoscaler evaluation (the admin monitor's loop calls it;
        rate-limited to ``AUTOSCALE_TICK_EVERY_S`` unless ``force``):
        grows a job's pool on sustained admission stalls, shrinks it
        through the drain path when idle, promotes warmed replicas into
        the routing pool and converges stuck drains. Returns the actions
        taken."""
        actions: List[Dict[str, Any]] = []
        if self.fenced or not self.kv_port:
            return actions
        now = time.monotonic()
        if not force and now - self._last_autoscale_tick < \
                self.AUTOSCALE_TICK_EVERY_S:
            return actions
        self._last_autoscale_tick = now
        with self.op_lock:
            job_ids = set(self._scaleout)
            for spec in self._respawn_specs.values():
                if spec["service_type"] == ServiceType.INFERENCE_WORKER:
                    jid = spec["meta_kwargs"].get("inference_job_id")
                    if jid:
                        job_ids.add(jid)
        for job_id in sorted(job_ids):
            job = self.meta.get_inference_job(job_id)
            if job is None or job.get("status") != "RUNNING":
                with self.op_lock:
                    self._scaleout.pop(job_id, None)
                continue
            st = self._ensure_scaleout(job_id)
            if st is None:
                continue
            self._promote_warmed(job_id, st)
            self._victim_tick(job_id, st)
            with self.op_lock:
                policy = st.get("policy")
                busy = bool(st.get("victim") or st.get("warming")
                            or st.get("manual") or st.get("rolling"))
                pool = list(st["pool"])
            if policy is None or busy:
                # decisions wait until the pool is quiescent: the policy
                # never fights an action or a manual scale in flight
                continue
            stats: Dict[str, Any] = {}
            for wid in pool:
                try:
                    stats[wid] = self._pool_hub().get_worker_stats(wid)
                except Exception:  # noqa: BLE001 — a hub hiccup reads
                    stats[wid] = None  # as missing stats
            decision = policy.observe(stats)
            if decision == "up":
                try:
                    wid = self._scale_up_one(job_id, slot_timeout=0.0)
                except Exception as e:  # noqa: BLE001 — a failed spawn
                    # must not kill the monitor loop
                    log.warning("autoscale-up spawn for job %s failed: "
                                "%s", job_id, e)
                    wid = None
                if wid is None:
                    self.scaling.inc("autoscale_blocked")
                    actions.append({"job_id": job_id,
                                    "action": "blocked"})
                else:
                    actions.append({"job_id": job_id, "action": "up",
                                    "worker": wid})
            elif decision == "down":
                victim = self._choose_victim(st, stats)
                if victim and self._begin_scale_down(job_id, victim):
                    actions.append({"job_id": job_id, "action": "down",
                                    "worker": victim})
        return actions

    def scale_inference_job(self, job_id: str, workers: int,
                            drain_timeout: float = 120.0,
                            warm_timeout: float = 180.0
                            ) -> Dict[str, Any]:
        """Scale to an exact replica count (the operator's override; it
        stamps the autoscaler's cooldown too, so the policy does not
        fight the operator). Ups spawn from the job's template and block
        until the new workers report their obs port (joined the routing
        pool); downs drain newest-first, one at a time, and block until
        each victim exits."""
        self._check_fence()
        workers = int(workers)
        if workers < 1:
            raise ValueError(f"workers={workers} must be >= 1")
        st = self._ensure_scaleout(job_id)
        if st is None:
            raise KeyError(
                f"no live inference workers for job {job_id!r}")
        with self.op_lock:
            if st.get("manual"):
                raise RuntimeError(
                    f"a manual scale of job {job_id} is already in "
                    "progress — wait for it to finish")
            if len(self._pool_trial_ids(job_id, st)) > 1:
                raise RuntimeError(
                    f"job {job_id}'s replicas serve DISTINCT trials "
                    "(an ensemble) — scaling would clone one trial "
                    "and skew/evict the others; redeploy with "
                    "max_workers=1 (or MULTI_ADAPTER) to scale")
            # the busy flag and an up-front cooldown stamp keep the
            # autoscaler out while this operation runs
            st["manual"] = True
            policy = st.get("policy")
        if policy is not None:
            policy.note_action()
        try:
            return self._scale_to(job_id, st, workers, drain_timeout,
                                  warm_timeout)
        finally:
            with self.op_lock:
                st["manual"] = False
            if policy is not None:
                policy.note_action()  # the cooldown runs from completion

    def _pool_trial_ids(self, job_id: str,
                        st: Dict[str, Any]) -> set:
        """The distinct ``trial_id`` values across the pool's worker
        configs (the caller holds op_lock); more than one is an
        ensemble."""
        out = set()
        for wid in st["pool"]:
            sid = self._worker_sid(job_id, wid)
            spec = self._respawn_specs.get(sid) if sid else None
            out.add((spec or {}).get("config", {}).get("trial_id"))
        return out

    def _scale_to(self, job_id: str, st: Dict[str, Any], workers: int,
                  drain_timeout: float,
                  warm_timeout: float) -> Dict[str, Any]:
        result: Dict[str, Any] = {"job_id": job_id, "scaled_up": [],
                                  "scaled_down": []}
        with self.op_lock:
            current = len(st["pool"]) + len(st["warming"])
        while current < workers:
            wid = self._scale_up_one(job_id,
                                     slot_timeout=self.slot_timeout)
            if wid is None:
                raise RuntimeError(
                    f"no free device slot to scale job {job_id} to "
                    f"{workers} workers ({self.allocator.n_slots} "
                    f"slots, {self.allocator.free_count()} free)")
            result["scaled_up"].append(wid)
            current += 1
        deadline = time.monotonic() + warm_timeout
        while time.monotonic() < deadline:
            self._promote_warmed(job_id, st)
            with self.op_lock:
                if not st["warming"]:
                    break
            time.sleep(0.05)
        with self.op_lock:
            # past the warm deadline: publish anyway, the breakers gate a
            # worker that still does not serve
            for item in list(st["warming"]):
                st["warming"].remove(item)
                if item["wid"] not in st["pool"]:
                    st["pool"].append(item["wid"])
        self._publish_pool(job_id)
        if result["scaled_up"]:
            # return once the predictor routes to the new workers
            self._await_pool_applied(job_id)
        while True:
            with self.op_lock:
                if len(st["pool"]) <= workers:
                    break
                victim = st["pool"][-1]
            self._scale_down_blocking(job_id, victim, drain_timeout)
            result["scaled_down"].append(victim)
        with self.op_lock:
            result["pool"] = list(st["pool"])
        return result

    def _scale_down_blocking(self, job_id: str, wid: str,
                             drain_timeout: float) -> None:
        """The manual scale-down: membership first, then the drain, then
        the wait for the exit (terminated past the deadline), as
        rolling_restart reaps or terminates."""
        with self.op_lock:
            st = self._scaleout.get(job_id)
            if st is None:
                return
            if wid in st["pool"]:
                st["pool"].remove(wid)
            sid = self._worker_sid(job_id, wid)
            spec = self._respawn_specs.pop(sid, None) if sid else None
            svc = self.services.get(sid) if sid else None
        self._publish_pool(job_id)
        if svc is None:
            return
        self._await_pool_applied(job_id)  # as _begin_scale_down
        drain_sent = self._request_drain(
            dict((spec or {}).get("config") or {}))
        try:
            svc.proc.wait(timeout=drain_timeout if drain_sent
                          else min(5.0, drain_timeout))
        except subprocess.TimeoutExpired:
            log.warning("scale-down victim %s did not drain within "
                        "%.0fs; terminating", wid, drain_timeout)
            svc.proc.terminate()
            try:
                svc.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                svc.proc.kill()
                svc.proc.wait()
        with self.op_lock:
            if sid in self.services:  # the monitor may have reaped the
                # clean rc 0 exit already
                self.meta.update_service(sid,
                                         status=ServiceStatus.STOPPED)
                if svc.slot is not None:
                    self.allocator.release(svc.slot)
                    svc.slot = None
                del self.services[sid]
        self.scaling.inc("autoscale_downs")

    def scaleout_status(self, job_id: str) -> Dict[str, Any]:
        """The pool and the autoscaler's state, for the admin API and
        the dashboard."""
        with self.op_lock:
            st = self._scaleout.get(job_id)
            if st is None:
                return {"enabled": False, "pool": [], "warming": [],
                        "victim": None}
            policy = st.get("policy")
            out = {"enabled": policy is not None,
                   "pool": list(st["pool"]),
                   "warming": [w["wid"] for w in st["warming"]],
                   "victim": (st.get("victim") or {}).get("wid"),
                   "drain_timeout_s": st["drain_timeout"]}
        if policy is not None:
            out.update(policy.status())
        return out

    def stop_service(self, service_id: str, timeout: float = 10.0) -> None:
        self._check_fence()
        with self.op_lock:
            self._stop_service(service_id, timeout)

    def _stop_service(self, service_id: str, timeout: float) -> None:
        svc = self.services.get(service_id)
        if svc is None:
            return
        if svc.alive():
            svc.proc.terminate()
            try:
                svc.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                svc.proc.kill()
                svc.proc.wait()
        self.meta.update_service(service_id, status=ServiceStatus.STOPPED)
        if svc.slot is not None:
            self.allocator.release(svc.slot)
            svc.slot = None
        self._respawn_specs.pop(service_id, None)
        del self.services[service_id]

    def _drop_handles(self) -> None:
        """Fenced shutdown: the children now belong to the admin that
        took the lease over. Release only local bookkeeping."""
        for sid, svc in list(self.services.items()):
            if svc.slot is not None:
                self.allocator.release(svc.slot)
                svc.slot = None
            self._respawn_specs.pop(sid, None)
            del self.services[sid]
        self._kv_server = None
        self._kv_proc = None
        self.kv_host, self.kv_port = "", 0

    def stop_all(self) -> None:
        if self.fenced:
            self._drop_handles()
            return
        for sid in list(self.services):
            with self.op_lock:
                self._stop_service(sid, timeout=10.0)
        if self._kv_proc is not None and self._kv_server is not None:
            self._kv_server.stop()
            self._kv_server = None
            self._kv_proc = None
            self.kv_host, self.kv_port = "", 0
            if self._kv_service_id:
                self.meta.update_service(self._kv_service_id,
                                         status=ServiceStatus.STOPPED)
        self.release_lease()


class _DeadProc:
    """Popen-shaped stand-in for a kvd the reconciler found dead (row
    present, process gone): an exited handle, so the respawn path sees
    the same supervision state as after a death under the monitor."""

    pid = 0
    returncode = -1

    def poll(self) -> int:
        return self.returncode


class _AdoptedKVServer:
    """KVServer-shaped handle over a kvd the reconciler adopted: the
    ``host``, ``port``, ``_proc`` and ``stop()`` of
    :class:`rafiki_tpu_torch.native.client.KVServer`."""

    def __init__(self, host: str, port: int,
                 proc: AdoptedProcess) -> None:
        self.host, self.port = host, port
        self._proc = proc

    def stop(self) -> None:
        from rafiki_tpu_torch.native.client import KVClient

        try:
            KVClient(self.host, self.port).shutdown()
        except OSError:
            pass
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self._proc.kill()
