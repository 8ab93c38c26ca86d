"""ServicesManager: spawn and track the stack's service processes on CUDA
device slots.

The port's own copy of the job path of
``rafiki_tpu/admin/services_manager.py``: ``ManagedService``, the
constructor, the data plane (``start_data_plane``, ``_boot_data_plane``,
on the port's kvd), ``param_store_uri``, the single-writer admin lease
(``acquire_lease``, ``start_lease_heartbeat``, ``renew_lease``,
``release_lease``, the fence check), ``_spawn``,
``create_train_services``, ``wait_train_job``,
``create_inference_services``, the monitor's ``poll`` with its worker
respawn budget, ``stop_service`` and ``stop_all``. The control plane
spawns an advisor plus N train workers per train job, and N inference
workers plus a predictor per inference job, each a
``python -m rafiki_tpu_torch.<module> --config <json>`` child:

- the card inventory comes from a throwaway probe subprocess
  (``device_probe.py``), so the manager never initializes CUDA itself;
  ``platform=None`` probes and raises when the host has no CUDA device.
  A CPU stack must be asked for (``platform="cpu"`` with virtual
  ``DeviceSpec`` slots): its workers get ``"device": "cpu"``;
- a :class:`SubMeshAllocator` hands each worker a slot, and the slot's
  ``CUDA_VISIBLE_DEVICES`` confines the child to its cards; the advisor
  and the predictor get ``CUDA_VISIBLE_DEVICES=""`` (no card);
- service rows land in the MetaStore with their full spawn recipe, as
  the JAX admin records them; ``poll()`` is the failure detector.

Not ported, each refused by name with ``NotPorted``: boot reconciliation
and adoption after an admin restart (``reconcile``,
``reap_stale_services``), kvd respawn with WAL replay (a dead kvd marks
the stack degraded), rolling restart, autoscale and scale-out (the
``AUTOSCALE``, ``MIN_WORKERS``, ``MAX_WORKERS`` and
``AUTOSCALE_COOLDOWN_S`` budget keys), the paged gather path
(``PAGED_KERNEL=false``) and fault injection. The decode modes are served
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

#: worker service types eligible for self-healing respawn
_WORKER_TYPES = (ServiceType.TRAIN_WORKER, ServiceType.INFERENCE_WORKER)

#: the modules the manager spawns, one per service type
SPAWN_TARGETS = {
    ServiceType.ADVISOR: "rafiki_tpu_torch.advisor.service",
    ServiceType.TRAIN_WORKER: "rafiki_tpu_torch.worker.train",
    ServiceType.INFERENCE_WORKER: "rafiki_tpu_torch.worker.inference",
    ServiceType.PREDICTOR: "rafiki_tpu_torch.serving.predictor",
}

#: inference-budget keys of options the port does not serve yet, each
#: with the name a refusal gives it
DEFERRED_BUDGET_KEYS = {
    "AUTOSCALE": "autoscale (AUTOSCALE)",
    "MIN_WORKERS": "autoscale bounds (MIN_WORKERS)",
    "MAX_WORKERS": "autoscale bounds (MAX_WORKERS)",
    "AUTOSCALE_COOLDOWN_S": "autoscale (AUTOSCALE_COOLDOWN_S)",
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
                 host: str = "", port: int = 0) -> None:
        self.service_id = service_id
        self.service_type = service_type
        self.proc = proc
        self.slot = slot
        self.host = host
        self.port = port

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
        self._kv_service_id: Optional[str] = None
        self._kv_data_dir: str = ""
        #: spawn spec per live worker, so a crashed worker can be
        #: respawned while its job still runs. Lineage = (type, job id):
        #: the budget is shared by a job's workers
        self._respawn_specs: Dict[str, Dict[str, Any]] = {}
        self._respawn_counts: Dict[Any, int] = {}
        for lineage, count in self.meta.get_respawn_counts().items():
            stype, _, job_id = lineage.partition(":")
            self._respawn_counts[(stype, job_id)] = int(count)
        #: max replacement spawns per (service type, job) lineage
        self.max_respawns = 3
        #: respawns that found no free slot, retried on every poll
        self._pending_respawns: List[Dict[str, Any]] = []
        #: jobs whose self-healing is exhausted (job id → reason)
        self._degraded: Dict[str, str] = {}
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
        self.recovery = StatsMap({"lease_takeovers": 0})
        self._kvd_stats_cache: Dict[str, Any] = {}
        self._kvd_stats_at = 0.0
        self._kvd_stats_lock = threading.Lock()

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

    # ---- deferred: refused by name ----
    def reconcile(self) -> Dict[str, Any]:
        raise _not_ported("boot reconciliation and adoption of a previous "
                          "admin's services")

    def reap_stale_services(self) -> int:
        raise _not_ported("reaping a previous admin's services (cold "
                          "start)")

    def rolling_restart(self, inference_job_id: str,
                        drain_timeout: float = 120.0) -> Dict[str, Any]:
        raise _not_ported("rolling restart of an inference job")

    def scale_inference_job(self, job_id: str, workers: int,
                            drain_timeout: float = 120.0
                            ) -> Dict[str, Any]:
        raise _not_ported("scale-out of an inference job")

    def scaleout_status(self, job_id: str) -> Dict[str, Any]:
        raise _not_ported("the inference-pool autoscaler")

    # ---- data plane ----
    #: kvd WAL fsync policy (overridable via RAFIKI_KVD_FSYNC)
    KVD_FSYNC_DEFAULT = "everysec"

    def start_data_plane(self) -> None:
        """Boot the port's kvd with WAL + snapshot persistence under
        ``workdir/kvd-data`` (a no-op when it already runs)."""
        if self.kv_port:
            return
        self._check_fence()
        data_dir = str(self.workdir / "kvd-data")
        fsync = os.environ.get("RAFIKI_KVD_FSYNC", self.KVD_FSYNC_DEFAULT)
        self._boot_data_plane("127.0.0.1", 0, data_dir, fsync)

    def _boot_data_plane(self, host: str, port: int, data_dir: str,
                         fsync: str) -> None:
        """Spawn a kvd and record its row + spawn spec."""
        from rafiki_tpu_torch.admin.proc import proc_start_time
        from rafiki_tpu_torch.native.client import KVServer

        server = KVServer(host=host, port=port, data_dir=data_dir,
                          fsync=fsync)
        self._kv_server = server
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

    def _check_data_plane(self) -> None:
        """Monitor-tick half of kvd supervision: a kvd that died marks
        the stack degraded (its respawn with WAL replay is not ported)."""
        server = self._kv_server
        if server is None or self.fenced or server._proc.poll() is None:
            return
        if "data-plane" not in self._degraded:
            reason = (f"kvd exited rc={server._proc.returncode}; kvd "
                      "respawn with WAL replay is not ported yet")
            log.error("data plane down: %s", reason)
            self._degraded["data-plane"] = reason
            if self._kv_service_id:
                self.meta.update_service(self._kv_service_id,
                                         status=ServiceStatus.ERRORED)

    def kvd_stats(self, max_age_s: float = 2.0) -> Dict[str, Any]:
        """Cached kvd ``STATS`` plus ``up`` (at most one socket round
        trip per ``max_age_s``)."""
        from rafiki_tpu_torch.native.client import KVClient

        with self._kvd_stats_lock:
            now = time.monotonic()
            if now - self._kvd_stats_at < max_age_s:
                return dict(self._kvd_stats_cache)
            st: Dict[str, Any] = {"up": 0}
            if self.kv_port:
                try:
                    c = KVClient(self.kv_host, self.kv_port,
                                 connect_timeout=2.0, op_timeout_s=2.0)
                    try:
                        st = {**c.stats(), "up": 1}
                    finally:
                        c.close()
                except (OSError, RuntimeError) as e:
                    log.debug("kvd stats probe failed: %s", e)
            self._kvd_stats_cache, self._kvd_stats_at = st, now
            return dict(st)

    def data_plane_status(self) -> Dict[str, Any]:
        """The /health ``data_plane`` block."""
        st = self.kvd_stats()
        return {"up": bool(st.get("up")), "host": self.kv_host,
                "port": self.kv_port, "data_dir": self._kv_data_dir,
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
        from rafiki_tpu_torch.admin.proc import proc_start_time

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
        from rafiki_tpu_torch.model.dev import check_gang_size
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
        # matches no model's knob config is a typo, and a gang the port
        # cannot run is refused by name
        requested = train_args.get("knob_overrides") or {}
        if requested:
            known: set = set()
            for cls in classes.values():
                known |= set(cls.get_knob_config())
            validate_override_keys(
                known, requested,
                context="knob_overrides for this job's models:")
        gang_size = int(train_args.get("gang_size") or 0)
        for cls in classes.values():
            check_gang_size(cls, gang_size)

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
            for key, what in DEFERRED_BUDGET_KEYS.items():
                if budget.get(key):
                    raise _not_ported(what)
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
        cfg = {"model_file": str(model_file),
               "model_class": model["model_class"],
               "trial_id": trial["id"], "knobs": trial["knobs"],
               "worker_id": f"iw-{inference_job_id[:8]}-{i}",
               "decode_loop": decode_loop,
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
             "kv_host": self.kv_host, "kv_port": self.kv_port},
            ServiceType.PREDICTOR, wait_port_file=True,
            inference_job_id=inference_job_id)
        spawned.append(predictor)
        self.meta.update_inference_job(
            inference_job_id, status="RUNNING",
            predictor_host=f"{predictor.host}:{predictor.port}")
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
        try:
            self._spawn(spec["module"], spec["config"], stype, slot=slot,
                        **meta_kwargs)
        except Exception:
            if slot is not None:
                self.allocator.release(slot)
            raise
        # write-through: the budget lives in the MetaStore
        self._respawn_counts[lineage] = \
            self.meta.incr_respawn_count(stype, job_id)
        self._degraded.pop(job_id, None)
        return True

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
        if stype == ServiceType.TRAIN_WORKER:
            self.meta.update_train_job(job_id,
                                       status=TrainJobStatus.ERRORED)
        else:
            self.meta.update_inference_job(job_id, status="ERRORED")

    def degraded_jobs(self) -> Dict[str, str]:
        """Jobs that lost self-healing (job id → reason), for /health."""
        with self.op_lock:
            return dict(self._degraded)

    def respawn_stats(self) -> Dict[str, int]:
        with self.op_lock:
            return {"respawns_done": sum(self._respawn_counts.values()),
                    "pending_respawns": len(self._pending_respawns),
                    "degraded_jobs": len(self._degraded)}

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
        self.kv_host, self.kv_port = "", 0

    def stop_all(self) -> None:
        if self.fenced:
            self._drop_handles()
            return
        for sid in list(self.services):
            with self.op_lock:
                self._stop_service(sid, timeout=10.0)
        if self._kv_server is not None:
            self._kv_server.stop()
            self._kv_server = None
            self.kv_host, self.kv_port = "", 0
            if self._kv_service_id:
                self.meta.update_service(self._kv_service_id,
                                         status=ServiceStatus.STOPPED)
        self.release_lease()
