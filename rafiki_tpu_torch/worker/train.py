"""Train worker: the trial loop, on the CUDA card.

Ports ``rafiki_tpu/worker/train.py``: loop until the advisor's budget is
exhausted — get a proposal, build the template with the proposed knobs,
train, evaluate, save the parameters, report the score. Ported:
``classify_trial_error``, ``TrainWorker`` (``run_trial``,
``_observe_log_record``, ``_record_trial_obs``, ``_admission_check``,
``_wire_checkpointing``, ``_start_heartbeat``,
``resume_orphaned_trials``, ``run_gang``, ``run``,
``_linger_for_orphans``, ``serve_obs``, ``stop_obs``),
``_count_blob_params``,
``_device_peak_flops`` and ``main``.

BOHB rungs ride the same loop (``budget_scale`` scales epochs,
``warm_start_trial_id`` resumes a promoted trial from its lower-rung
parameters), as do preemption safety (a heartbeat while the trial row is
RUNNING, throttled epoch checkpoints with their progress sidecar, the
atomic claim and warm resume of a dead peer's trials) and trial fault
isolation (a trial that raises is recorded ERRORED with its error class,
and the worker goes on).

Where it differs from the JAX worker, on purpose:

- ``device`` is a constructor argument (None: the CUDA card, raising
  without one); the template is built as ``model_class(device=...,
  **knobs)``, and a trial that fails on the card is recorded as failed,
  never moved to the CPU;
- checkpoints take the whole-tree path: the port's ``ParamStore`` has no
  sharded saves, so a template's ``tree=`` argument is ignored, as JAX
  ignores it when its store refuses one;
- ``profile_dir`` records ``train`` with ``torch.profiler`` (a Chrome
  trace under ``profile_dir/<trial_id>/``) where JAX takes a
  ``jax.profiler`` trace;
- admission reads the card's memory (``worker/admission.py``) and the
  template's single-card ``estimate_device_budget``;
- ``run_gang`` drives the port's gang engine (``rafiki_tpu_torch/
  tuning``) for a template with a gang spec, each lane-trial with its
  own MetaStore row and param blob, with JAX's admission callback over
  the card's memory; a template without a spec runs sequential trials
  (JAX's fallback);
- on exit ``main`` deletes its ``obs_port_file`` (``obs/http.py``
  ``remove_port_file``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from rafiki_tpu_torch.advisor.base import Proposal, TrialResult
from rafiki_tpu_torch.model.dev import profiled_train
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.knob import shape_signature
from rafiki_tpu_torch.model.log import ModelLogger
from rafiki_tpu_torch.obs.http import ObsServer, remove_port_file
from rafiki_tpu_torch.obs.metrics import MetricsRegistry, StatsMap
from rafiki_tpu_torch.obs.trace import TraceBuffer, mint_trace_id
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device
from rafiki_tpu_torch.worker.admission import resolve_device_limit

log = logging.getLogger(__name__)

#: substrings marking infra-class failures in exception text (the JAX
#: runtime's device-loss vocabulary, and scheduler wording)
_PREEMPTION_MARKERS = ("UNAVAILABLE", "RESOURCE_EXHAUSTED",
                       "DEADLINE_EXCEEDED", "DATA_LOSS", "ABORTED",
                       "preempt")


def classify_trial_error(e: BaseException) -> str:
    """``"preemption"`` (infra fault — resumable on healthy hardware) vs
    ``"deterministic"`` (code/knob bug — a resume would reproduce the
    crash). Only preemption-class ERRORED rows may be claimed by peers.
    A CUDA out-of-memory error is preemption-class, as JAX classes XLA's
    RESOURCE_EXHAUSTED."""
    if isinstance(e, (FileNotFoundError, IsADirectoryError,
                      NotADirectoryError, PermissionError)):
        # path-shaped OSErrors are config bugs every peer would hit too
        return "deterministic"
    if isinstance(e, (OSError, MemoryError, EOFError,
                      torch.cuda.OutOfMemoryError)):
        return "preemption"
    msg = f"{type(e).__name__}: {e}"
    if any(m in msg for m in _PREEMPTION_MARKERS):
        return "preemption"
    return "deterministic"


class TrainWorker:
    """Runs trials against an advisor (an in-process advisor or an
    ``AdvisorClient``: both expose propose / feedback / trial_errored)."""

    def __init__(self, model_class: type, advisor: Any,
                 train_dataset_path: str, val_dataset_path: str,
                 param_store: Optional[ParamStore] = None,
                 meta_store: Optional[Any] = None,
                 sub_train_job_id: str = "", model_id: str = "",
                 worker_id: str = "worker-0",
                 profile_dir: Optional[str] = None,
                 knob_overrides: Optional[dict] = None,
                 checkpoint_interval_s: float = 30.0,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.model_class = model_class
        self.advisor = advisor
        self.train_dataset_path = train_dataset_path
        self.val_dataset_path = val_dataset_path
        self.param_store = param_store or ParamStore()
        self.meta_store = meta_store
        self.sub_train_job_id = sub_train_job_id
        self.model_id = model_id
        self.worker_id = worker_id
        self.profile_dir = profile_dir
        #: job-level knob pins merged over every proposal
        self.knob_overrides = dict(knob_overrides or {})
        #: min seconds between mid-trial checkpoints; <= 0 disables them
        self.checkpoint_interval_s = checkpoint_interval_s
        #: liveness beacon period while a trial row is RUNNING
        self.heartbeat_interval_s = 5.0
        #: a RUNNING trial with no heartbeat for this long is an orphan
        self.orphan_stale_s = 60.0
        #: lifetime cap on resumed orphans (bounds cross-worker ping-pong
        #: on a trial that keeps crashing)
        self.max_resumes = 16
        self._resumes_done = 0
        #: trial ids created by THIS process (self-resume exclusion that
        #: still lets a restarted worker reclaim its pre-restart orphan)
        self._own_trial_ids: set = set()
        self.trials_run = 0
        self.metrics = MetricsRegistry()
        self.traces = TraceBuffer(256)
        self._h_trial = self.metrics.histogram(
            "trial_seconds", "trial wall time, train+eval (seconds)",
            buckets=(1, 2, 5, 10, 30, 60, 120, 300, 600, 1800, 3600,
                     7200, 14400))
        self._h_epoch = self.metrics.histogram(
            "epoch_seconds", "gap between epoch metric records",
            buckets=(0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60, 120, 300,
                     600, 1800))
        #: the JAX worker's counters and gauges: trials_completed,
        #: trials_errored, last_trial_tokens_per_s, last_trial_est_mfu
        self.stats = StatsMap({"trials_completed": 0, "trials_errored": 0,
                               "last_trial_tokens_per_s": 0.0,
                               "last_trial_est_mfu": 0.0})
        self.metrics.register_stats(self.stats)
        self._obs_server: Optional[ObsServer] = None

    def serve_obs(self, host: str = "127.0.0.1",
                  port: int = 0) -> Tuple[str, int]:
        """Start the observability sidecar (``GET /metrics``, ``GET
        /debug/requests``: the trial timelines, ``GET /health``) on a
        daemon thread; returns its (host, port)."""
        self._obs_server = ObsServer(self.metrics, self.traces,
                                     host=host, port=port)
        return self._obs_server.start()

    def stop_obs(self) -> None:
        if self._obs_server is not None:
            self._obs_server.stop()
            self._obs_server = None

    # ---- one trial ----
    def run_trial(self, proposal: Proposal) -> Optional[float]:
        if self.knob_overrides:
            proposal.knobs = {**proposal.knobs, **self.knob_overrides}
        if proposal.meta.get("resumed_from") and \
                proposal.warm_start_trial_id and \
                "share_params" in self.model_class.get_knob_config():
            # after the override merge: a pinned share_params must not
            # drop the resume's warm start
            proposal.knobs = {**proposal.knobs, "share_params": True}
        # a resumed trial's row keeps the ORIGINAL budget_scale; only the
        # in-context scale shrinks by the progress already made
        base_frac = float(proposal.meta.get("resume_frac_done") or 0.0)
        ctx_budget_scale = proposal.budget_scale * max(0.0, 1.0 - base_frac)
        if self.meta_store is not None:
            trial_id = self.meta_store.create_trial(
                self.sub_train_job_id, proposal.trial_no,
                model_id=self.model_id, knobs=proposal.knobs,
                worker_id=self.worker_id,
                budget_scale=proposal.budget_scale,
                shape_sig=shape_signature(
                    self.model_class.get_knob_config(), proposal.knobs))["id"]
        else:
            trial_id = f"{self.worker_id}-t{proposal.trial_no}"
        self._own_trial_ids.add(trial_id)

        logger = ModelLogger()
        obs_acc: Dict[str, Any] = {"tokens": 0, "epochs": 0,
                                   "last_t": None}

        def _sink(rec) -> None:
            self._observe_log_record(rec, obs_acc)
            if self.meta_store is not None:
                self.meta_store.add_trial_log(trial_id, rec.kind,
                                              rec.data, rec.time)

        logger.sink = _sink
        t_start = time.monotonic()
        trace_id = self.traces.start(
            mint_trace_id(), request_id=trial_id, span="trial_start",
            trial_no=proposal.trial_no, worker=self.worker_id)

        # the heartbeat covers the row's whole RUNNING time, the final
        # parameter save included
        hb_stop = self._start_heartbeat(trial_id)
        try:
            try:
                self.model_class.validate_knobs(proposal.knobs)
                model = self.model_class(device=self.device,
                                         **proposal.knobs)
                self._admission_check(model)
                shared = None
                if proposal.warm_start_trial_id:
                    shared = self.param_store.load(
                        proposal.warm_start_trial_id)
                trial_profile_dir = None
                if self.profile_dir:
                    trial_profile_dir = os.path.join(self.profile_dir,
                                                     trial_id)
                    os.makedirs(trial_profile_dir, exist_ok=True)
                ctx = TrainContext(budget_scale=ctx_budget_scale,
                                   shared_params=shared, logger=logger,
                                   trial_id=trial_id,
                                   profile_dir=trial_profile_dir)
                ckpt_key = f"ckpt-{trial_id}"
                if self.checkpoint_interval_s > 0:
                    self._wire_checkpointing(ctx, ckpt_key, base_frac,
                                             proposal, shared)
                profiled_train(model, self.train_dataset_path, ctx,
                               trial_profile_dir)
                score = float(model.evaluate(self.val_dataset_path))

                blob = model.dump_parameters()
                self._record_trial_obs(logger, trace_id, t_start,
                                       obs_acc, blob, score)
                self.param_store.save(trial_id, blob)
                fenced_out = False
                if self.meta_store is not None:
                    # fenced completion: False = a resume claimant already
                    # TERMINATED this row; our duplicate must not feed the
                    # advisor twice for this trial_no
                    fenced_out = not self.meta_store.mark_trial_completed(
                        trial_id, score, params_saved=True)
                try:
                    # best-effort cleanup after the terminal mark
                    self.param_store.delete(ckpt_key)
                    self.param_store.delete(f"{ckpt_key}-meta")
                except Exception:  # rafiki: noqa[silent-except]
                    pass
                if not fenced_out:
                    try:
                        self.advisor.feedback(TrialResult(
                            trial_no=proposal.trial_no,
                            knobs=proposal.knobs,
                            score=score, trial_id=trial_id,
                            budget_scale=proposal.budget_scale,
                            meta=proposal.meta))
                    except Exception:  # noqa: BLE001
                        # a resumed trial may outlive its advisor's state;
                        # its score is durable in the MetaStore
                        if not proposal.meta.get("resumed_from"):
                            raise
                self.trials_run += 1
                return score
            except Exception as e:  # trial fault isolation
                self.stats.inc("trials_errored")
                error_class = classify_trial_error(e)
                self.traces.add_span(trace_id, "trial_errored",
                                     error=f"{type(e).__name__}: {e}"[:200],
                                     error_class=error_class)
                fenced_out = False
                if self.meta_store is not None:
                    fenced_out = not self.meta_store.mark_trial_errored(
                        trial_id, f"{e}\n{traceback.format_exc()}",
                        error_class=error_class)
                if not fenced_out:
                    try:
                        self.advisor.trial_errored(proposal.trial_no)
                    except Exception:  # rafiki: noqa[silent-except]
                        # a dead advisor must not kill the worker; the
                        # error is durable in the MetaStore either way
                        pass
                return None
        finally:
            hb_stop()

    def _observe_log_record(self, rec, obs_acc: Dict[str, Any]) -> None:
        """Every ``values`` record carrying a loss marks an epoch
        boundary (the gap between two is the epoch time); templates that
        log a per-epoch ``tokens`` count feed the trial's throughput."""
        if rec.kind != "values" or "loss" not in rec.data:
            return
        now = time.monotonic()
        if obs_acc["last_t"] is not None:
            self._h_epoch.observe(now - obs_acc["last_t"])
        obs_acc["last_t"] = now
        obs_acc["epochs"] += 1
        tokens = rec.data.get("tokens")
        if isinstance(tokens, (int, float)) and tokens > 0:
            obs_acc["tokens"] += int(tokens)

    def _record_trial_obs(self, logger: ModelLogger, trace_id: str,
                          t_start: float, obs_acc: Dict[str, Any],
                          blob: Any, score: float) -> None:
        """The trial's throughput record, logged through its own logger
        (so it lands in the MetaStore beside the loss curve): wall seconds
        always; tokens/s and an estimated MFU (6·N·tokens/s over the
        card's peak, labelled an estimate) when the template logged
        per-epoch token counts."""
        dt = time.monotonic() - t_start
        self._h_trial.observe(dt)
        self.stats.inc("trials_completed")
        vals: Dict[str, Any] = {"trial_seconds": round(dt, 3),
                                "epochs_logged": obs_acc["epochs"]}
        if obs_acc["tokens"] and dt > 0:
            tps = obs_acc["tokens"] / dt
            vals["tokens_per_s"] = round(tps, 1)
            self.stats.set("last_trial_tokens_per_s", tps)
            n_params = _count_blob_params(blob)
            peak = _device_peak_flops(self.device)
            if n_params and peak:
                mfu = 6.0 * n_params * tps / peak
                vals["est_mfu"] = round(mfu, 5)
                self.stats.set("last_trial_est_mfu", mfu)
        try:
            logger.log(**vals)
        except Exception:  # noqa: BLE001 — a meta-store hiccup on the
            # throughput record must not void the trial
            log.warning("trial throughput record failed", exc_info=True)
        self.traces.add_span(trace_id, "trial_done",
                             score=round(score, 6), **vals)

    def _admission_check(self, model: Any) -> None:
        """Refuse a trial whose estimated train footprint exceeds the
        card's memory, before anything is allocated. Templates opt in
        with ``estimate_device_budget(n) -> {..., "total": bytes}``; the
        limit is ``RAFIKI_DEVICE_HBM_BYTES`` (which the services manager
        sets to a slot's share where slots share a card) or the card's
        total memory (none on the CPU without the override: the check is
        skipped). A
        refusal raises ValueError, a deterministic-class trial error."""
        est = getattr(model, "estimate_device_budget", None)
        if est is None:
            return
        limit = resolve_device_limit(self.device)
        if not limit:
            return
        try:
            budget = est(1)
            total = int(budget["total"])
        except Exception as e:  # an estimator bug must not block an
            # admissible trial, but it must be visible
            log.warning("train admission check skipped: "
                        "estimate_device_budget raised %r", e,
                        exc_info=True)
            return
        if total > limit:
            gib = {k: round(v / 2**30, 2) for k, v in budget.items()}
            raise ValueError(
                "admission control: estimated "
                f"{total / 2**30:.2f}GiB/device train footprint "
                f"exceeds the {limit / 2**30:.2f}GiB device limit "
                f"(breakdown: {gib} GiB); shrink batch_size/max_len")

    def _wire_checkpointing(self, ctx: TrainContext, ckpt_key: str,
                            base_frac: float, proposal: Proposal,
                            shared: Any) -> None:
        """Attach throttled epoch-boundary checkpointing to ``ctx``.

        The blob factory runs only when a save happens. ``frac_done``
        rides in a sidecar entry (not in the blob: warm-start consumers
        expect ``dump_parameters()``'s shape) and is GLOBAL progress: a
        resumed trial's template reports fractions of its remaining
        budget, mapped back onto the original total. A resumed trial is
        pre-seeded with the orphan's checkpoint under its own key, so a
        crash before its first save still leaves the warm state
        reachable from its row."""
        if proposal.meta.get("resumed_from") and shared is not None:
            self.param_store.copy(proposal.warm_start_trial_id, ckpt_key)
            if base_frac > 0:
                self.param_store.save(f"{ckpt_key}-meta",
                                      {"frac_done": base_frac})
        last_save = [time.monotonic()]

        def save_checkpoint(make_blob, frac_done=None, tree=None) -> None:
            # ``tree`` is the sharded-save hook of JAX's stores: the
            # port's store has no sharded saves, so the whole tree goes
            # through ``make_blob``
            now = time.monotonic()
            if now - last_save[0] < self.checkpoint_interval_s:
                return
            self.param_store.save(ckpt_key, make_blob())
            if frac_done is not None:
                global_frac = base_frac + float(frac_done) * (1 - base_frac)
                self.param_store.save(f"{ckpt_key}-meta",
                                      {"frac_done": global_frac})
            last_save[0] = now

        ctx.checkpoint = save_checkpoint

    def _start_heartbeat(self, trial_id: str):
        """Stamp the trial row every ``heartbeat_interval_s`` while it is
        RUNNING, so peers can tell a preempted trial from a slow one.
        Returns a stopper."""
        if self.meta_store is None:
            return lambda: None
        stop = threading.Event()

        def beat() -> None:
            while not stop.wait(self.heartbeat_interval_s):
                try:
                    self.meta_store.heartbeat_trial(trial_id)
                except Exception:  # rafiki: noqa[silent-except]
                    pass           # never kill the trial

        threading.Thread(target=beat, daemon=True,
                         name=f"hb-{trial_id[:8]}").start()
        return stop.set

    # ---- preemption recovery ----
    def resume_orphaned_trials(self) -> int:
        """Finish trials a dead worker left behind.

        Orphan = ERRORED with ``error_class='preemption'``, or RUNNING
        with a stale heartbeat (enforced inside the atomic claim, so a
        live peer's trial cannot be hijacked and exactly one claimant
        wins). Deterministic ERRORED rows are never resumed. With a
        ``ckpt-<id>`` blob the trial resumes warm under the same knobs and
        trial_no, training only the remaining budget; without one it
        re-runs cold."""
        if self.meta_store is None or self._resumes_done >= self.max_resumes:
            return 0
        n = 0
        for t in self.meta_store.get_trials_of_sub_train_job(
                self.sub_train_job_id):
            if t["status"] not in ("RUNNING", "ERRORED"):
                continue
            if t["status"] == "ERRORED" and \
                    t.get("error_class") != "preemption":
                continue  # deterministic crash: the claim would refuse
            if t["id"] in self._own_trial_ids:
                # this process's own failures are never resumed by it
                continue
            if self._resumes_done >= self.max_resumes:
                break
            if not self.meta_store.claim_trial_for_resume(
                    t["id"], self.worker_id,
                    stale_after_s=self.orphan_stale_s):
                continue  # live heartbeat, or another worker won
            ckpt_key = f"ckpt-{t['id']}"
            has_ckpt = self.param_store.exists(ckpt_key)
            frac = 0.0
            if has_ckpt:
                meta = self.param_store.load(f"{ckpt_key}-meta")
                if meta and meta.get("frac_done"):
                    frac = float(meta["frac_done"])
            knobs = t["knobs"]
            if isinstance(knobs, str):
                knobs = json.loads(knobs)
            score = self.run_trial(Proposal(
                trial_no=int(t["trial_no"]), knobs=knobs,
                budget_scale=float(t["budget_scale"] or 1.0),
                warm_start_trial_id=ckpt_key if has_ckpt else "",
                meta={"resumed_from": t["id"],
                      "resume_frac_done": frac}))
            if score is not None:
                # only a COMPLETED resume drops the orphan's blob: a
                # failed attempt may have died before its pre-seed
                try:
                    self.param_store.delete(ckpt_key)
                    self.param_store.delete(f"{ckpt_key}-meta")
                except Exception:  # rafiki: noqa[silent-except]
                    pass
            self._resumes_done += 1
            n += 1
        return n

    # ---- gang trial mode ----
    def run_gang(self, gang_size: int,
                 max_trials: Optional[int] = None) -> int:
        """Gang mode: K proposals train as K lanes of one step (one
        executor per static knob bucket), the advisor driven through its
        batched verbs, ASHA rungs culling lanes in place. Each lane-trial
        gets a MetaStore row and a ParamStore blob, as a process trial
        does, and is fed back to the advisor; the engine's gauges
        (``gang_lanes_active``, ``gang_lanes_culled_total``,
        ``trials_per_hour``, ``gang_samples_per_s``) ride this worker's
        registry. A template without a gang spec runs sequential trials.
        Returns the number of trials completed."""
        from rafiki_tpu_torch.tuning import GangEngine, supports_gang

        if not supports_gang(self.model_class):
            log.warning("%s has no gang spec; gang_size=%d ignored, "
                        "running sequential trials",
                        self.model_class.__name__, gang_size)
            return self.run(max_trials)
        knob_config = self.model_class.get_knob_config()

        def on_result(result, blob) -> None:
            trial_id = result.trial_id
            if self.meta_store is not None:
                trial_id = self.meta_store.create_trial(
                    self.sub_train_job_id, result.trial_no,
                    model_id=self.model_id, knobs=result.knobs,
                    worker_id=self.worker_id,
                    budget_scale=result.budget_scale,
                    shape_sig=shape_signature(knob_config,
                                              result.knobs))["id"]
                self._own_trial_ids.add(trial_id)
            self.param_store.save(trial_id, blob)
            if self.meta_store is not None:
                self.meta_store.mark_trial_completed(
                    trial_id, result.score, params_saved=True)
            self.stats.inc("trials_completed")
            self.trials_run += 1

        engine = GangEngine(
            self.model_class, self.advisor, self.train_dataset_path,
            self.val_dataset_path, gang_size=gang_size, mode="gang",
            knob_overrides=self.knob_overrides, metrics=self.metrics,
            on_result=on_result, admission_check=self._gang_admission,
            device=self.device)
        self.gang_engine = engine  # introspection: buckets, refusals
        return len(engine.run(max_trials))

    def _gang_admission(self, knobs: Dict[str, Any],
                        k: int) -> Optional[str]:
        """Memory admission for one gang bucket: the whole gang is one
        step on the card, so the estimate covers one frozen base plus K
        lanes' state and activations. Returns a refusal reason (the
        bucket then runs its trials sequentially, each through the
        per-trial gate) or None to admit; the limit is the card's
        (``RAFIKI_DEVICE_HBM_BYTES`` overrides it)."""
        limit = resolve_device_limit(self.device)
        if not limit:
            return None
        model = self.model_class(device=self.device, **knobs)
        est = getattr(model, "estimate_device_budget", None)
        if est is None:
            return None
        try:
            try:
                budget = est(1, gang_size=k)
            except TypeError:
                return None  # an estimator without gang budgets
            total = int(budget["total"])
        except Exception as e:  # an estimator bug: visible, not fatal
            log.warning("gang admission check skipped: "
                        "estimate_device_budget raised %r", e,
                        exc_info=True)
            return None
        if total > limit:
            gib = {key: round(v / 2**30, 2) for key, v in budget.items()}
            return (f"estimated {total / 2**30:.2f}GiB footprint for a "
                    f"{k}-lane gang exceeds the {limit / 2**30:.2f}GiB "
                    f"device limit (breakdown: {gib} GiB); shrink the "
                    "gang, batch_size or max_len")
        return None

    # ---- the loop ----
    def run(self, max_trials: Optional[int] = None) -> int:
        """Pull proposals until the advisor says stop; returns the number
        of trials run. Orphans are picked up at start, between proposals
        and in a bounded linger after the advisor is exhausted."""
        n = self.resume_orphaned_trials()
        while max_trials is None or n < max_trials:
            proposal = self.advisor.propose()
            if not proposal.is_valid:
                break
            self.run_trial(proposal)
            n += 1
            n += self.resume_orphaned_trials()
        n += self._linger_for_orphans()
        return n

    def _linger_for_orphans(self) -> int:
        """Wait (bounded) for peers' RUNNING trials to finish or turn
        stale, resuming any that do. "Not mine" means not created by this
        process: a respawned worker shares its predecessor's id."""
        if self.meta_store is None:
            return 0
        deadline = time.monotonic() + self.orphan_stale_s \
            + 2 * self.heartbeat_interval_s
        n = 0
        while time.monotonic() < deadline:
            peers_running = any(
                t["status"] == "RUNNING"
                and t["id"] not in self._own_trial_ids
                for t in self.meta_store.get_trials_of_sub_train_job(
                    self.sub_train_job_id))
            if not peers_running:
                break
            n += self.resume_orphaned_trials()
            time.sleep(min(2.0, self.heartbeat_interval_s))
        return n


def _count_blob_params(blob: Any) -> int:
    """Leaf-element count of a dumped parameter tree (arrays in nested
    dicts/lists)."""
    if hasattr(blob, "shape"):
        try:
            return int(math.prod(blob.shape))
        except (TypeError, ValueError):
            return 0
    if isinstance(blob, dict):
        return sum(_count_blob_params(v) for v in blob.values())
    if isinstance(blob, (list, tuple)):
        return sum(_count_blob_params(v) for v in blob)
    return 0


#: dense bf16 peak FLOP/s by CUDA device name (first match wins, so the
#: more specific names come first). Only for the est_mfu label.
_PEAK_FLOPS_BF16 = (("H100", 989e12),)


def _device_peak_flops(device: DeviceLike = None) -> float:
    """Peak FLOP/s of ``device``: the ``RAFIKI_DEVICE_PEAK_FLOPS`` env
    override wins, else a lookup by the CUDA device's name; the CPU or
    an unknown card gives 0, which suppresses the MFU estimate."""
    env = os.environ.get("RAFIKI_DEVICE_PEAK_FLOPS", "")
    if env:
        try:
            return max(0.0, float(env))
        except ValueError:
            return 0.0
    if device is None or torch.device(device).type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(torch.device(device))
    for key, flops in _PEAK_FLOPS_BF16:
        if key in name:
            return flops
    return 0.0


def main(argv: Optional[list] = None) -> int:
    """Service entry point: ``python -m rafiki_tpu_torch.worker.train
    --config cfg.json``. The config is the JAX worker's JSON
    (``advisor_url``, ``model_file``, ``model_class``, ``train_dataset``,
    ``val_dataset``, ``param_store_uri``, ``meta_store_path``,
    ``sub_train_job_id``, ``model_id``, ``worker_id``, ``profile_dir``,
    ``knob_overrides``, ``checkpoint_interval_s``, ``gang_size``,
    ``obs_host`` / ``obs_port`` / ``obs_port_file``) plus ``"device"``
    (default: the CUDA card). The obs sidecar listens on ``obs_port``
    (default: an ephemeral port), written to ``obs_port_file``."""
    import argparse

    from rafiki_tpu_torch.advisor.service import AdvisorClient
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.store.meta_store import MetaStore

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="JSON: {advisor_url, model_file, model_class, "
                             "train_dataset, val_dataset, param_store_uri, "
                             "meta_store_path, sub_train_job_id, worker_id, "
                             "device}")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    with open(cfg["model_file"], "rb") as f:
        model_class = load_model_class(f.read(), cfg["model_class"])
    meta_store = (MetaStore(cfg["meta_store_path"])
                  if cfg.get("meta_store_path") else None)
    worker = TrainWorker(
        model_class=model_class,
        advisor=AdvisorClient(cfg["advisor_url"]),
        train_dataset_path=cfg["train_dataset"],
        val_dataset_path=cfg["val_dataset"],
        param_store=ParamStore.from_uri(cfg.get("param_store_uri", "mem://")),
        meta_store=meta_store,
        sub_train_job_id=cfg.get("sub_train_job_id", ""),
        model_id=cfg.get("model_id", ""),
        worker_id=cfg.get("worker_id", "worker-0"),
        profile_dir=cfg.get("profile_dir"),
        knob_overrides=cfg.get("knob_overrides"),
        checkpoint_interval_s=float(cfg.get("checkpoint_interval_s", 30.0)),
        device=cfg.get("device"))
    # observability sidecar: /metrics (trial and epoch timing, the MFU
    # gauge) and /debug/requests (per-trial timelines)
    obs_host, obs_port = worker.serve_obs(
        cfg.get("obs_host", "127.0.0.1"), int(cfg.get("obs_port", 0)))
    if cfg.get("obs_port_file"):
        with open(cfg["obs_port_file"], "w") as f:
            f.write(str(obs_port))
    print(f"train worker {worker.worker_id} training on {worker.device} "
          f"(obs on {obs_host}:{obs_port})", flush=True)
    try:
        gang_size = int(cfg.get("gang_size") or 0)
        n = worker.run_gang(gang_size) if gang_size >= 1 else worker.run()
    finally:
        worker.stop_obs()
        remove_port_file(cfg.get("obs_port_file"), obs_port)
    print(f"train worker {worker.worker_id} done: {n} trials", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
