"""The gang engine: K trials as K lanes of one train step.

Ports ``rafiki_tpu/tuning/gang.py``: ``supports_gang``, the lane
executor (``_VmapExec`` there, :class:`_LaneExec` here) and
``GangEngine``, with JAX's behaviour:

- proposals fall into **static buckets** by ``static_signature``: every
  knob but the traceable ones (per-lane tensors) and the policy knobs is
  fixed per bucket, and each bucket gets one executor;
- the advisor is driven through ``propose_batch`` / ``feedback_batch``;
  lanes whose trial budget runs out at an epoch boundary are scored,
  fed back and **refilled in place** from the advisor's next batch; a
  promotion refill warm-starts from the parent's blob in the
  ``MAX_BLOBS`` LRU (a miss cold-starts visibly, ``warm_start_misses``);
- ``max_trials`` caps the trials started, on every fill; proposals
  pulled but never laned, and the live lanes of a session that raises,
  are released with ``trial_errored``;
- an ``admission_check`` callback and a template's ``gang_blockers``
  can refuse a bucket, whose trials then run sequentially with a
  warning; ``mode="sequential"`` runs the same schedule through the
  template's own ``train()`` / ``evaluate()``;
- ``stats`` (a ``StatsMap``) and, with a registry, the gauges
  ``gang_lanes_active``, ``gang_lanes_culled_total``,
  ``trials_per_hour``, ``gang_samples_per_s`` and, per lane
  (``lane=<i>``), ``lane_tokens_per_s`` and ``lane_est_mfu``.

Where it differs, by necessity: JAX adds the lane axis with ``jax.vmap``
and jits the step; the port has no such transform for its kernels, so a
template's spec writes the K-lane step itself (``GangSpec.train_lanes``,
``model/loop.py``), and nothing is compiled: :meth:`GangEngine.
compile_counts` reports one executor per bucket, built once and never
rebuilt for a refill. At K = 1 the executor runs the spec's one-lane
``train_step`` (the template's sequential step) on lane 0 with no lane
axis, as JAX jits the bare step there, so a 1-lane gang is the
sequential trial bit for bit. Templates are built on ``device`` (None:
the CUDA card).
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.advisor.base import Proposal, TrialResult
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.knob import (Knobs, static_signature,
                                         traceable_knobs,
                                         validate_override_keys)
from rafiki_tpu_torch.model.log import ModelLogger
from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)


def supports_gang(model_class: type) -> bool:
    """True when the template implements the gang contract
    (``make_gang_spec`` + ``gang_epochs``)."""
    return (callable(getattr(model_class, "make_gang_spec", None))
            and callable(getattr(model_class, "gang_epochs", None)))


def tree_map(fn, *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class _LaneExec:
    """One static bucket's executor: the stacked lane state (every leaf
    with a leading K), the per-lane hp tensors, and the spec's step."""

    def __init__(self, spec, gang_size: int, device: torch.device) -> None:
        if gang_size > 1 and spec.train_lanes is None:
            raise ValueError("the gang spec has no train_lanes: it runs "
                             "gangs of one lane only")
        self.spec = spec
        self.k = gang_size
        self.device = device
        self.state: Any = None
        self.hp: Dict[str, torch.Tensor] = {
            n: torch.zeros((gang_size,), dtype=torch.float32, device=device)
            for n in spec.hp_names}

    def _lane(self, i: int) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """Lane ``i``'s state (views into the stacked leaves) and hp."""
        return (tree_map(lambda a: a[i], self.state),
                {n: self.hp[n][i] for n in self.spec.hp_names})

    def _step(self, batch: Dict[str, np.ndarray]) -> None:
        if self.k == 1:
            # the 1-lane gang IS the sequential trial: the spec's own
            # step on lane 0's views, no lane axis anywhere
            lane, hp = self._lane(0)
            new, _loss = self.spec.train_step(
                lane, hp, {key: v[0] for key, v in batch.items()})
            self.state = tree_map(lambda a: a.unsqueeze(0), new)
        else:
            self.state, _loss = self.spec.train_lanes(self.state, self.hp,
                                                      batch)

    def fill_lane(self, i: int, knobs: Knobs,
                  warm_blob: Optional[dict]) -> None:
        """(Re)initialize lane ``i`` (fresh params and optimizer state,
        or params from a warm-start blob) and write its traceable knob
        values into the hp tensors. No executor is rebuilt."""
        lane_hp = {n: torch.tensor(float(knobs[n]), dtype=torch.float32,
                                   device=self.device)
                   for n in self.spec.hp_names}
        gen = torch.Generator(device=self.device).manual_seed(0)
        lane = self.spec.init_lane(gen, lane_hp)
        if warm_blob is not None:
            lane = self.spec.warm_lane(lane, warm_blob)
        if self.state is None:
            self.state = tree_map(
                lambda a: a.unsqueeze(0).repeat(
                    (self.k,) + (1,) * a.dim()), lane)
        else:
            tree_map(lambda s, v: s[i].copy_(v), self.state, lane)
        for n, v in lane_hp.items():
            self.hp[n][i] = v

    def run_epoch(self, lane_epochs: List[int]) -> Tuple[int, int]:
        """Step every lane through one epoch of its OWN batch schedule
        (lane i's batches are ``epoch_batches(lane_epochs[i])``). Returns
        (steps, samples per lane)."""
        iters = [self.spec.epoch_batches(e) for e in lane_epochs]
        steps = samples = 0
        for per_lane in zip(*iters):
            self._step({key: np.stack([b[key] for b in per_lane])
                        for key in per_lane[0]})
            steps += 1
            samples += int(per_lane[0]["mask"].sum())
        return steps, samples

    def _lane_eval(self, eb: Any) -> List[Any]:
        """Each lane's ``eval_lane`` on one eval batch."""
        if self.k > 1 and self.spec.eval_lanes is not None:
            return list(self.spec.eval_lanes(self.state, self.hp, eb))
        return [self.spec.eval_lane(*self._lane(i), eb)
                for i in range(self.k)]

    def scores(self) -> np.ndarray:
        """Per-lane score over the validation stream: inverse perplexity
        ``exp(-sum/count)`` (f64 sums, as the LM template's ``evaluate``)
        for ``score_kind="lm"``, else masked accuracy."""
        if self.spec.score_kind == "lm":
            totals, counts = np.zeros(self.k), np.zeros(self.k)
            for i in range(self.k):
                for eb in self.spec.eval_batches():
                    s, c = self.spec.eval_lane(*self._lane(i), eb)
                    totals[i] += float(s)
                    counts[i] += float(c)
            return np.exp(-totals / np.maximum(counts, 1.0))
        correct = np.zeros(self.k)
        total = 0.0
        for eb in self.spec.eval_batches():
            preds = [np.asarray(torch.as_tensor(p).cpu())
                     for p in self._lane_eval(eb["x"])]
            mask = eb["mask"].astype(np.float64)
            y = np.asarray(eb["y"])
            for i, p in enumerate(preds):
                correct[i] += float(((p == y) * mask).sum())
            total += float(mask.sum())
        return correct / max(total, 1.0)

    def export(self, i: int) -> dict:
        lane, hp = self._lane(i)
        return self.spec.export_blob(
            lane, {n: float(v) for n, v in hp.items()})


class GangEngine:
    """Drives an advisor's propose/feedback cycle over gang lanes
    (``mode="gang"``) or the template's own per-trial path on the same
    schedule (``mode="sequential"``, the equivalence baseline)."""

    #: completed-trial blobs kept for warm starts (LRU)
    MAX_BLOBS = 64

    def __init__(self, model_class: type, advisor: Any,
                 train_dataset_path: str, val_dataset_path: str,
                 gang_size: int = 8, mode: str = "gang",
                 knob_overrides: Optional[Dict[str, Any]] = None,
                 metrics: Optional[Any] = None,
                 keep_blobs: bool = True,
                 on_result: Optional[Any] = None,
                 admission_check: Optional[Any] = None,
                 device: DeviceLike = None) -> None:
        if mode not in ("gang", "sequential"):
            raise ValueError(f"unknown gang mode {mode!r}")
        if gang_size < 1:
            raise ValueError("gang_size must be >= 1")
        if mode == "gang" and not supports_gang(model_class):
            raise ValueError(
                f"{model_class.__name__} has no make_gang_spec/gang_epochs;"
                " use mode='sequential' or tune_model's fallback")
        self.model_class = model_class
        self.advisor = advisor
        self.train_dataset_path = train_dataset_path
        self.val_dataset_path = val_dataset_path
        self.gang_size = int(gang_size)
        self.mode = mode
        self.device = resolve_device(device)
        self.knob_config = model_class.get_knob_config()
        self.knob_overrides = dict(knob_overrides or {})
        validate_override_keys(self.knob_config, self.knob_overrides,
                               context="knob_overrides")
        self.hp_names = traceable_knobs(self.knob_config)
        self.keep_blobs = keep_blobs
        self.on_result = on_result  # callable(TrialResult, blob) or None
        #: ``(knobs, gang_size) -> Optional[str]``: a refusal reason (the
        #: worker's memory admission) or None to admit
        self.admission_check = admission_check
        self.results: List[TrialResult] = []
        self._pending: List[Proposal] = []
        self._seen_buckets: set = set()
        self._blocked_buckets: Dict[str, str] = {}  # bucket -> reason
        self._execs: "OrderedDict[str, _LaneExec]" = OrderedDict()
        self._blobs: "OrderedDict[str, dict]" = OrderedDict()
        self._t0: Optional[float] = None
        self.stats = StatsMap({
            "trials_completed": 0, "trials_started": 0, "lanes_culled": 0,
            "promotions": 0, "warm_start_misses": 0, "epoch_rounds": 0,
            "buckets": 0, "samples": 0})
        self._max_trials: Optional[int] = None
        self._wire_metrics(metrics)

    # ---- obs plumbing ----
    def _wire_metrics(self, metrics: Optional[Any]) -> None:
        self._metrics = metrics  # per-lane gauges mint lazily by label
        if metrics is None:
            self._g_active = self._c_culled = self._g_tph = \
                self._g_sps = None
            return
        self._g_active = metrics.gauge(
            "gang_lanes_active",
            "gang lanes currently training a live trial")
        self._c_culled = metrics.counter(
            "gang_lanes_culled_total",
            "lanes whose trial exited a sub-full ASHA rung (culled in "
            "place; promotions return in a later refill)")
        self._g_tph = metrics.gauge(
            "trials_per_hour",
            "completed-trial throughput of the gang engine")
        self._g_sps = metrics.gauge(
            "gang_samples_per_s",
            "aggregate training samples/s across all lanes")

    def _publish_lane_gauges(self, exec_: _LaneExec,
                             lanes: List[Optional[Proposal]],
                             samples: int, dt: float) -> None:
        """``lane_tokens_per_s`` and ``lane_est_mfu`` (6·N·tokens/s over
        the card's peak, ``worker/train.py`` ``_device_peak_flops``),
        labelled ``lane=<i>``; idle lanes read 0. Specs without token
        accounting skip both."""
        tokens = int(exec_.spec.tokens_per_sample or 0)
        if self._metrics is None or not tokens:
            return
        tps = samples * tokens / dt  # every active lane steps together
        n_params = int(exec_.spec.lane_param_count or 0)
        peak = 0.0
        if n_params:
            from rafiki_tpu_torch.worker.train import _device_peak_flops

            peak = _device_peak_flops(self.device)
        for i, p in enumerate(lanes):
            lane_tps = tps if p is not None else 0.0
            self._metrics.gauge(
                "lane_tokens_per_s",
                "training tokens/s of one gang lane (0 when idle)",
                labels={"lane": str(i)}).set(lane_tps)
            if n_params and peak > 0:
                self._metrics.gauge(
                    "lane_est_mfu",
                    "estimated MFU of one gang lane "
                    "(6*params*tokens_per_s / peak FLOP/s)",
                    labels={"lane": str(i)}).set(
                        6.0 * n_params * lane_tps / peak)

    def _publish(self, active: int) -> None:
        if self._g_active is not None:
            self._g_active.set(active)
        if self._g_tph is not None and self._t0 is not None:
            dt = max(time.monotonic() - self._t0, 1e-9)
            self._g_tph.set(self.stats["trials_completed"] / dt * 3600.0)

    # ---- proposal plumbing ----
    def _bucket_of(self, p: Proposal) -> str:
        return static_signature(self.knob_config, p.knobs)

    def _remaining_starts(self) -> Optional[int]:
        if self._max_trials is None:
            return None
        return max(0, self._max_trials - int(self.stats["trials_started"]))

    def _take_pending(self, bucket: str, n: int) -> List[Proposal]:
        """Up to ``n`` pending proposals of ``bucket`` in arrival order,
        topped up by ONE pull from the advisor when pending runs dry
        (proposals of other buckets are queued, not dropped); capped by
        ``max_trials``: every proposal returned starts a lane."""
        remaining = self._remaining_starts()
        if remaining is not None:
            n = min(n, remaining)
        out: List[Proposal] = []
        rest: List[Proposal] = []
        for p in self._pending:
            if len(out) < n and self._bucket_of(p) == bucket:
                out.append(p)
            else:
                rest.append(p)
        self._pending = rest
        if len(out) < n:
            for p in self.advisor.propose_batch(n - len(out)):
                self._apply_overrides(p)
                if len(out) < n and self._bucket_of(p) == bucket:
                    out.append(p)
                else:
                    self._pending.append(p)
        return out

    def _apply_overrides(self, p: Proposal) -> None:
        if self.knob_overrides:
            p.knobs = {**p.knobs, **self.knob_overrides}
        self.model_class.validate_knobs(p.knobs)

    def _epochs_for(self, p: Proposal) -> int:
        return int(self.model_class.gang_epochs(p.knobs, p.budget_scale)) \
            if supports_gang(self.model_class) else 1

    def _warm_blob(self, p: Proposal,
                   share_knob: Optional[str]) -> Optional[dict]:
        """The parent blob a refill warm-starts from, under the same gate
        as the sequential path (the SHARE_PARAMS knob on). A miss (the
        parent evicted from the LRU, or minted by another worker)
        cold-starts the lane, visibly."""
        if not p.warm_start_trial_id:
            return None
        if share_knob is not None and not p.knobs.get(share_knob):
            return None
        blob = self._blobs.get(p.warm_start_trial_id)
        if blob is None:
            self.stats.inc("warm_start_misses")
            log.warning("gang warm start %r for trial %d not in the blob "
                        "cache (evicted or foreign worker); lane "
                        "cold-starts", p.warm_start_trial_id, p.trial_no)
        return blob

    def _record(self, p: Proposal, score: float, blob: dict) -> None:
        trial_id = f"gang-{p.trial_no}"
        if self.keep_blobs:
            self._blobs[trial_id] = blob
            while len(self._blobs) > self.MAX_BLOBS:
                self._blobs.popitem(last=False)
        result = TrialResult(
            trial_no=p.trial_no, knobs=p.knobs, score=float(score),
            trial_id=trial_id, budget_scale=p.budget_scale, meta=p.meta)
        self.results.append(result)
        self.stats.inc("trials_completed")
        if p.meta.get("parent_trial_no") is not None:
            self.stats.inc("promotions")
        if p.budget_scale < 1.0 - 1e-9:
            self.stats.inc("lanes_culled")
            if self._c_culled is not None:
                self._c_culled.inc()
        if self.on_result is not None:
            self.on_result(result, blob)

    # ---- the run loop ----
    def run(self, max_trials: Optional[int] = None) -> List[TrialResult]:
        """Pull batched proposals until the advisor's budget, or
        ``max_trials`` trials started, is spent; returns one TrialResult
        per lane-trial (also fed back to the advisor, in completion
        order)."""
        self._t0 = time.monotonic()
        self._max_trials = max_trials
        while True:
            remaining = self._remaining_starts()
            if remaining is not None and remaining <= 0:
                break
            if not self._pending:
                k = self.gang_size if remaining is None \
                    else min(self.gang_size, remaining)
                batch = self.advisor.propose_batch(k)
                if not batch:
                    break
                for p in batch:
                    self._apply_overrides(p)
                self._pending.extend(batch)
            self._run_session(self._bucket_of(self._pending[0]))
        if self._pending:
            # pulled but never laned (cap hit, bucket stranded at the
            # budget's end): release the advisor's outstanding slots
            for p in self._pending:
                try:
                    self.advisor.trial_errored(p.trial_no)
                except Exception:  # noqa: BLE001 — the advisor may be
                    pass           # gone at teardown
            self._pending.clear()
        self._publish(active=0)
        return self.results

    def _run_session(self, bucket: str) -> None:
        """One gang over one static bucket until every lane drains."""
        lanes: List[Optional[Proposal]] = [None] * self.gang_size
        epochs_left = [0] * self.gang_size
        lane_epoch = [0] * self.gang_size
        initial = self._take_pending(bucket, self.gang_size)
        if not initial:
            return
        unlaned = list(initial)
        try:
            exec_ = self._get_exec(bucket, initial[0].knobs)
            self._seen_buckets.add(bucket)
            self.stats.set("buckets", len(self._seen_buckets))
            for i, p in enumerate(initial):
                self._fill(exec_, i, p, lanes, epochs_left, lane_epoch)
                unlaned.remove(p)
            while any(p is not None for p in lanes):
                self._session_round(bucket, exec_, lanes, epochs_left,
                                    lane_epoch)
        except Exception:
            # a template fault fails the whole gang; release the
            # advisor's outstanding slots so the budget is not stranded
            for p in [p for p in lanes if p is not None] + unlaned:
                try:
                    self.advisor.trial_errored(p.trial_no)
                except Exception:  # noqa: BLE001 — the original error
                    pass           # wins
            raise

    def _session_round(self, bucket: str, exec_: Optional[_LaneExec],
                       lanes: List[Optional[Proposal]],
                       epochs_left: List[int],
                       lane_epoch: List[int]) -> None:
        """One epoch round: step the lanes, then score, feed back and
        refill the lanes whose trial budget just ran out."""
        t_round = time.monotonic()
        if exec_ is not None:
            # idle lanes step a dummy schedule (epoch 0); their state is
            # overwritten on refill
            _steps, samples = exec_.run_epoch(
                [lane_epoch[i] if lanes[i] is not None else 0
                 for i in range(self.gang_size)])
            n_active = sum(p is not None for p in lanes)
            self.stats.inc("samples", samples * n_active)
            dt_round = max(time.monotonic() - t_round, 1e-9)
            if self._g_sps is not None:
                self._g_sps.set(samples * n_active / dt_round)
            self._publish_lane_gauges(exec_, lanes, samples, dt_round)
        self.stats.inc("epoch_rounds")
        finished: List[int] = []
        for i, p in enumerate(lanes):
            if p is None:
                continue
            lane_epoch[i] += 1
            epochs_left[i] -= 1
            if epochs_left[i] <= 0:
                finished.append(i)
        if not finished:
            self._publish(sum(p is not None for p in lanes))
            return
        scores = exec_.scores() if exec_ is not None else None
        batch_results: List[TrialResult] = []
        for i in finished:
            p = lanes[i]
            if exec_ is not None:
                score, blob = float(scores[i]), exec_.export(i)
            else:
                score, blob = self._run_sequential_trial(p)
            self._record(p, score, blob)
            batch_results.append(self.results[-1])
            lanes[i] = None
        self.advisor.feedback_batch(batch_results)
        refills = self._take_pending(bucket, len(finished))
        for i, p in zip(finished, refills):
            self._fill(exec_, i, p, lanes, epochs_left, lane_epoch)
        self._publish(sum(p is not None for p in lanes))

    def _fill(self, exec_: Optional[_LaneExec], i: int, p: Proposal,
              lanes: List[Optional[Proposal]], epochs_left: List[int],
              lane_epoch: List[int]) -> None:
        lanes[i] = p
        self.stats.inc("trials_started")
        epochs_left[i] = max(1, self._epochs_for(p))
        lane_epoch[i] = 0
        if exec_ is not None:
            share = exec_.spec.share_params_knob
            exec_.fill_lane(i, p.knobs, self._warm_blob(p, share))

    def _gang_refusal(self, knobs: Knobs) -> Optional[str]:
        """Why this bucket cannot run as lanes (None: it can): the
        template's named ``gang_blockers`` first, then the caller's
        admission check."""
        blockers_fn = getattr(self.model_class, "gang_blockers", None)
        if callable(blockers_fn):
            blockers = blockers_fn(knobs)
            if blockers:
                return "knobs block gang lanes: " + "; ".join(blockers)
        if self.admission_check is not None:
            return self.admission_check(knobs, self.gang_size)
        return None

    def _get_exec(self, bucket: str,
                  rep_knobs: Knobs) -> Optional[_LaneExec]:
        if self.mode == "sequential" or bucket in self._blocked_buckets:
            return None
        exec_ = self._execs.get(bucket)
        if exec_ is None:
            reason = self._gang_refusal(rep_knobs)
            if reason is not None:
                self._blocked_buckets[bucket] = reason
                log.warning("gang bucket falls back to sequential trials: "
                            "%s", reason)
                return None
            spec = self.model_class.make_gang_spec(
                dict(rep_knobs), self.train_dataset_path,
                self.val_dataset_path, device=self.device)
            if list(spec.hp_names) != list(self.hp_names):
                raise ValueError(
                    f"gang spec hp_names {list(spec.hp_names)} != "
                    f"traceable knobs {self.hp_names}")
            exec_ = _LaneExec(spec, self.gang_size, self.device)
            self._execs[bucket] = exec_
        return exec_

    # ---- sequential (process-mode) executor ----
    def _run_sequential_trial(self, p: Proposal) -> Tuple[float, dict]:
        """The template's own per-trial path on the gang schedule: what
        one process-per-trial worker computes for this proposal, its
        warm start included."""
        model = self.model_class(device=self.device, **p.knobs)
        shared = self._blobs.get(p.warm_start_trial_id) \
            if p.warm_start_trial_id else None
        ctx = TrainContext(logger=ModelLogger(),
                           budget_scale=p.budget_scale,
                           shared_params=shared,
                           trial_id=f"gang-{p.trial_no}")
        model.train(self.train_dataset_path, ctx)
        score = float(model.evaluate(self.val_dataset_path))
        return score, model.dump_parameters()

    # ---- introspection ----
    def compile_counts(self) -> Dict[str, int]:
        """Executors built per bucket. JAX counts the jitted step's
        compiled programs; the port compiles nothing, so the count is of
        :class:`_LaneExec` objects: 1 per bucket, never rebuilt for a
        refill or a new trial."""
        return {b: 1 for b in self._execs}

    @property
    def n_buckets(self) -> int:
        return len(self._execs)

    @property
    def trials_per_hour(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = max(time.monotonic() - self._t0, 1e-9)
        return self.stats["trials_completed"] / dt * 3600.0
