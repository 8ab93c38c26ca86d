"""Inference worker: one serving replica of a trial, on the CUDA card.

Ports ``rafiki_tpu/worker/inference.py``: boot by loading a trial's
parameters from the ``ParamStore`` (admission check, engine build,
warmup), then loop — block-pop the query queue, serve, push the replies
keyed by query id — answering the unchanged JAX ``Predictor`` over the
same queue hub and the same msgpack wire. Ported: ``ClockSkewEstimator``,
``InferenceWorker`` (``__init__``, ``_admission_check``, ``_warmup``,
``stop``, ``drain``, ``serve_obs`` (the obs sidecar with ``POST
/drain``), ``_publish_stats``, ``_engine_span``,
``_reject_expired``, ``_handle_control``, ``_reject_draining``,
``_share_prefix_snapshot``, ``_drain_reject_queued``,
``_hub_outage_pause``, ``_hub_ok``,
``run`` with the micro-batch path and ``_serve_batch``,
``_run_decode_loop`` /
``_decode_serve`` with streaming deltas, ``_admit_decode_message``, and
for disaggregated serving ``_can_import_kv``, ``_handle_prefill_leg``,
``_ship_finished_prefill``, ``_kv_stage_budget_ok`` and
``_pump_kv_shipments``), the fault-injection hooks (``chaos`` or
``RAFIKI_CHAOS``: queue faults through a ``ChaosHub``, the ``chaos_*``
counters on ``/metrics``, the ``kill_after_tokens`` death in the decode
loop, after which ``main`` exits 31 so the manager respawns the worker),
``_window_p95``, ``_safe_sampling``, ``_expired``, ``_tristate``,
``_to_plain`` and ``main``.

Two serving paths, as in JAX: the continuous-batching decode loop for a
template with ``make_decode_engine`` under ``decode_loop=True``
(``LlamaLoRA``: paged KV through kernels B1/B2), and the micro-batcher
that merges queued messages into one ``predict`` (``ViTBase16``: B7 and
B3/B4).

Where it differs from the JAX worker, on purpose:

- ``device`` is a constructor argument (None: the CUDA card, raising
  without one) and the model is built as ``model_class(device=...,
  **knobs)``;
- boot fails loudly: a warmup failure propagates, and ``decode_loop``
  with a template that has no ``make_decode_engine`` raises instead of
  degrading to the micro-batcher;
- the decode modes are the JAX worker's: ``speculate_k`` (prompt-lookup
  speculation), ``draft_trial_id`` with ``draft_knobs`` (draft-model
  speculation), ``extra_adapter_trials`` (one stacked multi-adapter
  engine, requests routed by ``sampling["adapter_id"]``),
  ``system_prefix`` and, with ``pool_id``, prefix sharing: the first
  replica of a pool publishes its prefix snapshot as the hub blob
  ``prefix:{pool_id}:0``, a later one installs it instead of prefilling
  (``_share_prefix_snapshot``, counted in ``kv_imports_installed``);
- disaggregated prefill/decode and the host KV tier are the JAX
  worker's: ``role`` (``unified`` / ``prefill`` / ``decode``, validated
  at boot: a role needs ``decode_loop`` and an engine that declares
  ``supports_kv_ship``), ``host_kv_pages`` (needs ``decode_loop`` and
  ``kv_page_size``; the tier's gauges and the ``kv_transfer_seconds``
  histogram on ``/metrics``) and ``kv_wait_s``. A prefill worker runs
  each message's prefill leg prefill-only and pushes the finished KV
  blobs to the decode worker the message names (its outbox,
  ``_ship_finished_prefill``); a decode worker holds a message whose
  prefill leg went elsewhere for up to ``kv_wait_s`` (the holding pen,
  ``_pump_kv_shipments``), uploads each arriving blob ahead of admission
  and submits the request with it, and degrades to a local re-prefill
  when a shipment is late, lost or refused (``kv_wait_timeouts``,
  ``kv_import_fallbacks``; ``kv_ships_sent``, ``kv_imports_installed``);
- ``paged_kernel=False`` raises ``NotImplementedError`` at boot, naming
  itself (the port has no gather path on the card: ``None``/``True``
  serve paged);
- ``main`` reads the same config JSON plus ``"device"``; there is no jax
  platform setup and no multi-host rendezvous; on exit it deletes its
  ``obs_port_file`` (``obs/http.py`` ``remove_port_file``);
- the published stats carry the process's kernel launch counts under
  ``kernel_launches`` (each kernel wrapper's ``launches``: zero where
  the plain versions ran), and the obs sidecar's ``/metrics`` as
  ``kernel_launches_<name>`` gauges, so a caller outside the process can
  tell which kernels its requests went through.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch.native.client import CLIENT_STATS
from rafiki_tpu_torch.obs.http import ObsServer, remove_port_file
from rafiki_tpu_torch.obs.metrics import MetricsRegistry, StatsMap
from rafiki_tpu_torch.obs.trace import TraceBuffer, mint_trace_id
from rafiki_tpu_torch.ops import attention as _fa
from rafiki_tpu_torch.ops import paged_attention as _pa
from rafiki_tpu_torch.ops import patch_embed as _pe
from rafiki_tpu_torch.serving.kv_transfer import normalize_role
from rafiki_tpu_torch.serving.queues import (EXPIRY_SKEW_TOLERANCE_S,
                                             QueueHub, pack_message,
                                             unpack_message)
from rafiki_tpu_torch.serving.slo import SLO_CLASSES, normalize_slo
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.utils.device import DeviceLike, resolve_device
from rafiki_tpu_torch.worker.admission import resolve_device_limit

log = logging.getLogger(__name__)

#: expiry pad for the RELATIVE (ttl_s) deadline path: the residual error
#: there is the skew estimator's convergence slack, not raw cross-host
#: clock skew, so it is a fraction of EXPIRY_SKEW_TOLERANCE_S
TTL_EXPIRY_PAD_S = 0.5

#: published-p95 samples older than this stop counting: an idle class
#: must read as recovered (empty window → 0.0 → ladder cooling)
SLO_WINDOW_MAX_AGE_S = 60.0

#: prefill-role outbox give-up window: long enough for the slowest
#: chunked prefill to finish and ship, short enough that legs whose slots
#: never produce a blob (an engine reset) cannot grow the outbox without
#: bound; a pruned leg's decode side re-prefilled long before
_KV_OUTBOX_TTL_S = 600.0


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


class ClockSkewEstimator:
    """Skew-compensated elapsed time since a remote wall-clock stamp.

    ``now - sent_ts`` observed here is true elapsed + clock skew; the
    MINIMUM over promptly popped queries converges on the skew itself
    (one-way-delay estimation), and subtracting it gives an elapsed
    estimate immune to static cross-host skew. The estimate relaxes
    upward slowly, so a clock step eventually re-converges."""

    #: upward relaxation per observation (fraction of the gap)
    RELAX = 0.01

    def __init__(self) -> None:
        self._est: Optional[float] = None

    def elapsed_since(self, sent_ts: float) -> float:
        obs = time.time() - float(sent_ts)  # true elapsed + skew
        if self._est is None or obs < self._est:
            self._est = obs
        else:
            self._est += self.RELAX * (obs - self._est)
        return obs - self._est


class InferenceWorker:
    def __init__(self, model_class: type, trial_id: str,
                 knobs: dict, param_store: ParamStore, hub: QueueHub,
                 worker_id: str, max_batch_msgs: int = 16,
                 decode_loop: bool = False, max_slots: int = 8,
                 max_new_tokens: int = 8, steps_per_sync: int = 4,
                 speculate_k: int = 0, system_prefix: str = "",
                 extra_adapter_trials: Optional[List[str]] = None,
                 draft_trial_id: str = "",
                 draft_knobs: Optional[dict] = None,
                 kv_page_size: int = 0, kv_pages: int = 0,
                 paged_kernel: Optional[bool] = None,
                 default_slo: str = "",
                 role: str = "", host_kv_pages: int = 0,
                 kv_wait_s: float = 1.5, pool_id: str = "",
                 chaos: Optional[Any] = None,
                 device: DeviceLike = None) -> None:
        self.worker_id = worker_id
        self.hub = hub
        self.max_batch_msgs = max_batch_msgs
        #: disaggregated serving role (``unified`` default): a ``prefill``
        #: worker runs prompts through chunked prefill and ships the KV to
        #: the decode leg's worker over the hub; a ``decode`` worker holds
        #: shipped-KV requests for up to ``kv_wait_s`` and installs the
        #: blob at admission, re-prefilling locally when the shipment is
        #: late, lost or mismatched. Validated at boot.
        self.role = normalize_role(role)
        self.kv_wait_s = max(0.0, float(kv_wait_s))
        #: decode-role holding pen: message id -> [message, monotonic
        #: give-up deadline, {qi: blob}, monotonic arrival]
        self._pending_kv: Dict[Any, List[Any]] = {}
        #: prefill-role outbox: message id -> [ship-to worker id, trace
        #: id, queries still owed, monotonic give-up deadline]
        self._kv_outbox: Dict[Any, List[Any]] = {}
        # an option the port does not serve: refused before anything loads
        if paged_kernel is False:
            raise _not_ported("paged_kernel=False (the gather path: on the "
                              "card paged KV always runs the kernels)")
        #: the job's pool id: keys the shared prefix-snapshot blob
        self.pool_id = str(pool_id or "")
        #: admission class for requests that carry no ``slo`` of their
        #: own; validated at boot (a typo'd job default fails the deploy)
        self.default_slo = normalize_slo(default_slo)
        #: visible drop accounting; drain_rejected counts messages
        #: error-replied while draining; the kv_* counters are the
        #: shipments sent (prefill role) and installed (decode role; a
        #: pool peer's prefix snapshot counts too), and the degradations
        #: to a local re-prefill (wait window expired, blob refused)
        self.stats = StatsMap({"dropped_expired": 0,
                               "drain_rejected": 0,
                               "kv_ships_sent": 0,
                               "kv_imports_installed": 0,
                               "kv_wait_timeouts": 0,
                               "kv_import_fallbacks": 0,
                               "data_plane_down": 0,
                               "hub_outages": 0})
        self._dp_down = False
        #: deterministic fault injection (tests, chaos drills): passed in
        #: or armed by the RAFIKI_CHAOS env var; queue faults ride a
        #: ChaosHub wrapper, the kill-after-N-tokens trigger is checked in
        #: the decode loop. None (the default) costs nothing
        if chaos is None:
            from rafiki_tpu_torch.chaos import ChaosConfig, ChaosInjector

            cfg = ChaosConfig.from_env()
            chaos = ChaosInjector(cfg) if cfg is not None else None
        self.chaos = chaos
        self.chaos_killed = False
        if self.chaos is not None:
            from rafiki_tpu_torch.chaos import ChaosHub

            self.hub = ChaosHub(hub, self.chaos)
        #: flipped by the first request a prefill worker ships KV for:
        #: from then on the pump drains the shipment queue even with
        #: nothing held, so late blobs do not accumulate
        self._kv_seen_traffic = False
        self._draining = threading.Event()
        self._skew = ClockSkewEstimator()
        self.metrics = MetricsRegistry()
        self.metrics.register_stats(self.stats)
        self.metrics.register_stats(CLIENT_STATS)
        # the kernel wrappers' launch counts, readable at any time on
        # the obs sidecar (the hub publish carries them too, but only
        # every STATS_EVERY loop iterations)
        self.metrics.register_stats(kernel_launches,
                                    prefix="kernel_launches_")
        if self.chaos is not None:
            # injected faults are observable: chaos_* on /metrics
            self.metrics.register_stats(self.chaos.counters,
                                        prefix="chaos_")
        self.traces = TraceBuffer(512)
        self._boot_mono = time.monotonic()
        #: the obs sidecar's port once serve_obs ran (0: none), published
        #: with the stats
        self._obs_port = 0
        self._obs_server: Optional[ObsServer] = None
        self._h_ttft = self.metrics.histogram(
            "ttft_seconds", "queued -> first generated token (seconds)")
        self._h_queue = self.metrics.histogram(
            "time_in_queue_seconds",
            "queued -> decode-slot admission (seconds)")
        self._h_e2e = self.metrics.histogram(
            "request_seconds",
            "queued -> request fully answered (seconds)")
        self._h_occupancy = self.metrics.histogram(
            "batch_occupancy", "live decode slots per engine step",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
        self._h_tps = self.metrics.histogram(
            "decode_tokens_per_s",
            "per-request generated-token throughput",
            buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000,
                     5000))
        self._h_step = self.metrics.histogram(
            "decode_step_seconds",
            "one engine step() — admission + K decode tokens (seconds)")
        self._h_kv_transfer = self.metrics.histogram(
            "kv_transfer_seconds",
            "one host-tier page transfer (evict or prefetch staging) on "
            "the tier's transfer thread (seconds)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5))
        # per-class latency histograms, and the bounded windows behind
        # the published per-class p95 gauges (the predictor's brownout
        # ladder reads slo_interactive_ttft_p95_s and must see recovery)
        self._h_ttft_slo = {
            c: self.metrics.histogram(
                "ttft_seconds",
                "queued -> first generated token (seconds)",
                labels={"slo": c}) for c in SLO_CLASSES}
        self._h_e2e_slo = {
            c: self.metrics.histogram(
                "request_seconds",
                "queued -> request fully answered (seconds)",
                labels={"slo": c}) for c in SLO_CLASSES}
        self._slo_ttft_win = {c: collections.deque(maxlen=256)
                              for c in SLO_CLASSES}
        self._slo_e2e_win = {c: collections.deque(maxlen=256)
                             for c in SLO_CLASSES}
        #: the windows are appended on the serve thread and read by
        #: _publish_stats, which drain() may call from another thread
        self._slo_win_lock = threading.Lock()
        #: engine request id -> (trace_id, queued monotonic, slo); touched
        #: only by the serve-loop thread (submits, step, span hook)
        self._req_obs: Dict[Any, Tuple[str, float, str]] = {}
        self._stop = threading.Event()
        self.device = resolve_device(device)
        self.model = model_class(device=self.device, **knobs)
        params = param_store.load(trial_id)
        if params is None:
            raise KeyError(f"no parameters for trial {trial_id!r}")
        self.model.load_parameters(params)
        del params
        # an unloaded draft twin sized from its knobs: its params and
        # cache count toward admission before any blob loads
        draft_for_admission = None
        if draft_trial_id and decode_loop and speculate_k >= 2:
            draft_for_admission = model_class(
                device=self.device, **(draft_knobs or knobs))
        #: prefix sharing: a pool peer's published snapshot replaces the
        #: local prefix prefill (installed after boot); single-adapter
        #: deployments only, best-effort (a hub hiccup just prefills)
        self._peer_prefix_blob: Optional[dict] = None
        self._system_prefix = str(system_prefix or "")
        if self.pool_id and system_prefix and decode_loop \
                and not extra_adapter_trials:
            try:
                raw = self.hub.get_blob(f"prefix:{self.pool_id}:0")
                if raw is not None:
                    self._peer_prefix_blob = unpack_message(raw)
                    system_prefix = ""
            except Exception:  # noqa: BLE001 — sharing never gates boot
                log.debug("prefix blob fetch failed", exc_info=True)
        if host_kv_pages and not (decode_loop and kv_page_size):
            raise ValueError(
                "host_kv_pages requires decode_loop and kv_page_size "
                "> 0 (the host tier spills KV PAGES)")
        if self.role != "unified" and not decode_loop:
            raise ValueError(
                f"worker role {self.role!r} requires decode_loop: the "
                "micro-batch path has no KV to disaggregate")
        self._admission_check(
            max_slots if decode_loop else 0,
            len(extra_adapter_trials or ()) if decode_loop else 0,
            draft_for_admission,
            kv_page_size=kv_page_size if decode_loop else 0,
            kv_pages=kv_pages if decode_loop else 0,
            host_kv_pages=host_kv_pages if decode_loop else 0)
        self.engine = None
        if draft_trial_id and (not decode_loop or speculate_k < 2):
            raise ValueError(
                "draft_trial_id requires decode_loop and "
                f"speculate_k >= 2 (got speculate_k={speculate_k})")
        if draft_trial_id and extra_adapter_trials:
            raise ValueError(
                "draft_trial_id is not supported with multi-adapter "
                "deployment (the stacked engine has no draft path)")
        if decode_loop:
            if not hasattr(self.model, "make_decode_engine"):
                raise RuntimeError(
                    f"{model_class.__name__} has no make_decode_engine: "
                    "decode_loop needs a continuous-batching engine (serve "
                    "it with decode_loop=False through predict())")
            extra = {}
            if kv_page_size:
                extra = {"kv_page_size": kv_page_size,
                         "kv_pages": kv_pages}
                if host_kv_pages:
                    # the host page tier: the admission budget becomes
                    # pool pages + host pages (serving/kv_tier.py)
                    extra["host_kv_pages"] = int(host_kv_pages)
            if extra_adapter_trials:
                self.engine = self._multi_adapter_engine(
                    model_class, param_store, extra_adapter_trials,
                    system_prefix, max_slots=max_slots,
                    max_new_tokens=max_new_tokens,
                    steps_per_sync=steps_per_sync,
                    speculate_k=speculate_k, **extra)
            else:
                if speculate_k:
                    extra["speculate_k"] = speculate_k
                if system_prefix:
                    extra["system_prefix"] = system_prefix
                if draft_trial_id:
                    # draft-model speculation: a second trial drafts,
                    # shaped by its own knobs
                    d_dump = param_store.load(draft_trial_id)
                    if d_dump is None:
                        raise KeyError("no parameters for draft trial "
                                       f"{draft_trial_id!r}")
                    d_model = model_class(device=self.device,
                                          **(draft_knobs or knobs))
                    d_model.load_parameters(d_dump)
                    extra["draft_model"] = d_model
                self.engine = self.model.make_decode_engine(
                    max_slots=max_slots, max_new_tokens=max_new_tokens,
                    steps_per_sync=steps_per_sync, **extra)
        if self.role != "unified" and not getattr(
                self.engine, "supports_kv_ship", False):
            # fail the deploy: a role-configured worker whose engine
            # cannot ship KV would silently serve unified
            raise ValueError(
                f"worker role {self.role!r} requires an engine with "
                "KV shipment support (supports_kv_ship); this "
                "deployment's engine has none")
        if self.engine is not None:
            # engine counters (the tier's gauges among them) surface in
            # the metrics under their bare names; the hub publish keeps
            # the engine_ prefix
            self.metrics.register_stats(self.engine.stats)
            self.engine.span_sink = self._engine_span
            tier = getattr(getattr(self.engine, "engine", self.engine),
                           "tier", None)
            if tier is not None:
                # observed on the tier's transfer thread (the registry's
                # instruments are locked)
                tier.observe_transfer = self._h_kv_transfer.observe
        self._warmup()
        self._share_prefix_snapshot()

    def _multi_adapter_engine(self, model_class: type,
                              param_store: ParamStore,
                              extra_adapter_trials: List[str],
                              system_prefix: str, **kw: Any) -> Any:
        """One stacked engine: the primary trial as adapter 0 and each
        extra trial as adapter 1..N, one base on the card. A base that
        does not stack fails the boot naming the remedy; a system prefix
        is registered per adapter (its KV is a function of the
        adapter)."""
        if not hasattr(self.model, "make_multi_adapter_engine"):
            raise RuntimeError(
                f"{model_class.__name__} does not support multi-adapter "
                "serving (no make_multi_adapter_engine); deploy plain "
                "replicas instead")
        trees = [self.model._params]
        for tid in extra_adapter_trials:
            dump = param_store.load(tid)
            if dump is None:
                raise KeyError(f"no parameters for adapter trial {tid!r}")
            trees.append(dump["params"])
        try:
            engine = self.model.make_multi_adapter_engine(trees, **kw)
        except ValueError as e:
            raise RuntimeError(
                "multi-adapter deployment requires trials that share one "
                "base (train them with adapters_only=True and identical "
                "shape-relevant knobs); deploy as plain replicas instead: "
                f"{e}") from e
        if system_prefix:
            for aid in range(len(trees)):
                engine.register_prefix(system_prefix, adapter_id=aid)
        return engine

    def _admission_check(self, max_slots: int, n_extra_adapters: int = 0,
                         draft: Any = None, kv_page_size: int = 0,
                         kv_pages: int = 0, host_kv_pages: int = 0
                         ) -> None:
        """Refuse a deployment whose serving footprint (params + KV cache
        + stacked adapters + a draft's params and cache + working set,
        the template's ``estimate_serving_device_bytes``) exceeds the
        device's memory, before any engine is built. A micro-batch
        deployment passes ``max_slots=0``; a paged one is budgeted at its
        page pool. An estimator that raises is logged and the deployment
        admitted."""
        est = getattr(self.model, "estimate_serving_device_bytes", None)
        if est is None:
            return
        limit = resolve_device_limit(self.device)
        if not limit:
            return
        try:
            kwargs = {"max_slots": max_slots,
                      "n_extra_adapters": n_extra_adapters}
            if draft is not None:
                kwargs["draft"] = draft
            if kv_page_size:
                kwargs["kv_page_size"] = kv_page_size
                kwargs["kv_pages"] = kv_pages
                if host_kv_pages:
                    # host memory: reported, never in the device total
                    kwargs["host_kv_pages"] = host_kv_pages
            budget = est(**kwargs)
            total = int(budget["total"])
        except Exception as e:  # noqa: BLE001 — an estimator bug must
            # not block an admissible deployment, but it must be visible
            log.warning("serving admission check skipped: "
                        "estimate_serving_device_bytes raised %r", e,
                        exc_info=True)
            return
        if total > limit:
            raise ValueError(
                "serving admission control: estimated "
                f"{total / 2**30:.2f}GiB footprint exceeds the "
                f"{limit / 2**30:.2f}GiB device limit (breakdown: "
                f"{ {k: round(v / 2**30, 3) for k, v in budget.items()} }"
                " GiB); lower max_slots/max_len or enable "
                "quantize_int8/kv_cache_int8")

    def _warmup(self) -> None:
        """Run the serving path once at boot (one dummy token through the
        engine, or the template's ``warmup``), so the first request does
        not pay the build. A failure propagates: a worker whose device
        path is broken must not come up."""
        if self.engine is not None:
            self.engine.submit("__warmup__", "warmup", max_new=1)
            while self.engine.busy:
                self.engine.step()
            self.engine.poll()  # drop the dummy completion
            # the dummy is not served traffic
            self.engine.reset_stats()
        else:
            warmup = getattr(self.model, "warmup", None)
            if warmup is not None:
                warmup()

    def _share_prefix_snapshot(self) -> None:
        """Prefix sharing across a pool: the replica that found a peer's
        blob at boot skipped its prefix prefill and installs the blob
        here (a blob that does not fit falls back to registering the
        prefix locally); the first replica publishes the snapshot it
        computed. Best-effort: a failure leaves a local snapshot
        serving."""
        if not self.pool_id or self.engine is None \
                or not self._system_prefix:
            return
        exp = getattr(self.engine, "export_prefix", None)
        imp = getattr(self.engine, "import_prefix", None)
        if exp is None or imp is None:
            return
        key = f"prefix:{self.pool_id}:0"
        if self._peer_prefix_blob is not None:
            blob, self._peer_prefix_blob = self._peer_prefix_blob, None
            try:
                imp(blob)
                self.stats.inc("kv_imports_installed")
            except Exception:  # noqa: BLE001 — a bad peer blob must not
                # leave the worker without its prefix
                log.warning("peer prefix snapshot rejected; registering "
                            "the prefix locally", exc_info=True)
                self.engine.register_prefix(self._system_prefix)
            return
        try:
            blob = exp()
            if blob is not None and self.hub.get_blob(key) is None:
                self.hub.put_blob(key, pack_message(blob))
        except Exception:  # noqa: BLE001 — publishing helps peers only
            log.warning("prefix snapshot publish failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()

    def drain(self) -> None:
        """Begin a graceful drain: new requests get an immediate
        structured ``draining`` rejection, in-flight ones (streams
        included) finish, then the serve loop exits. Idempotent; safe
        from any thread."""
        if self._draining.is_set():
            return
        log.info("%s draining: finishing in-flight work, rejecting new",
                 self.worker_id)
        self._draining.set()
        self._publish_stats()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def serve_obs(self, host: str = "127.0.0.1",
                  port: int = 0) -> Tuple[str, int]:
        """Start the observability sidecar (``GET /metrics``, ``GET
        /debug/requests?n=K``, ``GET /health``, ``POST /drain``) on a
        daemon thread; returns its (host, port). The serve loop never
        touches it: scrapes read the registry the loop writes, and
        ``/drain`` sets the event the loop polls."""
        self._obs_server = ObsServer(self.metrics, self.traces,
                                     host=host, port=port)
        # the drain control of rolling restarts: on the sidecar, as the
        # worker itself is a queue consumer with no HTTP surface
        self._obs_server.http.route(
            "POST", "/drain",
            lambda _m, _b, _h: (self.drain() or
                                (200, {"ok": True, "draining": True})))
        host, port = self._obs_server.start()
        self._obs_port = port
        return host, port

    def stop_obs(self) -> None:
        if self._obs_server is not None:
            self._obs_server.stop()
            self._obs_server = None

    #: loop iterations between stats publications to the hub
    STATS_EVERY = 50
    #: how long published counters stay trustworthy (the predictor reads
    #: an uptime_s that has not advanced for this long as a dead worker)
    STALE_AFTER_S = 60.0

    def _publish_stats(self) -> None:
        """Push this worker's counters to the hub, every key the
        predictor reads: draining, role, liveness (uptime_s,
        stale_after_s), the engine's counters as engine_*, the TTFT /
        e2e / queue-wait quantiles and the windowed per-class p95s."""
        stats = self.stats.snapshot()
        stats["role"] = self.role
        stats["draining"] = self._draining.is_set()
        stats["published_at"] = time.time()
        stats["uptime_s"] = time.monotonic() - self._boot_mono
        stats["stale_after_s"] = self.STALE_AFTER_S
        stats["kernel_launches"] = kernel_launches()
        if self._obs_port:
            stats["obs_port"] = self._obs_port  # where /metrics lives
        if self.engine is not None:
            snap = self.engine.stats_snapshot()
            stats.update({f"engine_{k}": v for k, v in snap.items()})
            stats["ttft_p50_s"] = self._h_ttft.quantile(0.50)
            stats["ttft_p95_s"] = self._h_ttft.quantile(0.95)
            stats["e2e_p50_s"] = self._h_e2e.quantile(0.50)
            stats["e2e_p95_s"] = self._h_e2e.quantile(0.95)
            stats["queue_p95_s"] = self._h_queue.quantile(0.95)
            with self._slo_win_lock:
                for c in SLO_CLASSES:
                    stats[f"slo_{c}_ttft_p95_s"] = _window_p95(
                        self._slo_ttft_win[c])
                    stats[f"slo_{c}_e2e_p95_s"] = _window_p95(
                        self._slo_e2e_win[c])
        try:
            self.hub.put_worker_stats(self.worker_id, stats)
        except Exception:  # noqa: BLE001 — observability must never
            log.debug("stats publish failed", exc_info=True)  # kill the loop

    def _engine_span(self, event: str, rid: Any, attrs: dict) -> None:
        """Decode-engine lifecycle hook: spans into the trace ring, and
        the queued → admitted / first token / done durations into the
        latency histograms and per-class windows. Runs on the serve-loop
        thread; unknown ids (the warmup dummy) are ignored."""
        entry = self._req_obs.get(rid)
        if entry is None:
            return
        tid, t_queued, slo = entry
        now = time.monotonic()
        if event == "admitted":
            if not attrs.get("resumed"):
                # a preempt-resume re-admission is not queue wait: the gap
                # since submit includes the victim's own generation time
                self._h_queue.observe(now - t_queued)
            self.traces.add_span(tid, "admitted", worker=self.worker_id,
                                 **attrs)
        elif event == "first_token":
            self._h_ttft.observe(now - t_queued)
            h = self._h_ttft_slo.get(slo)
            if h is not None:
                h.observe(now - t_queued)
                with self._slo_win_lock:
                    self._slo_ttft_win[slo].append((now,
                                                    now - t_queued))
            self.traces.add_span(tid, "first_token")
        elif event == "done":
            dt = now - t_queued
            self._h_e2e.observe(dt)
            h = self._h_e2e_slo.get(slo)
            if h is not None:
                h.observe(dt)
                with self._slo_win_lock:
                    self._slo_e2e_win[slo].append((now, dt))
            tokens = attrs.get("tokens") or 0
            if tokens and dt > 0:
                self._h_tps.observe(tokens / dt)
            self.traces.add_span(tid, "done", **attrs)
            self._req_obs.pop(rid, None)
        else:
            # incl. `preempted`: the span joins the timeline and the id
            # stays, since the victim resumes under it
            self.traces.add_span(tid, event, **attrs)

    def _count_dropped(self, n: int) -> None:
        if n <= 0:
            return
        total = self.stats.inc("dropped_expired", n)
        # the first drop and then every 100th: enough to diagnose skew
        if total == n or total % 100 < n:
            log.warning(
                "%s dropped %d expired quer%s (%d total) — if the "
                "predictor only reports timeouts, check clock skew "
                "between predictor and worker hosts",
                self.worker_id, n, "y" if n == 1 else "ies", total)

    def _reject_expired(self, m: dict) -> None:
        """Answer a past-deadline query with a structured ``expired``
        rejection (the predictor records a skipped vote or fails a
        stream over at once) instead of a silent drop."""
        self._count_dropped(1)
        if "id" not in m:
            return
        tid = str(m.get("trace_id") or "")
        if tid:
            self.traces.start(tid, request_id=str(m.get("id") or ""),
                              span="expired", worker=self.worker_id)
        self.hub.push_prediction(m["id"], pack_message(
            {"id": m["id"], "worker_id": self.worker_id,
             "predictions": [], "expired": True,
             "error": "query expired in transit "
                      "(deadline exceeded before pop)"}))

    def _handle_control(self, m: dict) -> None:
        """Control messages ride the query queue (``{"control":
        "drain"}``)."""
        cmd = str(m.get("control") or "")
        if cmd == "drain":
            self.drain()
        else:
            log.warning("%s ignoring unknown control message %r",
                        self.worker_id, cmd)

    def _reject_draining(self, m: dict) -> None:
        """Answer a message popped while draining with an immediate
        structured rejection the predictor fails over on."""
        if "id" not in m:
            return
        self.stats.inc("drain_rejected")
        tid = str(m.get("trace_id") or "")
        if tid:
            self.traces.start(tid, request_id=str(m.get("id") or ""),
                              span="drain_rejected",
                              worker=self.worker_id)
        self.hub.push_prediction(m["id"], pack_message(
            {"id": m["id"], "worker_id": self.worker_id,
             "predictions": [], "error": "worker draining",
             "draining": True}))

    def _drain_reject_queued(self) -> None:
        """Flush the query queue with drain rejections (non-blocking)."""
        raw = self.hub.pop_query(self.worker_id, 0.0)
        while raw is not None:
            m = unpack_message(raw)
            if not m.get("control"):
                self._reject_draining(m)
            raw = self.hub.pop_query(self.worker_id, 0.0)

    #: ceiling on the pause between hub retries while the data plane is
    #: down
    HUB_OUTAGE_PAUSE_S = 0.5

    def _hub_outage_pause(self, err: Exception,
                          poll_timeout: float) -> None:
        """The hub is unreachable past the client's reconnect window:
        pause the serve loop (in-flight engine state stays seated) and
        retry, with ``data_plane_down`` at 1."""
        pause = min(self.HUB_OUTAGE_PAUSE_S, max(poll_timeout, 0.05))
        if not self._dp_down:
            self._dp_down = True
            self.stats.set("data_plane_down", 1)
            self.stats.inc("hub_outages")
            log.warning("%s: data plane unreachable (%s) — serve loop "
                        "paused (retrying every %.1fs)", self.worker_id,
                        err, pause)
        self._stop.wait(pause)

    def _hub_ok(self) -> None:
        """A hub op reached the server again: clear the outage flag."""
        if self._dp_down:
            self._dp_down = False
            self.stats.set("data_plane_down", 0)
            log.warning("%s: data plane reachable again — serve loop "
                        "resumed", self.worker_id)
            self._publish_stats()

    # ---- the loop ----
    def run(self, poll_timeout: float = 0.5,
            max_iterations: Optional[int] = None) -> None:
        if self.role == "prefill":
            # prefill is throughput work, decode latency work: on a shared
            # host the prompt chew must not preempt a decode loop's step,
            # so this serve thread runs niced (Linux niceness is per
            # thread; pid 0 = this thread). Best-effort.
            try:
                os.setpriority(os.PRIO_PROCESS, 0, 10)
            except (AttributeError, OSError):
                pass
        if self.engine is not None:
            return self._run_decode_loop(poll_timeout, max_iterations)
        n = 0
        while not self._stop.is_set():
            if max_iterations is not None and n >= max_iterations:
                break
            n += 1
            if n % self.STATS_EVERY == 1:  # incl. the first iteration
                self._publish_stats()
            try:
                if self._draining.is_set():
                    # the micro-batcher holds nothing between iterations
                    self._drain_reject_queued()
                    break
                first = self.hub.pop_query(self.worker_id, poll_timeout)
                self._hub_ok()
                if first is None:
                    continue
                messages = [unpack_message(first)]
                while len(messages) < self.max_batch_msgs:
                    more = self.hub.pop_query(self.worker_id, 0.0)
                    if more is None:
                        break
                    messages.append(unpack_message(more))
                serve = []
                for m in messages:
                    if m.get("control"):
                        self._handle_control(m)
                    else:
                        serve.append(m)
                live = []
                for m in serve:
                    if _expired(m, skew_est=self._skew):
                        self._reject_expired(m)
                    else:
                        live.append(m)
                if live:
                    # messages popped alongside a drain preceded it
                    self._serve_batch(live)
            except ConnectionError as e:
                self._hub_outage_pause(e, poll_timeout)
        self._publish_stats()  # final counters visible after stop

    def _run_decode_loop(self, poll_timeout: float,
                         max_iterations: Optional[int]) -> None:
        """Continuous batching: admit queued messages into engine slots
        between steps; reply per message once all its queries finish.
        A hub outage pauses the loop with every in-flight request kept."""
        inflight: dict = {}  # message id -> [n_pending, {qi: text}]
        streaming: set = set()  # message ids that asked for deltas
        state = {"n": 0}
        while not self._stop.is_set():
            try:
                self._decode_serve(inflight, streaming, state,
                                   poll_timeout, max_iterations)
                break  # served to completion (stop/drain/iterations)
            except ConnectionError as e:
                self._hub_outage_pause(e, poll_timeout)
        if self.chaos_killed:
            return  # injected sudden death: no final publish either
        self._publish_stats()

    def _decode_serve(self, inflight: dict, streaming: set,
                      state: dict, poll_timeout: float,
                      max_iterations: Optional[int]) -> None:
        """One loop iteration = (drain the queue, admit, one engine step,
        stream deltas, harvest). While the engine is busy the queue pop
        is non-blocking, so decoding never waits on an empty queue."""
        while not self._stop.is_set():
            n = state["n"]
            if max_iterations is not None and n >= max_iterations:
                break
            n = state["n"] = n + 1
            if n % self.STATS_EVERY == 1:
                self._publish_stats()
            # held shipped-KV requests count as busy: the loop keeps
            # pumping the shipment queue instead of parking on an empty
            # query queue while a blob is in flight
            busy = self.engine.busy or bool(self._pending_kv)
            raw = self.hub.pop_query(self.worker_id,
                                     0.0 if busy else poll_timeout)
            self._hub_ok()
            while raw is not None:
                m = unpack_message(raw)
                if m.get("control"):
                    self._handle_control(m)
                elif self._draining.is_set():
                    self._reject_draining(m)
                elif _expired(m, skew_est=self._skew):
                    self._reject_expired(m)
                elif m.get("prefill_for"):
                    # a disaggregated request's prefill leg: run the
                    # prompt, ship the KV to the decode worker the payload
                    # names; never replied to (the decode leg's local
                    # re-prefill covers every failure here)
                    self._handle_prefill_leg(m)
                elif m.get("kv_from") and self._can_import_kv():
                    # the decode leg: a prefill worker is computing this
                    # prompt's KV; hold admission for up to kv_wait_s
                    self._kv_seen_traffic = True
                    self._pending_kv[m["id"]] = [
                        m, time.monotonic() + self.kv_wait_s, {},
                        time.monotonic()]
                else:
                    if m.get("kv_from"):
                        # not held (kv_wait_s 0), but a prefill worker will
                        # push blobs for it: keep draining them
                        self._kv_seen_traffic = True
                    self._admit_decode_message(m, inflight, streaming)
                raw = self.hub.pop_query(self.worker_id, 0.0)
            self._pump_kv_shipments(inflight, streaming)
            if self.engine.busy:
                try:
                    t_step = time.monotonic()
                    n_live = self.engine.step()
                    self._h_step.observe(time.monotonic() - t_step)
                    self._h_occupancy.observe(n_live)
                except Exception:
                    err = traceback.format_exc()
                    for mid in list(inflight):
                        self.hub.push_prediction(mid, pack_message(
                            {"id": mid, "worker_id": self.worker_id,
                             "predictions": [], "error": err}))
                        del inflight[mid]
                    streaming.clear()
                    for tid, _t, _slo in list(self._req_obs.values()):
                        self.traces.add_span(tid, "preempted",
                                             error="engine step failed")
                    self._req_obs.clear()
                    # drop every occupant and rebuild the cache, or the
                    # loop spins on a broken engine
                    self.engine.reset()
                    continue
                if self.chaos is not None and self.chaos.should_kill(
                        int(self.engine.stats.get("tokens_generated",
                                                  0) or 0)):
                    # injected sudden death: leave WITHOUT replying,
                    # streaming or publishing, as a killed process looks
                    # to the rest of the stack (the step that crossed the
                    # threshold never gets its tokens out)
                    log.warning("%s chaos-killed after %s generated "
                                "tokens", self.worker_id,
                                self.chaos.cfg.kill_after_tokens)
                    self.chaos_killed = True
                    return
                if streaming:
                    # per-message delta events between steps, ahead of
                    # the final predictions message (FIFO per query id)
                    deltas: dict = {}
                    for (mid, qi), delta in self.engine.poll_partial():
                        if mid in streaming:
                            deltas.setdefault(mid, {})[str(qi)] = delta
                    for mid, d in deltas.items():
                        self.hub.push_prediction(mid, pack_message(
                            {"id": mid, "worker_id": self.worker_id,
                             "delta": d}))
            for (mid, qi), text in self.engine.poll():
                entry = inflight.get(mid)
                if entry is None:
                    continue
                entry[1][qi] = text
                if len(entry[1]) >= entry[0]:
                    preds = [entry[1].get(i) for i in range(entry[0])]
                    self.hub.push_prediction(mid, pack_message(
                        {"id": mid, "worker_id": self.worker_id,
                         "predictions": preds}))
                    for i in range(entry[0]):
                        self._req_obs.pop((mid, i), None)
                    del inflight[mid]
                    streaming.discard(mid)
            self._ship_finished_prefill()
            if self._draining.is_set() and not inflight \
                    and not self._pending_kv and not self.engine.busy:
                break  # drain complete: every in-flight stream answered

    # ---- disaggregated prefill/decode (see serving/kv_transfer.py) ----
    def _can_import_kv(self) -> bool:
        """May this worker hold a request for a KV shipment? Any engine
        that ships KV (a unified worker gains the same way when the
        router disaggregated); a zero wait window disables holding."""
        return (self.kv_wait_s > 0
                and getattr(self.engine, "supports_kv_ship", False))

    def _handle_prefill_leg(self, m: dict) -> None:
        """Run a disaggregated request's prefill leg: submit each query
        prefill-only and remember where its blob ships. Fire-and-forget:
        on any local failure the decode worker's wait window expires and
        it re-prefills, so this path logs and never replies."""
        ship_to = str(m.get("prefill_for") or "")
        sub = getattr(self.engine, "submit_prefill", None)
        if not ship_to or sub is None or self._draining.is_set() \
                or _expired(m, skew_est=self._skew):
            return
        qs = m.get("queries")
        qs = list(qs) if not isinstance(qs, (list, tuple)) else qs
        samp = _safe_sampling(m.get("sampling"))
        tid = str(m.get("trace_id") or "") or mint_trace_id()
        try:
            slo = normalize_slo(m.get("slo"), default=self.default_slo)
        except ValueError:
            slo = self.default_slo
        kwargs = {"slo": slo}
        if samp.get("adapter_id"):
            # the KV is a function of the adapter; the decode side
            # validates the blob against the request's
            kwargs["adapter_id"] = samp["adapter_id"]
        self.traces.start(tid, request_id=str(m.get("id") or ""),
                          span="prefill_leg", worker=self.worker_id,
                          ship_to=ship_to, n_queries=len(qs))
        try:
            for qi, text in enumerate(qs):
                sub((m["id"], qi), str(text), **kwargs)
        except ValueError as e:
            log.warning("%s prefill leg rejected (%s); decode worker will "
                        "re-prefill locally", self.worker_id, e)
            return
        self._kv_outbox[m["id"]] = [ship_to, tid, len(qs),
                                    time.monotonic() + _KV_OUTBOX_TTL_S]

    def _ship_finished_prefill(self) -> None:
        """Forward completed prefill-only blobs to their decode workers;
        one no-op call on a worker without prefill traffic."""
        poll = getattr(self.engine, "poll_kv", None)
        if poll is None:
            return
        for (mid, qi), blob in poll():
            entry = self._kv_outbox.get(mid)
            if entry is None:
                continue
            ship_to, tid = entry[0], entry[1]
            entry[2] -= 1  # shipped or failed, this query is settled
            if entry[2] <= 0:
                del self._kv_outbox[mid]
            try:
                self.hub.push_kv(ship_to, pack_message(
                    {"id": mid, "qi": int(qi), "blob": blob,
                     "from": self.worker_id}))
                self.stats.inc("kv_ships_sent")
                self.traces.add_span(tid, "kv_shipped", qi=int(qi),
                                     nbytes=int(blob.get("nbytes", 0) or 0))
            except Exception:  # noqa: BLE001 — a failed shipment is the
                # decode side's local re-prefill, not this worker's crash
                log.warning("%s KV shipment to %s failed", self.worker_id,
                            ship_to, exc_info=True)
        if self._kv_outbox:
            # legs whose slots never produce a blob must not accumulate;
            # their decode side re-prefilled long ago
            now = time.monotonic()
            for mid in [k for k, e in self._kv_outbox.items()
                        if now > e[3]]:
                del self._kv_outbox[mid]

    def _kv_stage_budget_ok(self) -> bool:
        """Upload an arriving blob ahead of admission only when it will
        install soon: with the admission queue backed up, staged blobs
        would sit on the card for their whole wait. An unstaged blob
        installs from its host bytes at seat time."""
        if len(self._pending_kv) > 4:
            return False
        st = self.engine.stats
        return not any(st.get(f"queued_{c}", 0)
                       for c in ("interactive", "batch", "background"))

    def _pump_kv_shipments(self, inflight: dict, streaming: set) -> None:
        """Decode-leg intake: drain arrived shipments into held requests,
        admit every request whose blobs are complete, and turn expired
        wait windows into local re-prefills. Once per loop iteration,
        non-blocking; free when nothing is held.

        Unlike the JAX worker's, a failed upload of an arrived blob to
        the card is not swallowed: it propagates out of the serve loop."""
        if not self._pending_kv and not self._kv_seen_traffic:
            return
        now = time.monotonic()
        raw = self.hub.pop_kv(self.worker_id, 0.0)
        while raw is not None:
            try:
                ship = unpack_message(raw)
                mid, qi = ship["id"], int(ship["qi"])
                blob = ship["blob"]
            except Exception:  # noqa: BLE001 — a torn shipment degrades
                # to a local re-prefill, never a serve-thread crash
                log.warning("%s discarding undecodable KV shipment",
                            self.worker_id, exc_info=True)
                blob = mid = qi = None
            if mid is not None and mid in self._pending_kv \
                    and blob is not None:
                stage = getattr(self.engine, "stage_kv_blob", None)
                if stage is not None and self._kv_stage_budget_ok():
                    # the upload starts now, overlapping the step in
                    # flight; admission installs it later. A failed
                    # upload hands back the host blob (the engine's
                    # fallback), which installs at seat time
                    blob = stage(blob)
                self._pending_kv[mid][2][qi] = blob
            raw = self.hub.pop_kv(self.worker_id, 0.0)
        for mid in list(self._pending_kv):
            m, deadline, blobs, t_queued = self._pending_kv[mid]
            qs = m.get("queries")
            n = len(qs) if isinstance(qs, (list, tuple)) else 1
            if len(blobs) >= n:
                del self._pending_kv[mid]
                self._admit_decode_message(m, inflight, streaming,
                                           kv_blobs=blobs,
                                           t_queued=t_queued)
            elif now >= deadline or self._draining.is_set():
                # shipment late or lost (or draining): re-prefill locally
                del self._pending_kv[mid]
                self.stats.inc("kv_wait_timeouts")
                self._admit_decode_message(m, inflight, streaming,
                                           t_queued=t_queued)
        if self._pending_kv and not self.engine.busy:
            # nothing to decode while a blob is in flight: yield the CPU
            # briefly instead of spinning
            time.sleep(0.002)

    def _admit_decode_message(self, m: dict, inflight: dict,
                              streaming: set,
                              kv_blobs: Optional[Dict[int, Any]] = None,
                              t_queued: Optional[float] = None) -> None:
        """Submit one popped message's queries to the engine, each with
        its ``forced_prefix`` (a failover resume) when the message
        carries one, or its shipped KV blob (``kv_blobs``, by query
        index; a blob the engine refuses degrades that query to a local
        re-prefill, ``kv_import_fallbacks``). A request the engine
        refuses (``ValueError``: an unported adapter, a prompt larger
        than the page pool, a malformed class, a resume on an engine
        without ``supports_resume``) rejects the whole message with an
        error reply; the loop serves on."""
        qs = m["queries"]
        qs = list(qs) if not isinstance(qs, (list, tuple)) else qs
        if not qs:  # nothing will ever poll() for an empty message
            self.hub.push_prediction(m["id"], pack_message(
                {"id": m["id"], "worker_id": self.worker_id,
                 "predictions": []}))
            return
        tid = str(m.get("trace_id") or "") or mint_trace_id()
        if t_queued is None:
            t_queued = time.monotonic()
        self.traces.start(tid, request_id=str(m["id"]), span="queued",
                          worker=self.worker_id, n_queries=len(qs))
        samp = _safe_sampling(m.get("sampling"))
        try:
            slo = normalize_slo(m.get("slo"), default=self.default_slo)
        except ValueError:
            slo = self.default_slo
        if "max_new" in samp:
            # a client may not hold a slot longer than the operator's cap
            samp["max_new"] = min(samp["max_new"],
                                  getattr(self.engine, "max_new",
                                          samp["max_new"]))
        fp = m.get("forced_prefix")
        fp = fp if isinstance(fp, dict) else {}
        if fp:
            self.traces.add_span(tid, "resumed",
                                 prefix_chars=sum(len(str(v))
                                                  for v in fp.values()))
        try:
            if fp and not getattr(self.engine, "supports_resume", False):
                # checked before any submit, so no query of the message
                # leaks into the engine
                raise ValueError("engine does not support stream resume "
                                 "(forced_prefix)")
            for qi, text in enumerate(qs):
                kwargs = dict(samp)
                prefix = str(fp.get(str(qi), "") or "")
                if prefix:
                    kwargs["forced_prefix"] = prefix
                if getattr(self.engine, "supports_slo", False):
                    kwargs["slo"] = slo
                self._req_obs[(m["id"], qi)] = (tid, t_queued, slo)
                blob = None if kv_blobs is None else kv_blobs.get(qi)
                if blob is not None and not prefix:
                    try:
                        self.engine.submit((m["id"], qi), str(text),
                                           kv_blob=blob, **kwargs)
                        self.stats.inc("kv_imports_installed")
                        self.traces.add_span(tid, "kv_installed", qi=qi)
                        continue
                    except ValueError:
                        # a mismatched or corrupt shipment: this query
                        # re-prefills locally; a genuine submit error
                        # re-raises below and rejects the message
                        self.stats.inc("kv_import_fallbacks")
                self.engine.submit((m["id"], qi), str(text), **kwargs)
        except ValueError as e:
            for qi in range(len(qs)):
                self._req_obs.pop((m["id"], qi), None)
            self.traces.add_span(tid, "rejected", error=str(e))
            self.hub.push_prediction(m["id"], pack_message(
                {"id": m["id"], "worker_id": self.worker_id,
                 "predictions": [], "error": str(e)}))
        else:
            inflight[m["id"]] = [len(qs), {}]
            if m.get("stream"):
                streaming.add(m["id"])

    def _serve_batch(self, messages: List[dict]) -> None:
        """The micro-batcher: every message's queries through one
        ``predict``, the results split back per message."""
        t0 = time.monotonic()
        counts = []
        flat: List[Any] = []
        for m in messages:
            qs = m["queries"]
            qs = list(qs) if not isinstance(qs, (list, tuple)) else qs
            counts.append(len(qs))
            flat.extend(qs)
            tid = str(m.get("trace_id") or "")
            if tid:
                self.traces.start(tid, request_id=str(m.get("id") or ""),
                                  span="queued", worker=self.worker_id,
                                  n_queries=len(qs))
        try:
            preds = self.model.predict(flat)
            err = ""
        except Exception:
            preds = []
            err = traceback.format_exc()
        ofs = 0
        dt = time.monotonic() - t0
        for m, c in zip(messages, counts):
            chunk = preds[ofs:ofs + c] if not err else []
            ofs += c
            reply = {"id": m["id"], "worker_id": self.worker_id,
                     "predictions": _to_plain(chunk)}
            if err:
                reply["error"] = err
            self.hub.push_prediction(m["id"], pack_message(reply))
            self._h_e2e.observe(dt)
            tid = str(m.get("trace_id") or "")
            if tid:
                self.traces.add_span(
                    tid, "error" if err else "served",
                    latency_s=round(dt, 4))


def _window_p95(samples: "collections.deque",
                max_age_s: float = SLO_WINDOW_MAX_AGE_S) -> float:
    """Nearest-rank p95 over a bounded recent (timestamp, value) window,
    pruning entries older than ``max_age_s`` first. Empty → 0.0, which
    the brownout ladder reads as cooling."""
    cutoff = time.monotonic() - max_age_s
    while samples and samples[0][0] < cutoff:
        samples.popleft()
    if not samples:
        return 0.0
    vals = sorted(v for _t, v in samples)
    n = len(vals)
    return vals[max(0, min(n - 1, math.ceil(0.95 * n) - 1))]


def _safe_sampling(samp: Any) -> dict:
    """Client-supplied sampling params, coerced defensively: a malformed
    value degrades to the default, never raises inside the serve loop
    (one bad request must not be a denial of service)."""
    if not isinstance(samp, dict):
        samp = {}

    def num(key: str, cast, default):
        try:
            v = cast(samp.get(key, default))
        except (TypeError, ValueError, OverflowError):
            return default
        # NaN/inf would split host and device gates: finite or default
        return v if math.isfinite(v) else default

    out = {"temperature": num("temperature", float, 0.0),
           "top_k": num("top_k", int, 0),
           "top_p": num("top_p", float, 1.0),
           "seed": num("seed", int, 0)}
    eos = num("eos_id", int, None)
    if eos is not None and eos >= 0:
        out["eos_id"] = eos
    aid = num("adapter_id", int, 0)
    if aid:  # any non-default id, negatives included: the engine refuses
        out["adapter_id"] = aid
    mn = num("max_new", int, 0)
    if mn and mn > 0:
        out["max_new"] = mn
    return out


def _expired(msg: dict, skew_s: float = EXPIRY_SKEW_TOLERANCE_S,
             skew_est: Optional[ClockSkewEstimator] = None) -> bool:
    """Has the query's gather deadline passed? Preferred: the relative
    ``ttl_s`` + ``sent_ts`` pair judged through the skew estimator (pad
    ``TTL_EXPIRY_PAD_S``); fallback: the predictor's wall-clock
    ``deadline_ts`` on this host's clock, padded by ``skew_s``."""
    ttl = msg.get("ttl_s")
    sent = msg.get("sent_ts")
    if (skew_est is not None and ttl is not None and sent is not None
            and isinstance(ttl, (int, float))
            and isinstance(sent, (int, float))):
        return skew_est.elapsed_since(float(sent)) \
            > float(ttl) + TTL_EXPIRY_PAD_S
    ts = msg.get("deadline_ts")
    return ts is not None and time.time() > float(ts) + skew_s


#: the kernel wrappers whose launch counts the worker publishes
KERNEL_WRAPPERS = {
    "matmul_bias": _pe.matmul_bias,
    "flash_attention_fwd": _fa.flash_attention_fwd,
    "flash_attention_fwd_mh": _fa.flash_attention_fwd_mh,
    "flash_attention_bwd_dq": _fa.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": _fa.flash_attention_bwd_dkv,
    "paged_decode_attention": _pa.paged_decode_attention,
    "paged_window_attention": _pa.paged_window_attention,
}


def kernel_launches() -> Dict[str, int]:
    """This process's launch count of each kernel wrapper."""
    return {name: int(fn.launches) for name, fn in KERNEL_WRAPPERS.items()}


def _tristate(v: Any) -> Optional[bool]:
    """Config value → the ``paged_kernel`` tri-state: absent / blank /
    ``"auto"`` mean None; anything else is a bool."""
    if v is None:
        return None
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("", "auto"):
            return None
        return s in ("1", "true", "on", "yes")
    return bool(v)


def _to_plain(preds: List[Any]) -> List[Any]:
    """Predictions as plain lists/scalars (msgpack-safe)."""
    out = []
    for p in preds:
        if isinstance(p, np.ndarray):
            out.append(p.tolist())
        elif hasattr(p, "tolist"):
            out.append(np.asarray(p).tolist())
        else:
            out.append(p)
    return out


def main(argv: Optional[list] = None) -> int:
    """Service entry point: ``python -m rafiki_tpu_torch.worker.inference
    --config cfg.json``. The config is the JAX worker's JSON
    (``model_file``, ``model_class``, ``trial_id``, ``knobs``,
    ``param_store_uri``, ``kv_host``, ``kv_port``, ``worker_id``, the
    serving options, ``obs_host`` / ``obs_port`` / ``obs_port_file``)
    plus ``"device"`` (default: the CUDA card). The obs sidecar listens
    on ``obs_port`` (default: an ephemeral port), written to
    ``obs_port_file`` once the worker has booted."""
    import argparse
    import json

    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="JSON: {model_file, model_class, trial_id, "
                             "knobs, param_store_uri, kv_host, kv_port, "
                             "worker_id, device}")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    with open(cfg["model_file"], "rb") as f:
        model_class = load_model_class(f.read(), cfg["model_class"])
    worker = InferenceWorker(
        model_class=model_class, trial_id=cfg["trial_id"],
        knobs=cfg.get("knobs", {}),
        param_store=ParamStore.from_uri(cfg["param_store_uri"]),
        hub=KVQueueHub(cfg["kv_host"], int(cfg["kv_port"])),
        worker_id=cfg["worker_id"],
        decode_loop=bool(cfg.get("decode_loop")),
        max_slots=int(cfg.get("max_slots", 8)),
        steps_per_sync=int(cfg.get("steps_per_sync", 4)),
        max_new_tokens=int(cfg.get("max_new_tokens", 8)),
        speculate_k=int(cfg.get("speculate_k", 0)),
        system_prefix=str(cfg.get("system_prefix", "")),
        extra_adapter_trials=list(cfg.get("extra_adapter_trials") or []),
        draft_trial_id=str(cfg.get("draft_trial_id", "")),
        draft_knobs=cfg.get("draft_knobs"),
        kv_page_size=int(cfg.get("kv_page_size", 0)),
        kv_pages=int(cfg.get("kv_pages", 0)),
        paged_kernel=_tristate(cfg.get("paged_kernel")),
        default_slo=str(cfg.get("default_slo", "")),
        role=str(cfg.get("role", "")),
        host_kv_pages=int(cfg.get("host_kv_pages", 0)),
        kv_wait_s=float(cfg.get("kv_wait_s", 1.5)),
        pool_id=str(cfg.get("pool_id", "")),
        device=cfg.get("device"))
    # observability sidecar: /metrics, /debug/requests and /drain on
    # an ephemeral (or configured) port, written to obs_port_file
    obs_host, obs_port = worker.serve_obs(
        cfg.get("obs_host", "127.0.0.1"), int(cfg.get("obs_port", 0)))
    if cfg.get("obs_port_file"):
        with open(cfg["obs_port_file"], "w") as f:
            f.write(str(obs_port))
    print(f"inference worker {worker.worker_id} serving on "
          f"{worker.device} (obs on {obs_host}:{obs_port})", flush=True)
    try:
        worker.run()
    finally:
        worker.stop_obs()
        remove_port_file(cfg.get("obs_port_file"), obs_port)
    if worker.chaos_killed:
        # a chaos-killed worker must look ERRORED to the control plane
        # (a non-zero exit: the manager respawns it), not drained
        print(f"inference worker {worker.worker_id} chaos-killed",
              flush=True)
        return 31
    if worker.draining:
        print(f"inference worker {worker.worker_id} drained cleanly",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
