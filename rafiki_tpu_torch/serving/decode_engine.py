"""Continuous-batching decode engine for causal-LM serving.

Ports the core of ``rafiki_tpu/serving/decode_engine.py``:

- ``_Slot``, ``DecodeEngine`` (``__init__``, ``submit``, ``step``,
  ``poll``, ``poll_partial``, ``busy``, ``reset``, ``reset_stats``,
  ``stats_snapshot``) and ``TextDecodeEngine`` with stream resume
  (``supports_resume``, ``resume_sep``, ``submit(forced_prefix=)``: the
  delivered text is re-ingested as prompt and presented as output);
- the paged-KV allocator: a LIFO free list over pool pages
  ``1..n_pages-1`` (page 0 is the scratch page idle lanes write to),
  worst-case page reservation at admission (a request that does not fit
  waits, counted in ``admission_stalls``), lazy ``_ensure_pages_to``,
  ``_release_slot_pages``, and the live-width table slice
  (``_live_table_width``/``_ptab_arg``);
- ``_chunked_prefill`` with its narrow small-C call for short remainders;
- the request-lifecycle hook ``span_sink`` (``_span``,
  ``_mark_progress``): ``admitted``, ``prefill``, ``first_token``,
  ``decode_mark`` (every ``SPAN_DECODE_MARK_EVERY`` generated tokens) and
  ``done``, with the JAX engine's attributes at the JAX engine's points;
- SLO preemption: on a full engine a higher-class head evicts the
  youngest lowest-class, unshielded occupant (``_occupants``,
  ``_victim_for``, ``_evictable_for``, ``_res_of``, ``_resumed_from``,
  ``_preempt_slot``, ``_preempt_parked``), after a feasibility check
  that the evictions can end in its admission; the victim re-queues
  front-of-class with its tokens in ``_Slot.prior`` and resumes
  token-exact (``preempted`` span, ``resumed`` on the re-``admitted``
  one, the ``preemptions`` counter); an aged promotion is ``shielded``;
- the host KV page tier (``host_kv_pages > 0``, paged engines only;
  ``serving/kv_tier.py``): two-tier admission against device pages plus
  host pages (``_budget_pages``), and the policy — when the pool runs
  dry, ``_reclaim_one_hbm_page`` evicts parked slots' pages to the host
  (``_evict_parked_pages``) or parks a live victim first
  (``_park_victim``, ``_park_slot``, the ``_Parked`` record); parked
  slots resume in ``_unpark_order`` (``_try_unpark``, ``_seat_parked``,
  ``_apply_unpark_installs``) with their exact KV, no re-prefill, and
  ``_prefetch_hint`` stages the next one's pages ahead of time; the
  ``kv_host_pages_*``, ``kv_evictions_total``, ``kv_prefetch_*``,
  ``kv_transfer_bytes_total``, ``kv_parked_slots`` and
  ``kv_unparks_total`` counters and the ``parked`` / ``unparked`` spans.
  The gathers and installs of pages are ``index_select`` /
  ``index_copy_`` on the step thread's stream; the copies between the
  card and the pinned host pool run on the tier's side stream;
- disaggregated prefill/decode: prefill-only slots
  (``submit(prefill_only=True)``) stop at their last prompt token and
  ship their KV as a wire blob (``_harvest_prefill_only``,
  ``_extract_slot_kv``, ``poll_kv``, the ``prefilled`` span,
  ``kv_exports``); ``submit(kv_import=blob)`` validates a blob before
  any cache write and installs it at seat time (``_install_kv``,
  ``kv_imports``), and ``stage_kv_blob`` uploads a blob's leaves ahead
  of admission (best effort, as JAX's: a failed upload is logged and
  the host blob installs at seat time);
- ``_make_step`` → :func:`_decode_steps`: K decode steps as a Python
  loop with on-device input selection and ONE host sync (the emitted
  tokens) per call; argmax, or :func:`_select_next` (temperature,
  top-k/top-p, a threefry categorical keyed by (seed, position), bit for
  bit the JAX engine's draws) when a live slot samples;
- ``_make_prefill`` → :func:`_prefill`: one C-token cache pass that
  stops at the final norm (the (B, C, vocab) lm_head is never computed;
  XLA dead-code-eliminated it, eager PyTorch must not run it);
- multi-adapter serving (a module with ``n_adapters > 0``): the per-slot
  ``_aid`` operand of every step, prefill and verify call, and
  ``_check_adapter_id``;
- speculative decoding (``speculate_k >= 2``): prompt-lookup drafts
  (:func:`_ngram_draft`) or a draft model's greedy continuations
  (``draft=``, its own contiguous cache kept in step by the prefill,
  scan and verify mirrors, ``_resync_draft`` after a gated stretch),
  one verify call (:func:`_verify`, the JAX ``_make_verify``) over each
  slot's k-token window, the acceptance gate (``SPEC_*`` constants) and
  the spec margin of ``_pages_for``;
- registered prefixes (``register_prefix``; ``_install_prefix`` into
  rows or pages; the admission hit path, gated on the slot's adapter)
  and their wire form (``export_prefix`` / ``import_prefix``: the JAX
  engine's blob, a contiguous (1, plen, ...) snapshot with its leaves in
  ``jax.tree_util`` order). Where JAX computes a snapshot in one batch-1
  pass of a contiguous twin, the port runs the engine's own (B, C)
  prefill calls over it (``_prefix_snapshot``): a hit is then bit for
  bit a request prefilled without the prefix, in bf16 on the card too.

JAX compiles each program once and donates the cache; here the model
writes its cache tensors in place and runs eagerly. On a CUDA device a
paged engine's every decode call goes through the hand-written kernels
(``paged_decode_attention`` for the s == 1 steps,
``paged_window_attention`` for prefill and verify windows).

:class:`NotPorted` (a ``NotImplementedError`` that is also a
``ValueError``, so a serving worker answers such a request with an error
reply naming it and serves on) is kept for the options other modules
refuse by name (autoscale, chaos, ``PAGED_KERNEL=false``).
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.serving.kv_tier import HostPageTier
from rafiki_tpu_torch.serving.kv_transfer import (LAYOUT_PAGED, LAYOUT_ROWS,
                                                  cache_from_leaves,
                                                  cache_leaves, check_kv_blob,
                                                  dtype_name, leaf_signature,
                                                  make_kv_blob)
from rafiki_tpu_torch.serving.slo import (DEFAULT_SLO, ClassQueue,
                                          evictable_occupants,
                                          normalize_slo, preemption_victim,
                                          slo_priority)
from rafiki_tpu_torch.utils import threefry
from rafiki_tpu_torch.utils.device import (DeviceLike, resolve_device,
                                           same_device)


#: speculation break-even (tokens per verify call) of prompt-lookup
#: drafts, and of a draft model (which pays two extra forwards a verify
#: and a mirror a scan call); scan calls before a gated-off speculator
#: re-probes; the EMA decay of tokens per verify call
SPEC_MIN_TOKENS_PER_CALL = 1.5
SPEC_MIN_TOKENS_PER_CALL_DRAFT = 2.2
SPEC_REPROBE_CALLS = 32
SPEC_EMA_DECAY = 0.7


@dataclass
class _Slot:
    request_id: Any
    prompt: np.ndarray          # (p,) int32, valid tokens only
    max_new: int
    temperature: float = 0.0    # <= 0 → greedy
    top_k: int = 0              # <= 0 → no top-k cut
    top_p: float = 1.0          # >= 1 → no nucleus cut
    seed: int = 0               # with (position) → the sample's key
    eos_id: Optional[int] = None  # emitting this token ends the request
    adapter_id: int = 0         # multi-adapter engines: which fine-tune
    slo: str = DEFAULT_SLO      # admission class (interactive first)
    seq: int = 0                # arrival order; preemption evicts the
    #                             youngest lowest-class victim
    n_consumed: int = 0         # tokens fed to the model so far
    generated: List[int] = field(default_factory=list)
    #: tokens generated before a preemption: re-ingested as prompt on
    #: resume but still output, so poll/poll_partial present
    #: prior + generated
    prior: List[int] = field(default_factory=list)
    n_streamed: int = 0         # output tokens already poll_partial'd
    first_tokened: bool = False  # first_token span already emitted
    #: admitted by the aging promotion: immune to preemption (evicting
    #: it on the next interactive arrival would starve it again)
    shielded: bool = False
    #: disaggregated serving (prefill role): stop after chunked prefill
    #: and surface the slot's KV via ``poll_kv`` instead of generating
    prefill_only: bool = False
    #: disaggregated serving (decode role): a validated KV blob whose
    #: rows are installed at seat time, past the shipped prefill
    kv_import: Optional[Dict[str, Any]] = None


class _Parked:
    """A slot suspended to the host KV tier: its lane is free, its pages
    live wherever the allocator put them (per logical page: a pool page
    still on the card, or a host page), and the host mirrors needed to
    reseat it ride along. Parking loses no progress: unlike a preemption
    there is no re-prefill on resume; the restored pages are the KV the
    slot had."""

    __slots__ = ("slot", "pos", "tok", "stop_pos", "n_res", "pages",
                 "park_seq")

    def __init__(self, slot: _Slot, pos: int, tok: int, stop_pos: int,
                 n_res: int, pages: List[Tuple[str, int]],
                 park_seq: int) -> None:
        self.slot = slot
        self.pos = pos
        self.tok = tok
        self.stop_pos = stop_pos
        self.n_res = n_res
        self.pages = pages      # [("hbm", pool_page) | ("host", hp)]
        self.park_seq = park_seq

    def host_ids(self) -> List[int]:
        return [p for loc, p in self.pages if loc == "host"]

    def hbm_ids(self) -> List[int]:
        return [p for loc, p in self.pages if loc == "hbm"]


#: generated tokens between two ``decode_mark`` spans
SPAN_DECODE_MARK_EVERY = 32


class NotPorted(NotImplementedError, ValueError):
    """A request or option this slice of the port does not serve yet.
    A ``ValueError`` too: the worker's submit path answers it with an
    error reply instead of losing its serve thread."""


class DecodeEngine:
    """Slot-based continuous batching over one decode step program.

    ``steps_per_sync`` fuses K decode steps into one call with on-device
    input selection (next prompt token while prefilling, argmax feedback
    while generating); the host pays one sync per K tokens. Admission
    happens at call boundaries. Any K produces identical tokens.

    ``module`` is a port ``Llama`` (its ``kv_page_size``/``kv_pages``
    choose the cache layout, its ``n_adapters`` multi-adapter serving);
    ``device`` must be the module's device (None = the CUDA card,
    raising without one). ``speculate_k >= 2`` enables greedy
    speculation: each verify call checks ``speculate_k - 1`` drafted
    tokens plus the model's own next one in one window and emits 1..k
    tokens; drafts come from prompt lookup, or from ``draft`` (a
    contiguous-cache port ``Llama`` sharing the vocabulary; the JAX
    ``(module, params)`` pair is one module here). Every emitted token
    is the model's argmax given accepted history, so outputs are those
    of plain decoding; sampling slots fall back to the scan.

    ``host_kv_pages > 0`` (a paged module only) attaches the host KV page
    tier (``serving/kv_tier.py``): admission reserves against the pool's
    pages plus the host pages, and cold pages spill to host memory and
    come back ahead of the step that resumes them."""

    def __init__(self, module: Any, max_slots: int, max_len: int,
                 steps_per_sync: int = 4, prefill_chunk: int = 32,
                 speculate_k: int = 0,
                 draft: Optional[Tuple[Any, Any]] = None,
                 host_kv_pages: int = 0,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        if not same_device(self.device, module.device):
            raise ValueError(f"module lives on {module.device}, engine "
                             f"device is {self.device}")
        self.module = module
        self.B = int(max_slots)
        self.L = int(max_len)
        self.K = max(1, int(steps_per_sync))
        #: verify window width (0: no speculation)
        self.spec_k = 0 if int(speculate_k) < 2 else min(int(speculate_k),
                                                         self.L)
        #: scan calls since the last speculative attempt
        self._spec_idle = 0
        #: prompt tokens ingested per prefill call (1 disables prefill:
        #: prompts then stream token by token through the decode steps)
        self.C = max(1, min(int(prefill_chunk), self.L))
        #: short remainders take a narrow call instead of a C-wide one
        self._small_c = 4
        self._slots: List[Optional[_Slot]] = [None] * self.B
        #: class-aware admission queue; every touch happens under _lock
        self._cq = ClassQueue()
        self._seq = 0
        self._done: List[Tuple[Any, List[int]]] = []
        self._lock = threading.Lock()
        # host mirrors of the per-slot device inputs
        self._tok = np.zeros((self.B,), np.int32)
        self._pos = np.zeros((self.B,), np.int32)
        self._prompt_buf = np.zeros((self.B, self.L), np.int32)
        self._prompt_len = np.ones((self.B,), np.int32)
        self._stop_pos = np.zeros((self.B,), np.int32)
        # per-slot sampling parameters (device operands of sampled calls)
        self._temp = np.zeros((self.B,), np.float32)
        self._topk = np.zeros((self.B,), np.int32)
        self._topp = np.ones((self.B,), np.float32)
        self._seed = np.zeros((self.B,), np.int32)
        #: multi-adapter serving: each slot's adapter, a device operand
        self.n_adapters = int(getattr(module, "n_adapters", 0) or 0)
        self._aid = np.zeros((self.B,), np.int32)
        #: device copy of the prompts, refreshed only on admission
        self._prompt_dev: Optional[torch.Tensor] = None
        #: paged KV: host-owned page tables + free-list allocator over
        #: the module's pool. Pool page 0 is the SCRATCH page — idle
        #: lanes write their idempotent re-feeds there and no slot ever
        #: owns it, so a zeroed table row is always safe to step.
        self.page_size = int(getattr(module, "kv_page_size", 0) or 0)
        self.paged = self.page_size > 0
        if self.paged:
            if self.L % self.page_size:
                raise ValueError(f"kv_page_size {self.page_size} must "
                                 f"divide max_len {self.L}")
            self.n_pages = int(getattr(module, "kv_pages", 0) or 0)
            if self.n_pages < 2:
                raise ValueError("paged KV needs kv_pages >= 2 (scratch"
                                 " page + at least one usable page)")
            self._n_table = self.L // self.page_size
            #: LIFO free list; reservations guarantee pops never fail
            self._free_pages = list(range(self.n_pages - 1, 0, -1))
            self._n_alloc = np.zeros((self.B,), np.int32)
            #: worst-case pages reserved per slot at admission: the
            #: invariant sum(_n_res) <= usable pages makes lazy
            #: allocation infallible and queue waits deadlock-free
            self._n_res = np.zeros((self.B,), np.int32)
            self._res_total = 0
        else:
            self._n_table = 1
        #: the host KV page tier: the admission budget becomes pool pages
        #: plus host pages; whole slots park to make room for hotter work
        #: and their pages evict to a host pool, coming back (prefetched)
        #: ahead of the step that resumes them
        self.host_pages = int(host_kv_pages)
        if self.host_pages and not self.paged:
            raise ValueError("host_kv_pages requires a paged engine "
                             "(kv_page_size > 0): pages are the "
                             "tier's transfer unit")
        self.tier: Optional[HostPageTier] = None
        #: parked slots by a monotonic park key, insertion-ordered
        self._parked: Dict[int, _Parked] = {}
        self._park_seq = 0
        self._ptab = np.zeros((self.B, self._n_table), np.int32)
        self._ptab_dev: Optional[torch.Tensor] = None
        self._ptab_dev_width = 0
        self._ptab_dirty = True
        self._cache = module.init_cache(self.B)
        #: draft-model speculation: the draft's own contiguous cache,
        #: synced with the target's accepted history by construction
        #: (every prefill chunk, scan call and verify window is mirrored
        #: into it); a gated-off stretch skips the mirrors and the next
        #: probe rebuilds the cache (``_resync_draft``)
        self.draft_module = draft
        self._draft_cache: Optional[List[Dict[str, torch.Tensor]]] = None
        if draft is not None and self.spec_k:
            if not same_device(self.device, draft.device):
                raise ValueError(f"draft lives on {draft.device}, engine "
                                 f"device is {self.device}")
            if int(getattr(draft, "kv_page_size", 0) or 0):
                raise ValueError("the draft model keeps a contiguous "
                                 "cache (kv_page_size 0)")
            self._draft_cache = draft.init_cache(self.B)
        #: the acceptance gate's break-even floor and its EMA of tokens
        #: per verify call, seeded just above the floor
        self._spec_floor = (SPEC_MIN_TOKENS_PER_CALL_DRAFT
                            if self._draft_cache is not None
                            else SPEC_MIN_TOKENS_PER_CALL)
        self._spec_ema = self._spec_floor + 0.5
        self._draft_synced = True
        #: registered prefix per adapter: {"ids", "cache" (per-layer
        #: (1, plen, ...) tensors), "len", "aid"[, "draft_cache"]}
        self._prefixes: Dict[int, Dict[str, Any]] = {}
        self.stats = StatsMap({
            "steps": 0, "tokens_generated": 0, "requests_done": 0,
            "max_concurrent": 0, "prefill_calls": 0, "prefill_tokens": 0,
            "spec_calls": 0, "spec_drafted": 0, "spec_accepted": 0,
            "prefix_hits": 0, "prefix_tokens": 0,
            "spec_draft_model_calls": 0, "draft_resyncs": 0,
            "kv_imports": 0,
            # paged-KV pool gauges (0 on contiguous engines)
            "kv_pages_used": 0, "kv_pages_high_water": 0,
            "kv_pages_total": (self.n_pages - 1 if self.paged else 0),
            "admission_stalls": 0,
            # SLO plane: evictions of lower-class work so a higher
            # class could admit, and aging promotions
            "preemptions": 0, "slo_aged_promotions": 0,
            "queued_interactive": 0, "queued_batch": 0,
            "queued_background": 0,
            # the host KV tier (0 on untiered engines): host pool
            # occupancy, pages evicted to the host, prefetch hits and
            # misses (a miss uploads inline at the unpark), bytes moved
            # both ways, live parked slots and resumes
            "kv_host_pages_used": 0,
            "kv_host_pages_total": self.host_pages,
            "kv_evictions_total": 0, "kv_prefetch_hits": 0,
            "kv_prefetch_misses": 0, "kv_transfer_bytes_total": 0,
            "kv_parked_slots": 0, "kv_unparks_total": 0,
            # disaggregated prefill/decode: shipments produced here
            "kv_exports": 0})
        if self.host_pages:
            self.tier = HostPageTier(self.host_pages, self.stats,
                                     device=self.device)
        #: finished prefill-only shipments awaiting poll_kv
        self._done_kv: List[Tuple[Any, Dict[str, Any]]] = []
        #: optional request-lifecycle hook ``(event, request_id, attrs)``;
        #: the inference worker wires it into its traces and latency
        #: histograms. None costs one attribute read per emission site.
        self.span_sink: Optional[Callable[[str, Any, Dict[str, Any]],
                                          None]] = None

    # ---- submission / results (thread-safe: loop thread vs callers) ----
    def submit(self, request_id: Any, prompt_ids: np.ndarray,
               max_new: int, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0,
               eos_id: Optional[int] = None, adapter_id: int = 0,
               slo: str = "", prefill_only: bool = False,
               kv_import: Optional[Dict[str, Any]] = None) -> None:
        """Queue a request. ``prompt_ids``: 1-D valid tokens (>= 1);
        prompt + generation are truncated to fit the cache.
        ``temperature <= 0`` is greedy, which ignores ``top_k``, ``top_p``
        and ``seed``; otherwise top-k/top-p-filtered categorical sampling
        keyed by ``fold_in(fold_in(PRNGKey(0), seed), position)``, so a
        draw depends only on (seed, position), never on the batch.
        ``eos_id`` ends the request when emitted (the EOS is dropped from
        the reply). ``adapter_id`` (multi-adapter engines) picks the
        request's fine-tune; out-of-range ids raise ``ValueError``, and a
        single-adapter engine ignores the field. ``slo`` orders admission
        (interactive, batch, background), and a full engine preempts
        lower-class occupants for a higher-class head.

        ``prefill_only`` (the prefill role of disaggregated serving): the
        slot stops at its last prompt token and its KV comes out of
        :meth:`poll_kv` as a wire blob instead of generated tokens.
        ``kv_import`` (the decode role): such a blob, validated here
        (``ValueError`` on any mismatch, before the cache is touched) and
        installed when the request is seated, so its prompt walk resumes
        past the shipped positions."""
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        max_new = max(1, min(int(max_new), self.L - 1))
        prompt = prompt[:max(1, self.L - max_new)]
        aid = self._check_adapter_id(adapter_id)
        cls = normalize_slo(slo)
        if kv_import is not None:
            # validated on the caller's thread: a bad shipment is a
            # structured refusal the worker degrades on, never a shape
            # error on the step thread mid-install
            flat = cache_leaves(self._cache)
            cov = int(kv_import.get("covered", 0) or 0) \
                if isinstance(kv_import, dict) else 0
            if self.paged:
                sig = [[list(c.shape[1:]), dtype_name(c)] for c in flat]
                lead = ((cov - 1) // self.page_size + 1) if cov else 0
            else:  # rows layout: leaves are (covered, heads, dh)
                sig = [[list(c.shape[2:]), dtype_name(c)] for c in flat]
                lead = cov
            kv_import = check_kv_blob(
                kv_import, layout=LAYOUT_PAGED if self.paged
                else LAYOUT_ROWS, page_size=self.page_size,
                expect_sig=sig, expect_leading=lead,
                prompt_len=len(prompt), adapter_id=aid)
        if self.paged:
            # a request whose worst case exceeds what can ever be on the
            # card could never take a step: refuse it here instead of
            # stalling the queue forever (a host tier enlarges the
            # admission budget, not what one request can hold). Prefill-
            # only work stops at the last prompt token.
            need = self._pages_for(
                max(1, len(prompt) - 1) if prefill_only
                else min(len(prompt) - 1 + max_new, self.L))
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request needs {need} KV pages worst-case but the "
                    f"pool has {self.n_pages - 1} usable pages; raise "
                    "kv_pages or lower max_new/prompt length")
        with self._lock:
            self._seq += 1
            self._cq.push(cls, _Slot(
                request_id, prompt, max_new,
                temperature=float(temperature), top_k=int(top_k),
                top_p=float(top_p), seed=int(seed),
                eos_id=None if eos_id is None else int(eos_id),
                adapter_id=aid, slo=cls, seq=self._seq,
                prefill_only=bool(prefill_only), kv_import=kv_import))

    def _check_adapter_id(self, adapter_id: int) -> int:
        """A request's adapter, validated: an out-of-range id raises
        (serving another fine-tune would be a correct-looking wrong
        answer); single-adapter engines ignore the field."""
        if self.n_adapters <= 0:
            return 0
        aid = int(adapter_id)
        if not 0 <= aid < self.n_adapters:
            raise ValueError(f"adapter_id {aid} out of range for "
                             f"{self.n_adapters}-adapter engine")
        return aid

    def poll(self) -> List[Tuple[Any, List[int]]]:
        """Completed (request_id, generated ids) since the last poll."""
        with self._lock:
            done, self._done = self._done, []
        return done

    def poll_partial(self) -> List[Tuple[Any, List[int]]]:
        """(request_id, output-so-far) for still-live slots that
        produced new tokens since the last call: cumulative copies, not
        deltas, of ``prior + generated`` (a preempt-resumed request
        streams its whole output, never re-emitting the re-ingested
        tokens). Call from the thread that drives ``step``."""
        out: List[Tuple[Any, List[int]]] = []
        for slot in self._slots:
            if slot is None:
                continue
            total = len(slot.prior) + len(slot.generated)
            if total > slot.n_streamed:
                out.append((slot.request_id,
                            slot.prior + list(slot.generated)))
                slot.n_streamed = total
        return out

    @property
    def busy(self) -> bool:
        with self._lock:
            return bool(self._cq) or bool(self._parked) \
                or any(s is not None for s in self._slots)

    def _span(self, event: str, request_id: Any, **attrs: Any) -> None:
        """Emit a lifecycle event to the wired sink. A sink that raises
        is logged and detached: observability never kills the step
        loop."""
        sink = self.span_sink
        if sink is None:
            return
        try:
            sink(event, request_id, attrs)
        except Exception:  # noqa: BLE001 — see the docstring
            logging.getLogger(__name__).warning(
                "span sink failed on %s", event, exc_info=True)
            self.span_sink = None

    def _mark_progress(self, slot: _Slot, n0: int, n1: int) -> None:
        """first_token / periodic decode_mark spans for a slot that grew
        from ``n0`` to ``n1`` generated tokens this call."""
        if self.span_sink is None:
            return
        if not slot.first_tokened:
            # a flag, not n0 == 0: a preempt-resumed slot restarts its
            # generated list but its stream already first-tokened
            slot.first_tokened = True
            self._span("first_token", slot.request_id)
        if n0 // SPAN_DECODE_MARK_EVERY != n1 // SPAN_DECODE_MARK_EVERY:
            self._span("decode_mark", slot.request_id, tokens=n1)

    def reset_stats(self) -> None:
        """Zero the served-traffic counters, keeping the pool gauges."""
        keep = {"kv_host_pages_total": self.host_pages}
        if self.paged:
            keep.update(kv_pages_total=self.n_pages - 1,
                        kv_pages_used=(self.n_pages - 1
                                       - len(self._free_pages)))
        if self.tier is not None:
            keep.update(
                kv_host_pages_used=(self.host_pages
                                    - self.tier.free_pages()),
                kv_parked_slots=len(self._parked))
        self.stats.reset(keep=keep)

    def stats_snapshot(self) -> Dict[str, int]:
        """A point-in-time copy of the counters, taken under the stats
        lock."""
        return self.stats.snapshot()

    def close(self) -> None:
        """Stop the host tier's transfer thread (its pool is freed with
        the engine). Idempotent; an engine without a tier holds nothing
        that needs closing."""
        if self.tier is not None:
            self.tier.close()

    def reset(self) -> None:
        """Drop all occupants and zero the cache (error recovery)."""
        with self._lock:
            self._slots = [None] * self.B
            self._cq.clear()
            self._done.clear()
            self._tok[:] = 0
            self._pos[:] = 0
            self._prompt_buf[:] = 0
            self._prompt_len[:] = 1
            self._stop_pos[:] = 0
            self._temp[:] = 0
            self._topk[:] = 0
            self._topp[:] = 1
            self._seed[:] = 0
            self._aid[:] = 0
            self._prompt_dev = None
            self._spec_ema = self._spec_floor + 0.5
            self._spec_idle = 0
            self._draft_synced = True
            self._parked.clear()
            self._done_kv.clear()
            if self.tier is not None:
                self.tier.reset()
            self.stats.set("kv_parked_slots", 0)
            if self.paged:
                self._free_pages = list(range(self.n_pages - 1, 0, -1))
                self._ptab[:] = 0
                self._n_alloc[:] = 0
                self._n_res[:] = 0
                self._res_total = 0
                self._ptab_dirty = True
                self.stats.set("kv_pages_used", 0)
        self._cache = self.module.init_cache(self.B)
        if self._draft_cache is not None:
            self._draft_cache = self.draft_module.init_cache(self.B)

    # ---- registered prefixes (not concurrent with step) ----
    def _snapshot_module(self) -> Any:
        """The layout of a prefix snapshot: a contiguous twin over the
        same weights (a (1, plen, ...) row snapshot is the install
        source and the wire form on either layout)."""
        return self.module.with_kv_layout(0, 0) if self.paged \
            else self.module

    def _prefix_snapshot(self, module: Any, prefix: np.ndarray, aid: int,
                         paged: bool) -> List[Dict[str, torch.Tensor]]:
        """The KV of ``prefix`` through ``module`` as this engine's own
        chunked prefill computes it: (B, C) calls over C-token chunks from
        position 0, the prefix in row 0 and the other rows idle, on a
        scratch cache of the engine's layout (a pool of the prefix's
        pages behind a page table of the live width the engine would
        pass). Every call then has the shapes of the engine's prefill
        calls and row 0 the arithmetic of a slot prefilling the prefix:
        a hit's rows are the bits a request without the prefix computes
        for the same positions, on the card in bf16 too (a batch-1,
        plen-wide pass rounds differently). Returns (1, plen, ...)
        tensors per layer."""
        plen, w = len(prefix), self.C if self.C > 1 else len(prefix)
        page = self.page_size if paged else 0
        n_pg = (plen - 1) // page + 1 if paged else 0
        twin = module.with_kv_layout(page, 1 + n_pg) if paged else module
        cache = twin.init_cache(self.B)
        table = np.zeros((self.B, max(1, n_pg)), np.int32)
        table[0, :n_pg] = np.arange(1, n_pg + 1)
        aid_dev = (self._dev(np.full((self.B,), aid, np.int32), torch.int32)
                   if int(getattr(module, "n_adapters", 0) or 0) else None)
        for c0 in range(0, plen, w):
            n = min(w, plen - c0)
            tok = np.zeros((self.B, w), np.int32)
            pos = np.zeros((self.B, w), np.int32)
            tok[0, :n] = prefix[c0:c0 + n]
            pos[0, :n] = np.arange(c0, c0 + n)
            tok[0, n:], pos[0, n:] = tok[0, n - 1], pos[0, n - 1]
            ptab = None
            if paged:
                width = 1
                while width < (c0 + n - 1) // page + 1:
                    width *= 2
                ptab = self._dev(table[:, :min(width, self._n_table)],
                                 torch.int32)
            _prefill(twin, cache, self._dev(tok, torch.int64),
                     self._dev(pos, torch.int32), ptab, aid_dev)
        if not paged:
            return [{name: t[:1, :plen].clone() for name, t in layer.items()}
                    for layer in cache]
        pos = np.arange(plen)
        pg = self._dev(table[0, pos // page], torch.int64)
        off = self._dev(pos % page, torch.int64)
        return [{name: t[pg, off][None] for name, t in layer.items()}
                for layer in cache]

    def register_prefix(self, prefix_ids: np.ndarray,
                        adapter_id: int = 0) -> int:
        """Precompute the KV of a shared prompt prefix (a system prompt):
        a later request whose prompt strictly extends it skips its
        prefill, admission copying the snapshot's rows into the slot's
        cache (:meth:`_prefix_snapshot`; on a paged engine the prefill
        runs through the paged kernels). One prefix per adapter (its KV
        is a function of the adapter); re-register to replace, empty ids
        to clear. Returns the registered length (at most ``max_len -
        2``). Not concurrent with ``step``."""
        aid = self._check_adapter_id(adapter_id)
        prefix = np.asarray(prefix_ids, np.int32).ravel()[:self.L - 2]
        if len(prefix) == 0:
            self._prefixes.pop(aid, None)
            return 0
        entry = {"ids": prefix, "len": len(prefix), "aid": aid,
                 "cache": self._prefix_snapshot(self.module, prefix, aid,
                                                self.paged)}
        if self.tier is not None:
            # a tiered engine keeps its snapshots in host memory, uploaded
            # per install: the capacity trade the page tier makes
            entry["cache"] = [{n: t.cpu() for n, t in layer.items()}
                              for layer in entry["cache"]]
        if self._draft_cache is not None:
            # the draft attends the same positions: without its own
            # snapshot a hit slot would draft over zero KV
            entry["draft_cache"] = self._prefix_snapshot(
                self.draft_module, prefix, aid, False)
        self._prefixes[aid] = entry
        return len(prefix)

    def _install_prefix(self, rows: List[int], pre: Dict[str, Any]) -> None:
        """Copy prefix ``pre``'s KV into the given slots: their rows, or
        on a paged engine their pages (mapped at admission) through the
        page table; int8-KV scale leaves come along. The draft cache,
        always contiguous, takes the row copy."""
        plen = pre["len"]
        rws = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        if self.paged:
            pos = np.arange(plen)
            pg = self._ptab[np.asarray(rows, np.int64)][:, pos //
                                                        self.page_size]
            idx0 = self._dev(pg, torch.int64)
            idx1 = self._dev(pos % self.page_size, torch.int64)
            for layer, snap in zip(self._cache, pre["cache"]):
                for name, c in layer.items():
                    vals = snap[name][0].to(c.device, c.dtype)
                    c.index_put_((idx0, idx1[None, :].expand_as(idx0)),
                                 vals[None].expand(
                                     (len(rows),) + tuple(vals.shape)))
        else:
            _install_rows(self._cache, pre["cache"], rws, plen)
        if self._draft_cache is not None and "draft_cache" in pre:
            _install_rows(self._draft_cache, pre["draft_cache"], rws, plen)
        self.stats.inc("prefix_hits", len(rows))
        self.stats.inc("prefix_tokens", plen * len(rows))

    def export_prefix(self, adapter_id: int = 0
                      ) -> Optional[Dict[str, Any]]:
        """The registered prefix snapshot as the JAX engine's wire blob
        (``v``, ``ids``, ``len``, ``adapter_id``, ``sig``, ``leaves``,
        ``nbytes``), its leaves in ``jax.tree_util`` order on the host:
        numpy arrays, bf16 ones as CPU torch tensors (the param-store
        codec writes them as ``bfloat16``). None when no prefix is
        registered for the adapter."""
        pre = self._prefixes.get(self._check_adapter_id(adapter_id))
        if pre is None:
            return None
        leaves = [t.cpu() if t.dtype == torch.bfloat16 else t.cpu().numpy()
                  for t in cache_leaves(pre["cache"])]
        return {"v": 1, "ids": np.asarray(pre["ids"], np.int32),
                "len": int(pre["len"]), "adapter_id": int(pre["aid"]),
                "sig": leaf_signature(leaves), "leaves": leaves,
                "nbytes": int(sum(t.numel() * t.element_size()
                                  if isinstance(t, torch.Tensor)
                                  else t.nbytes for t in leaves))}

    def import_prefix(self, blob: Dict[str, Any],
                      adapter_id: int = 0) -> int:
        """Install a peer's exported prefix snapshot (the JAX engine's or
        this one's) without recomputing its prefill. The geometry is
        checked before any state changes, raising ``ValueError`` on a
        mismatch. A draft-model engine keeps no draft rows for it (still
        lossless: acceptance starts cold). Returns the installed length.
        Not concurrent with ``step``."""
        aid = self._check_adapter_id(adapter_id)
        if not isinstance(blob, dict) or int(blob.get("v", -1)) != 1:
            raise ValueError("not a prefix snapshot blob")
        ids = np.asarray(blob.get("ids"), np.int32).ravel()
        plen = int(blob.get("len", -1))
        if plen != len(ids) or not 0 < plen <= self.L - 2:
            raise ValueError(
                f"prefix blob length {plen} does not fit this engine "
                f"(1..{self.L - 2} tokens)")
        like = self._snapshot_module().init_cache(1, device="meta")
        flat = cache_leaves(like)
        leaves = list(blob.get("leaves") or [])
        if len(leaves) != len(flat) or any(
                tuple(v.shape[:2]) != (1, plen)
                or tuple(v.shape[2:]) != tuple(c.shape[2:])
                or dtype_name(v) != dtype_name(c)
                for v, c in zip(leaves, flat)):
            raise ValueError(
                "prefix blob does not match this engine's cache "
                "geometry (model shape / dtype / int8 mismatch)")
        tensors = [(v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v))).to(
                        "cpu" if self.tier is not None else self.device)
                   for v in leaves]
        self._prefixes[aid] = {"ids": ids, "len": plen, "aid": aid,
                               "cache": cache_from_leaves(tensors, like)}
        self.stats.inc("kv_imports")
        return plen

    # ---- disaggregated prefill/decode (KV shipment) ----
    def poll_kv(self) -> List[Tuple[Any, Dict[str, Any]]]:
        """Completed prefill-only shipments since the last call:
        ``(request_id, KV blob)`` pairs ready to ride the hub to a
        decode-role engine's ``submit(..., kv_import=blob)``."""
        with self._lock:
            done, self._done_kv = self._done_kv, []
        return done

    def _harvest_prefill_only(self) -> None:
        """Complete the prefill-only slots whose prompt walk reached its
        last token: extract the shipment, free the lane and its pages.
        Costs one scan of the lanes when no prefill-role traffic
        exists."""
        shipped: List[Tuple[Any, Dict[str, Any]]] = []
        for i in range(self.B):
            s = self._slots[i]
            if s is None or not s.prefill_only:
                continue
            if int(self._pos[i]) >= len(s.prompt) - 1:
                shipped.append((s.request_id, self._extract_slot_kv(i)))
                self._slots[i] = None
                self._tok[i] = 0
                self._pos[i] = 0
                self._prompt_len[i] = 1
                self._stop_pos[i] = 0
                if self.paged:
                    self._release_slot_pages(i)
        if shipped:
            with self._lock:
                self._done_kv.extend(shipped)
                self.stats.inc("requests_done", len(shipped))
            for rid, blob in shipped:
                self._span("prefilled", rid, covered=blob["covered"])

    def _extract_slot_kv(self, i: int) -> Dict[str, Any]:
        """Slot ``i``'s prefilled KV as a wire blob: the pages (paged) or
        rows (contiguous) covering positions ``0..pos-1``, every cache
        leaf alike (int8 pools with their scale rows), in
        ``jax.tree_util`` order. The one host sync of the prefill role
        (the JAX engine's one sanctioned sync outside the tier thread):
        every leaf is copied into pinned host memory asynchronously, then
        the stream is synchronized once."""
        s = self._slots[i]
        covered = max(0, min(int(self._pos[i]), len(s.prompt) - 1))
        leaves: List[Any] = []
        if covered:
            flat = cache_leaves(self._cache)
            if self.paged:
                n = (covered - 1) // self.page_size + 1
                idx = self._dev_async(self._ptab[i, :n], torch.int64)
                dev = [c.index_select(0, idx) for c in flat]
            else:
                dev = [c[i, :covered] for c in flat]
            leaves = _to_host(dev)
        self.stats.inc("kv_exports")
        return make_kv_blob(
            covered, LAYOUT_PAGED if self.paged else LAYOUT_ROWS,
            self.page_size, leaves, adapter_id=s.adapter_id)

    def stage_kv_blob(self, blob: Dict[str, Any]) -> Dict[str, Any]:
        """Upload a shipment's leaves to the device ahead of admission
        (call when the blob arrives off the wire, on the thread that
        drives ``step``): each leaf is pinned on the host and copied
        asynchronously, so the seat-time install pays only the copy into
        the pool. Best effort, as JAX's: a failed upload is logged and
        the host blob is returned, to install at seat time. A sticky
        CUDA error (one that every later call on the device repeats)
        then raises from that install and ends the caller's loop."""
        try:
            staged = dict(blob)
            staged["leaves"] = [self._upload(a) for a in blob["leaves"]]
            return staged
        except Exception:  # noqa: BLE001 — staging is an overlap, never
            # a correctness gate: the host blob installs fine, later
            logging.getLogger(__name__).warning(
                "KV blob staging failed; the host blob installs at seat "
                "time", exc_info=True)
            return blob

    def _upload(self, a: Any) -> torch.Tensor:
        """A blob leaf (numpy array or host tensor) on this engine's
        device; pinned and copied without a host sync on a CUDA device."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        if self.device.type == "cuda" and not t.is_cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _install_kv(self, i: int, blob: Dict[str, Any]) -> None:
        """Write a shipped blob's pages or rows into slot ``i``'s pages or
        rows (validated at submit; pages mapped at seat time): an
        ``index_copy_`` of the shipped pages per leaf, on the step
        thread's stream."""
        cov = int(blob["covered"])
        flat = cache_leaves(self._cache)
        vals = [self._upload(v).to(c.dtype)
                for v, c in zip(blob["leaves"], flat)]
        if self.paged:
            n = (cov - 1) // self.page_size + 1
            idx = self._dev_async(self._ptab[i, :n], torch.int64)
            for c, v in zip(flat, vals):
                c.index_copy_(0, idx, v)
        else:
            for c, v in zip(flat, vals):
                c[i, :cov] = v
        self.stats.inc("kv_imports")
        self.stats.inc("kv_transfer_bytes_total",
                       int(blob.get("nbytes", 0) or 0))

    # ---- paged-KV allocator (step thread only, except reservations,
    # ---- which share the admission lock) ----
    def _pages_for(self, stop_pos: int) -> int:
        """Worst-case pages a request can touch: the scan writes
        positions <= stop_pos - 1, and a verify window up to
        ``spec_k - 1`` past it (clamped to the cache). Reserved at
        admission, so lazy allocation never fails."""
        h = min(stop_pos - 1 + (self.spec_k - 1 if self.spec_k else 0),
                self.L - 1)
        return h // self.page_size + 1

    @property
    def _budget_pages(self) -> int:
        """The two-tier admission budget: usable pool pages plus the host
        tier's. Reservations are granted against this total; a pool
        shortfall is resolved by evicting cold pages to the host
        (:meth:`_reclaim_one_hbm_page`), which the invariant
        sum(reservations) <= budget proves always possible while growth
        inside a reservation is pending."""
        return self.n_pages - 1 + self.host_pages

    def _ensure_pages_to(self, i: int, last_pos: int,
                         have_lock: bool = False) -> None:
        """Allocate slot ``i``'s logical pages covering positions
        ``[0, last_pos]`` — called before every call with that call's
        write horizon (a slot holds pages for where it is, not for
        max_len). Infallible inside the slot's reservation: with a host
        tier an empty free list evicts cold pages (parked slots' first,
        else a freshly parked victim's) until the growth fits."""
        need = last_pos // self.page_size + 1
        grew = need > int(self._n_alloc[i])
        while int(self._n_alloc[i]) < need:
            if not self._free_pages:
                # only reachable on tiered engines (the untiered invariant
                # keeps the free list ahead of the reservations)
                self._reclaim_one_hbm_page(protect=i, have_lock=have_lock)
            self._ptab[i, int(self._n_alloc[i])] = self._free_pages.pop()
            self._n_alloc[i] += 1
        if grew:
            self._ptab_dirty = True
            used = self.n_pages - 1 - len(self._free_pages)
            self.stats.set("kv_pages_used", used)
            self.stats.max_set("kv_pages_high_water", used)

    # ---- the host tier's policy (step thread; the tier's transfer
    # ---- thread touches only its own pool and staging state) ----
    def _reclaim_one_hbm_page(self, protect: int,
                              have_lock: bool = False) -> None:
        """Free at least one pool page by evicting a cold page to the host
        tier: parked slots' pages still on the card first (nothing steps
        them), else park a live victim (never ``protect``) and evict from
        it. Raises only on an allocator-invariant breach (a bug)."""
        if self.tier is None:
            raise RuntimeError(
                "paged-KV allocator invariant breached: free list "
                "empty inside reservation and no host tier to spill "
                "to")
        if self._evict_parked_pages(limit=1, exclude_key=None):
            return
        j = self._park_victim(protect)
        if j is None:
            raise RuntimeError(
                "paged-KV allocator invariant breached: no free page, "
                "no parked cold page, and no parkable victim")
        self._park_slot(j, have_lock=have_lock)
        if not self._evict_parked_pages(limit=1, exclude_key=None):
            raise RuntimeError(
                "paged-KV allocator invariant breached: host tier "
                "full while within-reservation growth is pending")

    def _evict_parked_pages(self, limit: int,
                            exclude_key: Optional[int]) -> int:
        """Move up to ``limit`` on-card pages of parked slots to the host
        tier, freeing their pool pages, from the lowest-priority /
        youngest parked slot first (the work least likely to resume
        next). Returns the pages moved. The gather runs here, on the step
        thread's stream, before any later call can write the freed pages;
        the copy to the host runs on the tier's side stream."""
        moved = 0
        order = sorted(
            (k for k in self._parked if k != exclude_key),
            key=lambda k: (slo_priority(self._parked[k].slot.slo),
                           self._parked[k].slot.seq),
            reverse=True)
        for k in order:
            if moved >= limit:
                break
            rec = self._parked[k]
            hbm = [(t, p) for t, (loc, p) in enumerate(rec.pages)
                   if loc == "hbm"]
            if not hbm:
                continue
            # tail pages first: partial restores then refill in logical
            # order
            take = hbm[-(limit - moved):]
            host_ids = self.tier.alloc(len(take))
            if host_ids is None:
                if self.tier.free_pages() == 0:
                    break
                host_ids = self.tier.alloc(self.tier.free_pages())
                take = take[-len(host_ids):]
            pool_ids = [p for _t, p in take]
            idx = self._dev_async(np.asarray(pool_ids, np.int64),
                                  torch.int64)
            leaves = [c.index_select(0, idx)
                      for c in cache_leaves(self._cache)]
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            self.tier.evict_submit(host_ids, leaves, ready)
            # a staging for the old id set is stale now; the prefetcher
            # re-stages the grown set
            self.tier.drop_staged(k)
            for (t, _p), h in zip(take, host_ids):
                rec.pages[t] = ("host", int(h))
            self._free_pages.extend(pool_ids)
            self._ptab_dirty = True
            moved += len(take)
        if moved:
            self.stats.set("kv_pages_used",
                           self.n_pages - 1 - len(self._free_pages))
        return moved

    def _park_victim(self, protect: int) -> Optional[int]:
        """The live slot to suspend when the pool must shrink: lowest
        class, youngest (the preemption order), across classes and
        shields, since parking loses no progress."""
        cands = [j for j in range(self.B)
                 if j != protect and self._slots[j] is not None]
        if not cands:
            return None
        return max(cands, key=lambda j: (
            slo_priority(self._slots[j].slo), self._slots[j].seq))

    def _park_slot(self, j: int, have_lock: bool = False) -> None:
        """Suspend live slot ``j``: lane freed, host mirrors captured,
        pages kept (all on the card at first; eviction moves them to the
        host on demand). Its reservation stays counted (the slot is still
        admitted work)."""
        slot = self._slots[j]
        n = int(self._n_alloc[j])
        self._park_seq += 1
        rec = _Parked(slot, pos=int(self._pos[j]), tok=int(self._tok[j]),
                      stop_pos=int(self._stop_pos[j]),
                      n_res=int(self._n_res[j]),
                      pages=[("hbm", int(self._ptab[j, t]))
                             for t in range(n)],
                      park_seq=self._park_seq)
        self._slots[j] = None
        self._tok[j] = 0
        self._pos[j] = 0
        self._prompt_len[j] = 1
        self._stop_pos[j] = 0
        self._ptab[j, :] = 0
        self._n_alloc[j] = 0
        self._ptab_dirty = True
        if have_lock:
            self._n_res[j] = 0
        else:
            with self._lock:
                self._n_res[j] = 0
        self._parked[rec.park_seq] = rec
        if self._draft_cache is not None:
            # the draft cache's lane no longer mirrors this slot; the next
            # speculative probe rebuilds it from the accepted contexts
            self._draft_synced = False
        self.stats.set("kv_parked_slots", len(self._parked))
        self._span("parked", slot.request_id, slot=j, pages=len(rec.pages))

    def _unpark_order(self) -> List[int]:
        """Resume order: highest class first, then oldest arrival (the
        inverse of the eviction order, so restoring and evicting work
        opposite ends of the parked set and the page-by-page exchange
        converges)."""
        return sorted(self._parked,
                      key=lambda k: (slo_priority(self._parked[k].slot.slo),
                                     self._parked[k].slot.seq))

    def _try_unpark(self) -> Tuple[List[Tuple[int, _Parked, List[int],
                                              List[int], Any]], int]:
        """Admission-phase resume pass (lock held): restore parked slots'
        host pages into freshly allocated pool pages as capacity allows,
        and seat fully restored parked slots into free lanes. Returns
        ``(installs, slots seated)``; the installs ``(lane, rec,
        pool_ids, host_ids, staged)`` are applied at once, still under the
        lock (a later seat in the same admission pass may evict these
        very pages again, and must evict their content)."""
        installs: List[Tuple[int, _Parked, List[int], List[int], Any]] = []
        seated = 0
        for k in self._unpark_order():
            rec = self._parked[k]
            host = [(t, p) for t, (loc, p) in enumerate(rec.pages)
                    if loc == "host"]
            if host:
                fill = min(len(self._free_pages), len(host))
                if fill < len(host):
                    # not wholly restorable yet: pull what fits (head
                    # pages first) and try again next step
                    if fill == 0:
                        continue
                    host = host[:fill]
                pool_ids = [self._free_pages.pop() for _ in host]
                host_ids = [p for _t, p in host]
                staged = None
                if self.tier is not None and fill == len(rec.host_ids()):
                    staged = self.tier.take_staged(k, host_ids)
                for (t, _p), pid in zip(host, pool_ids):
                    rec.pages[t] = ("hbm", int(pid))
                installs.append((-1, rec, pool_ids, host_ids, staged))
                self.stats.set("kv_pages_used",
                               self.n_pages - 1 - len(self._free_pages))
            if rec.host_ids():
                continue  # still partly on the host
            i = next((j for j in range(self.B) if self._slots[j] is None),
                     None)
            if i is None:
                continue  # wholly on the card, waiting for a lane
            self._seat_parked(i, k, rec)
            seated += 1
        return installs, seated

    def _seat_parked(self, i: int, key: int, rec: _Parked) -> None:
        """Reseat a wholly restored parked slot into lane ``i`` (lock
        held): mirrors restored, page table rebuilt, reservation moved
        back onto the lane. No re-prefill."""
        slot = rec.slot
        self._slots[i] = slot
        self._tok[i] = rec.tok
        self._pos[i] = rec.pos
        self._prompt_buf[i, :] = 0
        self._prompt_buf[i, :len(slot.prompt)] = slot.prompt
        self._prompt_len[i] = len(slot.prompt)
        self._stop_pos[i] = rec.stop_pos
        self._temp[i] = slot.temperature
        self._topk[i] = slot.top_k
        self._topp[i] = slot.top_p
        self._seed[i] = np.int32(slot.seed & 0x7FFFFFFF)
        self._aid[i] = slot.adapter_id
        for t, (loc, p) in enumerate(rec.pages):
            assert loc == "hbm"
            self._ptab[i, t] = p
        self._n_alloc[i] = len(rec.pages)
        self._n_res[i] = rec.n_res
        self._ptab_dirty = True
        del self._parked[key]
        if self.tier is not None:
            self.tier.drop_staged(key)
        self.stats.set("kv_parked_slots", len(self._parked))
        self.stats.inc("kv_unparks_total")

    def _apply_unpark_installs(self, installs) -> None:
        """Copy restored pages' content into the pool before any call
        reads them. A prefetch hit takes the tensors the tier staged on
        the device (marked as used by this stream, since they were
        allocated on the tier's); a miss uploads from the host pool
        inline, after :meth:`HostPageTier.fetch` has waited out pending
        evictions of those pages."""
        cur = (torch.cuda.current_stream(self.device)
               if self.device.type == "cuda" else None)
        for _lane, rec, pool_ids, host_ids, staged in installs:
            if staged is None:
                self.stats.inc("kv_prefetch_misses")
                staged = self.tier.fetch(host_ids, device=self.device)
                self.stats.inc("kv_transfer_bytes_total", int(sum(
                    a.numel() * a.element_size() for a in staged)))
            else:
                self.stats.inc("kv_prefetch_hits")
                if cur is not None:
                    for v in staged:
                        v.record_stream(cur)
            idx = self._dev_async(np.asarray(pool_ids, np.int64),
                                  torch.int64)
            for c, v in zip(cache_leaves(self._cache), staged):
                c.index_copy_(0, idx, v.to(c.dtype))
            self.tier.free(host_ids)
            self._span("unparked", rec.slot.request_id, pages=len(pool_ids))

    def _prefetch_hint(self) -> None:
        """Tell the tier which parked slot resumes next, so its host pages
        are staged on the device before the unpark needs them."""
        if self.tier is None or not self._parked:
            return
        for k in self._unpark_order():
            ids = self._parked[k].host_ids()
            if ids:
                self.tier.prefetch_submit(k, ids)
                return

    def _release_slot_pages(self, i: int, have_lock: bool = False
                            ) -> None:
        """Return slot ``i``'s pages and reservation to the pool (request
        completed or preempted); its table row points back at the
        scratch page. ``have_lock``: preemption calls this from the
        admission loop, which holds ``_lock`` (not reentrant)."""
        n = int(self._n_alloc[i])
        if n:
            self._free_pages.extend(int(p) for p in self._ptab[i, :n])
            self._ptab[i, :n] = 0
            self._n_alloc[i] = 0
            self._ptab_dirty = True
        if have_lock:
            self._res_total -= int(self._n_res[i])
            self._n_res[i] = 0
        else:
            with self._lock:
                self._res_total -= int(self._n_res[i])
                self._n_res[i] = 0
        self.stats.set("kv_pages_used",
                       self.n_pages - 1 - len(self._free_pages))

    def _live_table_width(self) -> int:
        """Table columns the next call needs: every slot's allocated
        pages, rounded up to a power of two. Slicing the operand bounds
        the plain version's gather by live pages; the kernels read only
        live pages either way."""
        hi = max(1, int(self._n_alloc.max()))
        w = 1
        while w < hi:
            w *= 2
        return min(w, self._n_table)

    def _ptab_arg(self) -> Optional[torch.Tensor]:
        """The page-table operand (None on contiguous engines),
        re-uploaded only when allocation changed it or its live width
        moved."""
        if not self.paged:
            return None
        width = self._live_table_width()
        if self._ptab_dirty or width != self._ptab_dev_width:
            self._ptab_dev = torch.from_numpy(
                np.ascontiguousarray(self._ptab[:, :width])).to(self.device)
            self._ptab_dev_width = width
            self._ptab_dirty = False
        return self._ptab_dev

    def _dev(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _dev_async(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """:meth:`_dev` without a host sync on a CUDA device: the array is
        copied into pinned memory and uploaded asynchronously (the tier's
        and the shipments' index operands)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _aid_arg(self) -> Optional[torch.Tensor]:
        """The per-slot adapter operand (None on single-adapter
        engines)."""
        return (self._dev(self._aid, torch.int32) if self.n_adapters
                else None)

    # ---- the loop body ----
    def _chunked_prefill(self) -> None:
        """Ingest admitted prompts C tokens per call before they join the
        decode steps (positions 0..plen-2; the steps then start at the
        last prompt token, whose step emits the first generated token).
        Slots not prefilling re-feed their current input at their current
        position — an identical rewrite — so one call serves any mix."""
        occupied = np.array([s is not None for s in self._slots], bool)
        while True:
            rem = np.where(occupied,
                           np.maximum(0, (self._prompt_len - 1)
                                      - self._pos), 0)
            if rem.max() == 0:
                break
            c_use = self.C
            # short remainders take the narrow call; a draft engine stays
            # wide, as JAX compiles its draft mirror at C only
            if (self.C > self._small_c and self._draft_cache is None
                    and rem.max() <= self._small_c):
                c_use = self._small_c
            adv = np.minimum(rem, c_use)
            tok_chunk = np.empty((self.B, c_use), np.int32)
            pos_chunk = np.empty((self.B, c_use), np.int32)
            for i in range(self.B):
                a = int(adv[i])
                if a > 0:
                    p0 = int(self._pos[i])
                    tok_chunk[i, :a] = self._prompt_buf[i, p0:p0 + a]
                    pos_chunk[i, :a] = np.arange(p0, p0 + a)
                    # overhang repeats the chunk's last real entry: an
                    # identical rewrite, and positions stay nondecreasing
                    tok_chunk[i, a:] = tok_chunk[i, a - 1]
                    pos_chunk[i, a:] = pos_chunk[i, a - 1]
                else:
                    tok_chunk[i, :] = self._tok[i]
                    pos_chunk[i, :] = self._pos[i]
            if self.paged:
                # each chunk maps only the pages it writes. On a tiered
                # engine an earlier lane's growth may park this one inside
                # this loop (its row zeroed, its pos reset): allocating
                # for the emptied lane would leak the pages
                for i in range(self.B):
                    if adv[i] > 0 and self._slots[i] is not None:
                        self._ensure_pages_to(
                            i, int(self._pos[i]) + int(adv[i]) - 1)
            tok_dev = self._dev(tok_chunk, torch.int64)
            pos_dev = self._dev(pos_chunk, torch.int32)
            aid_dev = self._aid_arg()
            _prefill(self.module, self._cache, tok_dev, pos_dev,
                     self._ptab_arg(), aid_dev)
            if self._draft_cache is not None and self._draft_synced:
                # the draft's KV follows the prompt walk (while desynced,
                # the resync rebuilds prompts anyway)
                _prefill(self.draft_module, self._draft_cache, tok_dev,
                         pos_dev, None, None)
            self.stats.inc("prefill_calls")
            self.stats.inc("prefill_tokens", int(adv.sum()))
            for i in range(self.B):
                if adv[i] > 0 and self._slots[i] is not None:
                    # a lane parked mid-chunk skips the advance: its
                    # record saved the pre-chunk position, so the resume
                    # re-prefills this chunk (whose writes went to the
                    # scratch page: its table row was zeroed at park)
                    self._pos[i] += int(adv[i])
                    self._slots[i].n_consumed += int(adv[i])
                    self._tok[i] = self._prompt_buf[i, int(self._pos[i])]

    # ---- SLO preemption (lock held: admission-loop context) ----
    def _occupants(self, live_only: bool = False
                   ) -> List[Tuple[Any, str, int, bool]]:
        """Admitted work as the ``(handle, slo, seq, shielded)`` tuples
        the shared eviction policy consumes. Handles are ``("live",
        lane)`` for seated slots and ``("parked", key)`` for slots
        suspended to the host tier (they hold reservations and pages
        too, so a higher-class head may reclaim them the same way)."""
        occ: List[Tuple[Any, str, int, bool]] = [
            (("live", j), s.slo, s.seq, s.shielded)
            for j, s in enumerate(self._slots) if s is not None]
        if not live_only:
            occ.extend((("parked", k), r.slot.slo, r.slot.seq,
                        r.slot.shielded) for k, r in self._parked.items())
        return occ

    def _victim_for(self, cls: str, live_only: bool = False
                    ) -> Optional[Any]:
        """The occupant to evict so a ``cls`` head can admit
        (:func:`preemption_victim`: youngest lowest-class, shielded
        immune). ``live_only``: a lane can only come from a seated
        slot."""
        return preemption_victim(cls, self._occupants(live_only))

    def _evictable_for(self, cls: str, live_only: bool = False
                       ) -> List[Any]:
        """Every occupant :meth:`_victim_for` could return for a ``cls``
        head. The feasibility check sums their reservations before any
        eviction: a preemption that cannot end in the head admitting
        would destroy the victims' progress for nothing."""
        return [h for h, _s, _q in
                evictable_occupants(cls, self._occupants(live_only))]

    def _res_of(self, handle: Any) -> int:
        kind, ref = handle
        if kind == "live":
            return int(self._n_res[ref])
        return int(self._parked[ref].n_res)

    def _preempt_handle(self, handle: Any, by: str
                        ) -> Tuple[Any, int, int, str, str]:
        kind, ref = handle
        if kind == "live":
            return self._preempt_slot(ref, by)
        return self._preempt_parked(ref, by)

    def _preempt_parked(self, key: int, by: str
                        ) -> Tuple[Any, int, int, str, str]:
        """Evict a parked occupant, the cheapest victim: nothing is
        seated, so its pool pages, host pages and reservation free now,
        and it re-queues front-of-class like a live victim."""
        rec = self._parked.pop(key)
        slot = rec.slot
        hbm = rec.hbm_ids()
        if hbm:
            self._free_pages.extend(hbm)
            self._ptab_dirty = True
        host = rec.host_ids()
        if host and self.tier is not None:
            self.tier.free(host)
        if self.tier is not None:
            self.tier.drop_staged(key)
        self._res_total -= rec.n_res
        self._cq.push(slot.slo, self._resumed_from(slot), front=True)
        self.stats.inc("preemptions")
        self.stats.set("kv_parked_slots", len(self._parked))
        self.stats.set("kv_pages_used",
                       self.n_pages - 1 - len(self._free_pages))
        return (slot.request_id, -1, len(slot.generated), slot.slo, by)

    def _resumed_from(self, slot: _Slot) -> _Slot:
        """The front-of-class re-queued request a victim becomes: its
        prompt plus everything generated so far, so re-admission
        re-ingests them through chunked prefill at the same absolute
        positions (token-exact: a greedy token depends only on the
        history, a sampled one on (seed, position))."""
        gen = list(slot.generated)
        prompt = (np.concatenate([slot.prompt, np.asarray(gen, np.int32)])
                  if gen else slot.prompt)
        resumed = _Slot(slot.request_id, prompt, slot.max_new - len(gen),
                        temperature=slot.temperature, top_k=slot.top_k,
                        top_p=slot.top_p, seed=slot.seed,
                        eos_id=slot.eos_id, adapter_id=slot.adapter_id,
                        slo=slot.slo, seq=slot.seq,
                        prior=slot.prior + gen,
                        prefill_only=slot.prefill_only)
        resumed.n_streamed = slot.n_streamed
        resumed.first_tokened = slot.first_tokened
        resumed.shielded = slot.shielded
        return resumed

    def _preempt_slot(self, j: int, by: str
                      ) -> Tuple[Any, int, int, str, str]:
        """Evict slot ``j`` mid-generation so a ``by``-class admission
        fits: its pages and reservation return to the pool now, and it
        re-queues front-of-class as :meth:`_resumed_from`. Returns the
        ``preempted`` span record."""
        slot = self._slots[j]
        n_gen = len(slot.generated)
        resumed = self._resumed_from(slot)
        self._slots[j] = None
        self._tok[j] = 0
        self._pos[j] = 0  # a fresh occupant restarts at position 0
        self._prompt_len[j] = 1
        self._stop_pos[j] = 0
        if self.paged:
            self._release_slot_pages(j, have_lock=True)
        self._cq.push(resumed.slo, resumed, front=True)
        self.stats.inc("preemptions")
        return (slot.request_id, j, n_gen, slot.slo, by)

    def _seat_slot(self, i: int, slot: _Slot) -> None:
        """Install a popped request into free slot ``i`` (lock held):
        host mirrors, a shipped blob's fast-forward (disaggregated
        decode) or the shared-prefix fast-forward when the prompt
        strictly extends the prefix registered for its adapter (a
        preempt-resumed slot re-matches), first pages, then the content
        install into them. The install happens here, right after the
        lane's pages are mapped: on a tiered engine a later seat in the
        same admission pass may park this lane and evict its pages, and
        must evict their content."""
        self._slots[i] = slot
        self._tok[i] = slot.prompt[0]
        self._pos[i] = 0
        self._prompt_buf[i, :] = 0
        self._prompt_buf[i, :len(slot.prompt)] = slot.prompt
        self._prompt_len[i] = len(slot.prompt)
        pre = self._prefixes.get(slot.adapter_id)
        install: Optional[Tuple[str, Any]] = None
        if slot.kv_import is not None and int(slot.kv_import["covered"]) > 0:
            # a prefill-role worker computed positions 0..covered-1: the
            # shipped rows land in this slot's pages below and the prompt
            # walk resumes past them (the prefix-hit shape, from the wire)
            cov = int(slot.kv_import["covered"])
            self._pos[i] = cov
            slot.n_consumed = cov
            self._tok[i] = slot.prompt[cov]
            install = ("kv", slot.kv_import)
            # installed once; a preempt-resume re-ingests by prefill
            slot.kv_import = None
        elif pre is not None and (len(slot.prompt) > pre["len"]
                                  and np.array_equal(
                                      slot.prompt[:pre["len"]],
                                      pre["ids"])):
            # the KV copy makes positions 0..plen-1 as if prefilled; the
            # prompt walk resumes at plen
            install = ("prefix", pre)
            self._pos[i] = pre["len"]
            slot.n_consumed = pre["len"]
            self._tok[i] = slot.prompt[pre["len"]]
        if slot.prefill_only:
            # prefill role: stop at the last prompt token, where the
            # decode leg starts; the KV ships via poll_kv
            self._stop_pos[i] = max(0, len(slot.prompt) - 1)
        else:
            # finish once pos reaches plen - 1 + max_new (the step at
            # input position p emits a generated token iff p >= plen - 1)
            self._stop_pos[i] = min(len(slot.prompt) - 1 + slot.max_new,
                                    self.L)
        self._temp[i] = slot.temperature
        self._topk[i] = slot.top_k
        self._topp[i] = slot.top_p
        self._seed[i] = np.int32(slot.seed & 0x7FFFFFFF)
        self._aid[i] = slot.adapter_id
        if self.paged:
            # position 0, or the whole prefix / shipped span
            self._ensure_pages_to(i, int(self._pos[i]), have_lock=True)
        if install is not None:
            kind, payload = install
            if kind == "kv":
                self._install_kv(i, payload)
            else:
                self._install_prefix([i], payload)

    def step(self) -> int:
        """Resume parked slots, admit queued requests into free slots
        (preempting lower-class occupants for a higher-class head when
        the engine is full), run K decode steps for every live slot,
        harvest completions. Returns the live count."""
        admitted_info: List[Tuple[Any, int, int, str, bool]] = []
        preempted_info: List[Tuple[Any, int, int, str, str]] = []
        with self._lock:
            # parked slots first: they hold reservations and progress,
            # and restoring their host pages keeps the tier from silting
            unpark_installs, n_unparked = self._try_unpark()
            if unpark_installs:
                # restored content lands now, before admission: a later
                # seat may evict these very pages to the host again
                self._apply_unpark_installs(unpark_installs)
            while True:
                nxt = self._cq.peek()
                if nxt is None:
                    break
                cls, head = nxt
                i = next((j for j in range(self.B)
                          if self._slots[j] is None), None)
                # feasibility before any eviction: the head admits only
                # if its worst case fits what is not reserved plus what
                # evicting strictly-lower-class, unshielded occupants
                # (parked ones too) would free; otherwise it waits (FIFO
                # fairness) and nothing is evicted
                victims = self._evictable_for(cls)
                live_victims = [h for h in victims if h[0] == "live"]
                if i is None and not live_victims:
                    break  # a lane can only come from a live victim
                n_res = 0
                if self.paged:
                    n_res = self._pages_for(
                        max(1, len(head.prompt) - 1) if head.prefill_only
                        else min(len(head.prompt) - 1 + head.max_new,
                                 self.L))
                    avail = self._budget_pages - self._res_total
                    reclaim = sum(self._res_of(h) for h in victims)
                    if avail + reclaim < n_res:
                        self.stats.inc("admission_stalls")
                        break
                if i is None:
                    # every lane is taken: evict the youngest
                    # lowest-class seated occupant for its lane
                    i = self._victim_for(cls, live_only=True)[1]
                    preempted_info.append(self._preempt_slot(i, cls))
                if self.paged:
                    # terminates in admission by the feasibility check;
                    # parked victims are the cheapest
                    while self._res_total + n_res > self._budget_pages:
                        preempted_info.append(self._preempt_handle(
                            self._victim_for(cls), cls))
                    self._n_res[i] = n_res
                    self._res_total += n_res
                # pop() is the peeked head: a preemption pushes only into
                # strictly lower classes
                _, slot = self._cq.pop()
                if self._cq.last_pop_promoted:
                    slot.shielded = True  # aging fired: not preemptible
                self._seat_slot(i, slot)
                admitted_info.append((slot.request_id, i,
                                      len(slot.prompt), slot.slo,
                                      bool(slot.prior)))
            depths = self._cq.depths()
            self.stats.set("slo_aged_promotions", self._cq.promotions)
            live = [i for i in range(self.B) if self._slots[i] is not None]
            self.stats.max_set("max_concurrent",
                               len(live) + len(self._parked))
        for c, d in depths.items():
            self.stats.set(f"queued_{c}", d)
        # spans outside the engine lock: the sink takes its own locks
        for rid, row, n_gen, vslo, by in preempted_info:
            self._span("preempted", rid, slot=row, tokens=n_gen, slo=vslo,
                       by=by)
        for rid, row, plen, cls, resumed in admitted_info:
            # `resumed` marks a preempt-resume re-admission: not a fresh
            # queue-wait sample for observers
            self._span("admitted", rid, slot=row, prompt_tokens=plen,
                       slo=cls, resumed=resumed)
        if not live:
            self._prefetch_hint()
            return 0
        admitted = bool(admitted_info) or n_unparked > 0
        if admitted and self.C > 1:
            self._chunked_prefill()
            for rid, _row, plen, _cls, _res in admitted_info:
                self._span("prefill", rid, prompt_tokens=plen)
        # prefill-only slots at their last prompt token are done now:
        # their KV ships and their lanes free before the decode steps
        self._harvest_prefill_only()
        # prefill and the harvest may have parked or freed lanes
        live = [i for i in range(self.B) if self._slots[i] is not None]
        if admitted or self._prompt_dev is None:
            self._prompt_dev = self._dev(self._prompt_buf, torch.int64)
        self._prefetch_hint()
        if not live:
            return 0
        any_sampling = any(self._slots[i].temperature > 0 for i in live)
        # the speculative path: every live slot greedy and past its
        # prompt, room for a whole window in the cache, and recent
        # acceptance above break-even (or a periodic re-probe); else this
        # call runs the scan. Both emit the argmax tokens.
        if (self.spec_k and not any_sampling
                and (self._spec_ema >= self._spec_floor
                     or self._spec_idle >= SPEC_REPROBE_CALLS)
                and all(self._pos[i] >= len(self._slots[i].prompt) - 1
                        and int(self._pos[i]) + self.spec_k <= self.L
                        for i in live)):
            return self._speculative_step(live)
        if self.spec_k:
            self._spec_idle += 1
        if self.paged:
            for i in live:
                # the K steps write positions pos..pos+K-1, frozen at
                # stop_pos-1: map exactly that window's pages. On a tiered
                # engine an earlier lane's growth may have parked this one
                # (allocating for the emptied lane would leak its pages)
                if self._slots[i] is None:
                    continue
                self._ensure_pages_to(i, min(
                    int(self._pos[i]) + self.K,
                    int(self._stop_pos[i])) - 1)
        # the sampler (a vocab sort per step) runs only in calls where a
        # live slot samples, as JAX compiles a separate greedy program
        sampling = None
        if any_sampling:
            sampling = (self._dev(self._temp, torch.float32),
                        self._dev(self._topk, torch.int32),
                        self._dev(self._topp, torch.float32),
                        self._dev(self._seed, torch.int32))
        emitted = _decode_steps(
            self.module, self._cache, self.K,
            self._dev(self._tok, torch.int64),
            self._dev(self._pos, torch.int32), self._prompt_dev,
            self._dev(self._prompt_len, torch.int32),
            self._dev(self._stop_pos, torch.int32), self._ptab_arg(),
            sampling, self._aid_arg())
        self.stats.inc("steps", self.K)
        if self._draft_cache is not None:
            if not any_sampling and (
                    self._spec_ema >= self._spec_floor
                    or self._spec_idle >= SPEC_REPROBE_CALLS - 1):
                if not self._draft_synced:
                    self._resync_draft()
                self._mirror_scan_onto_draft(emitted)
            else:
                # speculation cannot pay now (gate off, or a sampling
                # slot): skip the mirror, and let the next probe rebuild
                # the draft cache from the accepted contexts
                self._draft_synced = False

        finished: List[Tuple[Any, List[int]]] = []
        for i in live:
            slot = self._slots[i]
            if slot is None:
                continue  # parked by a page reclaim before the call: its
                #           lane idled through it (stop_pos 0)
            plen = len(slot.prompt)
            pos0 = int(self._pos[i])
            # steps this slot really took (slots that hit their stop
            # mid-call idle for the rest)
            n_real = max(0, min(self.K, int(self._stop_pos[i]) - pos0,
                                self.L - pos0))
            eos_hit = False
            n0 = len(slot.generated)
            for j in range(n_real):
                if pos0 + j >= plen - 1:  # emission at a generated pos
                    t = int(emitted[j, i])
                    if slot.eos_id is not None and t == slot.eos_id:
                        eos_hit = True
                        break
                    slot.generated.append(t)
            if len(slot.generated) > n0:
                self.stats.inc("tokens_generated",
                               len(slot.generated) - n0)
                self._mark_progress(slot, n0, len(slot.generated))
            slot.n_consumed += n_real
            self._pos[i] = pos0 + n_real
            if (eos_hit or len(slot.generated) >= slot.max_new
                    or int(self._pos[i]) >= self.L):
                # a preempt-resumed request replies with its whole output
                finished.append((slot.request_id,
                                 slot.prior + slot.generated))
                self._slots[i] = None
                self._tok[i] = 0
                self._pos[i] = 0  # a fresh occupant restarts at 0
                self._prompt_len[i] = 1
                self._stop_pos[i] = 0
                if self.paged:  # pages and reservation free now
                    self._release_slot_pages(i)
            else:
                # the next input, mirroring the on-device selection
                self._tok[i] = (slot.prompt[slot.n_consumed]
                                if slot.n_consumed < plen
                                else slot.generated[-1])
        if finished:
            with self._lock:
                self._done.extend(finished)
                self.stats.inc("requests_done", len(finished))
            for rid, toks in finished:
                self._span("done", rid, tokens=len(toks))
        return len(live)

    # ---- speculation ----
    def _draft_pass(self, tok: np.ndarray, pos: np.ndarray) -> None:
        """One multi-token KV pass of (B, w) ``tok`` at ``pos`` through
        the draft (a prefill-shaped mirror)."""
        _prefill(self.draft_module, self._draft_cache,
                 self._dev(tok, torch.int64), self._dev(pos, torch.int32),
                 None, None)

    def _resync_draft(self) -> None:
        """Rebuild the draft cache from every live slot's accepted
        context (prompt + generated, positions 0..pos-1) in K-token
        passes: a re-probe after a gated-off stretch whose scan mirrors
        were skipped."""
        self._draft_cache = self.draft_module.init_cache(self.B)
        ctxs: Dict[int, np.ndarray] = {}
        maxp = 0
        for i in range(self.B):
            s = self._slots[i]
            if s is None:
                continue
            ctx = np.concatenate([s.prompt,
                                  np.asarray(s.generated, np.int32)])
            ctxs[i] = ctx[:int(self._pos[i])]
            maxp = max(maxp, len(ctxs[i]))
        for c0 in range(0, maxp, self.K):
            tok_m = np.zeros((self.B, self.K), np.int32)
            pos_m = np.zeros((self.B, self.K), np.int32)
            for i in range(self.B):
                ctx = ctxs.get(i)
                if ctx is None or len(ctx) <= c0:
                    # nothing (left) for this lane: an idempotent rewrite
                    # of its current token at its current position
                    tok_m[i, :] = self._tok[i]
                    pos_m[i, :] = self._pos[i]
                    continue
                n = min(self.K, len(ctx) - c0)
                tok_m[i, :n] = ctx[c0:c0 + n]
                pos_m[i, :n] = np.arange(c0, c0 + n)
                tok_m[i, n:] = tok_m[i, n - 1]
                pos_m[i, n:] = pos_m[i, n - 1]
            self._draft_pass(tok_m, pos_m)
        self._draft_synced = True
        self.stats.inc("draft_resyncs")

    def _mirror_scan_onto_draft(self, emitted: np.ndarray) -> None:
        """Write the scan call's consumed inputs into the draft cache in
        one pass, so the draft stays token for token in step with the
        target. Runs before the host mirrors advance (``_pos``/``_tok``
        are the call's start); idle lanes rewrite their current token at
        their current position."""
        tok_m = np.empty((self.B, self.K), np.int32)
        pos_m = np.empty((self.B, self.K), np.int32)
        for i in range(self.B):
            s = self._slots[i]
            p0 = int(self._pos[i])
            cur = int(self._tok[i])
            if s is None:
                tok_m[i, :] = cur
                pos_m[i, :] = p0
                continue
            plen = len(s.prompt)
            n_real = max(0, min(self.K, int(self._stop_pos[i]) - p0,
                                self.L - p0))
            for j in range(self.K):
                if j < n_real:
                    p = p0 + j
                    if j == 0:
                        t = cur
                    elif p < plen:
                        t = int(s.prompt[p])
                    else:  # generated region: the previous step's token
                        t = int(emitted[j - 1, i])
                    tok_m[i, j], pos_m[i, j] = t, p
                else:  # idle remainder: rewrite the last entry
                    tok_m[i, j] = tok_m[i, j - 1] if j else cur
                    pos_m[i, j] = pos_m[i, j - 1] if j else p0
        self._draft_pass(tok_m, pos_m)

    def _speculative_step(self, live: List[int]) -> int:
        """One verify call: each live slot's drafted continuation rides
        one k-token window; a slot emits its accepted prefix plus the
        model's own token at the first mismatch (1..spec_k tokens).
        Rejected drafts leave KV rows above the slot's new position:
        unreachable under the position mask, rewritten when generation
        reaches them."""
        k = self.spec_k
        if self._draft_cache is not None:
            if not self._draft_synced:
                self._resync_draft()
            # k-1 greedy steps of the draft over its own cache, then the
            # verify mirror writes the window's inputs [tok, drafts], the
            # last row included (a fully accepted window needs its KV)
            d_emit = _decode_steps(
                self.draft_module, self._draft_cache, k - 1,
                self._dev(self._tok, torch.int64),
                self._dev(self._pos, torch.int32), self._prompt_dev,
                self._dev(self._prompt_len, torch.int32),
                self._dev(self._stop_pos, torch.int32), None)
            drafts = np.ascontiguousarray(d_emit.T).astype(np.int32)
            self._draft_pass(
                np.concatenate([self._tok[:, None], drafts], axis=1),
                self._pos[:, None] + np.arange(k, dtype=np.int32)[None, :])
            self.stats.inc("spec_draft_model_calls")
        else:
            drafts = np.zeros((self.B, k - 1), np.int32)
            for i in live:
                s = self._slots[i]
                ctx = np.concatenate(
                    [s.prompt, np.asarray(s.generated, np.int32)])
                drafts[i] = _ngram_draft(ctx, k - 1)
        if self.paged:
            for i in live:
                # the window writes positions pos..pos+k-1 (the gate kept
                # them inside the cache), inside the reservation's spec
                # margin, whether or not the drafts are accepted; a lane
                # parked by an earlier lane's growth is skipped
                if self._slots[i] is None:
                    continue
                self._ensure_pages_to(i, min(int(self._pos[i]) + k - 1,
                                             self.L - 1))
        g, n_emit = _verify(self.module, self._cache, self._tok, self._pos,
                            drafts, self._stop_pos, self._ptab_arg(),
                            self._aid_arg(), self.device)
        self.stats.inc("steps")
        self.stats.inc("spec_calls")
        self._spec_idle = 0
        self._spec_ema = (SPEC_EMA_DECAY * self._spec_ema
                          + (1 - SPEC_EMA_DECAY)
                          * float(np.mean(n_emit[live])))

        finished: List[Tuple[Any, List[int]]] = []
        for i in live:
            slot = self._slots[i]
            if slot is None:
                continue  # parked by a page reclaim before the call
            pos0 = int(self._pos[i])
            take = max(1, min(int(n_emit[i]), int(self._stop_pos[i]) - pos0,
                              self.L - pos0))
            toks = [int(t) for t in g[i, :take]]
            eos_hit = slot.eos_id is not None and slot.eos_id in toks
            if eos_hit:  # drop the EOS and anything verified past it
                toks = toks[:toks.index(slot.eos_id)]
            n0 = len(slot.generated)
            slot.generated.extend(toks)
            slot.n_consumed += take
            self._pos[i] = pos0 + take
            if toks:
                self.stats.inc("tokens_generated", len(toks))
                self._mark_progress(slot, n0, len(slot.generated))
            self.stats.inc("spec_drafted", k - 1)
            self.stats.inc("spec_accepted", take - 1)
            if (eos_hit or len(slot.generated) >= slot.max_new
                    or int(self._pos[i]) >= self.L):
                finished.append((slot.request_id,
                                 slot.prior + slot.generated))
                self._slots[i] = None
                self._tok[i] = 0
                self._pos[i] = 0
                self._prompt_len[i] = 1
                self._stop_pos[i] = 0
                if self.paged:
                    self._release_slot_pages(i)
            else:
                self._tok[i] = slot.generated[-1]
        if finished:
            with self._lock:
                self._done.extend(finished)
                self.stats.inc("requests_done", len(finished))
            for rid, toks in finished:
                self._span("done", rid, tokens=len(toks))
        return len(live)


def _ngram_draft(context: np.ndarray, k: int, max_n: int = 3) -> np.ndarray:
    """Prompt-lookup drafting: the longest (<= ``max_n``) suffix n-gram of
    ``context`` with an earlier occurrence proposes the ``k`` tokens that
    followed its most recent match (padded with the last context token);
    without a match, the last token ``k`` times. Host-side numpy."""
    ctx = np.asarray(context, np.int32).ravel()
    n_ctx = len(ctx)
    for n in range(min(max_n, n_ctx - 1), 0, -1):
        suffix = ctx[n_ctx - n:]
        # windows over ctx[:-1]: every start whose n-gram ends before
        # the suffix's own final token
        windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.nonzero(np.all(windows == suffix, axis=1))[0]
        if len(hits):
            j = int(hits[-1]) + n  # continuation of the latest match
            cont = ctx[j:j + k]
            if len(cont) < k:
                cont = np.concatenate(
                    [cont, np.full(k - len(cont), ctx[-1], np.int32)])
            return cont.astype(np.int32)
    return np.full(k, ctx[-1], np.int32)


def _verify(module: Any, cache: List[Dict[str, torch.Tensor]],
            tok: np.ndarray, pos: np.ndarray, drafts: np.ndarray,
            stop_pos: np.ndarray, ptab: Optional[torch.Tensor],
            aid: Optional[torch.Tensor], device: torch.device
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One speculative verify call (the JAX ``_make_verify``): each slot's
    current token and its k-1 drafts at positions pos..pos+k-1 through
    one cache pass (on a paged module, a window of the window kernel);
    idle lanes (pos >= stop_pos) re-feed their token at their position k
    times. ``g[:, j]`` is the argmax after input j, so draft j+1 is right
    iff it equals ``g[:, j]``; ``n_emit`` is 1 + the accepted prefix.
    Returns both on the host (the call's one sync)."""
    k = drafts.shape[1] + 1
    active = (pos < stop_pos)[:, None]
    seq = np.where(active, np.concatenate([tok[:, None], drafts], axis=1),
                   tok[:, None])
    positions = np.where(active, pos[:, None] + np.arange(k)[None, :],
                         pos[:, None])
    logits = module(torch.from_numpy(seq.astype(np.int64)).to(device),
                    positions=torch.from_numpy(
                        positions.astype(np.int32)).to(device),
                    cache=cache, page_tables=ptab, adapter_ids=aid)
    g = logits.float().argmax(-1)
    d = torch.from_numpy(drafts.astype(np.int64)).to(device)
    ok = torch.cumprod((d == g[:, :-1]).long(), dim=1)
    n_emit = 1 + ok.sum(dim=1)
    out = torch.cat([g, n_emit[:, None]], dim=1).cpu().numpy()
    return out[:, :k].astype(np.int32), out[:, k].astype(np.int32)


def _to_host(tensors: List[torch.Tensor]) -> List[Any]:
    """Tensors as wire leaves on the host: numpy arrays, bf16 ones as CPU
    tensors (the param-store codec writes them as ``bfloat16``). From a
    CUDA device: asynchronous copies into pinned memory and one
    synchronization of the stream."""
    if tensors and tensors[0].is_cuda:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
    else:
        host = [t.clone() for t in tensors]
    return [h if h.dtype == torch.bfloat16 else h.numpy() for h in host]


def _install_rows(cache: List[Dict[str, torch.Tensor]],
                  snap: List[Dict[str, torch.Tensor]], rows: torch.Tensor,
                  plen: int) -> None:
    """Write a (1, plen, ...) snapshot into contiguous cache rows
    ``rows``, positions 0..plen-1, leaf by leaf."""
    for layer, pre in zip(cache, snap):
        for name, c in layer.items():
            c[rows, :plen] = pre[name][:, :plen].to(c.device, c.dtype)


def _select_next(logits: torch.Tensor, temp: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 seed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-slot token selection on the device (the JAX ``_select_next``):
    greedy where ``temp <= 0``, else temperature-scaled categorical over
    the top-k/top-p-filtered distribution. Both filters are a per-row
    logit threshold on one descending sort (the k-th largest; the
    smallest logit of the minimal nucleus). The draw's key is
    ``fold_in(fold_in(PRNGKey(0), seed), pos)``. ``logits`` (B, V) f32;
    the rest (B,)."""
    v = logits.shape[-1]
    greedy = logits.argmax(-1)
    lg = logits / temp.clamp(min=1e-6)[:, None]
    sorted_lg = lg.sort(-1, descending=True).values
    kk = torch.where(top_k <= 0, v, top_k).clamp(1, v).long()
    k_thresh = sorted_lg.gather(-1, (kk - 1)[:, None])
    probs = torch.softmax(sorted_lg, -1)
    cum = probs.cumsum(-1)
    # the minimal prefix whose mass reaches top_p (the first token's
    # "mass before" is 0 < top_p, so it is always kept)
    keep = (cum - probs) < top_p.clamp(min=1e-6)[:, None]
    p_thresh = torch.where(keep, sorted_lg,
                           torch.full_like(sorted_lg, math.inf)
                           ).amin(-1, keepdim=True)
    masked = torch.where(lg >= torch.maximum(k_thresh, p_thresh), lg,
                         torch.full_like(lg, -1e30))
    keys = threefry.fold_in(
        threefry.fold_in(threefry.prng_key(0, device=logits.device), seed),
        pos)
    sampled = threefry.categorical(keys, masked)
    return torch.where(temp <= 0, greedy, sampled)


def _decode_steps(module: Any, cache: List[Dict[str, torch.Tensor]],
                  k: int, tok: torch.Tensor, pos: torch.Tensor,
                  prompt_buf: torch.Tensor, prompt_len: torch.Tensor,
                  stop_pos: torch.Tensor, ptab: Optional[torch.Tensor],
                  sampling: Optional[Tuple[torch.Tensor, ...]] = None,
                  aid: Optional[torch.Tensor] = None) -> np.ndarray:
    """K decode steps over all slots, writing ``cache`` in place (the JAX
    ``_make_step`` scan). Each step's token is the argmax, or with
    ``sampling`` = (temp, top_k, top_p, seed) per slot
    :func:`_select_next` at the step's input position. Between steps the
    next input is chosen on the device: the next prompt token while a
    slot's next position is inside its prompt, else its own token; a
    slot whose next position reaches ``stop_pos`` freezes (tok/pos stop
    advancing). ``aid``: each slot's adapter (multi-adapter modules).
    Returns the (K, n_slots) tokens — the call's one host sync."""
    rows = torch.arange(tok.shape[0], device=tok.device)
    last = prompt_buf.shape[1] - 1
    emitted = []
    for _ in range(k):
        logits = module(tok[:, None], positions=pos[:, None], cache=cache,
                        page_tables=ptab, adapter_ids=aid)
        lg = logits[:, -1].float()
        nxt = (_select_next(lg, *sampling, pos) if sampling is not None
               else lg.argmax(-1))
        new_pos = pos + 1
        nxt_prompt = prompt_buf[rows, new_pos.clamp(max=last).long()]
        nxt_input = torch.where(new_pos < prompt_len, nxt_prompt, nxt)
        active = new_pos < stop_pos
        tok = torch.where(active, nxt_input, tok)
        pos = torch.where(active, new_pos, pos)
        emitted.append(nxt)
    return torch.stack(emitted).cpu().numpy()


def _prefill(module: Any, cache: List[Dict[str, torch.Tensor]],
             tok_chunk: torch.Tensor, pos_chunk: torch.Tensor,
             ptab: Optional[torch.Tensor],
             aid: Optional[torch.Tensor] = None) -> None:
    """One C-token prefill call (the JAX ``_make_prefill``): (B, C)
    tokens at their per-slot positions through the decode path, pure
    KV-cache population. ``return_hidden`` stops at the final norm, so
    the (B, C, vocab) lm_head is never computed."""
    module(tok_chunk, positions=pos_chunk, cache=cache, page_tables=ptab,
           return_hidden=True, adapter_ids=aid)


class TextDecodeEngine:
    """Text-level wrapper: encode prompts, detokenize completions.
    ``encode(text) -> 1-D int32 ids`` and ``decode(ids) -> text`` come
    from the owning model template (``LlamaLoRA.make_decode_engine``)."""

    #: the inference worker forwards a failover request's
    #: ``forced_prefix`` and a request's ``slo`` only to engines that
    #: declare them, and boots a prefill/decode role only over an engine
    #: that declares KV shipment (``submit_prefill`` / ``poll_kv`` on the
    #: prefill leg, ``submit(..., kv_blob=)`` on the decode leg)
    supports_resume = True
    supports_slo = True
    supports_kv_ship = True

    def __init__(self, engine: DecodeEngine,
                 encode: Callable[[str], np.ndarray],
                 decode: Callable[[List[int]], str],
                 max_new: int = 8, resume_sep: str = " ") -> None:
        self.engine = engine
        self._encode = encode
        self._decode = decode
        self.max_new = int(max_new)
        #: text joint between a prompt and a forced resume prefix, and
        #: between the prefix and the continuation: " " suits both
        #: tokenizers (the hash tokenizer splits and joins on
        #: whitespace; the byte-BPE detokenizer strips the leading space
        #: of its first generated token)
        self._sep = resume_sep
        self._stream_sent: Dict[Any, str] = {}  # rid -> text delivered
        #: rid -> forced resume prefix: text the engine re-ingests as
        #: prompt but that deltas and the final text present as output
        self._forced: Dict[Any, str] = {}
        #: resumes whose prefix already covered the token budget,
        #: completed without the engine; surfaced by the next poll()
        self._forced_done: List[Tuple[Any, str]] = []

    def submit(self, request_id: Any, text: str,
               max_new: Optional[int] = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_id: Optional[int] = None, adapter_id: int = 0,
               forced_prefix: str = "", slo: str = "",
               kv_blob: Optional[Dict[str, Any]] = None) -> None:
        """The JAX wrapper's signature. ``forced_prefix`` (stream
        failover): text a previous worker already emitted for this
        request. It is re-ingested with the prompt (``text + sep +
        prefix``, through chunked prefill), the budget shrinks by the
        tokens it covers, and deltas and the final text present it as
        output. Greedy continuations are token-exact when re-tokenizing
        prompt + prefix reproduces the original token boundaries (always
        for the hash tokenizer; byte-BPE may shift one at the splice).
        ``kv_blob``: a prefill-role engine's shipment for this prompt,
        installed instead of prefilling (``DecodeEngine.submit(
        kv_import=)``); a resume prefix drops it, since the shipment
        covers the original prompt only."""
        budget = self.max_new if max_new is None else int(max_new)
        if forced_prefix:
            full = text + self._sep + forced_prefix
            covered = max(0, len(self._encode(full))
                          - len(self._encode(text)))
            remaining = budget - covered
            if remaining <= 0:
                # the whole budget was generated before; only the final
                # message was lost: complete with the prefix as the text
                self._forced_done.append((request_id, str(forced_prefix)))
                return
            self._forced[request_id] = str(forced_prefix)
            self._stream_sent[request_id] = str(forced_prefix)
            text, budget = full, remaining
            kv_blob = None  # a shipment covers the original prompt only
        self.engine.submit(request_id, self._encode(text), budget,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed, eos_id=eos_id,
                           adapter_id=adapter_id, slo=slo,
                           kv_import=kv_blob)

    def submit_prefill(self, request_id: Any, text: str,
                       max_new: Optional[int] = None,
                       adapter_id: int = 0, slo: str = "") -> None:
        """Prefill-role submission: run the prompt through chunked
        prefill and surface its KV shipment via :meth:`poll_kv`; nothing
        is generated here (the decode leg installs the blob)."""
        self.engine.submit(request_id, self._encode(str(text)),
                           self.max_new if max_new is None
                           else int(max_new),
                           adapter_id=adapter_id, slo=slo,
                           prefill_only=True)

    def poll_kv(self) -> List[Tuple[Any, Dict[str, Any]]]:
        """Finished prefill-only shipments (:meth:`DecodeEngine.poll_kv`)."""
        return self.engine.poll_kv()

    def stage_kv_blob(self, blob: Dict[str, Any]) -> Dict[str, Any]:
        """Upload an arrived shipment's leaves ahead of admission
        (:meth:`DecodeEngine.stage_kv_blob`)."""
        return self.engine.stage_kv_blob(blob)

    def register_prefix(self, text: str, adapter_id: int = 0) -> int:
        """Precompute the KV of a shared prompt prefix (see
        :meth:`DecodeEngine.register_prefix`); not concurrent with
        ``step``."""
        return self.engine.register_prefix(self._encode(text),
                                           adapter_id=adapter_id)

    def export_prefix(self, adapter_id: int = 0):
        return self.engine.export_prefix(adapter_id=adapter_id)

    def import_prefix(self, blob, adapter_id: int = 0) -> int:
        return self.engine.import_prefix(blob, adapter_id=adapter_id)

    def _full_text(self, rid: Any, ids: List[int]) -> str:
        """The request's cumulative output text: the decoded ids, after
        the forced resume prefix when one is active."""
        text = self._decode(ids)
        base = self._forced.get(rid)
        if base is not None:
            text = base + (self._sep + text if text else "")
        return text

    def poll(self) -> List[Tuple[Any, str]]:
        done = [(rid, self._full_text(rid, ids))
                for rid, ids in self.engine.poll()]
        done.extend(self._forced_done)
        self._forced_done = []
        for rid, _ in done:  # a finished request stops streaming state
            self._stream_sent.pop(rid, None)
            self._forced.pop(rid, None)
        return done

    def poll_partial(self) -> List[Tuple[Any, str]]:
        """(request_id, new text) for live requests since the last call.
        Each event re-detokenizes the cumulative ids and emits the text
        past what was already delivered; trailing replacement characters
        (an incomplete UTF-8 sequence) are withheld until a later decode
        resolves them, so the delivered stream is append-only."""
        out: List[Tuple[Any, str]] = []
        for rid, ids in self.engine.poll_partial():
            text = self._full_text(rid, ids).rstrip("�")
            sent = self._stream_sent.get(rid, "")
            if len(text) > len(sent) and text.startswith(sent):
                out.append((rid, text[len(sent):]))
                self._stream_sent[rid] = text
        return out

    def step(self) -> int:
        return self.engine.step()

    def reset(self) -> None:
        self._stream_sent.clear()
        self._forced.clear()
        self._forced_done.clear()
        self.engine.reset()

    def close(self) -> None:
        self.engine.close()

    def reset_stats(self) -> None:
        self.engine.reset_stats()

    @property
    def busy(self) -> bool:
        return self.engine.busy

    @property
    def stats(self) -> StatsMap:
        return self.engine.stats

    def stats_snapshot(self) -> Dict[str, int]:
        return self.engine.stats_snapshot()

    @property
    def span_sink(self):
        return self.engine.span_sink

    @span_sink.setter
    def span_sink(self, sink) -> None:
        # request ids pass through submit untouched, so the token
        # engine's lifecycle events carry the caller's ids directly
        self.engine.span_sink = sink
