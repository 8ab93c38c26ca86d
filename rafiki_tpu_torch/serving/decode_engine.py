"""Continuous-batching decode engine for causal-LM serving.

Ports the core of ``rafiki_tpu/serving/decode_engine.py``:

- ``_Slot``, ``DecodeEngine`` (``__init__``, ``submit``, ``step``,
  ``poll``, ``poll_partial``, ``busy``, ``reset``, ``reset_stats``,
  ``stats_snapshot``) and ``TextDecodeEngine``;
- the paged-KV allocator: a LIFO free list over pool pages
  ``1..n_pages-1`` (page 0 is the scratch page idle lanes write to),
  worst-case page reservation at admission (a request that does not fit
  waits, counted in ``admission_stalls``), lazy ``_ensure_pages_to``,
  ``_release_slot_pages``, and the live-width table slice
  (``_live_table_width``/``_ptab_arg``);
- ``_chunked_prefill`` with its narrow small-C call for short remainders;
- ``_make_step`` → :func:`_decode_steps`: K greedy decode steps as a
  Python loop with on-device input selection and ONE host sync (the
  emitted tokens) per call;
- ``_make_prefill`` → :func:`_prefill`: one C-token cache pass that
  stops at the final norm (the (B, C, vocab) lm_head is never computed;
  XLA dead-code-eliminated it, eager PyTorch must not run it).

JAX compiles each program once and donates the cache; here the model
writes its cache tensors in place and runs eagerly. On a CUDA device a
paged engine's every decode call goes through the hand-written kernels
(``paged_decode_attention`` for the s == 1 steps,
``paged_window_attention`` for prefill windows).

Left for later slices, raising ``NotImplementedError``: sampling
(``temperature > 0`` needs threefry parity), speculation
(``speculate_k >= 2``, ``draft``), the host KV tier
(``host_kv_pages > 0``), registered/imported/exported prefixes and KV
shipment (``poll_kv``, ``stage_kv_blob``), multi-adapter engines, and
SLO preemption (classes still order admission).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.serving.slo import (DEFAULT_SLO, ClassQueue,
                                          normalize_slo)
from rafiki_tpu_torch.utils.device import (DeviceLike, resolve_device,
                                           same_device)


@dataclass
class _Slot:
    request_id: Any
    prompt: np.ndarray          # (p,) int32, valid tokens only
    max_new: int
    eos_id: Optional[int] = None  # emitting this token ends the request
    slo: str = DEFAULT_SLO      # admission class (interactive first)
    seq: int = 0                # arrival order
    n_consumed: int = 0         # tokens fed to the model so far
    generated: List[int] = field(default_factory=list)
    n_streamed: int = 0         # generated tokens already poll_partial'd


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


class DecodeEngine:
    """Slot-based continuous batching over one decode step program.

    ``steps_per_sync`` fuses K decode steps into one call with on-device
    input selection (next prompt token while prefilling, argmax feedback
    while generating); the host pays one sync per K tokens. Admission
    happens at call boundaries. Any K produces identical tokens.

    ``module`` is a port ``Llama`` (its ``kv_page_size``/``kv_pages``
    choose the cache layout); ``device`` must be the module's device
    (None = the CUDA card, raising without one)."""

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
        if int(speculate_k) >= 2 or draft is not None:
            raise _not_ported("speculative decoding")
        if int(host_kv_pages):
            raise _not_ported("the host KV tier")
        self.module = module
        self.B = int(max_slots)
        self.L = int(max_len)
        self.K = max(1, int(steps_per_sync))
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
        self._ptab = np.zeros((self.B, self._n_table), np.int32)
        self._ptab_dev: Optional[torch.Tensor] = None
        self._ptab_dev_width = 0
        self._ptab_dirty = True
        self._cache = module.init_cache(self.B)
        self.stats = StatsMap({
            "steps": 0, "tokens_generated": 0, "requests_done": 0,
            "max_concurrent": 0, "prefill_calls": 0, "prefill_tokens": 0,
            # paged-KV pool gauges (0 on contiguous engines)
            "kv_pages_used": 0, "kv_pages_high_water": 0,
            "kv_pages_total": (self.n_pages - 1 if self.paged else 0),
            "admission_stalls": 0,
            "queued_interactive": 0, "queued_batch": 0,
            "queued_background": 0})

    # ---- submission / results (thread-safe: loop thread vs callers) ----
    def submit(self, request_id: Any, prompt_ids: np.ndarray,
               max_new: int, temperature: float = 0.0,
               eos_id: Optional[int] = None, slo: str = "") -> None:
        """Queue a greedy request. ``prompt_ids``: 1-D valid tokens
        (>= 1); prompt + generation are truncated to fit the cache.
        ``eos_id`` ends the request when emitted (the EOS is dropped
        from the reply). ``slo`` orders admission (interactive, batch,
        background)."""
        if float(temperature) > 0:
            raise _not_ported("sampling (temperature > 0)")
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        max_new = max(1, min(int(max_new), self.L - 1))
        prompt = prompt[:max(1, self.L - max_new)]
        cls = normalize_slo(slo)
        if self.paged:
            # a request whose worst case exceeds the whole pool could
            # never take a step: refuse it here instead of stalling the
            # queue forever
            need = self._pages_for(min(len(prompt) - 1 + max_new, self.L))
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request needs {need} KV pages worst-case but the "
                    f"pool has {self.n_pages - 1} usable pages; raise "
                    "kv_pages or lower max_new/prompt length")
        with self._lock:
            self._seq += 1
            self._cq.push(cls, _Slot(
                request_id, prompt, max_new,
                eos_id=None if eos_id is None else int(eos_id),
                slo=cls, seq=self._seq))

    def poll(self) -> List[Tuple[Any, List[int]]]:
        """Completed (request_id, generated ids) since the last poll."""
        with self._lock:
            done, self._done = self._done, []
        return done

    def poll_partial(self) -> List[Tuple[Any, List[int]]]:
        """(request_id, generated-so-far) for still-live slots that
        produced new tokens since the last call: cumulative copies, not
        deltas. Call from the thread that drives ``step``."""
        out: List[Tuple[Any, List[int]]] = []
        for slot in self._slots:
            if slot is not None and len(slot.generated) > slot.n_streamed:
                out.append((slot.request_id, list(slot.generated)))
                slot.n_streamed = len(slot.generated)
        return out

    @property
    def busy(self) -> bool:
        with self._lock:
            return bool(self._cq) or any(s is not None
                                         for s in self._slots)

    def reset_stats(self) -> None:
        """Zero the served-traffic counters, keeping the pool gauges."""
        keep = {}
        if self.paged:
            keep.update(kv_pages_total=self.n_pages - 1,
                        kv_pages_used=(self.n_pages - 1
                                       - len(self._free_pages)))
        self.stats.reset(keep=keep)

    def stats_snapshot(self) -> Dict[str, int]:
        """A point-in-time copy of the counters, taken under the stats
        lock."""
        return self.stats.snapshot()

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
            self._prompt_dev = None
            if self.paged:
                self._free_pages = list(range(self.n_pages - 1, 0, -1))
                self._ptab[:] = 0
                self._n_alloc[:] = 0
                self._n_res[:] = 0
                self._res_total = 0
                self._ptab_dirty = True
                self.stats.set("kv_pages_used", 0)
        self._cache = self.module.init_cache(self.B)

    def register_prefix(self, prefix_ids: np.ndarray,
                        adapter_id: int = 0) -> int:
        raise _not_ported("registered prefixes")

    def export_prefix(self, adapter_id: int = 0):
        raise _not_ported("prefix export")

    def import_prefix(self, blob: Dict[str, Any],
                      adapter_id: int = 0) -> int:
        raise _not_ported("prefix import")

    def poll_kv(self):
        raise _not_ported("KV shipment (disaggregated prefill)")

    def stage_kv_blob(self, blob: Dict[str, Any]):
        raise _not_ported("KV shipment (disaggregated prefill)")

    # ---- paged-KV allocator (step thread only, except reservations,
    # ---- which share the admission lock) ----
    def _pages_for(self, stop_pos: int) -> int:
        """Worst-case pages a request can touch: the decode steps write
        positions <= stop_pos - 1."""
        return min(stop_pos - 1, self.L - 1) // self.page_size + 1

    def _ensure_pages_to(self, i: int, last_pos: int) -> None:
        """Allocate slot ``i``'s logical pages covering positions
        ``[0, last_pos]`` — called before every call with that call's
        write horizon (a slot holds pages for where it is, not for
        max_len). Infallible inside the slot's reservation."""
        need = last_pos // self.page_size + 1
        grew = need > int(self._n_alloc[i])
        while int(self._n_alloc[i]) < need:
            self._ptab[i, int(self._n_alloc[i])] = self._free_pages.pop()
            self._n_alloc[i] += 1
        if grew:
            self._ptab_dirty = True
            used = self.n_pages - 1 - len(self._free_pages)
            self.stats.set("kv_pages_used", used)
            self.stats.max_set("kv_pages_high_water", used)

    def _release_slot_pages(self, i: int) -> None:
        """Return slot ``i``'s pages and reservation to the pool; its
        table row points back at the scratch page."""
        n = int(self._n_alloc[i])
        if n:
            self._free_pages.extend(int(p) for p in self._ptab[i, :n])
            self._ptab[i, :n] = 0
            self._n_alloc[i] = 0
            self._ptab_dirty = True
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
            if self.C > self._small_c and rem.max() <= self._small_c:
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
                for i in range(self.B):
                    if adv[i] > 0:
                        self._ensure_pages_to(
                            i, int(self._pos[i]) + int(adv[i]) - 1)
            _prefill(self.module, self._cache,
                     self._dev(tok_chunk, torch.int64),
                     self._dev(pos_chunk, torch.int32), self._ptab_arg())
            self.stats.inc("prefill_calls")
            self.stats.inc("prefill_tokens", int(adv.sum()))
            for i in range(self.B):
                if adv[i] > 0:
                    self._pos[i] += int(adv[i])
                    self._slots[i].n_consumed += int(adv[i])
                    self._tok[i] = self._prompt_buf[i, int(self._pos[i])]

    def _seat_slot(self, i: int, slot: _Slot) -> None:
        """Install a popped request into free slot ``i`` (lock held)."""
        self._slots[i] = slot
        self._tok[i] = slot.prompt[0]
        self._pos[i] = 0
        self._prompt_buf[i, :] = 0
        self._prompt_buf[i, :len(slot.prompt)] = slot.prompt
        self._prompt_len[i] = len(slot.prompt)
        # finish once pos reaches plen - 1 + max_new (the step at input
        # position p emits a generated token iff p >= plen - 1)
        self._stop_pos[i] = min(len(slot.prompt) - 1 + slot.max_new, self.L)
        if self.paged:
            self._ensure_pages_to(i, 0)

    def step(self) -> int:
        """Admit queued requests into free slots, run K decode steps for
        every live slot, harvest completions. Returns the live count."""
        admitted = False
        with self._lock:
            while True:
                nxt = self._cq.peek()
                if nxt is None:
                    break
                _, head = nxt
                i = next((j for j in range(self.B)
                          if self._slots[j] is None), None)
                if i is None:
                    break
                if self.paged:
                    # the head admits only if its worst case fits what is
                    # not reserved; otherwise it WAITS (FIFO fairness:
                    # smaller latecomers never overtake it)
                    n_res = self._pages_for(
                        min(len(head.prompt) - 1 + head.max_new, self.L))
                    if self.n_pages - 1 - self._res_total < n_res:
                        self.stats.inc("admission_stalls")
                        break
                    self._n_res[i] = n_res
                    self._res_total += n_res
                _, slot = self._cq.pop()
                self._seat_slot(i, slot)
                admitted = True
            depths = self._cq.depths()
            live = [i for i in range(self.B) if self._slots[i] is not None]
            self.stats.max_set("max_concurrent", len(live))
        for c, d in depths.items():
            self.stats.set(f"queued_{c}", d)
        if not live:
            return 0
        if admitted and self.C > 1:
            self._chunked_prefill()
        if admitted or self._prompt_dev is None:
            self._prompt_dev = self._dev(self._prompt_buf, torch.int64)
        if self.paged:
            for i in live:
                # the K steps write positions pos..pos+K-1, frozen at
                # stop_pos-1: map exactly that window's pages
                self._ensure_pages_to(i, min(
                    int(self._pos[i]) + self.K,
                    int(self._stop_pos[i])) - 1)
        emitted = _decode_steps(
            self.module, self._cache, self.K,
            self._dev(self._tok, torch.int64),
            self._dev(self._pos, torch.int32), self._prompt_dev,
            self._dev(self._prompt_len, torch.int32),
            self._dev(self._stop_pos, torch.int32), self._ptab_arg())
        self.stats.inc("steps", self.K)

        finished: List[Tuple[Any, List[int]]] = []
        for i in live:
            slot = self._slots[i]
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
            slot.n_consumed += n_real
            self._pos[i] = pos0 + n_real
            if (eos_hit or len(slot.generated) >= slot.max_new
                    or int(self._pos[i]) >= self.L):
                finished.append((slot.request_id, slot.generated))
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
        return len(live)


def _decode_steps(module: Any, cache: List[Dict[str, torch.Tensor]],
                  k: int, tok: torch.Tensor, pos: torch.Tensor,
                  prompt_buf: torch.Tensor, prompt_len: torch.Tensor,
                  stop_pos: torch.Tensor,
                  ptab: Optional[torch.Tensor]) -> np.ndarray:
    """K greedy decode steps over all slots, writing ``cache`` in place
    (the JAX ``_make_step`` scan). Between steps the next input is chosen
    on the device: the next prompt token while a slot's next position is
    inside its prompt, else its own argmax; a slot whose next position
    reaches ``stop_pos`` freezes (tok/pos stop advancing). Returns the
    (K, n_slots) argmax tokens — the call's one host sync."""
    rows = torch.arange(tok.shape[0], device=tok.device)
    last = prompt_buf.shape[1] - 1
    emitted = []
    for _ in range(k):
        logits = module(tok[:, None], positions=pos[:, None], cache=cache,
                        page_tables=ptab)
        nxt = logits[:, -1].float().argmax(-1)
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
             ptab: Optional[torch.Tensor]) -> None:
    """One C-token prefill call (the JAX ``_make_prefill``): (B, C)
    tokens at their per-slot positions through the decode path, pure
    KV-cache population. ``return_hidden`` stops at the final norm, so
    the (B, C, vocab) lm_head is never computed."""
    module(tok_chunk, positions=pos_chunk, cache=cache, page_tables=ptab,
           return_hidden=True)


class TextDecodeEngine:
    """Text-level wrapper: encode prompts, detokenize completions.
    ``encode(text) -> 1-D int32 ids`` and ``decode(ids) -> text`` come
    from the owning model template (``LlamaLoRA.make_decode_engine``)."""

    def __init__(self, engine: DecodeEngine,
                 encode: Callable[[str], np.ndarray],
                 decode: Callable[[List[int]], str],
                 max_new: int = 8) -> None:
        self.engine = engine
        self._encode = encode
        self._decode = decode
        self.max_new = int(max_new)
        self._stream_sent: Dict[Any, str] = {}  # rid -> text delivered

    def submit(self, request_id: Any, text: str,
               max_new: Optional[int] = None, temperature: float = 0.0,
               eos_id: Optional[int] = None, slo: str = "") -> None:
        self.engine.submit(request_id, self._encode(text),
                           self.max_new if max_new is None
                           else int(max_new),
                           temperature=temperature, eos_id=eos_id, slo=slo)

    def poll(self) -> List[Tuple[Any, str]]:
        done = [(rid, self._decode(ids)) for rid, ids in self.engine.poll()]
        for rid, _ in done:  # a finished request stops streaming state
            self._stream_sent.pop(rid, None)
        return done

    def poll_partial(self) -> List[Tuple[Any, str]]:
        """(request_id, new text) for live requests since the last call.
        Each event re-detokenizes the cumulative ids and emits the text
        past what was already delivered; trailing replacement characters
        (an incomplete UTF-8 sequence) are withheld until a later decode
        resolves them, so the delivered stream is append-only."""
        out: List[Tuple[Any, str]] = []
        for rid, ids in self.engine.poll_partial():
            text = self._decode(ids).rstrip("�")
            sent = self._stream_sent.get(rid, "")
            if len(text) > len(sent) and text.startswith(sent):
                out.append((rid, text[len(sent):]))
                self._stream_sent[rid] = text
        return out

    def step(self) -> int:
        return self.engine.step()

    def reset(self) -> None:
        self._stream_sent.clear()
        self.engine.reset()

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
