"""Deterministic mixed-traffic overload harness: SLO drills on stubs.

The port's own copy of ``rafiki_tpu/chaos/sloload.py``:
``SloStubEngine`` over the port's ``serving/slo.py`` ``ClassQueue`` and
``preemption_victim``, ``SloStubLM`` and ``SloLoadHarness``.

The SLO acceptance property ("interactive p95 holds within 1.5x its
unloaded value while best-effort throughput fills the troughs") is a
property of the admission policy (class queues, aging, preemption,
shedding, brownout), not of matmul throughput, so like the scale-out
drills it runs on the :mod:`rafiki_tpu_torch.chaos.scaleout`
capacity-model stack: real :class:`InferenceWorker` serve loops, the real
predictor (shed gate and brownout ladder), and a stub decode engine whose
step costs ``base + per_req x live`` wall seconds.

:class:`SloStubEngine` runs the same :class:`ClassQueue` policy object
the real ``DecodeEngine`` uses: interactive-first admission, FIFO within
a class, aging promotion (shielded from re-preemption), and
youngest-lowest-class preemption where the victim re-queues with its
generated text as the forced prefix. Token text stays a deterministic
function of (prompt, index), so a preempted stream that resumes with any
token dropped, duplicated or reordered is a hard string mismatch.

Used by ``tests/test_torch_scaleout.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.chaos.scaleout import (ScaleoutHarness,
                                             StubDecodeEngine, StubLM,
                                             _StubReq, stub_completion)
from rafiki_tpu_torch.serving.predictor import nearest_rank
from rafiki_tpu_torch.serving.slo import (ClassQueue, normalize_slo,
                                          preemption_victim)


class _SloReq(_StubReq):
    __slots__ = ("slo", "seq", "shielded")

    def __init__(self, rid: Any, prompt: str, start: int, budget: int,
                 prefix: str) -> None:
        super().__init__(rid, prompt, start, budget, prefix)
        self.slo = "interactive"
        self.seq = 0
        self.shielded = False


class SloStubEngine(StubDecodeEngine):
    """Class-aware stub engine: the real SLO admission policy over the
    scaleout capacity model. Single-threaded by contract like its
    parent, so the (caller-locked) :class:`ClassQueue` needs no lock
    here either."""

    supports_slo = True

    def __init__(self, max_slots: int = 8, max_new: int = 16,
                 base_step_s: float = 0.002,
                 per_req_step_s: float = 0.002,
                 aging_skips: int = ClassQueue.DEFAULT_AGING_SKIPS
                 ) -> None:
        super().__init__(max_slots=max_slots, max_new=max_new,
                         base_step_s=base_step_s,
                         per_req_step_s=per_req_step_s)
        self._cq = ClassQueue(aging_skips=aging_skips)
        self._seq = 0
        for k in ("preemptions", "slo_aged_promotions",
                  "queued_interactive", "queued_batch",
                  "queued_background"):
            self.stats.set(k, 0)

    def submit(self, rid: Any, text: str, max_new: Optional[int] = None,
               forced_prefix: str = "", slo: str = "",
               **_samp: Any) -> None:
        budget = min(int(max_new) if max_new else self.max_new,
                     self.max_new)
        prefix = str(forced_prefix or "")
        start = len(prefix.split()) if prefix else 0
        try:
            cls = normalize_slo(slo)
        except ValueError:
            cls = "interactive"  # worker-defensive, like the real loop
        if start >= budget:
            self._done.append((rid, prefix))
            return
        req = _SloReq(rid, str(text), start, budget, prefix)
        req.slo = cls
        self._seq += 1
        req.seq = self._seq
        self._cq.push(cls, req)

    def _preempt_for(self, cls: str) -> bool:
        """Evict one occupant via the SAME :func:`preemption_victim`
        policy the real engine runs (youngest lowest-class, shielded
        aged-promotions immune); the victim re-queues front-of-class
        with its emitted text as the forced prefix — the stub twin of
        the real engine's token-level preempt-resume. False when no
        victim ranks below ``cls``."""
        victim = preemption_victim(
            cls, [(rid, req.slo, req.seq, req.shielded)
                  for rid, req in self._live.items()])
        if victim is None:
            return False
        req = self._live.pop(victim)
        resumed = _SloReq(req.rid, req.prompt,
                          req.start + req.n_out, req.budget, req.text)
        resumed.slo = req.slo
        resumed.seq = req.seq
        resumed.shielded = req.shielded
        self._cq.push(req.slo, resumed, front=True)
        self.stats.inc("preemptions")
        if self.span_sink:
            self.span_sink("preempted", req.rid,
                           {"slo": req.slo, "by": cls,
                            "tokens": req.start + req.n_out})
        return True

    def _admit_pending(self) -> None:
        while True:
            nxt = self._cq.peek()
            if nxt is None:
                break
            cls, _head = nxt
            if len(self._live) >= self.max_slots and \
                    not self._preempt_for(cls):
                # full and nothing evictable: backpressure, visible on
                # the stall counter the router/autoscaler read
                self.stats.inc("admission_stalls")
                break
            _, req = self._cq.pop()
            if self._cq.last_pop_promoted:
                req.shielded = True  # aging fired: immune to eviction
            self._admit(req)
        for c, d in self._cq.depths().items():
            self.stats.set(f"queued_{c}", d)
        self.stats.set("slo_aged_promotions", self._cq.promotions)
        self._gauge_pages()

    @property
    def busy(self) -> bool:
        return bool(self._live or self._pending or self._cq)

    def reset(self) -> None:
        super().reset()
        self._cq.clear()


class SloStubLM(StubLM):
    """Model shim booting :class:`SloStubEngine` workers."""

    def make_decode_engine(self, max_slots: int = 8,
                           max_new_tokens: int = 16,
                           steps_per_sync: int = 4,
                           **_extra: Any) -> SloStubEngine:
        return SloStubEngine(
            max_slots=max_slots, max_new=max_new_tokens,
            base_step_s=float(self.knobs.get("base_step_s", 0.002)),
            per_req_step_s=float(self.knobs.get("per_req_step_s",
                                                0.002)),
            aging_skips=int(self.knobs.get(
                "aging_skips", ClassQueue.DEFAULT_AGING_SKIPS)))


class SloLoadHarness(ScaleoutHarness):
    """Mixed-traffic drill: real workers + predictor (shed gate,
    brownout ladder) over :class:`SloStubEngine` replicas."""

    MODEL_CLASS = SloStubLM

    def __init__(self, n_workers: int = 1,
                 shed_depths: Optional[Dict[str, int]] = None,
                 brownout_target_p95_s: float = 0.0,
                 brownout_clamp_max_new: int = 4,
                 aging_skips: int = ClassQueue.DEFAULT_AGING_SKIPS,
                 **kw: Any) -> None:
        self._pred_extra = {
            "slo_shed_depths": dict(shed_depths or {}),
            "brownout_target_p95_s": float(brownout_target_p95_s),
            "brownout_clamp_max_new": int(brownout_clamp_max_new)}
        self._aging_skips = int(aging_skips)
        super().__init__(n_workers, **kw)
        # drill-speed brownout ticks: the ladder rides the load
        # refresh, and a drill cannot wait a wall-clock second per tick
        self.pred.LOAD_REFRESH_EVERY_S = min(
            0.2, self.pred.LOAD_REFRESH_EVERY_S)

    def _predictor_kwargs(self) -> Dict[str, Any]:
        return dict(self._pred_extra)

    def _worker_kwargs(self) -> Dict[str, Any]:
        # every boot (initial or scale-up) sees the aging knob: the
        # hook runs before each worker construction
        self.knobs["aging_skips"] = getattr(
            self, "_aging_skips", ClassQueue.DEFAULT_AGING_SKIPS)
        return dict(super()._worker_kwargs())

    def _boot(self, wid: str) -> None:
        super()._boot(wid)
        # drill-speed stats publishes: the shed gate feeds on the
        # workers' published queued_* gauges, and a drill cannot wait
        # the production 50-iteration publish cadence
        self.workers[wid][0].STATS_EVERY = 2

    # ---- per-stream drive with an SLO class ----
    def run_slo_stream(self, prompt: str, slo: str = "interactive",
                       max_new: Optional[int] = None,
                       timeout: float = 60.0) -> Dict[str, Any]:
        """One stream of class ``slo``; verdicts: ``shed`` (structured
        refusal with ``retry_after_s``) or token-exactness of whatever
        was generated (``k`` tokens must be exactly
        ``stub_completion(prompt, k)`` — preemption/clamping may
        shorten a best-effort stream, never corrupt it)."""
        t0 = time.monotonic()
        ttft = None
        acc = ""
        final: Dict[str, Any] = {}
        for ev in self.pred.predict_stream(
                [prompt], timeout=timeout, slo=slo,
                sampling={"max_new": int(max_new)} if max_new else None):
            if "delta" in ev:
                if ttft is None:
                    ttft = time.monotonic() - t0
                acc += "".join(ev["delta"].values())
            elif "replace" in ev:
                acc = "".join(ev["replace"].values())
            if ev.get("done"):
                final = ev
        if final.get("shed"):
            return {"shed": True, "ok": True, "tokens": 0,
                    "ttft_s": None,
                    "retry_after_s": final.get("retry_after_s"),
                    "total_s": time.monotonic() - t0, "slo": slo,
                    "prompt": prompt}
        text = (final.get("predictions") or [""])[0] or ""
        k = len(text.split())
        budget = int(max_new) if max_new else self.max_new
        ok = bool(k >= 1 and k <= budget
                  and text == stub_completion(prompt, k)
                  and acc == text and "error" not in final)
        return {"shed": False, "ok": ok, "tokens": k, "ttft_s": ttft,
                "total_s": time.monotonic() - t0, "slo": slo,
                "error": final.get("error"), "prompt": prompt,
                "text": text}

    def run_mixed(self, spec: Dict[str, Dict[str, Any]],
                  timeout: float = 120.0) -> Dict[str, Dict[str, Any]]:
        """Drive concurrent per-class client pools. ``spec`` maps an
        SLO class to ``{clients, streams, max_new, think_s}``; returns
        per-class aggregates (token-exact verdict, shed count, TTFT
        p50/p95, throughput)."""
        results: Dict[str, List[Dict[str, Any]]] = {c: [] for c in spec}
        lock = threading.Lock()

        def client(cls: str, c: int, cfg: Dict[str, Any]) -> None:
            for k in range(int(cfg.get("streams", 1))):
                prompt = f"{cls} client {c} stream {k} prompt"
                r = self.run_slo_stream(
                    prompt, slo=cls, max_new=cfg.get("max_new"),
                    timeout=timeout)
                with lock:
                    results[cls].append(r)
                think = float(cfg.get("think_s", 0.0))
                if think > 0:
                    time.sleep(think)

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(cls, c, cfg),
                                    daemon=True)
                   for cls, cfg in spec.items()
                   for c in range(int(cfg.get("clients", 1)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout + 30)
        wall = time.monotonic() - t0

        out: Dict[str, Dict[str, Any]] = {}
        for cls, rs in results.items():
            served = [r for r in rs if not r["shed"]]
            ttfts = sorted(r["ttft_s"] for r in served
                           if r["ttft_s"] is not None)
            out[cls] = {
                "streams": len(rs), "served": len(served),
                "shed": sum(1 for r in rs if r["shed"]),
                "shed_with_retry_hint": sum(
                    1 for r in rs if r["shed"]
                    and isinstance(r.get("retry_after_s"),
                                   (int, float))),
                "ok": bool(rs) and all(r["ok"] for r in rs),
                "failures": [r for r in rs if not r["ok"]],
                "tokens": sum(r["tokens"] for r in served),
                "tokens_per_s": (sum(r["tokens"] for r in served)
                                 / wall if wall > 0 else 0.0),
                "ttft_p50_s": nearest_rank(ttfts, 0.50),
                "ttft_p95_s": nearest_rank(ttfts, 0.95)}
        out["_wall_s"] = wall  # type: ignore[assignment]
        return out

    def engine_stats(self) -> Dict[str, Dict[str, Any]]:
        """Live per-worker engine counters (preemptions, queue depths,
        aged promotions) — the drill's policy-level evidence."""
        return {wid: w.engine.stats_snapshot()
                for wid, (w, _th) in self.workers.items()
                if w.engine is not None}


__all__ = ["SloLoadHarness", "SloStubEngine", "SloStubLM"]
