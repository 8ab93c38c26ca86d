"""Deterministic scale-out drill harness: stub engines, real plumbing.

The port's own copy of ``rafiki_tpu/chaos/scaleout.py``:
``stub_tokens``, ``stub_completion``, ``StubDecodeEngine``, ``StubLM``,
``ScaleoutHarness`` and ``shared_prefix_prompts``, over the port's
``InferenceWorker``, ``Predictor`` (its router, breakers and failover)
and ``InProcQueueHub``. The stub engine does no tensor work, so its
workers are booted with ``device="cpu"``.

What the scale-out machinery needs proved is *placement*: streams
spread across the pool, shared prefixes colocate, and membership events
(scale-up, drain-based scale-down, rolling restart) never drop or
duplicate a token. Those are properties of the predictor, router and
worker-loop plumbing, not of matmul throughput, and replicas sharing one
host cannot show throughput scaling with real engines. So the drill runs
the real stack over a **stub decode engine with an explicit capacity
model**: each engine step serves every live slot and costs
``base_step_s + per_req_step_s x live`` wall seconds, so one worker's
token throughput saturates at ``1/per_req_step_s`` and capacity scales
with engines, as it does with separate cards. Token text is a
deterministic function of (prompt, index), so any drop, duplication or
mis-resumed failover is a hard string mismatch.

Used by ``tests/test_torch_scaleout.py``; its numbers measure the
routing and scaling plane, never the kernels.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from rafiki_tpu_torch.obs.metrics import StatsMap
from rafiki_tpu_torch.serving.predictor import Predictor, nearest_rank
from rafiki_tpu_torch.serving.queues import InProcQueueHub
from rafiki_tpu_torch.worker.inference import InferenceWorker


def stub_tokens(prompt: str, n: int) -> List[str]:
    """The deterministic token stream for ``prompt``: worker-independent
    (a failover must continue the same stream), prompt-unique (a stream
    answered with another prompt's tokens is a hard mismatch)."""
    h = hashlib.blake2b(prompt.encode("utf-8", "replace"),
                        digest_size=4).hexdigest()
    return [f"{h}t{i}" for i in range(n)]


def stub_completion(prompt: str, n: int) -> str:
    """The full expected completion text for ``prompt``."""
    return " ".join(stub_tokens(prompt, n))


class _StubReq:
    __slots__ = ("rid", "prompt", "start", "budget", "text", "n_out")

    def __init__(self, rid: Any, prompt: str, start: int, budget: int,
                 prefix: str) -> None:
        self.rid = rid
        self.prompt = prompt
        self.start = start      # first token index still to generate
        self.budget = budget    # total tokens incl. the forced prefix
        self.text = prefix      # accumulates prefix + delta strings
        self.n_out = 0          # tokens generated HERE (not the prefix)


class StubDecodeEngine:
    """Duck-typed decode engine with an explicit capacity model.

    Single-threaded by contract (submit/step/poll all run on the
    worker's serve-loop thread, like the real engine). Implements the
    exact surface ``InferenceWorker._run_decode_loop`` consumes: busy,
    step() → n_live, poll()/poll_partial(), stats (a StatsMap carrying
    the same ``kv_pages_used``/``admission_stalls`` gauges the paged
    engine publishes, so the router/autoscaler see real signals),
    span_sink lifecycle events, ``supports_resume`` + forced_prefix.
    """

    #: fake page accounting: slots-worth of pages so the ratio gauges
    #: behave like a paged pool under load
    PAGES_PER_SLOT = 4

    def __init__(self, max_slots: int = 8, max_new: int = 16,
                 base_step_s: float = 0.002,
                 per_req_step_s: float = 0.002) -> None:
        self.max_slots = int(max_slots)
        self.max_new = int(max_new)
        self.base_step_s = float(base_step_s)
        self.per_req_step_s = float(per_req_step_s)
        self.supports_resume = True
        self.span_sink = None
        self._live: "collections.OrderedDict[Any, _StubReq]" = \
            collections.OrderedDict()
        self._pending: "collections.deque[_StubReq]" = collections.deque()
        self._done: List[Tuple[Any, str]] = []
        self._partial: List[Tuple[Any, str]] = []
        self._pages_total = self.max_slots * self.PAGES_PER_SLOT
        self.stats = StatsMap({
            "tokens_generated": 0, "requests_done": 0, "steps": 0,
            "admission_stalls": 0, "max_concurrent": 0,
            "kv_pages_used": 0, "kv_pages_total": self._pages_total})

    # ---- the worker-loop surface ----
    @property
    def busy(self) -> bool:
        return bool(self._live or self._pending)

    def submit(self, rid: Any, text: str, max_new: Optional[int] = None,
               forced_prefix: str = "", **_samp: Any) -> None:
        budget = min(int(max_new) if max_new else self.max_new,
                     self.max_new)
        prefix = str(forced_prefix or "")
        start = len(prefix.split()) if prefix else 0
        req = _StubReq(rid, str(text), start, budget, prefix)
        if start >= budget:
            # the forced prefix already covers the whole budget: the
            # instant-done path (mirrors TextDecodeEngine)
            self._done.append((rid, prefix))
            return
        if len(self._live) < self.max_slots:
            self._admit(req)
        else:
            self.stats.inc("admission_stalls")
            self._pending.append(req)
        self._gauge_pages()

    def _admit(self, req: _StubReq) -> None:
        self._live[req.rid] = req
        if self.span_sink:
            self.span_sink("admitted", req.rid, {})

    def _gauge_pages(self) -> None:
        self.stats.set("kv_pages_used",
                       len(self._live) * self.PAGES_PER_SLOT)
        self.stats.max_set("max_concurrent", len(self._live))

    def _admit_pending(self) -> None:
        """Move queued requests into free slots (subclass hook: the
        SLO stub engine replaces the plain FIFO with the shared
        class-queue + preemption policy)."""
        while self._pending and len(self._live) < self.max_slots:
            self._admit(self._pending.popleft())

    def step(self) -> int:
        self._admit_pending()
        n = len(self._live)
        if n == 0:
            self._gauge_pages()
            return 0
        # THE capacity model: one fused step serves every live slot and
        # costs launch overhead + per-request service time — throughput
        # saturates at 1/per_req_step_s tokens/s per engine
        time.sleep(self.base_step_s + self.per_req_step_s * n)
        for rid, req in list(self._live.items()):
            i = req.start + req.n_out
            tok = stub_tokens(req.prompt, req.budget)[i]
            delta = tok if i == 0 else " " + tok
            req.text += delta
            req.n_out += 1
            self._partial.append((rid, delta))
            self.stats.inc("tokens_generated")
            if self.span_sink and i == 0:
                self.span_sink("first_token", rid, {})
            if req.start + req.n_out >= req.budget:
                del self._live[rid]
                self._done.append((rid, req.text))
                self.stats.inc("requests_done")
                if self.span_sink:
                    self.span_sink("done", rid, {"tokens": req.n_out})
        self.stats.inc("steps")
        self._gauge_pages()
        return n

    def poll(self) -> List[Tuple[Any, str]]:
        out, self._done = self._done, []
        return out

    def poll_partial(self) -> List[Tuple[Any, str]]:
        out, self._partial = self._partial, []
        return out

    def reset(self) -> None:
        self._live.clear()
        self._pending.clear()
        self._done.clear()
        self._partial.clear()
        self._gauge_pages()

    def reset_stats(self) -> None:
        """Post-warmup scrub: zero the traffic counters AND drop the
        warmup dummy's buffered deltas — its plain-string rid must
        never reach the serve loop's ``(mid, qi)`` unpack."""
        self._partial.clear()
        self.stats.reset(keep={"kv_pages_total": self._pages_total})

    def stats_snapshot(self) -> Dict[str, Any]:
        return self.stats.snapshot()


class StubLM:
    """Model-shaped shim so a real :class:`InferenceWorker` (serve
    loop, drain, stats publish, spans) can run a stub engine."""

    def __init__(self, device: Any = None, **knobs: Any) -> None:
        self.knobs = dict(knobs)

    def load_parameters(self, _params: Any) -> None:
        pass

    def make_decode_engine(self, max_slots: int = 8,
                           max_new_tokens: int = 16,
                           steps_per_sync: int = 4,
                           **_extra: Any) -> StubDecodeEngine:
        return StubDecodeEngine(
            max_slots=max_slots, max_new=max_new_tokens,
            base_step_s=float(self.knobs.get("base_step_s", 0.002)),
            per_req_step_s=float(self.knobs.get("per_req_step_s",
                                                0.002)))


class ScaleoutHarness:
    """N real worker serve-loops over stub engines + one predictor with
    the affinity router, driven through membership events.

    Subclass hooks (the SLO overload harness rides them): ``MODEL_CLASS``
    picks the stub model every booted worker serves;
    ``_predictor_kwargs``/``_worker_kwargs`` extend the predictor /
    worker constructions."""

    MODEL_CLASS = StubLM

    def _predictor_kwargs(self) -> Dict[str, Any]:
        return {}

    def _worker_kwargs(self) -> Dict[str, Any]:
        return {}

    def __init__(self, n_workers: int, max_slots: int = 8,
                 max_new: int = 16, base_step_s: float = 0.002,
                 per_req_step_s: float = 0.002,
                 pool_id: str = "drill",
                 stream_silence_timeout_s: float = 5.0,
                 pool_refresh_every_s: float = 0.1) -> None:
        from rafiki_tpu_torch.store.param_store import ParamStore

        self.hub = InProcQueueHub()
        self.store = ParamStore.from_uri("mem://")
        self.store.save("stub", {})
        self.knobs = {"base_step_s": base_step_s,
                      "per_req_step_s": per_req_step_s}
        self.max_slots = max_slots
        self.max_new = max_new
        self.pool_id = pool_id
        self._version = 0.0
        self.workers: Dict[str, Tuple[InferenceWorker,
                                      threading.Thread]] = {}
        self._next = 0
        for _ in range(n_workers):
            self.add_worker(publish=False)
        self.pred = Predictor(
            self.hub, list(self.workers), gather_timeout=30.0,
            stream_silence_timeout_s=stream_silence_timeout_s,
            breaker_fail_threshold=3, pool_id=pool_id,
            **self._predictor_kwargs())
        # drill-speed refresh cadences (instance overrides of the
        # rate-limit floors; production keeps the class defaults)
        self.pred.POOL_REFRESH_EVERY_S = pool_refresh_every_s
        self.pred.LOAD_REFRESH_EVERY_S = pool_refresh_every_s
        self.publish()

    # ---- membership events ----
    def _boot(self, wid: str) -> None:
        w = InferenceWorker(self.MODEL_CLASS, "stub", self.knobs,
                            self.store, self.hub, wid,
                            decode_loop=True,
                            max_slots=self.max_slots,
                            max_new_tokens=self.max_new,
                            device="cpu", **self._worker_kwargs())
        th = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.02},
                              daemon=True)
        th.start()
        self.workers[wid] = (w, th)

    def add_worker(self, publish: bool = True) -> str:
        """Scale-up: boot a fresh replica, then publish membership (the
        manager's warm-then-publish order)."""
        wid = f"sw-{self._next}"
        self._next += 1
        self._boot(wid)
        if publish:
            self.publish()
        return wid

    def drain_worker(self, wid: str, keep_in_pool: bool = False,
                     timeout: float = 30.0) -> None:
        """Scale-down (membership first, then graceful drain) or — with
        ``keep_in_pool`` — the drain half of a rolling restart."""
        w, th = self.workers.pop(wid)
        if not keep_in_pool:
            self.publish()
        w.drain()
        th.join(timeout=timeout)
        if th.is_alive():
            raise RuntimeError(f"worker {wid} did not drain")

    def rolling_restart(self, timeout: float = 30.0) -> None:
        """Drain → replace each worker one at a time under the SAME
        worker id (membership unchanged; the predictor re-admits each
        replacement from its fresh published stats)."""
        for wid in list(self.workers):
            self.drain_worker(wid, keep_in_pool=True, timeout=timeout)
            self._boot(wid)

    def publish(self) -> None:
        self._version = max(time.time(), self._version + 1e-4)
        self.hub.put_pool_members(self.pool_id, {
            "workers": list(self.workers), "version": self._version})

    def stop(self) -> None:
        for wid, (w, th) in list(self.workers.items()):
            w.stop()
            th.join(timeout=10)
        self.workers.clear()

    # ---- load driving / measurement ----
    def run_stream(self, prompt: str, timeout: float = 60.0
                   ) -> Dict[str, Any]:
        t0 = time.monotonic()
        ttft = None
        acc = ""
        final: Dict[str, Any] = {}
        for ev in self.pred.predict_stream([prompt], timeout=timeout):
            if "delta" in ev:
                if ttft is None:
                    ttft = time.monotonic() - t0
                acc += "".join(ev["delta"].values())
            elif "replace" in ev:
                acc = "".join(ev["replace"].values())
            if ev.get("done"):
                final = ev
        text = (final.get("predictions") or [""])[0] or ""
        expected = stub_completion(prompt, self.max_new)
        return {"ok": bool(text == expected == acc
                           and "error" not in final),
                "tokens": len(text.split()), "ttft_s": ttft,
                "total_s": time.monotonic() - t0,
                "failovers": (final.get("info") or {}).get("failovers",
                                                           0),
                "error": final.get("error"), "prompt": prompt}

    def run_load(self, prompts: Sequence[str], n_clients: int,
                 streams_per_client: int, timeout: float = 120.0,
                 on_half_done: Optional[Any] = None) -> Dict[str, Any]:
        """Drive ``n_clients`` concurrent stream clients round-robin
        over ``prompts``; returns aggregate throughput/latency plus the
        per-stream token-exactness verdict. ``on_half_done`` (a
        callable) fires once when half the streams completed — the hook
        the membership-cycle drill injects its events through."""
        results: List[Dict[str, Any]] = []
        lock = threading.Lock()
        fired = threading.Event()
        total = n_clients * streams_per_client

        def client(c: int) -> None:
            for k in range(streams_per_client):
                prompt = prompts[(c + k * n_clients) % len(prompts)]
                r = self.run_stream(prompt, timeout=timeout)
                with lock:
                    results.append(r)
                    half = len(results) >= total // 2
                if on_half_done is not None and half and \
                        not fired.is_set():
                    fired.set()
                    on_half_done()

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,),
                                    daemon=True)
                   for c in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout + 30)
        wall = time.monotonic() - t0
        ttfts = sorted(r["ttft_s"] for r in results
                       if r["ttft_s"] is not None)
        return {"streams": len(results),
                "ok": all(r["ok"] for r in results) and bool(results),
                "failures": [r for r in results if not r["ok"]],
                "tokens": sum(r["tokens"] for r in results),
                "tokens_per_s": (sum(r["tokens"] for r in results)
                                 / wall if wall > 0 else 0.0),
                "ttft_p50_s": nearest_rank(ttfts, 0.50),
                "ttft_p95_s": nearest_rank(ttfts, 0.95),
                "failovers": sum(int(r["failovers"] or 0)
                                 for r in results),
                "wall_s": wall}


def shared_prefix_prompts(n_groups: int, per_group: int,
                          prefix_chars: int = 64) -> List[str]:
    """Prompts in ``n_groups`` shared-prefix families, each prefix
    longer than the router's affinity key so every family maps to ONE
    key (the shared-system-prompt traffic shape)."""
    out = []
    for g in range(n_groups):
        prefix = f"sys{g:02d}-" * (prefix_chars // 6 + 2)
        for j in range(per_group):
            out.append(f"{prefix} user question {j}")
    return out
