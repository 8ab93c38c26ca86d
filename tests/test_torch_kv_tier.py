"""Port parity: the host KV page tier and disaggregated prefill/decode of
``rafiki_tpu_torch`` against the JAX package's (``tests/test_kv_tier.py``).

(1) The tier: a paged engine with a tiny pool plus ``host_kv_pages`` parks
cold slots, evicts their pages to the host and brings them back, and must
emit the tokens of an untiered engine with a big pool — the JAX engine's
tokens, in every decode mode (greedy, sampled, int8 KV, multi-adapter,
prompt-lookup and draft-model speculation) — with the JAX tiered engine's
policy counters. (2) The prefill/decode split: a prefill-only engine ships
a slot's KV as a wire blob, a decode engine installs it and must produce
the locally prefilled stream; blobs cross between the packages through
both param-store codecs, at depth 12 (the layers of a blob lie in
``jax.tree_util``'s lexicographic order). (3) The workers: a prefill and a
decode port worker behind the port's Predictor stream the unified
worker's texts; a dropped, late or never-computed shipment degrades to a
local re-prefill. The worker cases wait on counters and events, never on
a wall-clock window, and every wait has its own deadline.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.llama_lora import \
    stack_lora_adapters as jstack_lora_adapters
from rafiki_tpu.serving import kv_transfer as jkvt
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu.serving.kv_tier import HostPageTier as JHostPageTier
from rafiki_tpu.serving.queues import pack_message as jpack
from rafiki_tpu.serving.queues import unpack_message as junpack
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA, stack_lora_adapters
from rafiki_tpu_torch.serving import kv_transfer as kvt
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine
from rafiki_tpu_torch.serving.kv_tier import HostPageTier
from rafiki_tpu_torch.serving.queues import pack_message, unpack_message
from rafiki_tpu_torch.store.params import llama_params_from_jax

from test_decode_engine import KNOBS
from test_multi_adapter import _lora_variant

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
PS = 8  # page size throughout (divides max_len 32)
#: the tiered geometry of the JAX tests: 6 pool pages = 5 usable (page 0
#: is scratch), far below the traffic's reservations, plus a host tier
TIER_KW = (PS, 6)
HOST_PAGES = 24
BIG = (PS, 33)
#: the policy counters the JAX tests read, which the port's tiered engine
#: must share with the JAX tiered engine (prefetch hits and misses split
#: by the transfer thread's timing; their sum is the installs)
TIER_STATS = ("steps", "tokens_generated", "requests_done", "prefill_calls",
              "prefill_tokens", "kv_pages_used", "kv_host_pages_used",
              "kv_host_pages_total", "kv_evictions_total",
              "kv_parked_slots", "kv_unparks_total", "max_concurrent",
              "admission_stalls", "preemptions", "spec_calls",
              "spec_accepted")


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


def _mixed_reqs(n=8, seed=0, max_new=6, vocab=64):
    rng = np.random.default_rng(seed)
    return [(r, rng.integers(1, vocab,
                             size=int(rng.integers(2, 15))
                             ).astype(np.int32), max_new)
            for r in range(n)]


def _drain(eng, reqs, submit_kw=None, budget=600):
    for i, (rid, p, mn) in enumerate(reqs):
        eng.submit(rid, p, mn, **(submit_kw(i) if submit_kw else {}))
    done = {}
    for _ in range(budget):
        eng.step()
        done.update({rid: [int(t) for t in ids] for rid, ids in eng.poll()})
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"undrained: {sorted(done)} / {dict(eng.stats)}")


def _engines(trained_lm, port_lm, layout, host=0, trees=None, **kw):
    """A JAX and a port core engine over the same weights: ``layout``
    (page, pages), ``host`` host pages; ``trees`` builds multi-adapter
    engines over the stacked trees."""
    page, pages = layout
    jkw = dict(kw, host_kv_pages=host)
    pkw = dict(kw, host_kv_pages=host, device="cpu")
    if "draft" in kw:
        jkw["draft"], pkw["draft"] = kw["draft"]
    if trees is not None:
        jmod = trained_lm._module(n_adapters=len(trees), kv_page_size=page,
                                  kv_pages=pages)
        jeng = JaxDecodeEngine(jmod, jstack_lora_adapters(list(trees)),
                               max_len=L, **jkw)
        pmodel = port_lm._module(n_adapters=len(trees))
        pmodel.load_state_dict(llama_params_from_jax(
            stack_lora_adapters(list(trees)), pmodel.dtype))
        return jeng, DecodeEngine(pmodel.with_kv_layout(page, pages),
                                  max_len=L, **pkw)
    jmod = (trained_lm._module(kv_page_size=page, kv_pages=pages) if page
            else trained_lm._module())
    return (JaxDecodeEngine(jmod, trained_lm._params, max_len=L, **jkw),
            DecodeEngine(port_lm._serving_module_params(page, pages),
                         max_len=L, **pkw))


def _tier_case(trained_lm, port_lm, reqs, submit_kw=None, **kw):
    """Big-pool untiered JAX tokens, tiny-pool tiered port and JAX tokens:
    all equal; the port's policy counters equal the JAX tiered engine's,
    every page recycled. Returns the port's tiered engine's stats."""
    want = _drain(_engines(trained_lm, port_lm, BIG, max_slots=4, **kw)[0],
                  reqs, submit_kw)
    jeng, teng = _engines(trained_lm, port_lm, TIER_KW, host=HOST_PAGES,
                          max_slots=4, **kw)
    try:
        jgot = _drain(jeng, reqs, submit_kw)
        got = _drain(teng, reqs, submit_kw)
        js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    finally:
        jeng.close()
        teng.close()
    assert jgot == want
    assert got == want, {k: (got.get(k), want[k]) for k in want
                         if got.get(k) != want[k]}
    assert {k: ts[k] for k in TIER_STATS} == {k: js[k] for k in TIER_STATS}
    assert ts["kv_prefetch_hits"] + ts["kv_prefetch_misses"] == \
        js["kv_prefetch_hits"] + js["kv_prefetch_misses"]
    assert ts["kv_pages_used"] == 0 and ts["kv_host_pages_used"] == 0
    assert ts["kv_parked_slots"] == 0
    assert sorted(teng._free_pages) == list(range(1, TIER_KW[1]))
    return ts


# ---- eviction -> prefetch round trip, per decode mode

def test_tiered_matches_untiered_greedy(trained_lm, port_lm):
    """10 mixed greedy requests through 5 usable pool pages: the tier
    engages (evictions, parks, unparks) and every output is the untiered
    engine's."""
    ts = _tier_case(trained_lm, port_lm, _mixed_reqs(10))
    assert ts["kv_evictions_total"] > 0 and ts["kv_unparks_total"] > 0
    assert ts["kv_prefetch_hits"] + ts["kv_prefetch_misses"] > 0
    assert ts["kv_transfer_bytes_total"] > 0


def test_tiered_sampled_parity(trained_lm, port_lm):
    """A sampled draw is a function of (seed, position): park/unpark
    replays nothing, so sampled streams mixed with greedy ones stay
    exact."""

    def samp(i):
        return {} if i % 2 == 0 else {"temperature": 0.9, "top_k": 8,
                                      "top_p": 0.95, "seed": 100 + i}

    ts = _tier_case(trained_lm, port_lm, _mixed_reqs(8, seed=1), samp)
    assert ts["kv_evictions_total"] > 0


def test_tiered_int8_kv_parity(trained_lm):
    """int8 pools and their f32 scale rows evict and come back together
    (every cache leaf alike)."""
    knobs = dict(KNOBS, kv_cache_int8=True)
    dump = trained_lm.dump_parameters()
    jm, pm = JLlamaLoRA(**knobs), LlamaLoRA(device="cpu", **knobs)
    jm.load_parameters(dump)
    pm.load_parameters(dump)
    ts = _tier_case(jm, pm, _mixed_reqs(8, seed=2))
    assert ts["kv_evictions_total"] > 0


def test_tiered_multi_adapter_parity(trained_lm, port_lm):
    """Mixed-adapter traffic over one tiered pool: parking one tenant's
    slot does not perturb another's stream."""
    trees = [jax.tree_util.tree_map(np.asarray, t) for t in
             (trained_lm._params, _lora_variant(trained_lm._params))]
    _tier_case(trained_lm, port_lm, _mixed_reqs(8, seed=4),
               lambda i: {"adapter_id": i % 2}, trees=trees)


SPEC_REQS = [(0, np.asarray([1, 7, 2, 7, 2, 7, 2], np.int32), 8),
             (1, np.asarray([1, 5, 9, 13], np.int32), 8),
             (2, np.asarray([1, 3], np.int32), 8),
             (3, np.asarray([2, 4, 6, 8, 10], np.int32), 8),
             (4, np.asarray([1, 5, 9, 13, 2, 4], np.int32), 8)]


def test_tiered_speculative_parity(trained_lm, port_lm):
    """Prompt-lookup speculation over the tier: the verify window's pages
    ride the same reservations, and park/unpark stays lossless."""
    ts = _tier_case(trained_lm, port_lm, SPEC_REQS, speculate_k=4)
    assert ts["spec_calls"] > 0 and ts["kv_evictions_total"] > 0


def test_tiered_draft_model_parity(trained_lm, port_lm):
    """Draft-model speculation over the tier: a park empties the lane the
    draft's cache mirrors, so the engine marks the draft out of sync and
    rebuilds it from the accepted contexts before the next speculative
    call (``draft_resyncs``); the tokens stay the untiered engine's."""
    jd = JLlamaLoRA(**KNOBS)
    jd.load_parameters(trained_lm.dump_parameters())
    draft = ((jd._module(), jd._params),
             port_lm._serving_module_params(0, 0))
    ts = _tier_case(trained_lm, port_lm, SPEC_REQS, speculate_k=4,
                    draft=draft)
    assert ts["spec_draft_model_calls"] > 0 and ts["draft_resyncs"] > 0
    assert ts["kv_evictions_total"] > 0


# ---- two-tier admission

def test_two_tier_admission_admits_beyond_hbm(trained_lm, port_lm):
    """4 requests whose reservations (2 pages each) exceed the 5-page
    pool alone: the untiered engine stalls and serializes; the tiered one
    admits all 4 at once against pool + host pages, token-exact."""
    reqs = [(r, np.asarray([1 + r, 5, 9, 13, 2, 6], np.int32), 8)
            for r in range(4)]
    jonly, ponly = _engines(trained_lm, port_lm, TIER_KW, max_slots=4)
    want = _drain(jonly, reqs)
    assert _drain(ponly, reqs) == want
    assert ponly.stats["admission_stalls"] == \
        jonly.stats["admission_stalls"] > 0
    assert ponly.stats["max_concurrent"] < 4
    jeng, teng = _engines(trained_lm, port_lm, TIER_KW, host=HOST_PAGES,
                          max_slots=4)
    try:
        assert _drain(jeng, reqs) == want
        assert _drain(teng, reqs) == want
    finally:
        jeng.close()
        teng.close()
    assert teng.stats["admission_stalls"] == 0, dict(teng.stats)
    assert teng.stats["max_concurrent"] == jeng.stats["max_concurrent"] == 4


def test_tier_requires_paged_engine(trained_lm, port_lm):
    """The JAX package's refusals, with its messages."""
    with pytest.raises(ValueError, match="paged") as want:
        JaxDecodeEngine(trained_lm._module(), trained_lm._params,
                        max_slots=2, max_len=L, host_kv_pages=8)
    with pytest.raises(ValueError) as got:
        DecodeEngine(port_lm._serving_module_params(), max_slots=2,
                     max_len=L, host_kv_pages=8, device="cpu")
    assert str(got.value) == str(want.value)
    for lm in (trained_lm, port_lm):
        with pytest.raises(ValueError, match="host_kv_pages"):
            lm.make_decode_engine(host_kv_pages=8)
        with pytest.raises(ValueError, match="host_kv_pages"):
            lm.estimate_serving_device_bytes(host_kv_pages=8)


def test_template_engine_with_host_pages_equals_jax(trained_lm, port_lm):
    """``make_decode_engine(host_kv_pages=)`` through the template: the
    JAX template's texts and tier counters on the same traffic."""
    texts = {i: " ".join(f"tok{(i * 7 + j) % 40}" for j in range(3 + i))
             for i in range(8)}
    outs = []
    for lm in (trained_lm, port_lm):
        eng = lm.make_decode_engine(max_slots=4, max_new_tokens=8,
                                    kv_page_size=PS, kv_pages=6,
                                    host_kv_pages=HOST_PAGES)
        try:
            for rid, text in texts.items():
                eng.submit(rid, text)
            done = {}
            for _ in range(600):
                eng.step()
                done.update(dict(eng.poll()))
                if not eng.busy:
                    break
            st = eng.stats_snapshot()
        finally:
            eng.close()
        outs.append((done, {k: st[k] for k in (
            "kv_evictions_total", "kv_unparks_total", "kv_host_pages_total",
            "max_concurrent", "admission_stalls")}))
    assert outs[1] == outs[0]
    assert outs[1][1]["kv_evictions_total"] > 0 and len(outs[1][0]) == 8


def test_estimator_reports_host_tier_outside_hbm_total(trained_lm, port_lm):
    """The host tier's bytes are host memory, outside the card's total;
    the port's ``host_kv_cache`` equals JAX's."""
    for kw in (dict(kv_page_size=PS, kv_pages=9),
               dict(kv_page_size=4, kv_pages=0, max_slots=3)):
        base = port_lm.estimate_serving_device_bytes(**kw)
        tiered = port_lm.estimate_serving_device_bytes(host_kv_pages=16,
                                                       **kw)
        want = trained_lm.estimate_serving_device_bytes(host_kv_pages=16,
                                                        **kw)
        assert tiered["total"] == base["total"]
        assert tiered["host_kv_cache"] == want["host_kv_cache"] > 0


# ---- HostPageTier, the mechanism (no model)

class _Stats(dict):
    def set(self, k, v):
        self[k] = v

    def inc(self, k, n=1):
        self[k] = self.get(k, 0) + n
        return self[k]


def _wait(pred, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _both(n):
    """A JAX and a port tier of ``n`` pages."""
    return JHostPageTier(n, _Stats()), HostPageTier(n, _Stats())


def test_host_tier_tail_first_evictions_form_one_run():
    """The engine evicts a parked slot's pages one at a time, tail first:
    the port's allocator gives each a lower id than the last, so the
    slot's host pages in logical order are one run (one copy per leaf
    when they come back), and they come back in that order."""
    from rafiki_tpu_torch.serving.kv_tier import _runs

    tier = HostPageTier(8, _Stats())
    try:
        pages = [np.full((1, 2), t, np.float32) for t in range(5)]
        ids = {}
        for t in reversed(range(5)):
            (ids[t],) = tier.alloc(1)
            tier.evict_submit([ids[t]], [pages[t]])
        logical = [ids[t] for t in range(5)]
        assert len(_runs(logical)) == 1
        got = tier.fetch(logical)[0]
        assert np.array_equal(np.asarray(got),
                              np.concatenate(pages))
        tier.free(logical)
        assert tier.alloc(2) == [logical[-2], logical[-1]]
    finally:
        tier.close()


def test_host_tier_evict_fetch_roundtrip():
    """Bytes an eviction wrote come back exactly from fetch(), which waits
    for the pending write; the port's tier returns the JAX tier's."""
    leaves = [np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4),
              np.ones((2, 3), np.int8)]
    for tier in _both(4):
        try:
            ids = tier.alloc(2)
            # JAX hands out the lowest ids first, the port the highest
            # (ascending), so a slot evicted tail first lands in runs
            assert ids == ([2, 3] if isinstance(tier, HostPageTier)
                           else [0, 1])
            tier.evict_submit(ids, [a.copy() for a in leaves])
            got = tier.fetch(ids)
            for g, want in zip(got, leaves):
                assert np.array_equal(np.asarray(g), want)
                assert str(np.asarray(g).dtype) == str(want.dtype)
            tier.free(ids)
            assert tier.free_pages() == 4
            assert tier.alloc(5) is None  # refuses, never corrupts
            assert tier.stats["kv_evictions_total"] == 2
        finally:
            tier.close()


def test_host_tier_prefetch_staging():
    """A prefetch stages leaves the consumer takes exactly once; a staging
    for another id set reads as a miss."""
    for tier in _both(4):
        try:
            ids = tier.alloc(2)
            leaves = [np.full((2, 4), 7.5, np.float32)]
            tier.evict_submit(ids, leaves)
            tier.prefetch_submit("k1", ids)
            assert _wait(lambda: tier._staged.get("k1") is not None
                         and tier._staged["k1"][2].done.is_set())
            staged = tier.take_staged("k1", ids)
            assert np.array_equal(np.asarray(staged[0]), leaves[0])
            assert tier.take_staged("k1", ids) is None  # consumed once
            tier.prefetch_submit("k2", ids)
            assert _wait(lambda: not tier._q
                         and tier._staged.get("k2") is not None)
            assert tier.take_staged("k2", [ids[0]]) is None  # wrong ids
        finally:
            tier.close()


class _FlakyLeaf:
    """An array stand-in whose materialization fails the first
    ``fail_times`` attempts: the transient copy failure the tier must
    never turn into silently garbage KV."""

    def __init__(self, arr, fail_times=1):
        self._arr = arr
        self.fails = int(fail_times)
        self.dtype = arr.dtype
        self.shape = arr.shape
        self.nbytes = arr.nbytes

    def __array__(self, dtype=None, copy=None):
        if self.fails > 0:
            self.fails -= 1
            raise RuntimeError("transient copy failure (injected)")
        return self._arr


def test_host_tier_failed_evict_recovers_on_fetch():
    """A failed eviction is retried by fetch() from the retained payload,
    or raises while it keeps failing; never served from the unwritten
    pool rows."""
    want = np.full((1, 3, 4), 5.0, np.float32)
    for tier in _both(4):
        try:
            ids = tier.alloc(1)
            tier.evict_submit(ids, [_FlakyLeaf(want.copy(), fail_times=1)])
            assert np.array_equal(np.asarray(tier.fetch(ids)[0]), want)
            ids2 = tier.alloc(1)
            tier.evict_submit(ids2, [_FlakyLeaf(want.copy(),
                                                fail_times=2)])
            with pytest.raises(RuntimeError):
                tier.fetch(ids2)
            assert np.array_equal(np.asarray(tier.fetch(ids2)[0]), want)
        finally:
            tier.close()


class _GatedLeaf:
    """An array stand-in whose materialization waits for ``gate``: holds
    the transfer thread busy so later tickets stay queued (an event, not
    a sleep)."""

    def __init__(self, arr, gate):
        self._arr = arr
        self._gate = gate
        self.dtype = arr.dtype
        self.shape = arr.shape
        self.nbytes = arr.nbytes

    def __array__(self, dtype=None, copy=None):
        assert self._gate.wait(10.0)
        return self._arr


def test_host_tier_stale_prefetch_never_stores():
    """A prefetch whose park key died before the transfer thread reached
    it must not store under the dead key (keys are never reused, so the
    staged leaves would be held forever)."""
    arr = np.ones((1, 2), np.float32)
    for tier in _both(4):
        gate = threading.Event()
        try:
            ids = tier.alloc(1)
            tier.evict_submit(ids, [_GatedLeaf(arr, gate)])  # busy thread
            tier.prefetch_submit("k", ids)   # queued behind the evict
            tier.drop_staged("k")            # the park dies first
            gate.set()
            assert _wait(lambda: not tier._q)
            assert np.array_equal(np.asarray(tier.fetch(ids)[0]), arr)
            assert _wait(lambda: tier._thread.is_alive() and not tier._q)
            assert "k" not in tier._staged   # no orphan staging
        finally:
            gate.set()
            tier.close()


def test_host_tier_submit_after_close_never_hangs():
    """An eviction submitted after close() has no consumer: it resolves
    through the failed-ticket recovery instead of stranding fetch()."""
    want = np.full((1, 2), 3.0, np.float32)
    for tier in _both(4):
        ids = tier.alloc(1)
        tier.close()
        tier.evict_submit(ids, [want.copy()])
        assert np.array_equal(np.asarray(tier.fetch(ids)[0]), want)


def test_host_tier_evict_releases_device_payload():
    """A completed eviction drops its gathered leaves (the writers map
    keeps the ticket until the pages free; holding the payload would pin
    every evicted page's bytes on the device)."""
    for tier in _both(4):
        try:
            ids = tier.alloc(1)
            tier.evict_submit(ids, [np.ones((1, 2), np.float32)])
            t = tier._writers[ids[0]]
            assert t.done.wait(10.0)
            assert t.payload is None and not t.failed
        finally:
            tier.close()


# ---- KV shipment blobs

def test_kv_blob_validation_rejects_mismatches():
    """Every refusal of the JAX validator, with its message, on the JAX
    blob and on the port's (whose bf16-free leaves are the same numpy
    arrays)."""
    leaves = [np.zeros((2, PS, 2, 4), np.float32)]
    ok = dict(layout="paged", page_size=PS,
              expect_sig=[[[PS, 2, 4], "float32"]], prompt_len=12,
              expect_leading=2)
    jblob = jkvt.make_kv_blob(10, "paged", PS, leaves, adapter_id=0)
    pblob = kvt.make_kv_blob(10, "paged", PS, leaves, adapter_id=0)
    assert {k: v for k, v in pblob.items() if k != "leaves"} == \
        {k: v for k, v in jblob.items() if k != "leaves"}
    assert kvt.check_kv_blob(dict(pblob), **ok) is not None
    mutations = [({"v": 99}, "version"), ({"layout": "rows"}, "layout"),
                 ({"page_size": 4}, "page_size"),
                 ({"adapter_id": 1}, "adapter"), ({"covered": 12}, "covers"),
                 ({"sig": [[[PS, 2, 8], "float32"]]}, "signature"),
                 ({"leaves": []}, "truncated"),
                 ({"leaves": [np.zeros((2, PS, 2, 4), np.int8)]}, "corrupt"),
                 ({"leaves": "x"}, "no leaves")]
    for mutate, match in mutations:
        with pytest.raises(ValueError, match=match) as want:
            jkvt.check_kv_blob({**jblob, **mutate}, **ok)
        with pytest.raises(ValueError) as got:
            kvt.check_kv_blob({**pblob, **mutate}, **ok)
        assert str(got.value) == str(want.value)
    for bad in ([1], None):
        with pytest.raises(ValueError, match="mapping"):
            kvt.check_kv_blob(bad, **ok)
    with pytest.raises(ValueError, match="pages/rows"):
        kvt.check_kv_blob(dict(pblob), **{**ok, "expect_leading": 3})
    with pytest.raises(ValueError, match="layout"):
        kvt.make_kv_blob(1, "ragged", PS, leaves)
    # a bf16 leaf is named as numpy names it, whatever carries it
    t = torch.zeros((1, PS, 2, 4), dtype=torch.bfloat16)
    assert kvt.make_kv_blob(3, "paged", PS, [t])["sig"] == \
        [[[PS, 2, 4], "bfloat16"]]


@pytest.mark.parametrize("value", [None, "", " Decode ", "prefill",
                                   "UNIFIED", "prefil", "decoder"])
def test_normalize_role(value):
    try:
        want = jkvt.normalize_role(value)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown worker role") as got:
            kvt.normalize_role(value)
        assert str(got.value) == str(e)
    else:
        assert kvt.normalize_role(value) == want


# ---- disaggregated prefill -> decode (engine level)

def _prefill_ship(pre, reqs, adapter_kw=None, budget=300):
    for i, (rid, p, mn) in enumerate(reqs):
        pre.submit(rid, p, mn, prefill_only=True,
                   **(adapter_kw(i) if adapter_kw else {}))
    blobs = {}
    for _ in range(budget):
        pre.step()
        blobs.update(dict(pre.poll_kv()))
        if len(blobs) == len(reqs):
            return blobs
    raise AssertionError(f"unshipped: {sorted(blobs)}")


@pytest.mark.parametrize("layout", ["paged", "rows"])
def test_disagg_ship_install_token_exact(trained_lm, port_lm, layout):
    """A prefill engine ships, a decode engine installs: the locally
    prefilled (JAX) streams, pages recycled on both sides, no token
    generated by the prefill engine; the port's blobs equal the JAX
    engine's, leaf for leaf."""
    reqs = _mixed_reqs(6, seed=5)
    lay = BIG if layout == "paged" else (0, 0)
    want = _drain(_engines(trained_lm, port_lm, lay, max_slots=4)[0], reqs)
    jpre, pre = _engines(trained_lm, port_lm, lay, max_slots=4)
    jblobs = _prefill_ship(jpre, reqs)
    blobs = _prefill_ship(pre, reqs)
    assert not pre.poll(), "prefill role must not generate"
    for rid in jblobs:
        b, jb = blobs[rid], jblobs[rid]
        assert {k: v for k, v in b.items() if k != "leaves"} == \
            {k: v for k, v in jb.items() if k != "leaves"}
        for a, ja in zip(b["leaves"], jb["leaves"]):
            np.testing.assert_allclose(a, np.asarray(ja), rtol=1e-5,
                                       atol=1e-5)
    assert pre.stats["kv_exports"] == jpre.stats["kv_exports"] == len(reqs)
    assert pre.stats["kv_pages_used"] == 0
    dec = _engines(trained_lm, port_lm, lay, max_slots=4)[1]
    got = _drain(dec, reqs, lambda i: {"kv_import": blobs[i]})
    assert got == want
    assert dec.stats["kv_imports"] == len(reqs)
    # the shipment skipped the prefill: only each prompt's last token
    # runs through the decode side's prefill path
    assert dec.stats["prefill_tokens"] < sum(len(p) - 1 for _r, p, _m in
                                             reqs)


def test_disagg_staged_blob_installs(trained_lm, port_lm):
    """``stage_kv_blob`` (the decode worker's upload ahead of admission)
    returns a blob that validates and installs like the host one."""
    reqs = _mixed_reqs(3, seed=9)
    want = _drain(_engines(trained_lm, port_lm, BIG, max_slots=4)[1], reqs)
    pre, dec = (_engines(trained_lm, port_lm, BIG, max_slots=4)[1]
                for _ in range(2))
    blobs = _prefill_ship(pre, reqs)
    staged = {rid: dec.stage_kv_blob(b) for rid, b in blobs.items()}
    assert all(isinstance(v, torch.Tensor) for b in staged.values()
               for v in b["leaves"])
    assert _drain(dec, reqs, lambda i: {"kv_import": staged[i]}) == want


def test_disagg_rejects_wrong_adapter_blob(trained_lm, port_lm):
    """A blob computed under adapter 0 does not install into an adapter-1
    request: submit raises JAX's error and the caller degrades."""
    trees = [jax.tree_util.tree_map(np.asarray, t) for t in
             (trained_lm._params, _lora_variant(trained_lm._params))]
    jeng, pre = _engines(trained_lm, port_lm, BIG, max_slots=4, trees=trees)
    dec = _engines(trained_lm, port_lm, BIG, max_slots=4, trees=trees)[1]
    reqs = _mixed_reqs(1, seed=7)
    rid, prompt, mn = reqs[0]
    jblob = _prefill_ship(jeng, reqs)[rid]
    blob = _prefill_ship(pre, reqs)[rid]
    with pytest.raises(ValueError, match="adapter") as want:
        jeng.submit(rid, prompt, mn, adapter_id=1, kv_import=jblob)
    with pytest.raises(ValueError) as got:
        dec.submit(rid, prompt, mn, adapter_id=1, kv_import=blob)
    assert str(got.value) == str(want.value)
    assert not dec.busy


def test_disagg_import_on_tiered_engine(trained_lm, port_lm):
    """The decode leg composes with the host tier: shipped KV installs
    into a tiered engine under pool pressure, still token-exact."""
    reqs = _mixed_reqs(8, seed=8)
    want = _drain(_engines(trained_lm, port_lm, BIG, max_slots=4)[0], reqs)
    pre = _engines(trained_lm, port_lm, BIG, max_slots=4)[1]
    dec = _engines(trained_lm, port_lm, TIER_KW, host=HOST_PAGES,
                   max_slots=4)[1]
    try:
        blobs = _prefill_ship(pre, reqs)
        assert _drain(dec, reqs, lambda i: {"kv_import": blobs[i]}) == want
    finally:
        dec.close()
    assert dec.stats["kv_pages_used"] == 0
    assert dec.stats["kv_imports"] == len(reqs)
    assert dec.stats["kv_evictions_total"] > 0


# ---- blobs across the packages, depth 12

DEEP = dict(KNOBS, depth=12)


@pytest.fixture(scope="module")
def deep_pair():
    """A depth-12 model from a seeded JAX init with nonzero adapters,
    loaded by both templates: depth 12 puts block_10 and block_11 between
    block_1 and block_2 in a blob."""
    jm = JLlamaLoRA(**DEEP)
    params = jm._module().init(jax.random.PRNGKey(3),
                               np.zeros((1, L), np.int32))["params"]
    key = jax.random.PRNGKey(4)

    def bump(kp, x):
        path = "/".join(str(getattr(k, "key", k)) for k in kp).lower()
        if "lora_b" in path:
            return 0.5 * jax.random.normal(
                jax.random.fold_in(key, hash(path) % (1 << 30)), x.shape)
        return x

    params = jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map_with_path(bump, params))
    dump = {"params": params, "meta": {"id2tok": {}}}
    jm.load_parameters(dump)
    pm = LlamaLoRA(device="cpu", **DEEP)
    pm.load_parameters(dump)
    return jm, pm


@pytest.mark.parametrize("layout", ["paged", "rows"])
def test_jax_blob_installs_into_the_port(deep_pair, layout):
    """A JAX prefill engine's blobs, through the JAX codec, install into a
    port decode engine: JAX's unified tokens."""
    jm, pm = deep_pair
    lay = BIG if layout == "paged" else (0, 0)
    reqs = _mixed_reqs(4, seed=11)
    want = _drain(_engines(jm, pm, lay, max_slots=4)[0], reqs)
    jpre = _engines(jm, pm, lay, max_slots=4)[0]
    wire = {rid: unpack_message(jpack(b))
            for rid, b in _prefill_ship(jpre, reqs).items()}
    dec = _engines(jm, pm, lay, max_slots=4)[1]
    assert _drain(dec, reqs, lambda i: {"kv_import": wire[i]}) == want
    assert dec.stats["kv_imports"] == len(reqs)


@pytest.mark.parametrize("layout", ["paged", "rows"])
def test_port_blob_installs_into_jax(deep_pair, layout):
    """A port prefill engine's blobs, through the port codec, install into
    a JAX decode engine: JAX's unified tokens. The leaves are in
    ``jax.tree_util`` order: regrouped in numeric layer order the same
    blobs install without an error and change the tokens."""
    jm, pm = deep_pair
    lay = BIG if layout == "paged" else (0, 0)
    reqs = _mixed_reqs(4, seed=11)
    want = _drain(_engines(jm, pm, lay, max_slots=4)[0], reqs)
    pre = _engines(jm, pm, lay, max_slots=4)[1]
    wire = {rid: junpack(pack_message(b))
            for rid, b in _prefill_ship(pre, reqs).items()}
    jdec = _engines(jm, pm, lay, max_slots=4)[0]
    assert _drain(jdec, reqs, lambda i: {"kv_import": wire[i]}) == want
    like = [dict.fromkeys(("k", "v"))] * DEEP["depth"]
    numeric = {rid: dict(b, leaves=[leaf for layer in kvt.cache_from_leaves(
        b["leaves"], like) for leaf in layer.values()])
        for rid, b in wire.items()}
    jdec = _engines(jm, pm, lay, max_slots=4)[0]
    assert _drain(jdec, reqs, lambda i: {"kv_import": numeric[i]}) != want


# ---- the workers: disaggregated prefill/decode over the hub

WORKER_PROMPTS = ["tok1 tok2 tok3 tok4 tok5 tok6 tok7 tok8",
                  "tok9 tok8 tok7 tok6 tok5 tok4",
                  "tok2 tok4 tok6 tok8 tok1 tok3 tok5"]
#: every wait of a worker test ends by this many seconds
DEADLINE_S = 60.0


@pytest.fixture(scope="module")
def lm_blob(trained_lm):
    """``trained_lm`` as the flax-msgpack bytes the JAX store writes."""
    from rafiki_tpu.store.param_store import ParamStore as JParamStore

    store = JParamStore.from_uri("mem://")
    store.save("lm0", trained_lm.dump_parameters())
    return store.backend.get("lm0")


def _port_worker(blob, hub, wid, **kw):
    from rafiki_tpu_torch.store.param_store import ParamStore
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    store = ParamStore.from_uri("mem://")
    store.backend.put("lm0", blob)
    return InferenceWorker(LlamaLoRA, "lm0", KNOBS, store, hub, wid,
                           decode_loop=True, max_slots=4, max_new_tokens=6,
                           device="cpu", **kw)


def _stream_all(pred, prompts):
    """Each prompt streamed alone; deltas must join to the final text."""
    outs = []
    for p in prompts:
        evs = list(pred.predict_stream([p], timeout=DEADLINE_S))
        final = [e for e in evs if e.get("done")][-1]
        assert "predictions" in final and "error" not in final, final
        acc = "".join(e["delta"]["0"] for e in evs if e.get("delta"))
        assert final["predictions"][0].startswith(acc), (acc, final)
        outs.append(final["predictions"][0])
    return outs


class _Loop:
    """Workers' serve loops on threads; ``close`` stops and joins them."""

    def __init__(self, *workers):
        self.workers = workers
        self.threads = {id(w): threading.Thread(
            target=w.run, kwargs={"poll_timeout": 0.02}, daemon=True)
            for w in workers}
        for t in self.threads.values():
            t.start()

    def stop(self, worker):
        worker.stop()
        self.threads[id(worker)].join(timeout=DEADLINE_S)
        assert not self.threads[id(worker)].is_alive()

    def close(self):
        for w in self.workers:
            self.stop(w)
            w.engine.close()


@pytest.fixture(scope="module")
def unified_reference(lm_blob):
    """The streamed texts of one unified worker, the JAX one behind the
    JAX Predictor and the port one behind the port's: equal, and the
    oracle every disaggregated topology must reproduce."""
    from rafiki_tpu.serving.predictor import Predictor as JPredictor
    from rafiki_tpu.serving.queues import InProcQueueHub as JHub
    from rafiki_tpu.store.param_store import ParamStore as JParamStore
    from rafiki_tpu.worker.inference import InferenceWorker as JWorker
    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.serving.queues import InProcQueueHub

    jstore = JParamStore.from_uri("mem://")
    jstore.backend.put("lm0", lm_blob)
    jhub = JHub()
    jw = JWorker(JLlamaLoRA, "lm0", KNOBS, jstore, jhub, "w-uni",
                 decode_loop=True, max_slots=4, max_new_tokens=6)
    hub = InProcQueueHub()
    pw = _port_worker(lm_blob, hub, "w-uni")
    loop = _Loop(jw, pw)
    try:
        want = _stream_all(JPredictor(jhub, ["w-uni"],
                                      gather_timeout=DEADLINE_S),
                           WORKER_PROMPTS)
        got = _stream_all(Predictor(hub, ["w-uni"],
                                    gather_timeout=DEADLINE_S),
                          WORKER_PROMPTS)
    finally:
        loop.close()
    assert got == want
    return want


class _ShipmentHub:
    """A prefill worker's view of the hub with its KV pushes intercepted
    (``on_push(data) -> deliver?``); everything else passes through."""

    def __init__(self, inner, on_push):
        self._inner = inner
        self._on_push = on_push

    def push_kv(self, worker_id, data):
        if self._on_push(data):
            self._inner.push_kv(worker_id, data)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _run_disagg(lm_blob, reference, on_push=None, kv_wait_s=DEADLINE_S,
                kill_prefill_after=None, wait_after_kill=0.05):
    """PROMPTS through a prefill and a decode port worker behind the
    port's Predictor, each stream token-exact against the unified
    reference. ``on_push`` intercepts the prefill worker's shipments;
    ``kill_prefill_after``: the prefill worker stops after that many
    streams and the decode worker's wait window shrinks to
    ``wait_after_kill``. Returns (decode worker, prefill worker)."""
    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.serving.queues import InProcQueueHub

    hub = InProcQueueHub()
    dec = _port_worker(lm_blob, hub, "w-dec", role="decode",
                       kv_page_size=PS, kv_pages=33, kv_wait_s=kv_wait_s)
    pre = _port_worker(lm_blob, hub if on_push is None
                       else _ShipmentHub(hub, on_push), "w-pre",
                       role="prefill", kv_page_size=PS, kv_pages=33)
    loop = _Loop(dec, pre)
    try:
        pred = Predictor(hub, ["w-dec", "w-pre"], gather_timeout=DEADLINE_S)
        assert _wait(lambda: hub.get_worker_stats("w-dec") is not None
                     and hub.get_worker_stats("w-pre") is not None,
                     DEADLINE_S)
        pred._refresh_load_signals()
        assert pred.router.select_prefill() == "w-pre"
        outs = []
        for i, p in enumerate(WORKER_PROMPTS):
            if kill_prefill_after is not None and i == kill_prefill_after:
                loop.stop(pre)  # later prefill legs are never served
                dec.kv_wait_s = wait_after_kill
            outs.extend(_stream_all(pred, [p]))
        assert outs == reference, (outs, reference)
        return dec, pre
    finally:
        loop.close()


def test_worker_disagg_token_exact(lm_blob, unified_reference):
    """The whole wire path: the Predictor places the prefill leg, the
    prefill worker ships each prompt's pages over the hub, the decode
    worker installs them; the unified texts, with no fallback."""
    dec, pre = _run_disagg(lm_blob, unified_reference)
    n = len(WORKER_PROMPTS)
    assert _wait(lambda: pre.stats["kv_ships_sent"] == n, DEADLINE_S)
    assert dec.stats["kv_imports_installed"] == n
    assert dec.stats["kv_wait_timeouts"] == 0
    assert dec.stats["kv_import_fallbacks"] == 0
    assert dec.engine.stats["kv_imports"] == n
    assert pre.engine.stats["kv_exports"] == n
    assert pre.engine.stats["tokens_generated"] == 0


def test_worker_disagg_dropped_shipment_degrades(lm_blob,
                                                 unified_reference):
    """Every shipment is lost on the way: each held request's wait window
    expires and it re-prefills locally, token-exact, without a hang."""
    dropped = []
    dec, _pre = _run_disagg(lm_blob, unified_reference,
                            on_push=lambda data: dropped.append(data),
                            kv_wait_s=0.05)
    assert len(dropped) == len(WORKER_PROMPTS)
    assert dec.stats["kv_wait_timeouts"] == len(WORKER_PROMPTS)
    assert dec.stats["kv_imports_installed"] == 0


def test_worker_disagg_slow_shipment_degrades(lm_blob, unified_reference):
    """Every shipment is held back until its request's wait window has
    expired (an event: the decode worker's ``kv_wait_timeouts`` count, not
    a delay): the stream never blocks on it, re-prefills locally, and the
    late blob is drained and dropped."""
    box = {}
    sent = []

    def late(data):
        n = len(sent) + 1
        assert _wait(lambda: box["dec"].stats["kv_wait_timeouts"] >= n,
                     DEADLINE_S)
        sent.append(data)
        return True

    from rafiki_tpu_torch.worker import inference as wi

    real_init = wi.InferenceWorker.__init__

    def remember(self, *a, **kw):
        real_init(self, *a, **kw)
        if self.role == "decode":
            box["dec"] = self

    wi.InferenceWorker.__init__ = remember
    try:
        dec, _pre = _run_disagg(lm_blob, unified_reference, on_push=late,
                                kv_wait_s=0.05)
    finally:
        wi.InferenceWorker.__init__ = real_init
    assert len(sent) == len(WORKER_PROMPTS)
    assert dec.stats["kv_wait_timeouts"] == len(WORKER_PROMPTS)
    assert dec.stats["kv_imports_installed"] == 0


def test_worker_disagg_prefill_kill_mid_run(lm_blob, unified_reference):
    """The prefill worker stops after the first stream: that stream
    installs its shipment, the later ones (whose prefill legs are never
    served) re-prefill locally when their window expires; no token
    dropped or repeated."""
    dec, pre = _run_disagg(lm_blob, unified_reference,
                           kill_prefill_after=1)
    assert dec.stats["kv_imports_installed"] == 1
    assert dec.stats["kv_wait_timeouts"] == len(WORKER_PROMPTS) - 1
    assert pre.stats["kv_ships_sent"] == 1


def test_worker_role_validation(lm_blob):
    from rafiki_tpu_torch.serving.queues import InProcQueueHub

    with pytest.raises(ValueError, match="role"):
        _port_worker(lm_blob, InProcQueueHub(), "w-x", role="prefil")
    with pytest.raises(ValueError, match="host_kv_pages"):
        _port_worker(lm_blob, InProcQueueHub(), "w-x", host_kv_pages=4)


def test_tiered_worker_serves_the_unified_texts(lm_blob, unified_reference):
    """A decode-loop worker with a tiny pool and a host tier streams the
    unified texts; the tier's gauges reach its published stats."""
    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.serving.queues import InProcQueueHub

    hub = InProcQueueHub()
    w = _port_worker(lm_blob, hub, "w-tier", kv_page_size=PS, kv_pages=3,
                     host_kv_pages=HOST_PAGES)
    loop = _Loop(w)
    try:
        pred = Predictor(hub, ["w-tier"], gather_timeout=DEADLINE_S)
        got, _info = pred.predict(WORKER_PROMPTS, timeout=DEADLINE_S)
        w._publish_stats()
        st = hub.get_worker_stats("w-tier")
    finally:
        loop.close()
    assert got == unified_reference
    assert st["engine_kv_host_pages_total"] == HOST_PAGES
    assert st["engine_kv_evictions_total"] > 0


# ---- placement

def test_router_prefill_placement():
    """``select_prefill`` and decode placement equal the JAX router's on
    the same observations."""
    from rafiki_tpu.serving.breaker import BreakerBoard as JBoard
    from rafiki_tpu.serving.router import Router as JRouter
    from rafiki_tpu_torch.serving.breaker import BreakerBoard
    from rafiki_tpu_torch.serving.router import Router

    outs = []
    for board_cls, router_cls in ((JBoard, JRouter), (BreakerBoard, Router)):
        r = router_cls(["d0", "d1", "p0"], board_cls(["d0", "d1", "p0"]))
        r.observe("p0", {"role": "prefill"})
        r.observe("d0", {"role": "decode"})
        r.observe("d1", {"role": "decode", "queue_p95_s": 0.5})
        picks = [r.select(k) for k in ("a", "b", "c", "zebra", "quux")]
        assert set(picks) <= {"d0", "d1"}
        r2 = router_cls(["p0"], board_cls(["p0"]))
        r2.observe("p0", {"role": "prefill"})
        outs.append((picks, r.select_prefill(),
                     r.select_prefill(exclude=("p0",)), r.role_of("p0"),
                     r.role_of("d1"), r2.select("k")))
    assert outs[1] == outs[0]
    assert outs[1][1:] == ("p0", None, "prefill", "decode", "p0")
