"""Port parity: SLO preemption in the ``rafiki_tpu_torch`` ``DecodeEngine``
against the JAX engine on the shared JAX-trained LM fixture.

The engine cases of ``tests/test_slo.py`` run on both engines with the
same weights and traffic: a preempted request resumes token-exact (greedy
and sampled), a head reclaims a lower class's page reservations, an
infeasible preemption evicts nothing, an aged promotion is shielded,
interactive admits first. Each case's outputs, span sequences (with the
``preempted`` spans and the ``resumed`` flag of a re-admission) and
scheduling counters must be equal: tokens exactly (f32, greedy or
threefry-keyed draws), counters exactly.
"""

import numpy as np
import pytest
import torch

from rafiki_tpu.serving import slo as jslo
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving import slo as pslo
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
PS = 8
BG_PROMPT = np.asarray([1, 5, 9, 13, 6], np.int32)
IA_PROMPT = np.asarray([2, 4], np.int32)
BG_NEW, IA_NEW = 10, 4
SAMPLED = {"temperature": 0.8, "top_k": 8, "top_p": 0.9, "seed": 13}
#: counters both engines must agree on
SAME_STATS = ("preemptions", "slo_aged_promotions", "admission_stalls",
              "requests_done", "tokens_generated", "prefill_calls",
              "prefill_tokens", "kv_pages_used", "max_concurrent",
              "queued_interactive", "queued_batch", "queued_background")


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


def _pair(trained_lm, port_lm, max_slots, kv_pages=0, **kw):
    """A JAX and a port engine over the same weights (paged at page 8
    when ``kv_pages``, else contiguous), each recording its spans."""
    if kv_pages:
        jmod = trained_lm._module(kv_page_size=PS, kv_pages=kv_pages)
        pmod = port_lm._serving_module_params(PS, kv_pages)
    else:
        jmod, pmod = trained_lm._module(), port_lm._serving_module_params()
    engines = (JaxDecodeEngine(jmod, trained_lm._params,
                               max_slots=max_slots, max_len=L, **kw),
               DecodeEngine(pmod, max_slots=max_slots, max_len=L,
                            device="cpu", **kw))
    for eng in engines:
        eng.events = []
        eng.span_sink = (lambda ev, rid, attrs, log=eng.events:
                         log.append((ev, rid, dict(attrs))))
    return engines


def _drain(eng, want, done=None, budget=800, streamed=None):
    done = {} if done is None else done
    for _ in range(budget):
        eng.step()
        if streamed is not None:
            for rid, toks in eng.poll_partial():
                prev = streamed.get(rid, [])
                # append-only across a preemption
                assert list(toks[:len(prev)]) == prev, (rid, prev, toks)
                streamed[rid] = list(toks)
        done.update({rid: list(t) for rid, t in eng.poll()})
        if len(done) == want:
            return done
    raise AssertionError(f"undrained: {sorted(done)} / {dict(eng.stats)}")


def _same(jeng, peng, jout, pout):
    assert pout == jout
    assert peng.events == jeng.events
    assert {k: peng.stats[k] for k in SAME_STATS} == \
        {k: jeng.stats[k] for k in SAME_STATS}


def test_policy_helpers_equal_jax():
    occ = [(("live", j), slo, seq, shielded)
           for j, (slo, seq, shielded) in enumerate(
               [("background", 3, False), ("batch", 1, False),
                ("background", 7, True), ("interactive", 2, False),
                ("background", 5, False), ("bogus", 9, False)])]
    for cls in pslo.SLO_CLASSES + ("bogus",):
        assert pslo.evictable_occupants(cls, occ) == \
            jslo.evictable_occupants(cls, occ)
        assert pslo.preemption_victim(cls, occ) == \
            jslo.preemption_victim(cls, occ)
    assert pslo.preemption_victim("interactive", []) is None


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_preempt_resume_token_exact_vs_jax(trained_lm, port_lm, mode):
    """One slot: background mid-generation, interactive arrives, the
    background is evicted and resumes; both outputs equal an uncontended
    run, the stream stays append-only, and the JAX engine does the
    same, span for span."""
    kw = SAMPLED if mode == "sampled" else {}
    _, ref_eng = _pair(trained_lm, port_lm, 2)
    ref_eng.submit("bg", BG_PROMPT, BG_NEW, slo="background", **kw)
    ref_eng.submit("ia", IA_PROMPT, IA_NEW, slo="interactive", **kw)
    ref = _drain(ref_eng, 2)

    outs = []
    for eng in _pair(trained_lm, port_lm, 1):
        eng.submit("bg", BG_PROMPT, BG_NEW, slo="background", **kw)
        eng.step()
        eng.step()  # the background is mid-generation in the only slot
        eng.submit("ia", IA_PROMPT, IA_NEW, slo="interactive", **kw)
        streamed = {}
        done = _drain(eng, 2, streamed=streamed)
        for rid, toks in streamed.items():
            assert done[rid][:len(toks)] == toks
        outs.append((eng, done))
    (jeng, jdone), (peng, pdone) = outs
    assert pdone == ref
    assert peng.stats["preemptions"] >= 1
    _same(jeng, peng, jdone, pdone)
    preempted = [(rid, a) for ev, rid, a in peng.events
                 if ev == "preempted"]
    assert len(preempted) == peng.stats["preemptions"]
    assert preempted[0] == ("bg", {"slot": 0, "tokens": preempted[0][1][
        "tokens"], "slo": "background", "by": "interactive"})
    admits = [(rid, a["resumed"]) for ev, rid, a in peng.events
              if ev == "admitted"]
    assert ("bg", False) in admits and ("ia", False) in admits
    assert ("bg", True) in admits  # the re-admission is flagged


def test_page_preemption_token_exact_vs_jax(trained_lm, port_lm):
    """Two slots, a pool too small for both: the interactive head
    reclaims the background's reservation; the background resumes and
    the pool drains back to empty."""
    _, ref_eng = _pair(trained_lm, port_lm, 2, kv_pages=13)
    ref_eng.submit("bg", BG_PROMPT, 16, slo="background")
    ref_eng.submit("ia", IA_PROMPT, 8, slo="interactive")
    ref = _drain(ref_eng, 2)
    engines = _pair(trained_lm, port_lm, 2, kv_pages=5)
    outs = []
    for eng in engines:
        eng.submit("bg", BG_PROMPT, 16, slo="background")  # 3 of 4 pages
        eng.step()
        eng.step()
        eng.submit("ia", IA_PROMPT, 8, slo="interactive")  # needs 2 more
        outs.append(_drain(eng, 2))
    peng = engines[1]
    assert outs[1] == ref
    assert peng.stats["preemptions"] >= 1
    assert peng.stats["kv_pages_used"] == 0
    assert sorted(peng._free_pages) == [1, 2, 3, 4]
    _same(*engines, *outs)


def test_infeasible_preemption_evicts_nothing_vs_jax(trained_lm, port_lm):
    """Interactive A (3 pages) and background B (2 pages) fill a 5-page
    pool; interactive C needs 3, which evicting B cannot free: B keeps
    running and C waits for A."""
    _, ref_eng = _pair(trained_lm, port_lm, 3, kv_pages=13)
    ref_eng.submit("a", BG_PROMPT, 16, slo="interactive")
    ref_eng.submit("b", IA_PROMPT, 12, slo="background")
    ref_eng.submit("c", BG_PROMPT, 16, slo="interactive")
    ref = _drain(ref_eng, 3)
    engines = _pair(trained_lm, port_lm, 3, kv_pages=6)
    outs = []
    for eng in engines:
        eng.submit("a", BG_PROMPT, 16, slo="interactive")
        eng.submit("b", IA_PROMPT, 12, slo="background")
        eng.step()
        assert int(eng._n_res.sum()) == 5  # the pool is exactly full
        eng.submit("c", BG_PROMPT, 16, slo="interactive")
        eng.step()
        eng.step()
        assert eng.stats["preemptions"] == 0
        assert eng.stats["admission_stalls"] >= 1
        outs.append(_drain(eng, 3))
        assert eng.stats["preemptions"] == 0
    assert outs[1] == ref
    _same(*engines, *outs)


def test_aging_promotes_and_shields_vs_jax(trained_lm, port_lm):
    """Sustained interactive arrivals on one slot: the background still
    completes (aging promotes it) and is then shielded from the next
    arrival's preemption; every interactive request is answered."""
    _, ref_eng = _pair(trained_lm, port_lm, 2)
    ref_eng.submit("bg", BG_PROMPT, 6, slo="background")
    ref = _drain(ref_eng, 1)
    engines = _pair(trained_lm, port_lm, 1)
    engines[0]._cq = jslo.ClassQueue(aging_skips=2)
    engines[1]._cq = pslo.ClassQueue(aging_skips=2)
    outs = []
    for eng in engines:
        eng.submit("bg", BG_PROMPT, 6, slo="background")
        done = {}
        for i in range(40):
            if i < 8:  # a fresh interactive arrival every step
                eng.submit(f"i{i}", IA_PROMPT, 2, slo="interactive")
            eng.step()
            done.update({rid: list(t) for rid, t in eng.poll()})
            if len(done) == 9:
                break
        outs.append(_drain(eng, 9, done=done))
    assert outs[1]["bg"] == ref["bg"]
    assert engines[1].stats["slo_aged_promotions"] >= 1
    _same(*engines, *outs)


def test_interactive_admits_first_vs_jax(trained_lm, port_lm):
    engines = _pair(trained_lm, port_lm, 1)
    outs = []
    for eng in engines:
        eng.submit("bg", BG_PROMPT, 6, slo="background")
        eng.submit("ia", IA_PROMPT, 8, slo="interactive")
        eng.step()
        assert eng._slots[0] is not None and \
            eng._slots[0].slo == "interactive"
        assert eng.stats["queued_background"] == 1
        outs.append(_drain(eng, 2))
    _same(*engines, *outs)


def test_preemption_storm_spans_and_counters_equal_jax(trained_lm, port_lm):
    """Mixed classes over two slots and a tight pool, with arrivals
    between steps: the ``preempted`` spans (slot, tokens, class, by),
    their count and the outputs equal the JAX engine's."""
    rng = np.random.default_rng(5)
    reqs = [(f"r{i}", rng.integers(1, 64, size=int(rng.integers(2, 9))
                                   ).astype(np.int32),
             int(rng.integers(3, 12)), cls)
            for i, cls in enumerate(["background", "batch", "background",
                                     "interactive", "batch", "interactive",
                                     "background", "interactive"])]
    engines = _pair(trained_lm, port_lm, 2, kv_pages=6)
    outs = []
    for eng in engines:
        done = {}
        for n in range(400):
            if n < len(reqs):
                rid, p, mn, cls = reqs[n]
                eng.submit(rid, p, mn, slo=cls)
            eng.step()
            done.update({rid: list(t) for rid, t in eng.poll()})
            if len(done) == len(reqs):
                break
        outs.append(done)
    jeng, peng = engines
    assert len(outs[1]) == len(reqs)
    assert peng.stats["preemptions"] >= 1
    assert peng.stats["preemptions"] == sum(
        1 for ev, _r, _a in peng.events if ev == "preempted")
    _same(jeng, peng, *outs)
