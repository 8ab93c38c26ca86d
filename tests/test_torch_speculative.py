"""Port parity: speculative decoding in the ``rafiki_tpu_torch``
``DecodeEngine`` against the JAX engine on the shared JAX-trained LM.

Mirrors ``tests/test_decode_engine.py``'s speculation cases, every case
of ``tests/test_draft_spec.py`` but the slow distilled-draft one, and
``tests/test_paged_kv.py``'s paged speculation case. Both engines get the
same weights (through the weight bridge) and the same traffic, paged at
pages 8 and 4 and contiguous: tokens must be identical (f32, greedy) and
equal to plain decoding, and the counters the JAX engine keeps for
speculation (``spec_*``, ``draft_resyncs``) equal. Prompt-lookup drafts
must be JAX's ``_ngram_draft`` on seeded contexts.
"""

import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.serving import decode_engine as jde
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving import decode_engine as de
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine

from test_decode_engine import KNOBS
from test_multi_adapter import _lora_variant

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
#: (page size, pool pages): paged at pages 8 and 4, and contiguous
LAYOUTS = {"paged8": (8, 13), "paged4": (4, 25), "contiguous": (0, 0)}
SPEC_STATS = ("steps", "tokens_generated", "requests_done", "spec_calls",
              "spec_drafted", "spec_accepted", "spec_draft_model_calls",
              "draft_resyncs", "prefill_calls", "prefill_tokens",
              "prefix_hits", "prefix_tokens", "kv_pages_used",
              "kv_pages_high_water", "admission_stalls", "max_concurrent")
PROMPTS = [np.asarray([1, 5, 9, 13], np.int32),          # arbitrary
           np.asarray([1, 7, 2, 7, 2, 7, 2], np.int32),  # repetitive
           np.asarray([1, 3], np.int32)]


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


def _pair(trained_lm, port_lm, layout, jax_draft=None, port_draft=None,
          **kw):
    """A JAX and a port core engine over the same weights and layout."""
    page, pages = LAYOUTS[layout]
    jmod = (trained_lm._module(kv_page_size=page, kv_pages=pages)
            if page else trained_lm._module())
    pmod = port_lm._serving_module_params(page, pages)
    return (JaxDecodeEngine(jmod, trained_lm._params, max_len=L,
                            draft=jax_draft, **kw),
            DecodeEngine(pmod, max_len=L, draft=port_draft, device="cpu",
                         **kw))


def _run(eng, reqs, late=(), late_at=2, budget=400):
    """Submit ``reqs`` ((rid, prompt, max_new, kwargs)), then ``late``
    after ``late_at`` steps; step until all are done."""
    for rid, p, mn, kw in reqs:
        eng.submit(rid, p, mn, **kw)
    want = len(reqs) + len(late)
    done = {}
    for n in range(budget):
        if n == late_at:
            for rid, p, mn, kw in late:
                eng.submit(rid, p, mn, **kw)
        eng.step()
        done.update({rid: [int(t) for t in toks] for rid, toks in
                     eng.poll()})
        if len(done) == want:
            return done
    raise AssertionError(f"undrained: {sorted(done)} / {dict(eng.stats)}")


def _same_stats(jeng, teng, keys=SPEC_STATS):
    js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    return ts


@pytest.mark.parametrize("seed", range(8))
def test_ngram_drafts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ctx = rng.integers(0, int(rng.integers(2, 9)),
                           size=int(rng.integers(1, 40))).astype(np.int32)
        for k in (1, 3, 7):
            np.testing.assert_array_equal(de._ngram_draft(ctx, k),
                                          jde._ngram_draft(ctx, k))
    # the JAX test's worked cases
    ctx = np.asarray([5, 7, 8, 9, 3, 1, 7, 8], np.int32)
    np.testing.assert_array_equal(de._ngram_draft(ctx, 2), [9, 3])
    np.testing.assert_array_equal(de._ngram_draft(ctx, 5), [9, 3, 1, 7, 8])
    np.testing.assert_array_equal(
        de._ngram_draft(np.asarray([9], np.int32), 2), [9, 9])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_speculation_equals_jax_and_plain(trained_lm, port_lm, layout):
    """Three requests through two slots (slot reuse), drafts that hit
    (repetitive prompt) and miss: the port's tokens equal the JAX
    engine's and plain greedy decoding's; the counters agree."""
    reqs = [(i, p, 10, {}) for i, p in enumerate(PROMPTS)]
    jeng, teng = _pair(trained_lm, port_lm, layout, max_slots=2,
                       speculate_k=4)
    want, got = _run(jeng, reqs), _run(teng, reqs)
    plain = _run(_pair(trained_lm, port_lm, layout, max_slots=2)[1], reqs)
    assert got == want == plain
    ts = _same_stats(jeng, teng)
    assert ts["spec_calls"] > 0 and ts["spec_drafted"] > 0
    assert 0 <= ts["spec_accepted"] <= ts["spec_drafted"]


@pytest.mark.parametrize("layout", ["paged8", "paged4"])
def test_spec_margin_reservation_and_mid_flight_admission(
        trained_lm, port_lm, layout):
    """A pool tight enough that admission stalls: the reservation covers
    the verify window's spec margin (``_pages_for``), so the page counters
    agree with JAX's; half the requests arrive mid-flight."""
    page, _ = LAYOUTS[layout]
    pages = 1 + 2 * (L // page) // 2 + 2
    rng = np.random.default_rng(5)
    reqs = [(r, rng.integers(1, 64, size=int(rng.integers(2, 12))).astype(
        np.int32), 7, {}) for r in range(6)]
    kw = dict(max_slots=3, speculate_k=3, steps_per_sync=2,
              prefill_chunk=4)
    jmod = trained_lm._module(kv_page_size=page, kv_pages=pages)
    jeng = JaxDecodeEngine(jmod, trained_lm._params, max_len=L, **kw)
    teng = DecodeEngine(port_lm._serving_module_params(page, pages),
                        max_len=L, device="cpu", **kw)
    assert teng._pages_for(20) == jeng._pages_for(20)
    want = _run(jeng, reqs[:3], late=reqs[3:])
    got = _run(teng, reqs[:3], late=reqs[3:])
    assert got == want
    ts = _same_stats(jeng, teng)
    assert ts["kv_pages_used"] == 0
    assert sorted(teng._free_pages) == list(range(1, pages))


@pytest.mark.parametrize("layout", ["paged8", "contiguous"])
def test_sampled_slot_falls_back_to_the_scan(trained_lm, port_lm, layout):
    reqs = [("g", PROMPTS[0], 6, {}),
            ("s", PROMPTS[0], 6, dict(temperature=0.8, top_k=5, seed=7))]
    jeng, teng = _pair(trained_lm, port_lm, layout, max_slots=2,
                       speculate_k=4)
    want, got = _run(jeng, reqs), _run(teng, reqs)
    plain = _run(_pair(trained_lm, port_lm, layout, max_slots=2)[1], reqs)
    assert got == want == plain
    assert _same_stats(jeng, teng)["spec_calls"] == 0


def test_gate_closes_at_low_acceptance_and_reprobes(trained_lm, port_lm):
    """Forced to the worst EMA, the gate sends calls to the scan
    (``_spec_idle`` grows) until the re-probe budget is spent; both
    engines take the same path call for call."""
    jeng, teng = _pair(trained_lm, port_lm, "paged8", max_slots=2,
                       speculate_k=4)
    for eng in (jeng, teng):
        eng._spec_ema = 1.0
        eng.submit("x", np.asarray([1, 5, 9], np.int32), 8)
        eng.step()
    before = teng.stats["spec_calls"]
    for _ in range(4):
        jeng.step()
        teng.step()
    assert teng.stats["spec_calls"] == before
    assert teng._spec_idle == jeng._spec_idle > 0
    for eng in (jeng, teng):
        eng._spec_idle = de.SPEC_REPROBE_CALLS
        eng.submit("y", np.asarray([1, 7, 2, 7, 2], np.int32), 8)
    outs = []
    for eng in (jeng, teng):
        done = {}
        for _ in range(60):
            eng.step()
            done.update({r: list(map(int, t)) for r, t in eng.poll()})
            if len(done) == 2:
                break
        outs.append(done)
    assert outs[0] == outs[1] and len(outs[1]) == 2
    assert teng.stats["spec_calls"] > before
    assert teng._spec_ema == pytest.approx(jeng._spec_ema, abs=1e-12)
    assert (de.SPEC_MIN_TOKENS_PER_CALL, de.SPEC_MIN_TOKENS_PER_CALL_DRAFT,
            de.SPEC_REPROBE_CALLS, de.SPEC_EMA_DECAY) == (
        jde.SPEC_MIN_TOKENS_PER_CALL, jde.SPEC_MIN_TOKENS_PER_CALL_DRAFT,
        jde.SPEC_REPROBE_CALLS, jde.SPEC_EMA_DECAY)


def test_eos_ends_a_speculative_request(trained_lm, port_lm):
    jeng, teng = _pair(trained_lm, port_lm, "paged8", max_slots=2,
                       speculate_k=4)
    ref = _run(_pair(trained_lm, port_lm, "paged8", max_slots=2)[1],
               [("r", PROMPTS[1], 10, {})])["r"]
    reqs = [("e", PROMPTS[1], 10, {"eos_id": ref[3]}),
            ("n", PROMPTS[0], 6, {})]
    want, got = _run(jeng, reqs), _run(teng, reqs)
    assert got == want
    assert got["e"] == ref[:ref.index(ref[3])]
    _same_stats(jeng, teng)


# ---- draft-model speculation (tests/test_draft_spec.py)

def _draft_pair(trained_lm, port_lm, params=None):
    """A draft sibling of the trained model, as each package loads it:
    the same params (a perfect draft) or ``params``."""
    dump = trained_lm.dump_parameters()
    if params is not None:
        dump = dict(dump, params=params)
    jd = JLlamaLoRA(**KNOBS)
    jd.load_parameters(dump)
    pd = LlamaLoRA(device="cpu", **KNOBS)
    pd.load_parameters(dump)
    return jd, pd


def _serve_text(lm, reqs, late=(), **kw):
    eng = lm.make_decode_engine(max_slots=kw.pop("max_slots", 4),
                                max_new_tokens=kw.pop("max_new_tokens", 8),
                                **kw)
    for rid, text in reqs:
        eng.submit(rid, text)
    got = {}
    for n in range(400):
        for at, rid, text in late:
            if n == at:
                eng.submit(rid, text)
        if not eng.busy and n > max((a for a, _r, _t in late), default=0):
            break
        eng.step()
        got.update(dict(eng.poll()))
    assert not eng.busy, "engine failed to drain"
    return got, eng


TEXT_REQS = [("a", "tok1 tok2 tok3"), ("b", "tok4 tok5"),
             ("c", "tok6 tok7 tok8")]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("draft", ["perfect", "perturbed"])
def test_draft_model_speculation_equals_jax(trained_lm, port_lm, layout,
                                            draft):
    """A perfect draft (the target's own params: near-total acceptance)
    and a perturbed one (low acceptance): the port's texts and counters
    equal the JAX engine's, and plain decoding's."""
    params = (None if draft == "perfect"
              else _lora_variant(trained_lm._params, scale=0.5))
    jd, pd = _draft_pair(trained_lm, port_lm, params)
    page, pages = LAYOUTS[layout]
    kw = dict(kv_page_size=page, kv_pages=pages) if page else {}
    plain, _ = _serve_text(port_lm, TEXT_REQS, **kw)
    want, jeng = _serve_text(trained_lm, TEXT_REQS, speculate_k=4,
                             draft_model=jd, **kw)
    got, teng = _serve_text(port_lm, TEXT_REQS, speculate_k=4,
                            draft_model=pd, **kw)
    assert got == want == plain
    ts = _same_stats(jeng.engine, teng.engine)
    assert ts["spec_draft_model_calls"] > 0
    if draft == "perfect":
        assert ts["spec_accepted"] >= 0.9 * ts["spec_drafted"], ts


def test_draft_model_mid_flight_admission_equals_jax(trained_lm, port_lm):
    jd, pd = _draft_pair(trained_lm, port_lm)
    late = [(2, "b", "tok4 tok5"), (4, "c", "tok6 tok7")]
    kw = dict(max_slots=2, max_new_tokens=6, speculate_k=3)
    want, jeng = _serve_text(trained_lm, [("a", "tok1 tok2 tok3")], late,
                             draft_model=jd, **kw)
    got, teng = _serve_text(port_lm, [("a", "tok1 tok2 tok3")], late,
                            draft_model=pd, **kw)
    plain, _ = _serve_text(port_lm, TEXT_REQS[:1] + [
        ("b", "tok4 tok5"), ("c", "tok6 tok7")], max_slots=2,
        max_new_tokens=6)
    assert got == want == plain
    _same_stats(jeng.engine, teng.engine)


def test_draft_checks_are_jax_s(trained_lm, port_lm):
    """The template's draft checks refuse what JAX refuses, with its
    messages: a vocabulary mismatch, speculate_k < 2, a draft whose
    max_len does not cover the target's, params not of the draft's
    knobs."""
    other = LlamaLoRA(device="cpu", **{**KNOBS, "vocab_size": 1 << 9})
    other._params = {}
    with pytest.raises(ValueError, match="vocab"):
        port_lm.make_decode_engine(speculate_k=3, draft_model=other)
    _, pd = _draft_pair(trained_lm, port_lm)
    with pytest.raises(ValueError, match="requires speculate_k >= 2"):
        port_lm.make_decode_engine(speculate_k=1, draft_model=pd)
    short = LlamaLoRA(device="cpu", **{**KNOBS, "max_len": 16})
    short._params = pd._params
    with pytest.raises(ValueError, match="draft max_len must cover"):
        port_lm.make_decode_engine(speculate_k=3, draft_model=short)
    wide = LlamaLoRA(device="cpu", **{**KNOBS, "hidden_dim": 64})
    wide._params = pd._params
    with pytest.raises(ValueError, match="draft parameters do not match"):
        port_lm.make_decode_engine(speculate_k=3, draft_model=wide)
    jwide = JLlamaLoRA(**{**KNOBS, "hidden_dim": 64})
    jwide._params = trained_lm._params
    with pytest.raises(ValueError, match="draft parameters do not match"):
        trained_lm.make_decode_engine(speculate_k=3, draft_model=jwide)


@pytest.mark.parametrize("layout", ["paged8", "contiguous"])
def test_draft_with_prefix_equals_jax(trained_lm, port_lm, layout):
    """system_prefix + a perfect draft: the prefix KV installs into both
    caches, hits keep near-total acceptance, texts equal JAX's."""
    jd, pd = _draft_pair(trained_lm, port_lm)
    prefix = "tok1 tok2 tok3"
    reqs = [("a", prefix + " tok4 tok5"), ("b", prefix + " tok6")]
    page, pages = LAYOUTS[layout]
    kw = dict(max_slots=2, max_new_tokens=6, speculate_k=3,
              system_prefix=prefix,
              **(dict(kv_page_size=page, kv_pages=pages) if page else {}))
    want, jeng = _serve_text(trained_lm, reqs, draft_model=jd, **kw)
    got, teng = _serve_text(port_lm, reqs, draft_model=pd, **kw)
    ref, _ = _serve_text(port_lm, reqs, max_slots=2, max_new_tokens=6)
    assert got == want == ref
    ts = _same_stats(jeng.engine, teng.engine)
    assert ts["prefix_hits"] == 2
    assert ts["spec_accepted"] >= 0.9 * ts["spec_drafted"], ts


def test_draft_resync_after_a_gated_stretch_equals_jax(trained_lm,
                                                       port_lm):
    """Gate forced shut: the scan skips the draft mirror and the draft
    goes stale; reopened, the engine rebuilds the draft cache from the
    accepted contexts (``draft_resyncs``) and stays lossless."""
    jd, pd = _draft_pair(trained_lm, port_lm)
    outs, engines = [], []
    for lm, d in ((trained_lm, jd), (port_lm, pd)):
        eng = lm.make_decode_engine(max_slots=2, max_new_tokens=6,
                                    speculate_k=3, draft_model=d)
        eng.engine._spec_ema = 0.0
        eng.submit("warm", "tok1 tok2")
        while eng.busy:
            eng.step()
        eng.poll()
        assert eng.engine._draft_synced is False
        eng.engine._spec_ema = eng.engine._spec_floor + 1.0
        eng.submit("x", "tok1 tok2 tok3")
        got = {}
        while eng.busy:
            eng.step()
            got.update(dict(eng.poll()))
        outs.append(got)
        engines.append(eng.engine)
    ref, _ = _serve_text(port_lm, [("x", "tok1 tok2 tok3")], max_slots=2,
                         max_new_tokens=6)
    assert outs[1] == outs[0] == ref
    ts = _same_stats(*engines)
    assert ts["draft_resyncs"] >= 1


def test_reset_rebuilds_the_draft_and_the_gate(trained_lm, port_lm):
    _, pd = _draft_pair(trained_lm, port_lm)
    eng = port_lm.make_decode_engine(max_slots=2, max_new_tokens=6,
                                     speculate_k=3, draft_model=pd).engine
    eng._spec_ema, eng._spec_idle, eng._draft_synced = 0.0, 7, False
    eng.submit("a", np.asarray([1, 5, 9], np.int32), 4)
    eng.step()
    eng.reset()
    assert (eng._spec_ema, eng._spec_idle, eng._draft_synced) == (
        eng._spec_floor + 0.5, 0, True)
    assert all(float(c["k"].abs().sum()) == 0 for c in eng._draft_cache)
