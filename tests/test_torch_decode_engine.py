"""Port parity: the ``rafiki_tpu_torch`` paged ``DecodeEngine`` against the
JAX ``DecodeEngine`` on the shared JAX-trained LM fixture.

Both engines get the same weights (through the weight bridge) and the
same traffic — mixed prompt lengths, half the requests admitted mid-
flight, a pool small enough that admission backpressures — and must emit
the same tokens and schedule the same way (the counters agree too).
"""

import numpy as np
import pytest
import torch

from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
PAGE = 8
#: scheduling counters both engines must agree on
SAME_STATS = ("steps", "tokens_generated", "requests_done",
              "prefill_calls", "prefill_tokens", "kv_pages_used",
              "kv_pages_high_water", "kv_pages_total", "admission_stalls",
              "max_concurrent")


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


def _drain(eng, reqs):
    """Submit half the requests, run two steps, submit the rest
    (admission mid-flight), then step until every request is done."""
    half = len(reqs) // 2
    for rid, p, mn in reqs[:half]:
        eng.submit(rid, p, mn)
    done = {}
    for n in range(600):
        if n == 2:
            for rid, p, mn in reqs[half:]:
                eng.submit(rid, p, mn)
        eng.step()
        done.update({rid: list(toks) for rid, toks in eng.poll()})
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"undrained: {sorted(done)} / {eng.stats}")


@pytest.mark.parametrize("steps_per_sync", [1, 4], ids=["K1", "K4"])
@pytest.mark.parametrize("prefill_chunk", [1, 8], ids=["C1", "C8"])
def test_paged_engine_token_exact_vs_jax(trained_lm, port_lm,
                                         prefill_chunk, steps_per_sync):
    """8 mixed-length greedy requests through 4 slots and a 9-page pool
    (8 usable pages: admission stalls), half admitted mid-flight."""
    reqs = _mixed_reqs(8)
    kw = dict(max_slots=4, max_len=L, steps_per_sync=steps_per_sync,
              prefill_chunk=prefill_chunk)
    jeng = JaxDecodeEngine(trained_lm._module(kv_page_size=PAGE,
                                              kv_pages=9),
                           trained_lm._params, **kw)
    teng = DecodeEngine(port_lm._serving_module_params(PAGE, 9),
                        device="cpu", **kw)
    want = _drain(jeng, reqs)
    got = _drain(teng, reqs)
    assert got == want
    js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    assert {k: ts[k] for k in SAME_STATS} == {k: js[k] for k in SAME_STATS}
    assert ts["admission_stalls"] > 0       # backpressure really happened
    assert ts["kv_pages_used"] == 0         # drained → every page freed
    assert sorted(teng._free_pages) == list(range(1, 9))


def test_contiguous_engine_token_exact_vs_jax(trained_lm, port_lm):
    reqs = _mixed_reqs(6, seed=3)
    kw = dict(max_slots=4, max_len=L, steps_per_sync=3, prefill_chunk=4)
    want = _drain(JaxDecodeEngine(trained_lm._module(), trained_lm._params,
                                  **kw), reqs)
    got = _drain(DecodeEngine(port_lm._serving_module_params(),
                              device="cpu", **kw), reqs)
    assert got == want


def test_text_engine_matches_jax_template(trained_lm, port_lm):
    """``make_decode_engine(kv_page_size=8)`` on the port serves the same
    text as the JAX template's, streamed deltas included."""
    texts = {0: "tok1 tok2 tok3", 1: "the quick brown fox jumps",
             2: "a", 3: "tok4 tok5 tok6 tok7 tok8 tok9 tok10", 4: "b c"}

    def serve(lm):
        eng = lm.make_decode_engine(max_slots=3, max_new_tokens=6,
                                    kv_page_size=PAGE)
        for rid, text in texts.items():
            eng.submit(rid, text)
        done, streamed = {}, {}
        for _ in range(300):
            eng.step()
            for rid, delta in eng.poll_partial():
                streamed[rid] = streamed.get(rid, "") + delta
            done.update(dict(eng.poll()))
            if not eng.busy:
                return done, streamed
        raise AssertionError("undrained")

    want, want_stream = serve(trained_lm)
    got, got_stream = serve(port_lm)
    assert got == want and len(got) == len(texts)
    assert got_stream == want_stream


def test_submit_rejects_request_larger_than_pool(port_lm):
    eng = DecodeEngine(port_lm._serving_module_params(PAGE, 3),
                       max_slots=2, max_len=L, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(0, np.arange(1, 20, dtype=np.int32), 8)  # 4 pages > 2
    eng.submit(1, np.arange(1, 5, dtype=np.int32), 4)  # 1 page fits


def test_reset_frees_pool_and_slots(port_lm):
    eng = DecodeEngine(port_lm._serving_module_params(PAGE, 9),
                       max_slots=4, max_len=L, device="cpu")
    for rid, p, mn in _mixed_reqs(4):
        eng.submit(rid, p, mn)
    eng.step()
    assert eng.busy and eng.stats["kv_pages_used"] > 0
    eng.reset()
    assert not eng.busy and eng.stats["kv_pages_used"] == 0
    assert sorted(eng._free_pages) == list(range(1, 9))
    assert all(float(c["k"].abs().sum()) == 0 for c in eng._cache)


def test_unported_modes_raise(port_lm):
    mod = port_lm._serving_module_params(PAGE, 9)
    for kw in ({"speculate_k": 3}, {"host_kv_pages": 4},
               {"draft": (mod, None)}):
        with pytest.raises(NotImplementedError):
            DecodeEngine(mod, max_slots=2, max_len=L, device="cpu", **kw)
    eng = DecodeEngine(mod, max_slots=2, max_len=L, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.submit(0, np.array([1, 2], np.int32), 4, temperature=0.7)
    for call in (lambda: eng.register_prefix(np.array([1, 2])),
                 lambda: eng.export_prefix(), lambda: eng.poll_kv(),
                 lambda: eng.import_prefix({}),
                 lambda: eng.stage_kv_blob({})):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError):
        port_lm.make_decode_engine(system_prefix="tok1")
