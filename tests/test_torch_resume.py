"""Port parity: stream resume (``forced_prefix``) in the port's
``TextDecodeEngine``, and a Predictor stream that fails over between two
port inference workers.

- ``TextDecodeEngine.submit(forced_prefix=)`` on the port and the JAX
  engine over the same weights: the same final texts and the same stream
  deltas, for the hash tokenizer (``trained_lm``) and for byte-BPE (a
  JAX template trained with a BPE artifact), including a prefix that
  already covers the token budget (completed at once, the engine never
  touched) and a sampled request. With the hash tokenizer a greedy
  resume equals the uninterrupted run; byte-BPE may shift a token
  boundary at the splice, so there the port is held to JAX's output.
- The port's Predictor over two port workers: the worker serving a
  stream is stopped from the test after it streamed deltas; the stream
  completes on the other worker equal to a no-fault run (as
  ``tests/test_chaos.py`` holds the JAX stack, whose chaos injector the
  port does not have).
"""

import threading

import pytest
import torch

from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving.predictor import Predictor
from rafiki_tpu_torch.serving.queues import InProcQueueHub
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_decode_engine import KNOBS
from test_torch_bpe import bpe_lm  # noqa: F401 — the BPE-trained template
from test_torch_worker import _port_store, lm_blob  # noqa: F401

torch.set_num_threads(1)

PROMPTS = ["tok1 tok2 tok3", "tok4 tok5", "w3 w1 tok9"]


def _port_twin(jm, knobs):
    pm = LlamaLoRA(device="cpu", **knobs)
    pm.load_parameters(jm.dump_parameters())
    return pm


def _serve(eng, reqs):
    """Submit ``(rid, text, kwargs)`` requests, step to the end; (final
    texts, every rid's stream deltas in order)."""
    for rid, text, kw in reqs:
        eng.submit(rid, text, **kw)
    done, deltas = {}, {}
    for _ in range(300):
        eng.step()
        for rid, d in eng.poll_partial():
            deltas.setdefault(rid, []).append(d)
        done.update(dict(eng.poll()))
        if len(done) == len(reqs):
            return done, deltas
    raise AssertionError(f"undrained: {sorted(done)}")


def _resume_cases(full, n_words):
    """For each request, prefixes of its delivered text: the first
    ``n`` words, and the whole text (the budget already covered)."""
    reqs = []
    for rid, text in full.items():
        words = text.split(" ")
        for n in n_words:
            if n < len(words):
                reqs.append((f"{rid}/{n}", " ".join(words[:n])))
        reqs.append((f"{rid}/all", text))
    return reqs


@pytest.mark.parametrize("paged", [0, 8], ids=["contiguous", "paged8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_hash_tokenizer_resume_equals_jax(trained_lm, paged, sampled):
    pm = _port_twin(trained_lm, KNOBS)
    kw = ({"temperature": 0.8, "top_k": 20, "seed": 5} if sampled else {})
    engines = [m.make_decode_engine(max_slots=4, max_new_tokens=6,
                                    steps_per_sync=2, kv_page_size=paged)
               for m in (trained_lm, pm)]
    full = {}
    for eng in engines:
        full[eng] = _serve(eng, [(i, p, kw) for i, p in
                                 enumerate(PROMPTS)])[0]
    assert full[engines[1]] == full[engines[0]]
    cases = _resume_cases(full[engines[0]], (1, 3))
    outs = []
    for eng in engines:
        reqs = [(rid, PROMPTS[int(rid.split("/")[0])],
                 {**kw, "forced_prefix": prefix}) for rid, prefix in cases]
        outs.append(_serve(eng, reqs))
    (jdone, jdeltas), (pdone, pdeltas) = outs
    assert pdone == jdone and pdeltas == jdeltas
    for rid, prefix in cases:
        src = full[engines[1]][int(rid.split("/")[0])]
        assert pdone[rid].startswith(prefix)
        if rid.endswith("/all"):  # covered: no engine work, the prefix
            assert pdone[rid] == prefix and rid not in pdeltas
        else:  # deltas continue after the delivered prefix (the last
            #    step's tokens arrive with the final text only)
            assert pdone[rid].startswith(
                prefix + "".join(pdeltas.get(rid, [])))
        if not sampled:  # the whitespace splice keeps token boundaries
            assert pdone[rid] == src
    assert engines[1].engine.stats["requests_done"] == \
        engines[0].engine.stats["requests_done"]


def test_bpe_resume_equals_jax(bpe_lm):  # noqa: F811
    jm, knobs = bpe_lm
    pm = _port_twin(jm, knobs)
    queries = ["tok1 tok2 tok3", "the quick", "naïve café tok5"]
    engines = [m.make_decode_engine(max_slots=4, max_new_tokens=8,
                                    kv_page_size=8) for m in (jm, pm)]
    full = [_serve(eng, [(i, q, {}) for i, q in enumerate(queries)])[0]
            for eng in engines]
    assert full[1] == full[0]
    cases = _resume_cases(full[0], (1, 2))
    cases.append(("0/chars", full[0][0][:max(1, len(full[0][0]) // 2)]))
    outs = [_serve(eng, [(rid, queries[int(rid.split("/")[0])],
                          {"forced_prefix": prefix})
                         for rid, prefix in cases]) for eng in engines]
    assert outs[1] == outs[0]
    for rid, prefix in cases:
        assert outs[1][0][rid].startswith(prefix)


def test_forced_prefix_state_is_dropped_on_poll_and_reset(trained_lm):
    pm = _port_twin(trained_lm, KNOBS)
    eng = pm.make_decode_engine(max_slots=2, max_new_tokens=4)
    eng.submit("a", "tok1 tok2", forced_prefix="x")
    eng.submit("b", "tok1", forced_prefix="p q r s t")  # covers 4 tokens
    assert set(eng._forced) == {"a"} and eng._forced_done == [
        ("b", "p q r s t")]
    eng.reset()
    assert not eng._forced and not eng._forced_done and not eng.busy
    done, _ = _serve(eng, [("c", "tok1 tok2", {"forced_prefix": "x"})])
    assert done["c"].startswith("x ") and not eng._forced
    assert not eng._stream_sent
    # a shipment is validated as the JAX engine validates it
    with pytest.raises(ValueError, match="KV blob version None != 1"):
        eng.submit("d", "tok1", kv_blob={"covered": 1})
    # a resume drops a shipment, as the JAX engine does
    eng.submit("e", "tok1", forced_prefix="x", kv_blob={"covered": 1})


def _boot(store, hub, wid, **kw):
    w = InferenceWorker(LlamaLoRA, "t0", KNOBS, store, hub, wid,
                        decode_loop=True, max_slots=4, max_new_tokens=6,
                        kv_page_size=8, device="cpu", **kw)
    t = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.05},
                         daemon=True)
    t.start()
    return w, t


def _collect(events_iter):
    events = list(events_iter)
    acc = ""
    for ev in events[:-1]:
        assert set(ev) == {"delta"}, ev
        acc += "".join(ev["delta"].values())
    return events, acc


def test_stream_fails_over_between_port_workers_token_exact(
        lm_blob):  # noqa: F811
    """A worker stopped mid-stream (deltas already delivered) fails over
    to its healthy twin, which re-ingests the delivered text as a forced
    prefix: the stream ends equal to a no-fault run, nothing duplicated,
    nothing lost."""
    hub = InProcQueueHub()
    ref, ref_t = _boot(_port_store(lm_blob), hub, "ref")
    try:
        events, acc = _collect(Predictor(
            hub, ["ref"], gather_timeout=120.0).predict_stream(
                ["tok1 tok2 tok3"], timeout=60.0))
        expected = events[-1]["predictions"]
        assert acc == expected[0] and len(expected[0].split(" ")) == 6
    finally:
        ref.stop()
        ref_t.join(timeout=10)

    hub = InProcQueueHub()
    store = _port_store(lm_blob)
    workers = dict((wid, _boot(store, hub, wid, steps_per_sync=1))
                   for wid in ("w0", "w1"))
    stopped = []

    def stop_after_three_tokens(w):
        step = w.engine.step

        def wrapped():
            n = step()
            if not stopped and w.engine.stats["tokens_generated"] >= 3:
                stopped.append(w.worker_id)
                w.stop()  # the loop streams these deltas, then exits
            return n
        w.engine.step = wrapped

    for w, _t in workers.values():
        stop_after_three_tokens(w)
    pred = Predictor(hub, ["w0", "w1"], gather_timeout=120.0,
                     stream_silence_timeout_s=1.0,
                     breaker_fail_threshold=1)
    try:
        events, acc = _collect(pred.predict_stream(["tok1 tok2 tok3"],
                                                   timeout=60.0))
        final = events[-1]
        assert final.get("done") and "error" not in final, final
        assert final["predictions"] == expected
        assert acc == expected[0], (acc, expected)
        assert final["info"]["failovers"] == 1
        assert len(stopped) == 1 and len(events) >= 3
        dead, _t = workers[stopped[0]]
        _t.join(timeout=10)
        assert not _t.is_alive()
        assert int(pred._c_failover.value) == 1
        live = workers["w1" if stopped[0] == "w0" else "w0"][0]
        assert live.engine.stats["requests_done"] >= 1
    finally:
        for w, t in workers.values():
            w.stop()
            t.join(timeout=10)
