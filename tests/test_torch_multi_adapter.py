"""Port parity: multi-adapter serving in ``rafiki_tpu_torch`` against the
JAX package on the shared JAX-trained LM.

Mirrors ``tests/test_multi_adapter.py``: N adapter-only fine-tunes of one
base share one engine, each request picking its fine-tune per slot. The
port's engine must emit the JAX engine's tokens (f32, greedy; paged at
pages 8 and 4 and contiguous) and each request its solo oracle's;
``stack_lora_adapters`` validates as JAX's does, a stacked JAX tree loads
into ``Llama(n_adapters=N)`` and computes JAX's logits, the int8 knob
composes, and the worker serves a stacked deployment booted from the
store, routed by ``sampling["adapter_id"]``.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.llama_lora import \
    stack_lora_adapters as jstack_lora_adapters
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu.serving.predictor import Predictor
from rafiki_tpu.serving.queues import InProcQueueHub as JHub
from rafiki_tpu.store.param_store import ParamStore as JParamStore
from rafiki_tpu.worker.inference import InferenceWorker as JWorker
from rafiki_tpu_torch.models.llama_lora import (Llama, LlamaLoRA,
                                                greedy_generate,
                                                stack_lora_adapters)
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.store.params import llama_params_from_jax
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_decode_engine import KNOBS
from test_multi_adapter import _lora_variant

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
LAYOUTS = {"paged8": (8, 13), "paged4": (4, 25), "contiguous": (0, 0)}
SAME_STATS = ("steps", "tokens_generated", "requests_done", "prefill_calls",
              "prefill_tokens", "prefix_hits", "prefix_tokens",
              "max_concurrent", "kv_pages_high_water", "spec_calls")
PROMPTS = [np.asarray([1, 5, 9, 13], np.int32),
           np.asarray([1, 7], np.int32),
           np.asarray([2, 4, 6], np.int32),
           np.asarray([3, 1, 4, 1, 5, 9, 2, 6], np.int32)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees(trained_lm):
    """The trained tree and an adapter variant (same base), numpy."""
    a = _np_tree(trained_lm._params)
    return a, _np_tree(_lora_variant(trained_lm._params))


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


def _multi_pair(trained_lm, port_lm, trees, layout, **kw):
    page, pages = LAYOUTS[layout]
    jstacked = jstack_lora_adapters(list(trees))
    jmod = trained_lm._module(n_adapters=len(trees), kv_page_size=page,
                              kv_pages=pages)
    jeng = JaxDecodeEngine(jmod, jstacked, max_len=L, **kw)
    pmodel = port_lm._module(n_adapters=len(trees))
    pmodel.load_state_dict(llama_params_from_jax(
        stack_lora_adapters(list(trees)), pmodel.dtype))
    teng = DecodeEngine(pmodel.with_kv_layout(page, pages), max_len=L,
                        device="cpu", **kw)
    return jeng, teng


def _run(eng, reqs, budget=400):
    for rid, p, mn, kw in reqs:
        eng.submit(rid, p, mn, **kw)
    done = {}
    for _ in range(budget):
        eng.step()
        done.update({rid: [int(t) for t in ids] for rid, ids in eng.poll()})
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"undrained: {sorted(done)}")


def _oracle(port_lm, tree, prompt, max_new):
    """Solo greedy generation of one tree through the port's
    single-adapter model."""
    m = port_lm._module()
    m.load_state_dict(llama_params_from_jax(tree, m.dtype))
    out = greedy_generate(m, np.asarray(prompt, np.int32)[None, :],
                          np.asarray([len(prompt)], np.int32), max_new)
    return [int(t) for t in out[0]]


def test_stacked_tree_loads_and_matches_jax_logits(trained_lm, port_lm,
                                                   trees):
    """The weight bridge takes the stacked JAX tree (a leading adapter
    axis on every lora_a/lora_b) into ``Llama(n_adapters=2)``, and each
    row's logits under its adapter equal the JAX module's."""
    jstacked = jstack_lora_adapters(list(trees))
    pstacked = stack_lora_adapters(list(trees))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstacked):
        node = pstacked
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(leaf), node)
    model = port_lm._module(n_adapters=2)
    model.load_state_dict(llama_params_from_jax(pstacked, model.dtype))
    assert model.block_0.attn.wq.lora_a.shape == (2, 32, 4)
    ids = np.asarray([[1, 5, 9, 13], [2, 4, 6, 8], [1, 5, 9, 13]], np.int32)
    aid = np.asarray([0, 1, 1], np.int32)
    want = np.asarray(trained_lm._module(n_adapters=2).apply(
        {"params": jstacked}, ids, adapter_ids=aid))
    with torch.no_grad():
        got = model(torch.as_tensor(ids).long(), decode=False,
                    adapter_ids=torch.as_tensor(aid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got[0], got[2])  # adapter 1 really differs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_multi_adapter_engine_equals_jax_and_solo_oracles(
        trained_lm, port_lm, trees, layout):
    """Requests of both adapters in flight together, each equal to the
    JAX engine's and to its own tree's solo generation."""
    reqs = [(("r", i), p, 6, {"adapter_id": i % 2})
            for i, p in enumerate(PROMPTS)]
    jeng, teng = _multi_pair(trained_lm, port_lm, trees, layout,
                             max_slots=4, steps_per_sync=2, prefill_chunk=4)
    want, got = _run(jeng, reqs), _run(teng, reqs)
    assert got == want
    js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    assert {k: ts[k] for k in SAME_STATS} == {k: js[k] for k in SAME_STATS}
    assert ts["max_concurrent"] == 4
    for i, p in enumerate(PROMPTS):
        assert got[("r", i)] == _oracle(port_lm, trees[i % 2], p, 6)


@pytest.mark.parametrize("layout", ["paged8", "contiguous"])
def test_multi_adapter_speculation_equals_jax(trained_lm, port_lm, trees,
                                              layout):
    """A stacked engine speculates too (prompt lookup): the adapter rides
    every verify window."""
    reqs = [(i, p, 8, {"adapter_id": 1 - i % 2})
            for i, p in enumerate(PROMPTS[:3])]
    jeng, teng = _multi_pair(trained_lm, port_lm, trees, layout,
                             max_slots=2, speculate_k=3)
    assert _run(teng, reqs) == _run(jeng, reqs)
    js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    assert ts["spec_calls"] == js["spec_calls"] > 0
    assert ts["spec_accepted"] == js["spec_accepted"]


def test_out_of_range_adapter_is_refused_as_jax_does(trained_lm, port_lm,
                                                     trees):
    jeng, teng = _multi_pair(trained_lm, port_lm, trees, "paged8",
                             max_slots=2)
    for eng in (jeng, teng):
        with pytest.raises(ValueError,
                           match="adapter_id 5 out of range for "
                                 "2-adapter engine"):
            eng.submit("r", np.asarray([1, 2], np.int32), 4, adapter_id=5)
        with pytest.raises(ValueError, match="out of range"):
            eng.register_prefix(np.asarray([1, 2], np.int32),
                                adapter_id=-1)
    # single-adapter engines ignore the field
    solo = port_lm.make_decode_engine(max_slots=1, max_new_tokens=2)
    solo.submit("s", "tok1", adapter_id=99)


def test_stack_validates_the_shared_base_as_jax_does(trained_lm, trees):
    def bump(kp, x):
        path = "/".join(str(getattr(k, "key", k)) for k in kp).lower()
        return x + 1e-3 if "final_norm" in path else x

    bad = _np_tree(jax.tree_util.tree_map_with_path(bump, trees[1]))
    with pytest.raises(ValueError) as want:
        jstack_lora_adapters([trees[0], bad])
    with pytest.raises(ValueError) as got:
        stack_lora_adapters([trees[0], bad])
    assert str(got.value) == str(want.value)
    assert "adapters_only" in str(got.value)
    stack_lora_adapters([trees[0], bad], validate=False)
    with pytest.raises(ValueError, match="at least one"):
        stack_lora_adapters([])


def test_prefix_gated_by_adapter_equals_jax(trained_lm, port_lm, trees):
    """A prefix fast-forwards only requests of the adapter that computed
    it; per-adapter registrations; clearing one keeps the other."""
    prefix = np.asarray([3, 1, 4, 1, 5], np.int32)
    prompt = np.concatenate([prefix, np.asarray([9, 2, 6], np.int32)])
    jeng, teng = _multi_pair(trained_lm, port_lm, trees, "paged8",
                             max_slots=2, steps_per_sync=1, prefill_chunk=2)
    outs = []
    for eng in (jeng, teng):
        out = {}
        assert eng.register_prefix(prefix, adapter_id=1) == len(prefix)
        out.update(_run(eng, [("hit", prompt, 5, {"adapter_id": 1}),
                              ("miss", prompt, 5, {"adapter_id": 0})]))
        out["hits1"] = eng.stats["prefix_hits"]
        eng.register_prefix(prefix, adapter_id=0)
        out.update(_run(eng, [("hit0", prompt, 5, {"adapter_id": 0}),
                              ("hit1", prompt, 5, {"adapter_id": 1})]))
        out["hits2"] = eng.stats["prefix_hits"]
        eng.register_prefix(np.zeros((0,), np.int32), adapter_id=1)
        out.update(_run(eng, [("cleared", prompt, 5, {"adapter_id": 1}),
                              ("kept", prompt, 5, {"adapter_id": 0})]))
        out["hits3"] = eng.stats["prefix_hits"]
        outs.append(out)
    assert outs[1] == outs[0]
    assert (outs[1]["hits1"], outs[1]["hits2"], outs[1]["hits3"]) == (1, 3,
                                                                      4)
    assert outs[1]["hit"] == _oracle(port_lm, trees[1], prompt, 5)
    assert outs[1]["miss"] == _oracle(port_lm, trees[0], prompt, 5)


def test_multi_adapter_composes_with_int8_as_jax_does(trained_lm, trees):
    """quantize_int8: the shared base quantized once, the adapters as
    they are; each adapter's tokens equal the JAX int8 engine's."""
    knobs = {**KNOBS, "quantize_int8": True}
    dump = trained_lm.dump_parameters()
    jq = JLlamaLoRA(**knobs)
    jq.load_parameters(dump)
    pq = LlamaLoRA(device="cpu", **knobs)
    pq.load_parameters(dump)
    outs = []
    for m in (jq, pq):
        eng = m.make_multi_adapter_engine(list(trees), max_slots=2,
                                          max_new_tokens=5,
                                          kv_page_size=8)
        assert eng.engine.module.quantized
        assert eng.engine.module.n_adapters == 2
        outs.append(_run(eng.engine, [
            ("a", PROMPTS[0], 5, {"adapter_id": 0}),
            ("b", PROMPTS[0], 5, {"adapter_id": 1})]))
    assert outs[1] == outs[0]
    assert outs[1]["a"] != outs[1]["b"]


# ---- the worker: a stacked deployment from the store

def _stores(trained_lm, trees):
    """Port and JAX stores holding the trained dump and its variant."""
    dump = trained_lm.dump_parameters()
    out = []
    for cls in (ParamStore, JParamStore):
        store = cls.from_uri("mem://")
        store.save("t-best", dump)
        store.save("t-second", dict(dump, params=trees[1]))
        out.append(store)
    return out


def test_worker_boots_a_stacked_deployment_and_routes_by_adapter(
        trained_lm, trees):
    """``extra_adapter_trials``: adapter 0 the primary trial, adapter 1
    the extra, one engine; requests routed by ``sampling["adapter_id"]``
    through the Predictor get the JAX worker's texts; an out-of-range id
    gets an error reply naming it."""
    pstore, jstore = _stores(trained_lm, trees)
    answers = []
    for cls, store in ((JWorker, jstore), (InferenceWorker, pstore)):
        kw = {"device": "cpu"} if cls is InferenceWorker else {}
        w = cls(LlamaLoRA if cls is InferenceWorker else JLlamaLoRA,
                "t-best", KNOBS, store, JHub(), "w0", decode_loop=True,
                max_slots=4, max_new_tokens=6, kv_page_size=8,
                extra_adapter_trials=["t-second"], **kw)
        assert w.engine.engine.n_adapters == 2
        t = threading.Thread(target=w.run, kwargs={"poll_timeout": 0.05},
                             daemon=True)
        t.start()
        try:
            pred = Predictor(w.hub, ["w0"], gather_timeout=120.0)
            out0, _ = pred.predict(["tok1 tok2 tok3"],
                                   sampling={"adapter_id": 0})
            out1, _ = pred.predict(["tok1 tok2 tok3"],
                                   sampling={"adapter_id": 1})
            _, info = pred.predict(["tok1 tok2 tok3"],
                                   sampling={"adapter_id": -1})
            answers.append((out0, out1, info["errors"]))
        finally:
            w.stop()
            t.join(timeout=30)
    (j0, j1, jerr), (p0, p1, perr) = answers
    assert (p0, p1) == (j0, j1) and p0 != p1
    assert perr and "out of range" in perr[0] and jerr


def test_worker_refuses_a_base_that_does_not_stack(trained_lm, trees):
    def bump(kp, x):
        path = "/".join(str(getattr(k, "key", k)) for k in kp).lower()
        return x + 1e-3 if "final_norm" in path else x

    pstore, _ = _stores(trained_lm, trees)
    pstore.save("t-bad", dict(trained_lm.dump_parameters(), params=_np_tree(
        jax.tree_util.tree_map_with_path(bump, trained_lm._params))))
    with pytest.raises(RuntimeError, match="adapters_only"):
        InferenceWorker(LlamaLoRA, "t-best", KNOBS, pstore, JHub(), "w1",
                        decode_loop=True, extra_adapter_trials=["t-bad"],
                        device="cpu")


def test_worker_refuses_a_draft_with_extra_adapters(trained_lm, trees):
    """The JAX worker's rule: the stacked engine has no draft path."""
    pstore, jstore = _stores(trained_lm, trees)
    for cls, store, kw in ((JWorker, jstore, {}),
                           (InferenceWorker, pstore, {"device": "cpu"})):
        with pytest.raises(ValueError) as ei:
            cls(LlamaLoRA if cls is InferenceWorker else JLlamaLoRA,
                "t-best", KNOBS, store, JHub(), "w2", decode_loop=True,
                speculate_k=3, draft_trial_id="t-second",
                extra_adapter_trials=["t-second"], **kw)
        assert "not supported with multi-adapter" in str(ei.value)


def test_llama_module_takes_n_adapters():
    m = Llama(vocab_size=16, max_len=8, hidden_dim=8, depth=1, n_heads=2,
              n_kv_heads=1, mlp_dim=16, lora_rank=2, n_adapters=3,
              device="cpu")
    assert m.n_adapters == 3
    assert m.block_0.gate.lora_a.shape == (3, 8, 2)
    assert m.block_0.gate.lora_b.shape == (3, 2, 16)
    assert m.lm_head.n_adapters == 0
    ids = torch.zeros(2, 3, dtype=torch.long)
    out = m(ids, decode=False, adapter_ids=torch.tensor([0, 2]))
    assert out.shape == (2, 3, 16)
