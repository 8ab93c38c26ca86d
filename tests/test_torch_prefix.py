"""Port parity: registered, exported and imported prefixes in the
``rafiki_tpu_torch`` ``DecodeEngine`` against the JAX engine.

Mirrors the prefix cases of ``tests/test_decode_engine.py`` and
``tests/test_paged_kv.py``: a registered prefix changes no token for
prompts that extend it, equal it, miss it or are shorter, while hits skip
its prefill (``prefix_hits``/``prefix_tokens`` equal to JAX's); paged at
pages 8 and 4 and contiguous. The wire form: a prefix blob exported by
the JAX engine installs into the port and the reverse, at depth 12 (the
layers of a blob lie in ``jax.tree_util``'s lexicographic order:
``block_0, block_1, block_10, block_11, block_2, ...``), bf16 leaves
through both param-store codecs, int8-KV scale leaves with them; a blob
of the wrong geometry raises JAX's ``ValueError``. Then a port worker and
a JAX worker of one pool share ``prefix:{pool_id}:0`` through the kv hub.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu.serving.predictor import Predictor
from rafiki_tpu.serving.queues import pack_message as jpack
from rafiki_tpu.serving.queues import unpack_message as junpack
from rafiki_tpu.store.param_store import ParamStore as JParamStore
from rafiki_tpu.worker.inference import InferenceWorker as JWorker
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving import kv_transfer as kvt
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine
from rafiki_tpu_torch.serving.queues import pack_message, unpack_message
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.worker.inference import InferenceWorker

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
LAYOUTS = {"paged8": (8, 13), "paged4": (4, 25), "contiguous": (0, 0)}
PREFIX = np.asarray([1, 5, 9, 13, 2], np.int32)
PROMPTS = {
    "hit": np.concatenate([PREFIX, [7, 4]]).astype(np.int32),
    "hit2": np.concatenate([PREFIX, [3]]).astype(np.int32),
    "exact": PREFIX.copy(),                       # not strictly longer
    "miss": np.asarray([2, 5, 9, 13, 2, 7], np.int32),
    "short": np.asarray([1, 5], np.int32),
}
SAME_STATS = ("steps", "tokens_generated", "requests_done", "prefill_calls",
              "prefill_tokens", "prefix_hits", "prefix_tokens",
              "kv_imports", "kv_pages_used", "kv_pages_high_water",
              "admission_stalls", "preemptions")


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


def _pair(jlm, plm, layout, **kw):
    page, pages = LAYOUTS[layout]
    jmod = (jlm._module(kv_page_size=page, kv_pages=pages) if page
            else jlm._module())
    return (JaxDecodeEngine(jmod, jlm._params, max_len=L, **kw),
            DecodeEngine(plm._serving_module_params(page, pages), max_len=L,
                         device="cpu", **kw))


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


def _same_stats(jeng, teng):
    js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    assert {k: ts[k] for k in SAME_STATS} == {k: js[k] for k in SAME_STATS}
    return ts


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_registered_prefix_equals_jax_and_plain(trained_lm, port_lm,
                                                layout):
    reqs = [(n, p, 6, {}) for n, p in PROMPTS.items()]
    jeng, teng = _pair(trained_lm, port_lm, layout, max_slots=3)
    assert teng.register_prefix(PREFIX) == jeng.register_prefix(PREFIX) \
        == len(PREFIX)
    want, got = _run(jeng, reqs), _run(teng, reqs)
    plain = _run(_pair(trained_lm, port_lm, layout, max_slots=3)[1], reqs)
    assert got == want == plain
    ts = _same_stats(jeng, teng)
    assert ts["prefix_hits"] == 2                 # hit + hit2 only
    assert ts["prefix_tokens"] == 2 * len(PREFIX)


@pytest.mark.parametrize("layout", ["paged8", "contiguous"])
def test_prefix_with_tokenwise_prefill_equals_jax(trained_lm, port_lm,
                                                  layout):
    """prefill_chunk=1: the prompt past the prefix streams through the
    decode steps from the prefix boundary."""
    prefix = np.asarray([1, 7, 2, 9], np.int32)
    reqs = [("x", np.concatenate([prefix, [5, 3]]).astype(np.int32), 5,
             {})]
    jeng, teng = _pair(trained_lm, port_lm, layout, max_slots=2,
                       prefill_chunk=1)
    jeng.register_prefix(prefix)
    teng.register_prefix(prefix)
    want, got = _run(jeng, reqs), _run(teng, reqs)
    plain = _run(_pair(trained_lm, port_lm, layout, max_slots=2,
                       prefill_chunk=1)[1], reqs)
    assert got == want == plain
    _same_stats(jeng, teng)


def test_system_prefix_through_the_template_equals_jax(trained_lm,
                                                       port_lm):
    sys_text = "tok1 tok5"
    query = sys_text + " tok9 tok13"
    outs = []
    for lm in (trained_lm, port_lm):
        for kw in ({}, {"system_prefix": sys_text}):
            eng = lm.make_decode_engine(max_slots=2, max_new_tokens=6,
                                        kv_page_size=8, **kw)
            eng.submit("q", query)
            done = {}
            while eng.busy:
                eng.step()
                done.update(dict(eng.poll()))
            outs.append((done["q"], eng.stats["prefix_hits"]))
    assert outs[3] == outs[1] and outs[2][0] == outs[3][0] == outs[0][0]
    assert outs[3][1] == 1 and outs[2][1] == 0


def test_preempted_slot_rematches_the_prefix_as_jax_does(trained_lm,
                                                         port_lm):
    """One slot: a background request extending the prefix is preempted
    by an interactive one and resumes; its re-admission hits the prefix
    again (its prompt still extends it), counted as JAX counts it."""
    bg = np.concatenate([PREFIX, [7, 4, 6]]).astype(np.int32)
    outs = []
    for eng in _pair(trained_lm, port_lm, "paged8", max_slots=1,
                     steps_per_sync=2):
        eng.register_prefix(PREFIX)
        eng.submit("bg", bg, 10, slo="background")
        eng.step()
        eng.step()
        eng.submit("ia", np.asarray([2, 4], np.int32), 4,
                   slo="interactive")
        done = {}
        for _ in range(200):
            eng.step()
            done.update({r: [int(t) for t in ids] for r, ids in eng.poll()})
            if len(done) == 2:
                break
        outs.append((done, eng.stats_snapshot()))
    (jdone, js), (pdone, ps) = outs
    assert pdone == jdone
    assert ps["preemptions"] == js["preemptions"] == 1
    assert ps["prefix_hits"] == js["prefix_hits"] == 2


# ---- the wire form

DEEP = dict(KNOBS, depth=12)


@pytest.fixture(scope="module")
def deep_pair():
    """A depth-12 model (hidden 32) from a seeded JAX init with nonzero
    adapters, loaded by both templates: depth 12 puts block_10 and
    block_11 between block_1 and block_2 in the blob."""
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


def _deep_reqs():
    return [(f"r{i}", np.concatenate([PREFIX, np.asarray(t, np.int32)]),
             6, {}) for i, t in enumerate(([7, 4], [3], [8, 8, 1]))]


def test_leaf_order_is_jax_tree_util_order():
    cache = [{"k": i, "v": 100 + i} for i in range(12)]
    leaves = kvt.cache_leaves(cache)
    assert leaves[:6] == [0, 100, 1, 101, 10, 110]
    assert kvt.cache_from_leaves(leaves, cache) == cache
    tree = {f"block_{i}": {"attn": {"k": i, "v": 100 + i}}
            for i in range(12)}
    assert leaves == jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("layout", ["paged8", "contiguous"])
def test_jax_blob_installs_into_the_port_and_back(deep_pair, layout):
    jm, pm = deep_pair
    jeng, teng = _pair(jm, pm, layout, max_slots=3)
    jeng.register_prefix(PREFIX)
    teng.register_prefix(PREFIX)
    jblob, pblob = jeng.export_prefix(), teng.export_prefix()
    assert pblob["sig"] == jblob["sig"] and pblob["len"] == jblob["len"]
    assert pblob["nbytes"] == jblob["nbytes"]
    assert set(pblob) == set(jblob)
    for a, b in zip(pblob["leaves"], jblob["leaves"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    want = _run(jeng, _deep_reqs())
    # the JAX blob over the JAX codec into a fresh port engine
    fresh_p = _pair(jm, pm, layout, max_slots=3)[1]
    assert fresh_p.import_prefix(unpack_message(jpack(jblob))) == \
        len(PREFIX)
    assert _run(fresh_p, _deep_reqs()) == want
    assert fresh_p.stats["prefix_hits"] == 3
    assert fresh_p.stats["kv_imports"] == 1
    # the port blob over the port codec into a fresh JAX engine
    fresh_j = _pair(jm, pm, layout, max_slots=3)[0]
    assert fresh_j.import_prefix(junpack(pack_message(pblob))) == \
        len(PREFIX)
    assert _run(fresh_j, _deep_reqs()) == want
    # and port to port
    again = _pair(jm, pm, layout, max_slots=3)[1]
    again.import_prefix(unpack_message(pack_message(pblob)))
    assert _run(again, _deep_reqs()) == want


def test_a_numeric_layer_order_would_differ(deep_pair):
    """The check above has teeth: the same leaves regrouped in numeric
    layer order install a different cache, and the tokens change."""
    jm, pm = deep_pair
    jeng = _pair(jm, pm, "contiguous", max_slots=3)[0]
    jeng.register_prefix(PREFIX)
    jblob = jeng.export_prefix()
    want = _run(jeng, _deep_reqs())
    names = ["k", "v"]
    numeric = [leaf for i in range(12) for leaf in
               kvt.cache_from_leaves(jblob["leaves"], [dict.fromkeys(
                   names)] * 12)[i].values()]
    swapped = dict(jblob, leaves=numeric)
    eng = _pair(jm, pm, "contiguous", max_slots=3)[1]
    eng.import_prefix(swapped)  # same shapes: nothing raises
    assert _run(eng, _deep_reqs()) != want


@pytest.mark.parametrize("case", ["not_a_blob", "version", "length",
                                  "too_long", "leaf_count", "dtype",
                                  "shape"])
def test_a_blob_of_the_wrong_geometry_raises_jax_s_error(trained_lm,
                                                         port_lm, case):
    jeng, teng = _pair(trained_lm, port_lm, "paged8", max_slots=2)
    jeng.register_prefix(PREFIX)
    blob = jeng.export_prefix()
    leaves = [np.asarray(v) for v in blob["leaves"]]
    bad = {"not_a_blob": [1, 2],
           "version": dict(blob, v=2),
           "length": dict(blob, len=3),
           "too_long": dict(blob, len=L - 1,
                            ids=np.arange(L - 1, dtype=np.int32)),
           "leaf_count": dict(blob, leaves=leaves[:-1]),
           "dtype": dict(blob, leaves=[v.astype(np.int8) for v in leaves]),
           "shape": dict(blob, leaves=[v[..., :4] for v in leaves])}[case]
    with pytest.raises(ValueError) as want:
        jeng.import_prefix(bad)
    with pytest.raises(ValueError) as got:
        teng.import_prefix(bad)
    assert str(got.value) == str(want.value)
    assert teng.stats["kv_imports"] == 0 and not teng._prefixes


def test_bf16_blobs_cross_both_codecs(trained_lm):
    """bf16 leaves travel as ``bfloat16`` over uint16 bits: a port blob
    reads back in JAX with the same bits and installs; a JAX blob
    installs into the port bit for bit."""
    knobs = dict(KNOBS, bf16=True)
    dump = trained_lm.dump_parameters()
    jm, pm = JLlamaLoRA(**knobs), LlamaLoRA(device="cpu", **knobs)
    jm.load_parameters(dump)
    pm.load_parameters(dump)
    jeng, teng = _pair(jm, pm, "paged8", max_slots=2)
    jeng.register_prefix(PREFIX)
    teng.register_prefix(PREFIX)
    pblob, jblob = teng.export_prefix(), jeng.export_prefix()
    assert pblob["sig"] == jblob["sig"]
    assert {s[1] for s in pblob["sig"]} == {"bfloat16"}
    back = junpack(pack_message(pblob))
    for a, b in zip(back["leaves"], pblob["leaves"]):
        assert str(a.dtype) == "bfloat16"
        assert np.array_equal(a.view(np.uint16),
                              b.view(torch.int16).numpy().view(np.uint16))
    fresh_j = _pair(jm, pm, "paged8", max_slots=2)[0]
    fresh_j.import_prefix(back)
    fresh_p = _pair(jm, pm, "paged8", max_slots=2)[1]
    fresh_p.import_prefix(unpack_message(jpack(jblob)))
    for t, b in zip(kvt.cache_leaves(fresh_p._prefixes[0]["cache"]),
                    jblob["leaves"]):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(b).view(np.uint16))


def test_int8_kv_blobs_carry_their_scales(trained_lm):
    knobs = dict(KNOBS, kv_cache_int8=True)
    dump = trained_lm.dump_parameters()
    jm, pm = JLlamaLoRA(**knobs), LlamaLoRA(device="cpu", **knobs)
    jm.load_parameters(dump)
    pm.load_parameters(dump)
    jeng, teng = _pair(jm, pm, "paged8", max_slots=2)
    jeng.register_prefix(PREFIX)
    jblob = jeng.export_prefix()
    assert [s[1] for s in jblob["sig"][:4]] == ["int8", "float32", "int8",
                                                "float32"]
    reqs = [(n, PROMPTS[n], 6, {}) for n in ("hit", "hit2")]
    want = _run(jeng, reqs)
    teng.import_prefix(unpack_message(jpack(jblob)))
    assert _run(teng, reqs) == want
    teng2 = _pair(jm, pm, "paged8", max_slots=2)[1]
    teng2.register_prefix(PREFIX)
    pblob = teng2.export_prefix()
    assert pblob["sig"] == jblob["sig"]
    # f32-KV engines refuse the int8 blob by geometry
    pf = LlamaLoRA(device="cpu", **KNOBS)
    pf.load_parameters(dump)
    plain = _pair(trained_lm, pf, "paged8", max_slots=2)[1]
    with pytest.raises(ValueError, match="geometry"):
        plain.import_prefix(jblob)


def test_export_without_a_prefix_is_none(port_lm):
    eng = port_lm.make_decode_engine(max_slots=1)
    assert eng.export_prefix() is None
    assert eng.engine.register_prefix(np.zeros((0,), np.int32)) == 0
    assert not eng.engine._prefixes


# ---- the workers of one pool share the snapshot through the kv hub

SYS = "tok1 tok2 tok3 tok4"
QUERIES = [SYS + " tok5 tok6", SYS + " tok9"]


def _worker(cls, store, hub, wid):
    kw = {"device": "cpu"} if cls is InferenceWorker else {}
    return cls(LlamaLoRA if cls is InferenceWorker else JLlamaLoRA, "t0",
               KNOBS, store, hub, wid, decode_loop=True, max_slots=2,
               max_new_tokens=6, kv_page_size=8, system_prefix=SYS,
               pool_id="pool-1", **kw)


def _serve(worker):
    t = threading.Thread(target=worker.run, kwargs={"poll_timeout": 0.05},
                         daemon=True)
    t.start()
    try:
        preds, info = Predictor(worker.hub, [worker.worker_id],
                                gather_timeout=120.0).predict(QUERIES)
        assert info["workers_answered"] == 1, info
        return preds
    finally:
        worker.stop()
        t.join(timeout=30)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_workers_of_one_pool_share_the_prefix_snapshot(trained_lm, first):
    from rafiki_tpu.native import KVServer
    from rafiki_tpu.serving.queues import KVQueueHub as JKVHub
    from rafiki_tpu_torch.serving.queues import KVQueueHub

    dump = trained_lm.dump_parameters()
    jstore, pstore = JParamStore.from_uri("mem://"), \
        ParamStore.from_uri("mem://")
    jstore.save("t0", dump)
    pstore.save("t0", dump)
    with KVServer() as server:
        hubs = {"jax": JKVHub(server.host, server.port),
                "port": KVQueueHub(server.host, server.port)}
        classes = {"jax": (JWorker, jstore), "port": (InferenceWorker,
                                                      pstore)}
        second = "port" if first == "jax" else "jax"
        w1 = _worker(*classes[first], hubs[first], "w1")
        assert w1.stats["kv_imports_installed"] == 0
        assert hubs[first].get_blob("prefix:pool-1:0") is not None
        w2 = _worker(*classes[second], hubs[second], "w2")
        assert w2.stats["kv_imports_installed"] == 1
        assert w2.engine.engine.stats["kv_imports"] == 1
        texts1, texts2 = _serve(w1), _serve(w2)
    assert texts2 == texts1 and len(texts1) == 2


def test_a_bad_peer_blob_falls_back_to_a_local_prefix(trained_lm):
    from rafiki_tpu.serving.queues import InProcQueueHub as JHub

    pstore = ParamStore.from_uri("mem://")
    pstore.save("t0", trained_lm.dump_parameters())
    hub = JHub()
    hub.put_blob("prefix:pool-1:0", pack_message(
        {"v": 1, "ids": np.arange(3, dtype=np.int32), "len": 3,
         "leaves": [np.zeros((1, 3, 7), np.float32)]}))
    w = _worker(InferenceWorker, pstore, hub, "w3")
    assert w.stats["kv_imports_installed"] == 0
    assert w.engine.engine._prefixes[0]["len"] > 0
    plain = _worker(InferenceWorker, pstore, JHub(), "w4")
    assert _serve(w) == _serve(plain)
