"""Port parity: int8 Llama serving (the ``quantize_int8`` and
``kv_cache_int8`` knobs) of ``rafiki_tpu_torch`` against the JAX package.

The shared JAX-trained LM fixture (``trained_lm``: f32, depth 2, hidden
32, head dim 8) goes through the weight bridge into the port. Held here:

- ``quantize_llama_params`` bit-identical to JAX's (int8 kernels and f32
  scales);
- the int8 KV cache after a prefill window and two decode steps: the int8
  K/V rows bit-identical to the JAX module's cache, the scales equal to
  f32 rounding (each is absmax/127 of a K or V vector that the two
  frameworks compute with f32 sums in another order: a few ulps), and the
  row quantizer itself bit-identical to JAX's on the same vectors;
- engines with each knob and both, paged at pages 8 and 4 and contiguous,
  and ``predict``, token-identical to the JAX template's;
- the JAX tests' cache size and logits bounds (``tests/test_kv_int8.py``).

On the CPU the paged kernels run their plain versions, which the
paged-attention tests hold against the Pallas kernels with int8 pools.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import LlamaLoRA as JaxLlamaLoRA
from rafiki_tpu.models.llama_lora import \
    quantize_llama_params as jax_quantize
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine

from test_decode_engine import KNOBS
from test_torch_decode_engine import _drain, _mixed_reqs

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
INT8_KNOBS = {"kv": {"kv_cache_int8": True},
              "weights": {"quantize_int8": True},
              "both": {"kv_cache_int8": True, "quantize_int8": True}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(trained_lm, knobs):
    """The JAX and the port template with ``knobs``, both loaded with the
    fixture's blob."""
    blob = trained_lm.dump_parameters()
    jm = JaxLlamaLoRA(**{**KNOBS, **knobs})
    jm.load_parameters(blob)
    tm = LlamaLoRA(device="cpu", **{**KNOBS, **knobs})
    tm.load_parameters(blob)
    return jm, tm


def test_quantize_llama_params_bit_identical_to_jax(trained_lm):
    """Every base kernel becomes int8 ``qkernel`` + f32 ``qscale`` with
    JAX's bits (``torch.round`` and ``jnp.round`` both round half to
    even); the other leaves pass through unchanged."""
    tree = trained_lm.dump_parameters()["params"]
    want = _flat(jax_quantize(trained_lm._params))
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in _flat(ll.quantize_llama_params(tree)).items()}
    assert got.keys() == want.keys()
    assert sum(k.endswith("/qkernel") for k in got) == 7 * KNOBS["depth"] + 1
    assert not any(k.endswith("/kernel") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_q8_rows_bit_identical_to_jax():
    """The cache's row quantizer on the same vectors: JAX's ``q8`` (the
    closure of ``_DecoderAttention``, spelled out here with its jnp
    calls) and the port's ``_quantize_int8`` along the rows give the same
    int8 rows and scales, ties at .5 included (a row scaled so that
    absmax/127 is 1)."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, 5, 2, 8)).astype(np.float32) * 3
    u[0, 0, 0] = [127, 0.5, 1.5, -2.5, -0.5, 3.5, 126.5, -127]
    u[0, 0, 1] = 0  # the 1e-8 floor

    def jax_q8(x):
        scale = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32)), -1),
                            1e-8) / 127.0
        q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale[..., None]),
                     -127, 127).astype(jnp.int8)
        return np.asarray(q), np.asarray(scale)

    want_q, want_s = jax_q8(jnp.asarray(u))
    got_q, got_s = ll._quantize_int8(torch.from_numpy(u), -1)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert list(want_q[0, 0, 0]) == [127, 0, 2, -2, 0, 4, 126, -127]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_int8_cache_matches_jax_after_prefill_and_decode(trained_lm, paged):
    """A 5-token prefill window and two single-token steps on 2 slots at
    different depths, the same inputs to both: the logits agree at rtol
    1e-4, the int8 K/V leaves are bit-identical to the JAX module's cache
    and the scales equal it to 1e-6 relative."""
    jm, tm = _pair(trained_lm, INT8_KNOBS["kv"])
    kw = dict(kv_page_size=8, kv_pages=9) if paged else {}
    jmod = jm._module(**kw)
    tmod = tm._serving_module_params(**kw)
    assert jmod.kv_int8 and tmod.kv_int8
    jcache = jmod.init(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
                       decode=True)["cache"]
    tcache = tmod.init_cache(2)
    ptab = np.array([[3, 1, 0, 0], [2, 5, 0, 0]], np.int32)
    extra = {"page_tables": jnp.asarray(ptab)} if paged else {}
    ids = np.random.default_rng(1).integers(2, 200, size=(2, 5)).astype(
        np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [0, 1, 2, 2, 2]], np.int32)
    for _ in range(3):
        want, muts = jmod.apply(
            {"params": jm._params, "cache": jcache}, jnp.asarray(ids),
            positions=jnp.asarray(pos), decode=True, mutable=["cache"],
            **extra)
        jcache = muts["cache"]
        want = np.asarray(want)
        got = tmod(torch.from_numpy(ids).long(), torch.from_numpy(pos),
                   tcache, torch.from_numpy(ptab) if paged else None)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        ids = want[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1
    for i in range(KNOBS["depth"]):
        jc = jcache[f"block_{i}"]["attn"]
        assert sorted(tcache[i]) == ["k", "k_scale", "v", "v_scale"]
        for name in ("k", "v"):
            assert tcache[i][name].dtype == torch.int8
            np.testing.assert_array_equal(tcache[i][name].numpy(),
                                          np.asarray(jc[name]))
        for name in ("k_scale", "v_scale"):
            assert tcache[i][name].dtype == torch.float32
            np.testing.assert_allclose(tcache[i][name].numpy(),
                                       np.asarray(jc[name]), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("page", [8, 4, 0], ids=["page8", "page4",
                                                 "contiguous"])
@pytest.mark.parametrize("which", list(INT8_KNOBS))
def test_int8_engine_token_exact_vs_jax(trained_lm, which, page):
    """8 mixed-length greedy requests through 4 slots, half admitted
    mid-flight, on the serving model of each int8 knob set (int8 cache,
    int8 weights, both), paged or contiguous: the port's engine emits the
    JAX engine's tokens."""
    jm, tm = _pair(trained_lm, INT8_KNOBS[which])
    kw = dict(kv_page_size=page, kv_pages=1 + 4 * L // page) if page \
        else {}
    ekw = dict(max_slots=4, max_len=L, steps_per_sync=4, prefill_chunk=8)
    reqs = _mixed_reqs(8, seed=5)
    jmod, jparams = jm._serving_module_params(**kw)
    tmod = tm._serving_module_params(**kw)
    assert (tmod.quantized, tmod.kv_int8) == (jmod.quantized, jmod.kv_int8)
    want = _drain(JaxDecodeEngine(jmod, jparams, **ekw), reqs)
    got = _drain(DecodeEngine(tmod, device="cpu", **ekw), reqs)
    assert got == want


@pytest.mark.parametrize("which", ["weights", "both"])
def test_int8_predict_and_text_engine_match_jax(trained_lm, which):
    """``predict`` (greedy_generate over the contiguous cache) and
    ``make_decode_engine(kv_page_size=8)`` serve the JAX template's
    text."""
    jm, tm = _pair(trained_lm, INT8_KNOBS[which])
    queries = ["tok1 tok2 tok3", "the quick brown fox", "a"]
    assert tm.predict(queries, max_new_tokens=6) == \
        jm.predict(queries, max_new_tokens=6)

    def serve(lm):
        eng = lm.make_decode_engine(max_slots=2, max_new_tokens=5,
                                    kv_page_size=8)
        for rid, text in enumerate(queries):
            eng.submit(rid, text)
        done = {}
        for _ in range(300):
            eng.step()
            done.update(dict(eng.poll()))
            if not eng.busy:
                return done
        raise AssertionError("undrained")

    assert serve(tm) == serve(jm)


def test_int8_serving_model_cached_and_evaluate_keeps_f32(trained_lm,
                                                          tmp_path):
    """The int8 model is quantized once per loaded tree and shared by
    every layout; loading a tree drops it; no compute-dtype model is built
    for serving; evaluate runs the f32 tree and scores what the plain
    template scores."""
    _, tm = _pair(trained_lm, INT8_KNOBS["both"])
    assert tm._model is None
    a = tm._serving_module_params()
    b = tm._serving_module_params(8, 9)
    assert a.quantized and a.kv_int8 and b.kv_page_size == 8
    assert a.block_0.attn.wq.qkernel.data_ptr() == \
        b.block_0.attn.wq.qkernel.data_ptr()
    assert tm._model is None
    tm.load_parameters(trained_lm.dump_parameters())
    assert tm._qmodel is None
    c = tm._serving_module_params()
    assert c.block_0.attn.wq.qkernel.data_ptr() != \
        a.block_0.attn.wq.qkernel.data_ptr()
    from rafiki_tpu.data import generate_text_classification_dataset

    path = str(tmp_path / "val.jsonl")
    generate_text_classification_dataset(path, 16, seed=1)
    plain = LlamaLoRA(device="cpu", **KNOBS)
    plain.load_parameters(trained_lm.dump_parameters())
    assert tm.evaluate(path) == plain.evaluate(path)
    assert not tm._model.quantized


def test_int8_cache_dtype_and_size(trained_lm):
    """``tests/test_kv_int8.py``'s size check on the port's engine: int8
    K/V leaves, f32 scale leaves, under half the f32 cache's bytes."""
    _, tm = _pair(trained_lm, INT8_KNOBS["kv"])
    _, plain = _pair(trained_lm, {})
    cache = tm.make_decode_engine(max_slots=4, max_new_tokens=4).engine \
        ._cache
    f32 = plain.make_decode_engine(max_slots=4, max_new_tokens=4).engine \
        ._cache
    assert all(c["k"].dtype == torch.int8 and c["v"].dtype == torch.int8
               and c["k_scale"].dtype == torch.float32
               and c["v_scale"].dtype == torch.float32 for c in cache)

    def nbytes(c):
        return sum(t.numel() * t.element_size()
                   for layer in c for t in layer.values())

    assert nbytes(cache) < 0.5 * nbytes(f32)


def test_int8_logits_close_to_f32_cache(trained_lm):
    """``tests/test_kv_int8.py``'s logits bound on the port: next-token
    logits through the int8 decode cache within 5 % (of the largest
    logit) of the f32-cache path on the same weights, and as close to the
    JAX module's int8 logits as the f32 paths are to each other."""
    _, tm = _pair(trained_lm, INT8_KNOBS["kv"])
    _, plain = _pair(trained_lm, {})
    ids = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    pos = torch.arange(8, dtype=torch.int32)[None]

    def logits(module):
        return module(ids, pos, module.init_cache(1))[0, -1].numpy()

    l8 = logits(tm._serving_module_params())
    l32 = logits(plain._serving_module_params())
    denom = max(1e-6, float(np.abs(l32).max()))
    assert float(np.abs(l8 - l32).max()) / denom < 0.05
    assert float(np.abs(l8 - l32).max()) > 0  # the cache really is int8
