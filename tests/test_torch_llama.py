"""Port parity: the ``rafiki_tpu_torch`` Llama against the JAX Llama.

The shared JAX-trained LM fixture (``trained_lm``: f32, depth 2, hidden 32)
goes through the weight bridge into the port; from there the port must
reproduce the JAX module's decode logits on both cache layouts (rtol
1e-4 at f32: the two frameworks sum matmuls in different orders) and its
greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models.llama_lora import greedy_generate as jax_greedy
from rafiki_tpu.models.llama_lora import rope as jax_rope
from rafiki_tpu_torch.models.llama_lora import (Llama, LlamaLoRA,
                                                _parse_rope_scaling,
                                                greedy_generate, rope)
from rafiki_tpu_torch.store.params import (llama_params_from_jax,
                                           params_to_jax)

from test_decode_engine import KNOBS

torch.set_num_threads(1)

PAGE = 8
L = int(KNOBS["max_len"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


def test_param_bridge_round_trip_exact(trained_lm, port_lm):
    """JAX tree → state_dict → JAX tree is exact, and the loaded port
    model holds exactly the JAX leaves under the same names."""
    tree = trained_lm.dump_parameters()["params"]
    want = _flat(tree)
    back = _flat(params_to_jax(llama_params_from_jax(tree)))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    loaded = _flat(params_to_jax(port_lm._model.state_dict()))
    assert loaded.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)


def test_bf16_load_casts_matmul_weights_once(trained_lm):
    """bf16 compute: matmul weights become bf16 at load (JAX's per-call
    ``kernel.astype(bf16)`` rounding), norm scales and the embedding
    table stay f32."""
    m = LlamaLoRA(device="cpu", **{**KNOBS, "bf16": True})
    m.load_parameters(trained_lm.dump_parameters())
    tree = _flat(trained_lm.dump_parameters()["params"])
    for key, t in m._model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        src = torch.from_numpy(np.array(tree[key.replace(".", "/")]))
        if leaf in ("kernel", "lora_a", "lora_b"):
            assert t.dtype == torch.bfloat16, key
            assert torch.equal(t, src.bfloat16()), key
        else:
            assert t.dtype == torch.float32, key
            assert torch.equal(t, src), key


@pytest.mark.parametrize("scaling", ["", '{"rope_type": "llama3", '
                                         '"factor": 8.0}'],
                         ids=["plain", "llama3"])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 9000, size=(2, 5)).astype(np.int32)
    sc = _parse_rope_scaling(scaling)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos),
                               theta=500000.0, scaling=sc))
    got = rope(torch.from_numpy(x), torch.from_numpy(pos), theta=500000.0,
               scaling=sc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _jax_decoder(module, paged):
    """The JAX module's decode-branch call, jitted (one compile per
    window length)."""
    @jax.jit
    def call(params, cache, ids, pos, ptab):
        kw = {"page_tables": ptab} if paged else {}
        logits, muts = module.apply(
            {"params": params, "cache": cache}, ids, positions=pos,
            decode=True, mutable=["cache"], **kw)
        return logits, muts["cache"]
    return call


@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged"])
def test_prefill_then_decode_logits_match_jax(trained_lm, port_lm, paged):
    """A 5-token prefill window, then 3 single-token steps fed the
    argmax, on 2 slots at different depths: logits agree at rtol 1e-4
    on every call, for contiguous rows and for the paged pool."""
    b = 2
    kw = dict(kv_page_size=PAGE, kv_pages=9) if paged else {}
    jmod = trained_lm._module(**kw)
    jparams = trained_lm._params
    jcache = jmod.init(jax.random.PRNGKey(0), jnp.zeros((b, 1), jnp.int32),
                       decode=True)["cache"]
    jdecode = _jax_decoder(jmod, paged)
    tmod = port_lm._serving_module_params(**kw)
    tcache = tmod.init_cache(b)
    ptab = np.array([[3, 1, 0, 0], [2, 5, 0, 0]], np.int32)
    tptab = torch.from_numpy(ptab) if paged else None
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 200, size=(b, 5)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [0, 1, 2, 2, 2]], np.int32)
    for _ in range(4):
        want, jcache = jdecode(jparams, jcache, jnp.asarray(ids),
                               jnp.asarray(pos), jnp.asarray(ptab))
        want = np.asarray(want)
        got = tmod(torch.from_numpy(ids).long(), torch.from_numpy(pos),
                   tcache, tptab).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        ids = want[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1


def test_greedy_generate_token_equal(trained_lm, port_lm):
    rng = np.random.default_rng(2)
    lens = np.array([3, 9, 1, 14], np.int32)
    ids = np.zeros((4, 14), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, 1000, size=n)
    want = np.asarray(jax_greedy(trained_lm._module(), trained_lm._params,
                                 ids, lens, 10))
    got = greedy_generate(port_lm._model, ids, lens, 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_predict_matches_jax_template(trained_lm, port_lm):
    queries = ["tok1 tok2 tok3", "the quick brown fox", "a"]
    assert port_lm.predict(queries, max_new_tokens=6) == \
        trained_lm.predict(queries, max_new_tokens=6)


def test_kv_layout_view_shares_weights(port_lm):
    """``with_kv_layout`` re-lays the cache only: the view shares every
    weight tensor and leaves the original contiguous."""
    base = port_lm._model
    view = base.with_kv_layout(PAGE, 9)
    assert base.kv_page_size == 0 and view.kv_page_size == PAGE
    for (n, a), (_, b) in zip(base.state_dict().items(),
                              view.state_dict().items()):
        assert a.data_ptr() == b.data_ptr(), n
    assert view.init_cache(4)[0]["k"].shape == (9, PAGE, 2, 8)
    assert base.init_cache(4)[0]["k"].shape == (4, L, 2, 8)
    with pytest.raises(ValueError):
        base.with_kv_layout(5, 9)  # must divide max_len
    with pytest.raises(ValueError):
        view(torch.zeros(1, 1, dtype=torch.long), cache=view.init_cache(1))


def test_unported_branches_raise():
    m = Llama(vocab_size=16, max_len=8, hidden_dim=8, depth=1, n_heads=2,
              n_kv_heads=1, mlp_dim=16, device="cpu")
    # the train branch is ported; the sharded train path is not
    assert m(torch.zeros(1, 2, dtype=torch.long), decode=False).shape == \
        (1, 2, 16)
    with pytest.raises(NotImplementedError):
        LlamaLoRA(device="cpu", **{**KNOBS, "model_parallel": 2}).train(
            "unread.jsonl")
    for kw in ({"n_adapters": 2}, {"n_experts": 4}):
        with pytest.raises(NotImplementedError):
            Llama(vocab_size=16, max_len=8, hidden_dim=8, depth=1,
                  n_heads=2, n_kv_heads=1, mlp_dim=16, device="cpu", **kw)
    for knob in ("moe_experts", "tokenizer_path", "pretrained_path"):
        with pytest.raises(NotImplementedError, match=knob):
            LlamaLoRA(device="cpu", **{**KNOBS, knob: 4})
    # the int8 serving forms are ported: int8 base kernels with their
    # scales, an int8 cache with its scale leaves, and the knobs
    q = Llama(vocab_size=16, max_len=8, hidden_dim=8, depth=1, n_heads=2,
              n_kv_heads=1, mlp_dim=16, quantized=True, kv_int8=True,
              device="cpu")
    assert q.block_0.attn.wq.qkernel.dtype == torch.int8
    assert q.lm_head.qscale.dtype == torch.float32
    cache = q.init_cache(1)
    assert q(torch.zeros(1, 2, dtype=torch.long), cache=cache).shape == \
        (1, 2, 16)
    assert cache[0]["k"].dtype == torch.int8 and cache[0]["k_scale"].shape \
        == (1, 8, 1)
    m8 = LlamaLoRA(device="cpu", **{**KNOBS, "quantize_int8": True,
                                    "kv_cache_int8": True})
    assert m8._module(quantized=True).quantized and m8._module().kv_int8
