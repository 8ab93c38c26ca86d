"""Port parity for the MoE FFN (``rafiki_tpu_torch/ops/moe.py``) and the
MoE ``Llama`` against the JAX package, in f32 on the CPU.

- ``router_dispatch`` at k = 1 and 2, with and without overflow: the
  dispatch tensor equal, the combine tensor and the aux within the f32
  bound;
- ``MoEFeedForward``'s output, aux and gradients (input, router and
  experts) against JAX's;
- a MoE ``Llama`` forward over rows with padded ``lens``: logits and the
  summed aux against JAX's, and padding rows (the card's ``ROW_BUCKET``)
  routed as if absent;
- the template: MoE training (k = 1, 2) to JAX's losses, leaves and
  score; a JAX-trained MoE blob served token for token through
  ``predict`` (padded to JAX's power-of-two batch) and the decode engines;
  the params bridge, the trainable mask and the int8 quantizer on MoE
  leaves; a dense HF checkpoint leaves the experts at their init.

Tolerances: the f32 bound ``1e-5 + 1e-5·|ref|`` per element for the
module's outputs and gradients; losses at 1e-4 relative and trained
leaves at 1e-4 absolute, as ``test_torch_llama_train.py`` holds them
(Adam divides each gradient entry by its own root-mean-square, so an
expert entry whose gradient sits at rounding level moves by up to
lr per step in either framework; 2.2e-4 is seen at lr 1e-2, 2e-5 at
the 1e-3 used here); scores at 1e-5; tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models.llama_lora import Llama as JLlama
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.llama_lora import lora_trainable_mask
from rafiki_tpu.models.llama_lora import \
    quantize_llama_params as jax_quantize
from rafiki_tpu.ops import moe as jmoe
from rafiki_tpu.serving.decode_engine import DecodeEngine as JDecodeEngine
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import convert as pconv
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.ops import moe as pmoe
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine
from rafiki_tpu_torch.store.params import (llama_params_from_jax,
                                           params_to_jax)

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
MOE = {**KNOBS, "moe_experts": 4, "moe_top_k": 2, "max_epochs": 2,
       "learning_rate": 1e-3}


def _f32_close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    bound = 1e-5 + 1e-5 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), (
        err_msg, float(np.max(np.abs(got - want) / bound)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("top_k", [1, 2], ids=["k1", "k2"])
@pytest.mark.parametrize("tokens,experts,capacity", [
    (16, 4, 3), (24, 4, 9), (7, 3, 2), (12, 4, 1)],
    ids=["overflow", "roomy", "odd", "one-slot"])
def test_router_dispatch_matches_jax(top_k, tokens, experts, capacity):
    rng = np.random.default_rng(tokens * 10 + top_k)
    logits = rng.normal(size=(tokens, experts)).astype(np.float32)
    jd, jc, ja = jmoe.router_dispatch(jnp.asarray(logits), capacity, top_k)
    pd, pc, pa = pmoe.router_dispatch(torch.from_numpy(logits), capacity,
                                      top_k)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    _f32_close(pc.numpy(), jc, "combine")
    _f32_close(float(pa), float(ja), "aux")
    kept = int(np.asarray(jd).sum())
    if capacity * experts < tokens * top_k:
        assert kept < tokens * top_k  # the overflow case drops choices


def test_expert_capacity_is_jaxs():
    for t, k, e in ((2048, 2, 8), (7, 1, 3), (1, 2, 4), (4096, 1, 16)):
        want = max(1, int(-(-t * k * 1.25 // e)))
        assert pmoe.expert_capacity(t, k, e) == want


@pytest.mark.parametrize("top_k", [1, 2], ids=["k1", "k2"])
def test_moe_feedforward_and_grads_match_jax(top_k):
    b, s, d, h, e = 2, 12, 16, 24, 4
    rng = np.random.default_rng(top_k)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(b, s, d)).astype(np.float32)
    jmod = jmoe.MoEFeedForward(e, h, router_top_k=top_k)
    params = jmod.init(jax.random.PRNGKey(top_k), jnp.asarray(x))["params"]

    def jloss(p, xx):
        y, muts = jmod.apply({"params": p}, xx, mutable=["losses"])
        aux = jmoe.moe_aux_loss(muts)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    mod = pmoe.MoEFeedForward(d, e, h, torch.device("cpu"),
                              torch.Generator().manual_seed(0), top_k=top_k)
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(mod, name).copy_(torch.from_numpy(np.asarray(leaf)))
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in mod.named_parameters()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = torch.func.functional_call(mod, leaves, (xt,))
    (y * torch.from_numpy(w)).sum().add(aux).backward()
    _f32_close(y.detach().numpy(), jy, "y")
    _f32_close(float(aux), float(jaux), "aux")
    scale = max(float(np.abs(np.asarray(jgx)).max()), 1e-30)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * scale)
    for name, g in jgp.items():
        g = np.asarray(g)
        np.testing.assert_allclose(leaves[name].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-30),
                                   err_msg=name)


def _moe_llama_pair(top_k=2, seed=0):
    kw = dict(vocab_size=96, max_len=16, hidden_dim=32, depth=2, n_heads=4,
              n_kv_heads=2, mlp_dim=48, lora_rank=2, n_experts=4)
    jmod = JLlama(**kw, moe_top_k=top_k)
    ids = np.random.default_rng(seed).integers(
        1, 96, size=(3, 16)).astype(np.int32)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ids))["params"]
    model = ll.Llama(**kw, moe_top_k=top_k, device="cpu")
    model.load_state_dict(llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmod, params, model, ids


def test_moe_llama_forward_with_padded_lens_matches_jax():
    jmod, params, model, ids = _moe_llama_pair()
    lens = np.array([16, 9, 3], np.int32)
    jlogits, muts = jmod.apply({"params": params}, jnp.asarray(ids),
                               lens=jnp.asarray(lens), mutable=["losses"])
    aux = []
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), decode=False,
                    lens=torch.from_numpy(lens), aux_losses=aux)
    assert len(aux) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-5)
    _f32_close(float(pmoe.moe_aux_loss(aux)),
               float(jmoe.moe_aux_loss(muts)), "aux")


def test_padding_rows_take_no_capacity():
    """The card pads a window's rows to ROW_BUCKET: a MoE block routes
    the first b·s rows only, so its outputs there are the unpadded
    call's, bit for bit."""
    _, _, model, ids = _moe_llama_pair(seed=1)
    block = model.block_0
    x = torch.randn(6, 32, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(3, dtype=torch.int32).expand(2, 3)
    lens = torch.tensor([3, 3], dtype=torch.int32)
    with torch.no_grad():
        want, want_aux = block(x, pos, None, None, lens, False)
        padded = torch.cat([x, torch.randn(58, 32)])
        got, got_aux = block(padded, pos, None, None, lens, False)
    assert torch.equal(got[:6], want) and torch.equal(got_aux, want_aux)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    train, val = str(d / "train.jsonl"), str(d / "val.jsonl")
    generate_text_classification_dataset(train, 48, seed=0)
    generate_text_classification_dataset(val, 16, seed=1)
    return train, val


def _init_blob(knobs):
    module = JLlamaLoRA(**knobs)._module()
    params = module.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, L), jnp.int32))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "meta": {"id2tok": {}}}


@pytest.mark.parametrize("top_k", [1, 2], ids=["k1", "k2"])
def test_moe_template_trains_to_jax(corpus, top_k):
    train, val = corpus
    knobs = {**MOE, "moe_top_k": top_k}
    blob = _init_blob(knobs)
    jm = JLlamaLoRA(**knobs)
    jm.load_parameters(blob)
    jctx = JTrainContext(devices=jax.devices()[:1])
    jm.train(train, jctx)
    pm = ll.LlamaLoRA(device="cpu", **knobs)
    pm.load_parameters(blob)
    pctx = TrainContext()
    pm.train(train, pctx)
    np.testing.assert_allclose(pctx.logger.get_values("loss"),
                               jctx.logger.get_values("loss"), rtol=1e-4)
    want = _flat(jm.dump_parameters()["params"])
    got = _flat(pm.dump_parameters()["params"])
    assert got.keys() == want.keys()
    assert any("/moe/experts_gate" in key for key in got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    # the experts trained: they always do (no checkpoint carries them)
    init = _flat(blob["params"])
    assert not np.array_equal(got["block_0/moe/experts_up"],
                              init["block_0/moe/experts_up"])
    assert abs(pm.evaluate(val) - jm.evaluate(val)) <= 1e-5


@pytest.fixture(scope="module")
def jax_moe(corpus):
    """A JAX-trained MoE LM (k = 2) and the port template that loads its
    blob."""
    trained = JLlamaLoRA(**MOE)
    trained.train(corpus[0], JTrainContext(devices=jax.devices()[:1]))
    blob = trained.dump_parameters()
    # served from its blob: the trained tree is committed to the one
    # device it trained on
    jm = JLlamaLoRA(**MOE)
    jm.load_parameters(blob)
    pm = ll.LlamaLoRA(device="cpu", **MOE)
    pm.load_parameters(blob)
    return jm, pm


def test_jax_trained_moe_blob_predicts_token_exact(jax_moe):
    jm, pm = jax_moe
    # three queries: both pad to four rows, which route with the rest
    queries = ["tok1 tok2 tok3", "the quick brown fox", "a"]
    assert pm.predict(queries, max_new_tokens=6) == \
        jm.predict(queries, max_new_tokens=6)
    assert pm.predict(queries[:1], max_new_tokens=6) == \
        jm.predict(queries[:1], max_new_tokens=6)


def _drain(eng, reqs):
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
    raise AssertionError(f"undrained: {sorted(done)}")


@pytest.mark.parametrize("page,pages,steps,chunk", [
    (8, 9, 4, 8), (8, 9, 1, 1), (0, 0, 3, 4)],
    ids=["paged-K4-C8", "paged-K1-C1", "contiguous"])
def test_jax_trained_moe_blob_decodes_token_exact(jax_moe, page, pages,
                                                  steps, chunk):
    """Every decode call routes its (slots, window) rows as JAX's engine
    does, idle slots included: the same tokens come out."""
    jm, pm = jax_moe
    rng = np.random.default_rng(0)
    reqs = [(r, rng.integers(1, 64, size=int(rng.integers(2, 15))
                             ).astype(np.int32), 6) for r in range(8)]
    kw = dict(max_slots=4, max_len=L, steps_per_sync=steps,
              prefill_chunk=chunk)
    jmod = (jm._module(kv_page_size=page, kv_pages=pages) if page
            else jm._module())
    want = _drain(JDecodeEngine(jmod, jm._params, **kw), reqs)
    got = _drain(DecodeEngine(pm._serving_module_params(page, pages),
                              device="cpu", **kw), reqs)
    assert got == want


def test_moe_params_cross_both_ways(jax_moe):
    jm, pm = jax_moe
    tree = jax.tree_util.tree_map(np.asarray, jm._params)
    state = llama_params_from_jax(tree)
    for leaf in ("router", "experts_gate", "experts_up", "experts_down"):
        key = f"block_1.moe.{leaf}"
        assert state[key].dtype == torch.float32
        np.testing.assert_array_equal(state[key].numpy(),
                                      tree["block_1"]["moe"][leaf])
    back = _flat(params_to_jax(pm._model.state_dict()))
    for key, want in _flat(tree).items():
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    # the served model keeps the experts f32 even when it computes bf16
    bf = ll.LlamaLoRA(device="cpu", **{**MOE, "bf16": True})
    bf.load_parameters(jm.dump_parameters())
    assert bf._model.block_0.moe.experts_up.dtype == torch.float32
    assert bf._model.block_0.attn.wq.kernel.dtype == torch.bfloat16


@pytest.mark.parametrize("adapters_only", [False, True],
                         ids=["lora-norms-head-moe", "adapters-only"])
def test_trainable_mask_matches_jax(jax_moe, adapters_only):
    from rafiki_tpu.models.llama_lora import adapter_only_mask

    jm, pm = jax_moe
    mask = (adapter_only_mask if adapters_only
            else lora_trainable_mask)(jm._params)
    want = sorted(k.lower() for k, v in _flat(mask).items() if bool(v))
    got = sorted(n.replace(".", "/").lower() for n in
                 ll.lora_trainable_names(pm._model, adapters_only))
    assert got == want
    assert any("/moe/" in n for n in got) != adapters_only


def test_quantizer_passes_moe_leaves_through(jax_moe):
    jm, pm = jax_moe
    tree = jax.tree_util.tree_map(np.asarray, jm._params)
    got = _flat(ll.quantize_llama_params(tree))
    want = _flat(jax.tree_util.tree_map(np.asarray, jax_quantize(tree)))
    assert got.keys() == want.keys()
    for key in want:
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) \
            else np.asarray(got[key])
        if "/moe/" in key:
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, tree_leaf(tree, key))
        np.testing.assert_array_equal(g, want[key], err_msg=key)
    # the int8 deployment serves with f32 experts, as JAX's does
    q = ll.LlamaLoRA(device="cpu", **{**MOE, "quantize_int8": True})
    q.load_parameters(jm.dump_parameters())
    assert q._serving_module_params().block_0.moe.router.dtype == \
        torch.float32
    jq = JLlamaLoRA(**{**MOE, "quantize_int8": True})
    jq.load_parameters(jm.dump_parameters())
    assert q.predict(["tok1 tok2", "b"], max_new_tokens=4) == \
        jq.predict(["tok1 tok2", "b"], max_new_tokens=4)


def tree_leaf(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[part]
    return np.asarray(node)


def test_dense_checkpoint_leaves_the_experts_at_init(jax_moe, corpus,
                                                     tmp_path):
    """An HF-convention checkpoint carries no MoE leaves: importing one
    fills the attention, norms, embedding and head and leaves the
    routers and experts as the init drew them; a MoE fine-tune from it
    trains on that base."""
    jm, _ = jax_moe
    ckpt = str(tmp_path / "model.safetensors")
    pconv.export_llama_safetensors(
        jax.tree_util.tree_map(np.asarray, jm._params), ckpt)
    init = _flat(_init_blob(MOE)["params"])
    got = _flat(pconv.import_llama_safetensors(
        ckpt, _init_blob(MOE)["params"]))
    trained = _flat(jax.tree_util.tree_map(np.asarray, jm._params))
    for key in got:
        if "/moe/" in key:
            np.testing.assert_array_equal(got[key], init[key], err_msg=key)
        elif "lora_" not in key:
            np.testing.assert_array_equal(got[key], trained[key],
                                          err_msg=key)
    m = ll.LlamaLoRA(device="cpu", **{**MOE, "max_epochs": 1,
                                      "pretrained_path": ckpt})
    m.train(corpus[0])
    out = _flat(m.dump_parameters()["params"])
    np.testing.assert_array_equal(out["block_0/attn/wq/kernel"],
                                  trained["block_0/attn/wq/kernel"])
