"""Port parity for the rest of LoRA training on one device: the
checkpointing schedules (``remat``, ``remat_policy``), gradient
accumulation (``grad_accum``), the streamed loss (``loss_chunk``) and
their compositions, against the JAX template, in f32 on the CPU.

JAX routes ``grad_accum``, ``loss_chunk`` and ``moe_experts`` to its
sharded train loop, here on a mesh of one device
(``TrainContext(devices=jax.devices()[:1])``; the tier-1 run forces 8
CPU devices, over which the accumulation batch would round to a multiple
of 16). That loop never reads ``lora_scale`` (ROADMAP Queue C 23), so
the parity cases run at ``lora_scale = 1`` and one case shows the port
applying a scale of 0.5 where JAX does not.

Tolerances: losses at 1e-4 relative, trained leaves at 1e-4 absolute and
scores at 1e-5, as ``test_torch_llama_train.py`` holds them; a schedule
changes no math, so the port's losses and leaves under ``none``,
``full`` and ``policy`` are equal bit for bit. The ports of JAX's own
tests keep JAX's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.llama_lora import \
    chunked_lm_loss_terms as jax_chunked_terms
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import llama_lora as ll

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
BASE = {**KNOBS, "max_epochs": 2, "lora_scale": 1.0}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_knobs")
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


def _port_train(corpus, knobs, blob=None):
    m = ll.LlamaLoRA(device="cpu", **knobs)
    if blob is not None:
        m.load_parameters(blob)
    ctx = TrainContext()
    m.train(corpus[0], ctx)
    return m, ctx.logger.get_values("loss")


def _jax_train(corpus, knobs, blob):
    m = JLlamaLoRA(**knobs)
    m.load_parameters(blob)
    ctx = JTrainContext(devices=jax.devices()[:1])
    m.train(corpus[0], ctx)
    return m, ctx.logger.get_values("loss")


CASES = {
    "remat": {"remat": True},
    "remat-full": {"remat_policy": "full"},
    "remat-policy": {"remat_policy": "policy"},
    "grad-accum": {"grad_accum": 2},
    "loss-chunk": {"loss_chunk": 12},
    "accum-chunk-policy": {"grad_accum": 2, "loss_chunk": 12,
                           "remat_policy": "policy"},
    "moe-accum-chunk-full": {"moe_experts": 4, "moe_top_k": 2,
                             "grad_accum": 2, "loss_chunk": 12,
                             "remat_policy": "full",
                             "learning_rate": 1e-3},
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_knobs_train_to_jax(corpus, case):
    knobs = {**BASE, **CASES[case]}
    blob = _init_blob(knobs)
    jm, want_losses = _jax_train(corpus, knobs, blob)
    pm, got_losses = _port_train(corpus, knobs, blob)
    assert len(got_losses) == len(want_losses) == 2
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want = _flat(jm.dump_parameters()["params"])
    got = _flat(pm.dump_parameters()["params"])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    jx = JLlamaLoRA(**knobs)  # scored from its blob, as a deployment is
    jx.load_parameters(jm.dump_parameters())
    assert abs(pm.evaluate(corpus[1]) - jx.evaluate(corpus[1])) <= 1e-5


def test_schedules_change_no_math(corpus):
    """The same trial under none, full and policy (and the legacy remat
    flag): equal losses and trained leaves, bit for bit."""
    runs = {}
    for name, extra in (("none", {"remat_policy": "none"}),
                        ("full", {"remat_policy": "full"}),
                        ("policy", {"remat_policy": "policy"}),
                        ("remat", {"remat": True, "remat_policy": ""})):
        m, losses = _port_train(corpus, {**BASE, **extra,
                                         "lora_scale": 0.5})
        runs[name] = (losses, _flat(m.dump_parameters()["params"]))
    ref_losses, ref = runs.pop("none")
    for name, (losses, leaves) in runs.items():
        assert losses == ref_losses, name
        for key in ref:
            np.testing.assert_array_equal(leaves[key], ref[key],
                                          err_msg=f"{name} {key}")


def test_unknown_remat_policy_raises_jaxs_error(corpus):
    for m in (JLlamaLoRA(**{**BASE, "remat_policy": "sometimes"}),
              ll.LlamaLoRA(device="cpu",
                           **{**BASE, "remat_policy": "sometimes"})):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            m.train(corpus[0])


# ---- ports of the JAX package's own tests

def test_grad_accum_matches_big_batch_exactly(corpus):
    """``tests/test_grad_accum.py``'s case: same data order, same init,
    grad_accum = 4 reproduces the big batch's losses and parameters
    (JAX's tolerances)."""
    knobs = {**BASE, "batch_size": 16}
    m1, l1 = _port_train(corpus, knobs)
    m4, l4 = _port_train(corpus, {**knobs, "grad_accum": 4})
    np.testing.assert_allclose(l4, l1, rtol=2e-5, atol=2e-5)
    a, b = (_flat(m.dump_parameters()["params"]) for m in (m1, m4))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-3, atol=1e-3,
                                   err_msg=key)


def test_grad_accum_composes_with_chunked_loss(corpus):
    _, losses = _port_train(corpus, {**BASE, "batch_size": 16,
                                     "grad_accum": 2, "loss_chunk": 8})
    assert losses and np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


def test_chunked_lm_loss_matches_dense():
    """``tests/test_models_llama.py``'s case: the streamed LM head and
    loss give the dense loss's value, count and gradients with a chunk
    that does not divide the sequence, a masked example and GQA; and the
    JAX function's value."""
    m = ll.Llama(vocab_size=128, max_len=16, hidden_dim=16, depth=1,
                 n_heads=2, n_kv_heads=1, mlp_dim=32, lora_rank=2,
                 device="cpu")
    trainable = ll.make_trainable(m, ll.lora_trainable_names(m))
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, 128, (3, 16)).astype(np.int64))
    lens = torch.tensor([16, 9, 5], dtype=torch.int32)
    mask = torch.tensor([1.0, 1.0, 0.0])
    batch = {"ids": ids, "lens": lens, "mask": mask}

    def loss(chunk):
        total, count, _ = ll.micro_terms(m, dict(trainable), batch, chunk)
        return total / count.clamp(min=1.0), count

    dense, c0 = loss(0)
    chunked, c1 = loss(5)  # 16 % 5 != 0
    np.testing.assert_allclose(float(chunked), float(dense), rtol=1e-5)
    assert int(c0) == int(c1) == (16 - 1) + (9 - 1)
    g0 = torch.autograd.grad(dense, list(trainable.values()))
    g1 = torch.autograd.grad(chunked, list(trainable.values()))
    for name, a, b in zip(trainable, g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                   atol=1e-7, err_msg=name)
    with torch.no_grad():
        hidden = m(ids, decode=False, lens=lens, return_hidden=True)
    kernel = m.lm_head.kernel.detach()
    want_t, want_c = jax_chunked_terms(
        jnp.asarray(hidden.numpy()), jnp.asarray(kernel.numpy()),
        jnp.asarray(ids.numpy().astype(np.int32)), jnp.asarray(lens.numpy()),
        jnp.asarray(mask.numpy()), chunk=5)
    got_t, got_c = ll.chunked_lm_loss_terms(hidden, kernel, ids, lens, mask,
                                            chunk=5)
    np.testing.assert_allclose(float(got_t), float(want_t), rtol=1e-5)
    assert int(got_c) == int(want_c)


def test_remat_identical_math_and_decode_unaffected():
    """``tests/test_models_llama.py``'s case: remat gives the train
    branch's outputs and gradients, and the decode branch (a cache
    written in place) never rematerializes: greedy tokens agree."""
    kw = dict(vocab_size=128, max_len=16, hidden_dim=32, depth=2,
              n_heads=4, n_kv_heads=2, mlp_dim=64, lora_rank=2,
              device="cpu")
    plain = ll.Llama(**kw)
    remat = ll.Llama(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    for m in (plain, remat):
        for p in m.parameters():
            p.requires_grad_(True)
    ids = torch.ones((2, 8), dtype=torch.int64)
    outs = [m(ids, decode=False) for m in (plain, remat)]
    np.testing.assert_allclose(outs[0].detach().numpy(),
                               outs[1].detach().numpy(), atol=1e-6,
                               rtol=1e-6)
    grads = [torch.autograd.grad(o.float().pow(2).sum(),
                                 list(m.parameters()))
             for o, m in zip(outs, (plain, remat))]
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)
    prompts = np.asarray([[1, 5, 9], [1, 7, 0]], np.int32)
    lens = np.asarray([3, 2], np.int32)
    with torch.no_grad():
        assert torch.equal(ll.greedy_generate(plain, prompts, lens, 4),
                           ll.greedy_generate(remat, prompts, lens, 4))


# ---- ROADMAP Queue C 23: lora_scale in the accumulation loop

def test_lora_scale_applies_where_jax_drops_it(corpus):
    """At lora_scale 0.5 the port's grad_accum = 2 run equals its own
    big-batch run (both apply the scale and fold it into lora_b); JAX's
    grad_accum run trains at scale 1 (its sharded loop never reads the
    knob), so it equals the port's scale-1 run and not the scale-0.5
    one."""
    knobs = {**BASE, "lora_scale": 0.5}
    blob = _init_blob(knobs)
    big, l_big = _port_train(corpus, knobs, blob)
    acc, l_acc = _port_train(corpus, {**knobs, "grad_accum": 2}, blob)
    np.testing.assert_allclose(l_acc, l_big, rtol=2e-5, atol=2e-5)
    a, b = (_flat(m.dump_parameters()["params"]) for m in (big, acc))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-3, atol=1e-3,
                                   err_msg=key)
    jm, l_jax = _jax_train(corpus, {**knobs, "grad_accum": 2}, blob)
    one, l_one = _port_train(corpus, {**knobs, "grad_accum": 2,
                                      "lora_scale": 1.0}, blob)
    np.testing.assert_allclose(l_jax, l_one, rtol=1e-4)
    assert abs(l_jax[-1] - l_acc[-1]) > 1e-3
    key = "block_0/attn/wq/lora_b"
    j = _flat(jm.dump_parameters()["params"])[key]
    np.testing.assert_allclose(j, _flat(one.dump_parameters()["params"])[key],
                               rtol=0, atol=1e-4)
    assert np.abs(j - b[key]).max() > 1e-3


# ---- the estimator

def _budget(**extra):
    return ll.LlamaLoRA(device="cpu", **{**BASE, **extra})


def test_estimator_prices_schedules_accumulation_chunks_and_experts():
    none, full, policy = (_budget(remat_policy=p).estimate_device_budget(1)
                          for p in ("none", "full", "policy"))
    assert none["activations"] > policy["activations"] > \
        full["activations"]
    assert none["total"] >= policy["total"] >= full["total"]
    assert _budget(remat=True).estimate_device_budget(1) == full
    for p in ("none", "full", "policy"):
        est = _budget(remat_policy=p).estimate_device_budget(1)
        assert est["total"] == est["params"] + est["opt"] + max(
            est["activations"] + est["transient"], 3 * est["grads"])
    gang = [_budget(remat_policy=p).estimate_device_budget(1, gang_size=2)
            for p in ("none", "policy", "full")]
    assert gang[0]["total"] > gang[1]["total"] > gang[2]["total"]
    # a micro-batch's activations, plus the f32 gradient accumulator
    acc = _budget(grad_accum=2, batch_size=16).estimate_device_budget(1)
    big = _budget(batch_size=16).estimate_device_budget(1)
    assert acc["activations"] < big["activations"]
    assert acc["total"] == acc["params"] + acc["opt"] + max(
        acc["activations"] + acc["transient"] + acc["grads"],
        3 * acc["grads"])
    # one chunk of logits in place of the whole
    chunked = _budget(loss_chunk=8).estimate_device_budget(1)
    assert chunked["activations"] < none["activations"]
    # the experts' f32 state: trained, with grads and moments
    # (routers and experts in, the dense FFN's adapters out)
    moe = _budget(moe_experts=4).estimate_device_budget(1)
    depth, hd, rank = BASE["depth"], BASE["hidden_dim"], BASE["lora_rank"]
    experts = depth * 4 * (hd + 3 * hd * 4 * hd)
    ffn_adapters = depth * rank * 3 * (hd + 4 * hd)
    assert moe["opt"] - none["opt"] == 8 * (experts - ffn_adapters)


def test_estimator_counts_what_autograd_saves():
    """The activation term of the ``"none"`` schedule against the bytes
    autograd holds at the end of a forward (the distinct storages of the
    saved tensors), plus the two vocab-wide f32 cotangents the backward
    starts with, at the template's shapes in f32: within 10 %. (The
    checkpointed schedules keep their tensors out of reach of such a
    count; ``chip_smoke.py`` phase 35 holds all three against the card's
    peak.)"""
    tmpl = _budget(batch_size=8, remat_policy="none")
    est = tmpl.estimate_device_budget(1)
    model = tmpl._module()
    trainable = ll.make_trainable(model, ll.lora_trainable_names(model))
    ids = torch.randint(1, 1024, (8, L))
    lens = torch.full((8,), L, dtype=torch.int32)
    seen = []

    def pack(t):
        seen.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = ll.lm_objective(model, trainable, 1.0,
                               {"ids": ids, "lens": lens})
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in seen if not (t.requires_grad and t.grad_fn is None)}
    total = sum(held.values()) + 2 * 4 * ids.numel() * model.vocab_size
    assert abs(total - est["activations"]) / est["activations"] < 0.1, \
        (total, est["activations"])
    del loss
