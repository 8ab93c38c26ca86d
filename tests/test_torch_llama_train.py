"""Port parity for training: the ``rafiki_tpu_torch`` Llama's train branch
and ``LlamaLoRA.train`` / ``evaluate`` / ``dump_parameters`` against the
JAX template.

On the CPU the port's attention runs its plain versions and the JAX
module its XLA reference (the template's own CPU dispatch), both in f32.
Tolerances: logits at rtol 1e-4 (the two frameworks sum matmuls in
another order, as in ``test_torch_llama.py``); gradients at rtol 1e-4
with a floor of 1e-4 of the leaf's largest entry; per-epoch losses at
1e-4 relative; trained leaves at 1e-4 absolute (16 Adam steps of at
most lr = 1e-2 each from the same init; about 2e-5 is seen); scores at
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.models.llama_lora import lm_loss_terms as jax_loss_terms
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import llama_lora as ll

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, KNOBS["vocab_size"], size=(b, L)).astype(np.int32)
    lens = np.array([L, 17, 5][:b], np.int32)
    mask = np.array([True, True, False][:b])
    return ids, lens, mask


def _port_model(blob, knobs=KNOBS):
    m = ll.LlamaLoRA(device="cpu", **knobs)
    m.load_parameters(blob)
    return m._model


def test_train_branch_logits_match_jax(trained_lm):
    ids, lens, _ = _batch()
    module = trained_lm._module()
    want = np.asarray(module.apply({"params": trained_lm._params},
                                   jnp.asarray(ids), lens=jnp.asarray(lens)))
    model = _port_model(trained_lm.dump_parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), decode=False,
                    lens=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("adapters_only", [False, True],
                         ids=["lora-norms-head", "adapters-only"])
def test_loss_and_grads_on_trainable_leaves_match_jax(trained_lm,
                                                      adapters_only):
    """The objective and its gradient on every trainable leaf, with a
    rank-scale of 0.5 merged into lora_b, against jax.grad of the JAX
    template's step objective."""
    ids, lens, mask = _batch(seed=1)
    scale = 0.5
    module = trained_lm._module()
    params = trained_lm._params
    _, _, _, jmerge, split = JLlamaLoRA._lane_functions(
        module, params, adapters_only)
    hp = {"learning_rate": jnp.float32(1e-2),
          "lora_scale": jnp.float32(scale)}

    def loss_fn(t):
        logits = module.apply({"params": jmerge(t, hp)}, jnp.asarray(ids),
                              lens=jnp.asarray(lens))
        total, count = jax_loss_terms(logits, jnp.asarray(ids),
                                      jnp.asarray(lens), jnp.asarray(mask))
        return total / jnp.maximum(count, 1.0)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(split(params))

    model = _port_model(trained_lm.dump_parameters())
    names = ll.lora_trainable_names(model, adapters_only)
    trainable = ll.make_trainable(model, names)
    assert sorted(n.replace(".", "/").lower() for n in names) == \
        sorted(want_grads)
    frozen = [n for n, p in model.named_parameters() if n not in names]
    assert frozen and not any(p.requires_grad
                              for n, p in model.named_parameters()
                              if n in frozen)
    batch = {"ids": torch.from_numpy(ids).long(),
             "lens": torch.from_numpy(lens), "mask": torch.from_numpy(mask)}
    loss = ll.lm_objective(model, trainable, scale, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    for name, p in trainable.items():
        assert p.dtype == torch.float32 and p.requires_grad
        want = np.asarray(want_grads[name.replace(".", "/").lower()])
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=name)
    assert all(p.grad is None for n, p in model.named_parameters()
               if n in frozen)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_train_parity")
    train = str(d / "train.jsonl")
    val = str(d / "val.jsonl")
    generate_text_classification_dataset(train, 64, seed=0)
    generate_text_classification_dataset(val, 40, seed=1)
    return train, val


def _init_blob(knobs):
    """The JAX template's PRNGKey(0) init as a dumped blob."""
    module = JLlamaLoRA(**knobs)._module()
    params = module.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, L), jnp.int32))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "meta": {"id2tok": {}}}


CASES = {
    "default": {},
    "adapters-only": {"adapters_only": True},
    "lora-scale-0.5": {"lora_scale": 0.5},
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_template_train_evaluate_and_blob_exchange_match_jax(corpus, case):
    train, val = corpus
    knobs = {**KNOBS, "max_epochs": 2, **CASES[case]}
    blob = _init_blob(knobs)

    jm = JLlamaLoRA(**knobs)
    jm.load_parameters(blob)
    jctx = JTrainContext()
    jm.train(train, jctx)
    pm = ll.LlamaLoRA(device="cpu", **knobs)
    pm.load_parameters(blob)
    pctx = TrainContext()
    pm.train(train, pctx)

    want_losses = jctx.logger.get_values("loss")
    got_losses = pctx.logger.get_values("loss")
    assert len(want_losses) == len(got_losses) == 2
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert pctx.logger.get_values("tokens") == \
        jctx.logger.get_values("tokens")

    jdump, pdump = jm.dump_parameters(), pm.dump_parameters()
    assert pdump["meta"] == jdump["meta"]
    want, got, init = (_flat(d["params"]) for d in (jdump, pdump, blob))
    assert got.keys() == want.keys()
    trained = set(n.replace(".", "/").lower()
                  for n in ll.lora_trainable_names(
                      pm._model, bool(knobs.get("adapters_only"))))
    for key in want:
        assert got[key].dtype == np.float32, key
        if key.lower() in trained:  # lora_b folded by lora_scale
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-4, err_msg=key)
        else:  # frozen: the init, bit for bit
            np.testing.assert_array_equal(got[key], init[key], err_msg=key)
            np.testing.assert_array_equal(want[key], init[key], err_msg=key)

    j_score, p_score = jm.evaluate(val), pm.evaluate(val)
    assert 0.0 < p_score <= 1.0
    assert abs(p_score - j_score) <= 1e-5
    # blob exchange, both ways: each template scores the other's dump as
    # its owner does
    jx = JLlamaLoRA(**knobs)
    jx.load_parameters(pdump)
    px = ll.LlamaLoRA(device="cpu", **knobs)
    px.load_parameters(jdump)
    assert abs(jx.evaluate(val) - p_score) <= 1e-5
    assert abs(px.evaluate(val) - j_score) <= 1e-5
    # the port's own dump reloads to the same model: same score, same text
    pr = ll.LlamaLoRA(device="cpu", **knobs)
    pr.load_parameters(pdump)
    assert pr.evaluate(val) == p_score
    assert pr.predict(["tok1 tok2"], max_new_tokens=4) == \
        pm.predict(["tok1 tok2"], max_new_tokens=4)


def test_train_refuses_unported_knobs(corpus):
    m = ll.LlamaLoRA(device="cpu", **{**KNOBS, "pipeline_stages": 2})
    with pytest.raises(NotImplementedError, match="pipeline_stages"):
        m.train(corpus[0])
    # model_parallel trains on a mesh: on the template's one CPU device
    # JAX's halving rule gives a (1, 1) mesh, which starts from the same
    # init as one card and takes the same steps; sequence_parallel 2
    # trains on a (1, 2) mesh of two CPU shards, the sequence split in
    # two, and takes the same steps too
    losses = []
    for extra, n in (({"model_parallel": 2}, 1),
                     ({"sequence_parallel": 2}, 2), ({}, 1)):
        ctx = TrainContext(devices=["cpu"] * n)
        ll.LlamaLoRA(device="cpu", **{**KNOBS, **extra}).train(corpus[0],
                                                                ctx)
        losses.append(ctx.logger.get_values("loss"))
    np.testing.assert_allclose(losses[0], losses[2], rtol=1e-5)
    np.testing.assert_allclose(losses[1], losses[2], rtol=1e-5)


def test_warm_start_and_checkpoint_hooks(corpus):
    """``share_params`` adopts a compatible dumped blob; ``checkpoint``
    gets a folded blob factory each epoch; ``should_continue`` stops."""
    knobs = {**KNOBS, "max_epochs": 2, "share_params": True}
    blob = _init_blob(knobs)
    calls = []
    ctx = TrainContext(shared_params=blob,
                       checkpoint=lambda f, frac_done, tree: calls.append(
                           (frac_done, f())),
                       should_continue=lambda epoch, score: False)
    m = ll.LlamaLoRA(device="cpu", **knobs)
    m.train(corpus[0], ctx)
    assert len(ctx.logger.get_values("loss")) == 1
    assert [c[0] for c in calls] == [0.5]
    got = _flat(m.dump_parameters()["params"])
    np.testing.assert_array_equal(got["tok_embed/embedding"],
                                  blob["params"]["tok_embed"]["embedding"])
    np.testing.assert_array_equal(
        _flat(calls[0][1]["params"])["block_0/attn/wq/lora_b"],
        got["block_0/attn/wq/lora_b"])
