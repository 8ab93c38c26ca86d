"""Port parity: ``rafiki_tpu_torch.models.bert`` against the JAX package.

On the CPU the port's attention runs its plain versions; the JAX module
runs its own CPU dispatch (the XLA reference of its Pallas kernels), as
``tests/test_models_bert.py`` runs it. Weights move between the two as the
templates' dumped blobs; inputs are drawn with numpy from a seed.

Tolerances as in ``test_torch_vit.py``: f32 logits at rtol 1e-4 with a
floor of 1e-5; bf16 logits within 2^-5 of the largest logit (every Dense
output, norm output and residual rounds to bf16 on each side, and the
table is cast before the lookup on both); per-epoch losses within 1e-4
relative; trained leaves within 2e-4 absolute (the key bias, which has no
true gradient, within 2·lr a step); probabilities within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models.bert import Bert as JBert
from rafiki_tpu.models.bert import BertClassifier as JBertClassifier
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models.bert import Bert, BertClassifier
from rafiki_tpu_torch.store.params import params_from_jax, params_to_jax

torch.set_num_threads(1)

# head dim 12 (48 / 4), a width the JAX knob grid gives; batch 16 divides
# the 8 virtual CPU devices the JAX template shards over
KNOBS = {"max_epochs": 2, "vocab_size": 512, "hidden_dim": 48, "depth": 2,
         "n_heads": 4, "max_len": 16, "learning_rate": 1e-3,
         "weight_decay": 1e-4, "warmup_frac": 0.1, "batch_size": 16,
         "bf16": False, "quick_train": False, "share_params": False}
MODULE = dict(vocab_size=512, max_len=16, hidden_dim=48, depth=2, n_heads=4,
              mlp_dim=192, n_classes=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_init(dtype=jnp.float32):
    module = JBert(**MODULE, dtype=dtype)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32),
                         jnp.ones((1,), jnp.int32))["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


def _port_module(params, dtype=torch.float32):
    m = Bert(**MODULE, dtype=dtype, device="cpu")
    m.load_state_dict(params_from_jax(params))
    return m


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 512, size=(4, 16)).astype(np.int32)
    ids[:, 0] = 1  # CLS
    lens = np.array([16, 9, 1, 5], np.int32)
    return ids, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_logits_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    module, params = _jax_init(jdt)
    ids, lens = _batch()
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(lens)), np.float32)
    with torch.no_grad():
        got = _port_module(params, tdt)(torch.from_numpy(ids).long(),
                                        torch.from_numpy(lens))
    assert got.dtype == torch.float32  # final_norm and head run in f32
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()


def test_param_names_and_shapes_are_flax():
    _, params = _jax_init()
    port = Bert(**MODULE, device="cpu")
    want = {k: v.shape for k, v in _flat(params).items()}
    got = {k: tuple(v.shape)
           for k, v in _flat(params_to_jax(port.state_dict())).items()}
    assert got == want


def test_padding_invariance():
    """Logits do not depend on what sits past each example's length: the
    masked keys get exactly zero weight."""
    _, params = _jax_init()
    m = _port_module(params)
    ids, lens = _batch(1)
    garbage = ids.copy()
    for i, n in enumerate(lens):
        garbage[i, n:] = 7 + i
    with torch.no_grad():
        a = m(torch.from_numpy(ids).long(), torch.from_numpy(lens))
        b = m(torch.from_numpy(garbage).long(), torch.from_numpy(lens))
    assert torch.equal(a, b)


# ---- the template, trained from one init blob on both sides

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    tr, va = str(d / "train.jsonl"), str(d / "val.jsonl")
    generate_text_classification_dataset(tr, 48, vocab_size=200, max_len=24,
                                         seed=0)
    generate_text_classification_dataset(va, 24, vocab_size=200, max_len=24,
                                         seed=1)
    _, params = _jax_init()
    blob = {"params": params, "meta": {"n_classes": 4}}
    jm, pm = JBertClassifier(**KNOBS), BertClassifier(device="cpu", **KNOBS)
    jctx, pctx = JTrainContext(), TrainContext()
    jm.load_parameters(blob)
    pm.load_parameters(blob)
    jm.train(tr, jctx)
    pm.train(tr, pctx)
    return dict(jm=jm, pm=pm, jctx=jctx, pctx=pctx, val=va,
                queries=["tok1 tok2 tok3", "tok5", "tok9 " * 30, ""])


def test_template_epoch_losses_match_jax(trained):
    want = trained["jctx"].logger.get_values("loss")
    got = trained["pctx"].logger.get_values("loss")
    assert len(got) == len(want) == KNOBS["max_epochs"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_template_trained_leaves_scores_and_probs_match_jax(trained):
    jm, pm = trained["jm"], trained["pm"]
    want, got = _flat(jm.dump_parameters()["params"]), \
        _flat(pm.dump_parameters()["params"])
    assert want.keys() == got.keys()
    d = KNOBS["hidden_dim"]
    for k in want:
        if k.endswith("qkv/bias"):  # the key bias: no true gradient
            key = slice(d, 2 * d)
            steps = KNOBS["max_epochs"] * 3
            assert np.abs(got[k][key] - want[k][key]).max() <= \
                2 * KNOBS["learning_rate"] * steps
            got[k], want[k] = np.delete(got[k], key), np.delete(want[k], key)
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0,
                                   err_msg=k)
    assert pm.evaluate(trained["val"]) == pytest.approx(
        jm.evaluate(trained["val"]), abs=1e-5)
    np.testing.assert_allclose(pm.predict(trained["queries"]),
                               jm.predict(trained["queries"]), atol=1e-4)


def test_blobs_move_both_ways(trained):
    jm, pm, q = trained["jm"], trained["pm"], trained["queries"]
    to_port = BertClassifier(device="cpu", **KNOBS)
    to_port.load_parameters(jm.dump_parameters())
    np.testing.assert_allclose(to_port.predict(q), jm.predict(q), rtol=1e-4,
                               atol=1e-5)
    to_jax = JBertClassifier(**KNOBS)
    to_jax.load_parameters(pm.dump_parameters())
    np.testing.assert_allclose(to_jax.predict(q), pm.predict(q), rtol=1e-4,
                               atol=1e-5)
    again = BertClassifier(device="cpu", **KNOBS)
    again.load_parameters(pm.dump_parameters())
    assert again.predict(q) == pm.predict(q)


def test_empty_predict_and_warmup(trained):
    pm, jm = trained["pm"], trained["jm"]
    assert pm.predict([]) == jm.predict([]) == []
    pm.warmup()
