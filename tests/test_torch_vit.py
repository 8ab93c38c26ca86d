"""Port parity: ``rafiki_tpu_torch.models.vit`` and ``model/optim.py``
against the JAX package.

On the CPU the port's attention and patch projection run their plain
versions; the JAX module runs its own CPU dispatch (the XLA references of
its Pallas kernels), as ``tests/test_models_vit.py`` runs it. Weights move
between the two as the templates' dumped blobs; inputs are drawn with
numpy from a seed.

Tolerances: f32 logits at rtol 1e-4 with a floor of 1e-5 (the two
frameworks sum matmuls in another order); bf16 logits within 2^-5 of the
largest logit (each side rounds every Dense output and the residual
stream to bf16, 2^-8 relative each, about ten times a block, and a
rounding that falls the other way early carries forward; about 1 % is
seen); per-epoch losses within 1e-4 relative; trained leaves within 2e-4
absolute (6 AdamW steps of at most lr = 1e-3 each from one init: an entry
whose gradient is at noise level can move by up to lr a step on one side
and not the other); probabilities within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.data import generate_image_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models.vit import ViT as JViT
from rafiki_tpu.models.vit import ViTBase16 as JViTBase16
from rafiki_tpu_torch.model import optim
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models.vit import ViT, ViTBase16
from rafiki_tpu_torch.store.params import params_from_jax, params_to_jax

torch.set_num_threads(1)

# batch 16 divides the 8 virtual CPU devices the JAX template shards over
KNOBS = {"patch_size": 4, "hidden_dim": 48, "depth": 2, "n_heads": 4,
         "batch_size": 16, "max_epochs": 2, "learning_rate": 1e-3,
         "weight_decay": 1e-4, "warmup_frac": 0.1, "bf16": False,
         "remat": False, "quick_train": False, "share_params": False}
IMAGE = (16, 16, 3)
N_CLASSES = 10


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_init(dtype=jnp.float32, seed=1):
    module = JViT(patch_size=4, hidden_dim=48, depth=2, n_heads=4,
                  mlp_dim=192, n_classes=N_CLASSES, dtype=dtype)
    params = module.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, *IMAGE), jnp.float32))["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


def _port_module(params, dtype):
    m = ViT(patch_size=4, hidden_dim=48, depth=2, n_heads=4, mlp_dim=192,
            n_classes=N_CLASSES, dtype=dtype, image_shape=IMAGE,
            device="cpu")
    m.load_state_dict(params_from_jax(params))
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_logits_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    module, params = _jax_init(jdt)
    x = np.random.default_rng(0).uniform(-1, 1, (5, *IMAGE)) \
        .astype(np.float32)
    want = np.asarray(module.apply({"params": params},
                                   jnp.asarray(x, jdt)), np.float32)
    with torch.no_grad():
        got = _port_module(params, tdt)(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32  # final_norm and head run in f32
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()


def test_param_names_and_shapes_are_flax():
    _, params = _jax_init()
    port = ViT(patch_size=4, hidden_dim=48, depth=2, n_heads=4, mlp_dim=192,
               n_classes=N_CLASSES, image_shape=IMAGE, device="cpu")
    want = {k: v.shape for k, v in _flat(params).items()}
    got = {k: tuple(v.shape)
           for k, v in _flat(params_to_jax(port.state_dict())).items()}
    assert got == want
    back = _flat(params_to_jax(params_from_jax(params)))
    assert all(np.array_equal(back[k], v) for k, v in _flat(params).items())


def test_remat_gives_equal_gradients():
    """``remat`` recomputes each block in the backward: the same loss and
    the same gradients, bit for bit on the CPU."""
    _, params = _jax_init()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, *IMAGE)).astype(np.float32))
    grads = []
    for remat in (False, True):
        m = _port_module(params, torch.float32)
        m.remat = remat
        loss = m(x).square().sum()
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


@pytest.mark.parametrize("warmup,total", [(2, 6), (1, 2), (3, 9)])
def test_optimizer_matches_optax_step_by_step(warmup, total):
    """``model/optim.adamw`` against ``optax.adamw`` over the templates'
    ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), max(total, 2))``:
    the same parameters after every step, past the end of the decay too
    (f32, rtol 1e-5 with a floor of 1e-6: AdamW applies the decay and the
    Adam term as two roundings where optax sums them first, a few ulps of
    the parameter a step). optax reads the schedule before the update, so
    step 0 runs at lr 0."""
    rng = np.random.default_rng(warmup)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    lr, wd = 3e-2, 1e-2
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(warmup, 1),
                                               max(total, 2))
    tx = optax.adamw(sched, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, lr_sched = optim.adamw(tp.values(), lr, warmup, total, wd)
    mine = optim.warmup_cosine_decay(0.0, lr, max(warmup, 1), max(total, 2))
    for step in range(total + 2):
        assert mine(step) == pytest.approx(float(sched(step)), rel=1e-6,
                                           abs=1e-12)
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        lr_sched.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {step}")
    if warmup == 2:
        np.testing.assert_array_equal(  # step 0 moved nothing: lr 0
            optim.warmup_cosine_decay(0.0, lr, 2, 6)(0), 0.0)


# ---- the template, trained from one init blob on both sides

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("vit")
    tr, va = str(d / "train.npz"), str(d / "val.npz")
    generate_image_classification_dataset(tr, 48, image_size=16,
                                          n_channels=3, seed=0)
    ds = generate_image_classification_dataset(va, 24, image_size=16,
                                               n_channels=3, seed=1)
    _, params = _jax_init()
    blob = {"params": params,
            "meta": {"n_classes": N_CLASSES, "image_shape": list(IMAGE),
                     "prep_version": 2}}
    jm, pm = JViTBase16(**KNOBS), ViTBase16(device="cpu", **KNOBS)
    jctx, pctx = JTrainContext(), TrainContext()
    jm.load_parameters(blob)
    pm.load_parameters(blob)
    jm.train(tr, jctx)
    pm.train(tr, pctx)
    return dict(jm=jm, pm=pm, jctx=jctx, pctx=pctx, val=va,
                queries=[ds.images[i] for i in range(5)])


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
        if k.endswith("qkv/bias"):
            # the key bias has no true gradient (a shift of every score
            # in a row leaves the softmax unchanged): Adam normalizes the
            # rounding noise on each side, so it moves at most lr a step
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
    """A JAX-trained blob served by the port, and a port-trained blob
    served by JAX, give the other side's probabilities; the port's own
    dump → load round trip is exact."""
    jm, pm, q = trained["jm"], trained["pm"], trained["queries"]
    to_port = ViTBase16(device="cpu", **KNOBS)
    to_port.load_parameters(jm.dump_parameters())
    np.testing.assert_allclose(to_port.predict(q), jm.predict(q), rtol=1e-4,
                               atol=1e-5)
    to_jax = JViTBase16(**KNOBS)
    to_jax.load_parameters(pm.dump_parameters())
    np.testing.assert_allclose(to_jax.predict(q), pm.predict(q), rtol=1e-4,
                               atol=1e-5)
    again = ViTBase16(device="cpu", **KNOBS)
    again.load_parameters(pm.dump_parameters())
    assert again.predict(q) == pm.predict(q)
    assert again.dump_parameters()["meta"] == pm.dump_parameters()["meta"]


def test_prep_version_1_blob_serves_as_in_jax(trained):
    """A v1 checkpoint (trained on [0, 1] pixels) keeps its input contract
    in both templates and through a re-dump."""
    blob = trained["jm"].dump_parameters()
    blob["meta"] = dict(blob["meta"], prep_version=1)
    jm, pm = JViTBase16(**KNOBS), ViTBase16(device="cpu", **KNOBS)
    jm.load_parameters(blob)
    pm.load_parameters(blob)
    q = trained["queries"]
    np.testing.assert_allclose(pm.predict(q), jm.predict(q), rtol=1e-4,
                               atol=1e-5)
    assert pm.dump_parameters()["meta"]["prep_version"] == 1
    v2 = ViTBase16(device="cpu", **KNOBS)
    v2.load_parameters(trained["pm"].dump_parameters())
    assert not np.allclose(v2.predict(q), pm.predict(q))


def test_predict_edges(trained):
    pm = trained["pm"]
    # a grayscale query of another size is conformed to the trained shape
    gray = np.zeros((20, 12), np.uint8)
    (probs,) = pm.predict([gray])
    assert len(probs) == N_CLASSES and abs(sum(probs) - 1.0) < 1e-5
    pm.warmup()


# ---- the template helpers and the image loader, against the JAX copies

def test_template_utils_match_jax():
    from rafiki_tpu.model import template_utils as jtu
    from rafiki_tpu_torch.model import template_utils as ttu

    rng = np.random.default_rng(5)
    for shape in ((3, 20, 12, 1), (2, 16, 16, 3), (1, 9, 30, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(ttu.conform_images(x, (16, 16, 3)),
                                      jtu.conform_images(x, (16, 16, 3)))
    with pytest.raises(ValueError, match="channels"):
        ttu.conform_images(np.zeros((1, 8, 8, 2), np.float32), (8, 8, 3))
    a = {"w": np.zeros((2, 3)), "blk": {"b": np.zeros(3)}}
    for b in ({"w": np.ones((2, 3)), "blk": {"b": np.ones(3)}},
              {"w": np.ones((3, 2)), "blk": {"b": np.ones(3)}},
              {"w": np.ones((2, 3))}, {"w": np.ones((2, 3)), "blk": 1.0}):
        assert ttu.same_tree_shapes(a, b) == jtu.same_tree_shapes(a, b)
    xs = rng.standard_normal((70, 4)).astype(np.float32)
    got = ttu.bucketed_forward(lambda c: c * 2.0, xs, bucket=32, out_dim=4)
    np.testing.assert_array_equal(got, xs * 2.0)
    calls = []
    ttu.bucketed_forward(lambda c: calls.append(len(c)) or c, xs,
                         bucket=32, out_dim=4)
    assert calls == [32, 32, 32]  # zero-padded, fixed bucket shape
    assert ttu.bucketed_forward(lambda c: c, xs[:0], out_dim=4).shape == \
        (0, 4)


def test_image_loader_matches_jax(tmp_path):
    from rafiki_tpu.data import load_image_classification_dataset as jload
    from rafiki_tpu_torch.data.dataset import \
        load_image_classification_dataset as tload

    path = str(tmp_path / "d.npz")
    generate_image_classification_dataset(path, 12, image_size=8, seed=3)
    want, got = jload(path), tload(path)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.n_classes, got.image_shape, len(got)) == \
        (want.n_classes, want.image_shape, len(want))
    (tmp_path / "a.zip").write_bytes(b"PK")
    with pytest.raises(NotImplementedError, match="npz"):
        tload(str(tmp_path / "a.zip"))
    (tmp_path / "dir").mkdir()
    (tmp_path / "dir" / "labels.csv").write_text("a.png,0\n")
    with pytest.raises(NotImplementedError, match="npz"):
        tload(str(tmp_path / "dir"))
    with pytest.raises(ValueError, match="unrecognized"):
        tload(str(tmp_path / "missing.npz"))


def test_warm_start_gates(trained, tmp_path, caplog):
    """``share_params``: a donor of the same shapes and prep_version warm
    starts the trial; a v1 donor is skipped with a warning, as in JAX."""
    import logging

    tr = str(tmp_path / "t.npz")
    generate_image_classification_dataset(tr, 16, image_size=16,
                                          n_channels=3, seed=4)
    donor = trained["pm"].dump_parameters()
    knobs = dict(KNOBS, max_epochs=1, learning_rate=0.0, share_params=True)
    warm = ViTBase16(device="cpu", **knobs)
    warm.train(tr, TrainContext(shared_params=donor))
    q = trained["queries"]
    # lr 0 (one step, at schedule(0)): the donor's weights, unchanged
    np.testing.assert_allclose(warm.predict(q), trained["pm"].predict(q),
                               atol=1e-6)
    v1 = dict(donor, meta=dict(donor["meta"], prep_version=1))
    cold = ViTBase16(device="cpu", **knobs)
    with caplog.at_level(logging.WARNING,
                         logger="rafiki_tpu_torch.models.vit"):
        cold.train(tr, TrainContext(shared_params=v1))
    assert any("skipping warm start" in r.getMessage()
               for r in caplog.records)
    assert not np.allclose(cold.predict(q), trained["pm"].predict(q))
