"""Port parity: the BatchNorm CNNs (``rafiki_tpu_torch.models.resnet``,
``vgg``, ``densenet``, ``_cnn_base``), their layers, the blob bridge and
the SGD recipe against the JAX package.

Four networks, each small: a ResNet of basic blocks on 16×16 (the small
stem), a ResNet of bottlenecks on 64×64 (the 7×7 / 2 stem and the SAME
max-pool) at width 8, a VGG and a DenseNet. The JAX side runs jitted on
the CPU; weights move as the templates' blobs; inputs come from numpy
seeds. The init blobs are perturbed (scales, biases and running stats
drawn around their init values) so no zero-initialised scale hides a
branch.

Tolerances: f32 logits at rtol 1e-4 with a floor of 1e-5 (the two
frameworks sum the convolutions in another order); ``batch_stats`` after
a train-mode forward within 4e-5 of the leaf's largest entry (seen: at
most 1.2e-5, in the bottleneck net, whose stem normalizes all-positive
inputs, x − mean cancelling; a running variance blended with the
unbiased estimate is off by 1.5e-4 to 6.5e-4 in these four nets, and
fails); bf16 logits within 2^-5 of the largest logit (each side rounds
every conv and BatchNorm output to bf16); the templates' per-epoch losses
at rtol 1e-4, dumped leaves within 2e-4 absolute (4 SGD steps from one
blob: an entry whose gradient is at noise level moves by up to lr × its
noise a step; behind the ImageNet stem, where JAX's f32 gradient itself
is off by up to 3.6 % of a leaf's, also 5 % of the leaf's movement, and
probabilities within 1e-3, not 1e-4; the port's gradients there are
held to 1e-4 of an f64 computation instead); SAME convs and pools at 1e-5; the optimizer at rtol 1e-5
with a floor of 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from rafiki_tpu.data import generate_image_classification_dataset
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models import densenet as jdensenet
from rafiki_tpu.models import resnet as jresnet
from rafiki_tpu.models import vgg as jvgg
from rafiki_tpu.store.param_store import params_to_bytes as jax_to_bytes
from rafiki_tpu_torch.model import optim
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import densenet, resnet, vgg
from rafiki_tpu_torch.models.layers import Conv, max_pool_same
from rafiki_tpu_torch.store.param_store import params_to_bytes
from rafiki_tpu_torch.store.params import (cnn_params_from_jax,
                                           cnn_params_to_jax)

torch.set_num_threads(1)

N_CLASSES = 5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


#: kind -> (JAX module(dtype), port module(dtype), image shape)
KINDS = {
    "resnet_basic": (
        lambda dt: jresnet.ResNet(stage_sizes=(1, 1), bottleneck=False,
                                  width=8, n_classes=N_CLASSES,
                                  small_inputs=True, dtype=dt),
        lambda dt: resnet.ResNet(stage_sizes=(1, 1), bottleneck=False,
                                 width=8, n_classes=N_CLASSES,
                                 small_inputs=True, dtype=dt, device="cpu"),
        (16, 16, 3)),
    "resnet_bottleneck": (
        lambda dt: jresnet.ResNet(stage_sizes=(1, 1), bottleneck=True,
                                  width=8, n_classes=N_CLASSES,
                                  small_inputs=False, dtype=dt),
        lambda dt: resnet.ResNet(stage_sizes=(1, 1), bottleneck=True,
                                 width=8, n_classes=N_CLASSES,
                                 small_inputs=False, dtype=dt,
                                 device="cpu"),
        (64, 64, 3)),
    "vgg": (
        lambda dt: jvgg.VGG(stage_sizes=(1, 1, 2), width=8,
                            n_classes=N_CLASSES, dtype=dt),
        lambda dt: vgg.VGG(stage_sizes=(1, 1, 2), width=8,
                           n_classes=N_CLASSES, dtype=dt, device="cpu"),
        (16, 16, 3)),
    "densenet": (
        lambda dt: jdensenet.DenseNet(block_sizes=(1, 2), growth=4,
                                      n_classes=N_CLASSES, dtype=dt),
        lambda dt: densenet.DenseNet(block_sizes=(1, 2), growth=4,
                                     n_classes=N_CLASSES, dtype=dt,
                                     device="cpu"),
        (16, 16, 3)),
}


def _perturbed(blob, seed):
    """The blob with every scale, bias and running stat drawn around its
    init value (scales and variances kept positive)."""
    rng = np.random.default_rng(seed)

    def leaf(kp, a):
        if kp[-1].key == "kernel":
            return a
        b = a + rng.normal(0, 0.2, a.shape)
        if kp[-1].key in ("var", "scale"):
            b = np.abs(b) + 0.3
        return b.astype(np.float32)

    return {kind: jax.tree_util.tree_map_with_path(leaf, blob[kind])
            for kind in ("params", "batch_stats")}


@pytest.fixture(scope="module", params=sorted(KINDS))
def net(request):
    """One network's perturbed init blob (drawn by the port's seeded init,
    in flax's layout) and an input batch."""
    jm, pm, shape = KINDS[request.param]
    blob = _perturbed(cnn_params_to_jax(pm(torch.float32).state_dict()), 3)
    x = np.random.default_rng(4).uniform(0, 1, (8, *shape)) \
        .astype(np.float32)
    return dict(kind=request.param, jm=jm, pm=pm, shape=shape, blob=blob,
                x=x)


def _port(net, dtype=torch.float32):
    m = net["pm"](dtype)
    m.load_state_dict(cnn_params_from_jax(net["blob"]))
    return m


def test_param_names_and_shapes_are_flax(net):
    module = net["jm"](jnp.float32)
    want = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x,
                                                train=False),
                          jnp.zeros((1, *net["shape"])))
    for kind in ("params", "batch_stats"):
        shapes = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, bool),
                                        dict(want[kind]))
        assert {k: v.shape for k, v in _flat(net["blob"][kind]).items()} \
            == {k: v.shape for k, v in _flat(shapes).items()}


def test_eval_logits_match_flax(net):
    module = net["jm"](jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        net["blob"], net["x"]))
    m = _port(net).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(net["x"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_train_logits_and_batch_stats_match_flax(net):
    """A train-mode forward: the batch's statistics normalize, and the
    running stats blend 0.9·old + 0.1·batch with the *biased* variance."""
    module = net["jm"](jnp.float32)
    logits, upd = jax.jit(lambda v, x: module.apply(
        v, x, train=True, mutable=["batch_stats"]))(net["blob"], net["x"])
    m = _port(net).train()
    with torch.no_grad():
        got = m(torch.from_numpy(net["x"])).numpy()
    np.testing.assert_allclose(got, np.asarray(logits), rtol=1e-4,
                               atol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    stats = _flat(cnn_params_to_jax(m.state_dict())["batch_stats"])
    assert stats.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(stats[k], want[k], rtol=0,
                                   atol=4e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    moved = [k for k in want
             if not np.allclose(want[k], _flat(net["blob"]["batch_stats"])[k])]
    assert len(moved) == len(want)


def test_bf16_logits_match_flax(net):
    module = net["jm"](jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        net["blob"], net["x"]), np.float32)
    m = _port(net, torch.bfloat16).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(net["x"]))
    assert got.dtype == torch.float32  # the head runs in f32
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -5 * np.abs(want).max()


# ---- the templates, trained two epochs from one blob on both sides

#: per kind: (JAX template, port template, knobs, the variant the test
#: shrinks on both sides, the shrunk variant)
TEMPLATES = {
    "resnet_basic": (jresnet, resnet, "ResNetClassifier",
                     {"variant": "resnet18", "width_mult": 0.25},
                     ((1, 1), False)),
    "resnet_bottleneck": (jresnet, resnet, "ResNetClassifier",
                          {"variant": "resnet50", "width_mult": 0.25},
                          ((1, 1), True)),
    "vgg": (jvgg, vgg, "VGGClassifier",
            {"variant": "vgg11", "width_mult": 0.25}, (1, 1, 2)),
    "densenet": (jdensenet, densenet, "DenseNetClassifier",
                 {"variant": "densenet-s", "growth": 8}, (1, 1)),
}
KNOBS = {"max_epochs": 2, "learning_rate": 0.05, "weight_decay": 1e-3,
         "batch_size": 16, "bf16": False, "quick_train": False,
         "share_params": False}


@pytest.fixture(scope="module")
def trained(net, tmp_path_factory):
    jmod, pmod, cls, knobs, small = TEMPLATES[net["kind"]]
    knobs = {**KNOBS, **knobs}
    d = tmp_path_factory.mktemp(net["kind"])
    tr, va = str(d / "train.npz"), str(d / "val.npz")
    size = net["shape"][0]
    generate_image_classification_dataset(tr, 32, image_size=size,
                                          n_channels=3, n_classes=N_CLASSES,
                                          seed=0)
    ds = generate_image_classification_dataset(va, 16, image_size=size,
                                               n_channels=3,
                                               n_classes=N_CLASSES, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmod.VARIANTS, knobs["variant"], small)
        mp.setitem(pmod.VARIANTS, knobs["variant"], small)
        jm, pm = getattr(jmod, cls)(**knobs), getattr(pmod, cls)(
            device="cpu", **knobs)
        # the init blob at the template's own widths (the port's seeded
        # init, in flax's layout)
        pm._n_classes, pm._image_shape = N_CLASSES, list(net["shape"])
        blob = {**_perturbed(cnn_params_to_jax(pm._module().state_dict()),
                             5),
                "meta": {"n_classes": N_CLASSES,
                         "image_shape": list(net["shape"])}}
        jctx, pctx = JTrainContext(), TrainContext()
        jm.load_parameters(blob)
        pm.load_parameters(blob)
        jm.train(tr, jctx)
        pm.train(tr, pctx)
        # JAX's dump through a fresh port template's serving module
        jd = jm.dump_parameters()
        fresh = getattr(pmod, cls)(device="cpu", **knobs)
        fresh.load_parameters(jd)
        back = {**cnn_params_to_jax(fresh._serving_net().state_dict()),
                "meta": jd["meta"]}
        out = dict(jdump=jd, back=back, fresh_dump=fresh.dump_parameters(),
                   jm=jm, pm=pm, jctx=jctx, pctx=pctx, val=va, blob=blob,
                   queries=[ds.images[i] for i in range(4)],
                   jscore=jm.evaluate(va), pscore=pm.evaluate(va),
                   jprobs=np.asarray(jm.predict([ds.images[i]
                                                 for i in range(4)])),
                   pprobs=np.asarray(pm.predict([ds.images[i]
                                                 for i in range(4)])))
    return out


def test_template_epoch_losses_and_leaves_match_jax(trained):
    want = trained["jctx"].logger.get_values("loss")
    got = trained["pctx"].logger.get_values("loss")
    assert len(got) == len(want) == KNOBS["max_epochs"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jd, pd = trained["jm"].dump_parameters(), trained["pm"].dump_parameters()
    assert pd["meta"] == jd["meta"]
    imagenet_stem = trained["blob"]["meta"]["image_shape"][0] >= 64
    for kind in ("params", "batch_stats"):
        w, g = _flat(jd[kind]), _flat(pd[kind])
        init = _flat(trained["blob"][kind])
        assert g.keys() == w.keys()
        for k in w:
            # the ImageNet-stem net: JAX's own f32 gradient is off by up
            # to 4 % (test_imagenet_stem_gradients_match_an_f64_reference)
            moved = np.abs(w[k] - init[k]).max() if imagenet_stem else 0.0
            np.testing.assert_allclose(g[k], w[k], atol=2e-4 + 0.05 * moved,
                                       err_msg=k)
    assert trained["pscore"] == pytest.approx(trained["jscore"], abs=1e-6)
    np.testing.assert_allclose(trained["pprobs"], trained["jprobs"],
                               atol=1e-3 if imagenet_stem else 1e-4)


def test_blob_round_trip_is_bit_identical(trained):
    """JAX's dump → the port's module → the port's dump: the same bytes
    in both packages' codecs, keys in ``jax.tree_util``'s order."""
    want = jax_to_bytes(trained["jdump"])
    assert jax_to_bytes(trained["back"]) == want
    assert params_to_bytes(trained["back"]) == want
    assert params_to_bytes(trained["fresh_dump"]) == want


def test_imagenet_stem_gradients_match_an_f64_reference():
    """The bottleneck net behind the ImageNet stem, in train mode: the
    port's f32 gradients are within 1e-4 of each leaf's largest entry of
    the JAX module's gradients computed in f64 (seen: 1.6e-5). (JAX's own f32 gradients
    are off by up to 3.6 % there, e.g. ``stage1_block0/BatchNorm_0/bias``:
    a BatchNorm whose input's mean is large against its spread cancels in
    ``E[x²] − E[x]²`` and in its backward, and XLA's CPU reductions sum
    less accurately than torch's. So the template test above allows that
    net's trained leaves 5 % of their movement beside 2e-4.)"""
    jm, pm, shape = KINDS["resnet_bottleneck"]
    port = pm(torch.float32)
    blob = _perturbed(cnn_params_to_jax(port.state_dict()), 3)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (16, *shape)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, 16)
    with jax.enable_x64(True):
        module = jm(jnp.float64)
        b64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     blob)

        def loss(p):
            logits, _ = module.apply(
                {"params": p, "batch_stats": b64["batch_stats"]},
                jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        want = _flat(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(b64["params"])))
    port.load_state_dict(cnn_params_from_jax(blob))
    port.train()
    torch.nn.functional.cross_entropy(
        port(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    got = _flat(cnn_params_to_jax(
        {n: p.grad for n, p in port.named_parameters()})["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_float_pixels_are_scaled_as_jax_does(trained, tmp_path):
    """Pixels that are not uint8 (a JSON client's floats, a float
    ``.npz``) are divided by 255 as they are, fractions and values outside
    [0, 255] included, as JAX's ``astype(float32) / 255``; uint8 pixels,
    divided on the device, give the same f32 values bit for bit."""
    jm, pm = trained["jm"], trained["pm"]
    rng = np.random.default_rng(6)
    q = np.stack(trained["queries"]).astype(np.float32)
    q += rng.uniform(-0.5, 0.5, q.shape).astype(np.float32)
    q[0, 0, 0] = [300.7, -12.3, 255.9]
    for x in (q, np.stack(trained["queries"])):
        got = pm._device_images(pm._prep(x)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jm._prep(x))
    imagenet_stem = trained["blob"]["meta"]["image_shape"][0] >= 64
    np.testing.assert_allclose(np.asarray(pm.predict(list(q))),
                               np.asarray(jm.predict(list(q))),
                               atol=1e-3 if imagenet_stem else 1e-4)
    with np.load(trained["val"]) as z:
        images = z["images"].astype(np.float32) + rng.uniform(
            0, 0.9, z["images"].shape).astype(np.float32)
        path = str(tmp_path / "val_f32.npz")
        np.savez(path, images=images, labels=z["labels"],
                 n_classes=z["n_classes"])
    assert pm.evaluate(path) == pytest.approx(jm.evaluate(path), abs=1e-6)


# ---- SAME padding: XLA's is asymmetric

@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("op", ["conv7s2", "conv3s2", "conv1s2", "conv3s1",
                                "maxpool3s2"])
def test_same_padding_matches_flax(op, size):
    """At an even size a stride-2 SAME conv or pool pads one more pixel
    after than before; a symmetric pad would shift every output."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    if op.startswith("conv"):
        k, s = int(op[4]), int(op[6])
        kernel = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
        want = np.asarray(fnn.Conv(4, (k, k), (s, s), use_bias=False,
                                   dtype=jnp.float32).apply(
            {"params": {"kernel": kernel}}, x))
        conv = Conv(3, 4, (k, k), (s, s), torch.float32, "cpu",
                    torch.Generator().manual_seed(0))
        with torch.no_grad():
            conv.kernel.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    else:
        want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                       padding="SAME"))
        got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- the optimizer

def test_sgd_nesterov_matches_optax():
    """``optim.sgd_nesterov`` against the CNN recipe's optax chain over
    10 steps, past the end of the cosine: decay on kernels, none on
    ``bias`` / ``scale``."""
    rng = np.random.default_rng(0)
    p0 = {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4))},
          "bn": {"scale": rng.standard_normal(4),
                 "bias": rng.standard_normal(4)}}
    p0 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), p0)
    lr, wd, total = 0.3, 1e-2, 8
    mask = jax.tree_util.tree_map_with_path(
        lambda kp, _: kp[-1].key not in ("bias", "scale"), p0)
    tx = optax.chain(optax.add_decayed_weights(wd, mask=mask),
                     optax.sgd(optax.cosine_decay_schedule(lr, total),
                               momentum=0.9, nesterov=True))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {f"{a}.{b}": torch.nn.Parameter(torch.from_numpy(v.copy()))
          for a, leaves in p0.items() for b, v in leaves.items()}
    opt, sched = optim.sgd_nesterov(tp.items(), lr, total, wd)
    mine = optim.cosine_decay(lr, total)
    sched_j = optax.cosine_decay_schedule(lr, total)
    for step in range(10):
        # optax evaluates the cosine in f32
        assert mine(step) == pytest.approx(float(sched_j(step)), rel=1e-5,
                                           abs=1e-7)
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), p0)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, t in tp.items():
            a, b = name.split(".")
            t.grad = torch.from_numpy(g[a][b])
        opt.step()
        sched.step()
        for name, t in tp.items():
            a, b = name.split(".")
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jp[a][b]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {step}")
