"""The port's tabular datasets and ``JaxTabularMLP`` against the JAX
package's, on the CPU.

- the table generator writes JAX's bytes; the npz and the CSV loaders
  give JAX's arrays;
- the dropout masks are ``jax.random.split`` / ``bernoulli``'s bit for
  bit, step after step, for one lane and for K lanes;
- from JAX's initial tree, 2 epochs at dropout 0.3: per-epoch losses
  within 1e-5 relative (f32), probabilities within 1e-5, the same
  ``evaluate``; blobs cross both ways through both codecs;
- the gang: BOHB culls and promotions equal ``mode="sequential"``
  (``tests/test_tuning.py::test_gang_asha_culls_match_process_mode`` on
  the port, two traceable knobs), a 1-lane gang equals sequential
  ``tune_model``, and a K = 3 lane steps like its sequential twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import generate_tabular_dataset as jgen_table
from rafiki_tpu.data import load_tabular_dataset as jload_table
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models.tabular import JaxTabularMLP as JTabularMLP
from rafiki_tpu.store.param_store import params_from_bytes as jax_from_bytes
from rafiki_tpu.store.param_store import params_to_bytes as jax_to_bytes
from rafiki_tpu_torch.advisor import make_advisor
from rafiki_tpu_torch.data.dataset import (generate_tabular_dataset,
                                           load_tabular_dataset)
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.dev import tune_model
from rafiki_tpu_torch.models.tabular import JaxTabularMLP, _drop_masks
from rafiki_tpu_torch.store.param_store import (params_from_bytes,
                                               params_to_bytes)
from rafiki_tpu_torch.tuning import GangEngine, supports_gang
from rafiki_tpu_torch.utils import threefry

torch.set_num_threads(1)

KNOBS = {"max_epochs": 2, "hidden_layer_count": 2, "hidden_layer_units": 32,
         "dropout": 0.3, "learning_rate": 1e-2, "batch_size": 64,
         "quick_train": False, "share_params": False}
#: tests/test_tuning.py's shape pins: one static bucket
TAB_PINS = {"hidden_layer_count": 2, "hidden_layer_units": 32,
            "batch_size": 128}


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_table")
    tr, va = str(d / "tr.npz"), str(d / "va.npz")
    jgen_table(tr, 512, seed=0)
    jgen_table(va, 128, seed=1)
    return tr, va


@pytest.fixture(scope="module")
def gang_table(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_gang_table")
    tr, va = str(d / "tr.npz"), str(d / "va.npz")
    generate_tabular_dataset(tr, 384, seed=0)
    generate_tabular_dataset(va, 128, seed=1)
    return tr, va


def _jax_init_blob(train_path):
    ds = jload_table(train_path)
    module = JTabularMLP._build_module(KNOBS["hidden_layer_count"],
                                       KNOBS["hidden_layer_units"],
                                       ds.n_classes)
    init = module.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, ds.features.shape[1])))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, init),
            "mean": ds.features.mean(axis=0),
            "std": ds.features.std(axis=0) + 1e-6,
            "meta": {"n_classes": int(ds.n_classes)}}


# ---- the datasets

@pytest.mark.parametrize("shape", [(64, 16, 3, 0), (300, 54, 7, 4)])
def test_generated_table_is_jax_bytes_and_arrays(tmp_path, shape):
    n, d, k, seed = shape
    a, b = tmp_path / "jax.npz", tmp_path / "port.npz"
    jds = jgen_table(str(a), n, n_features=d, n_classes=k, seed=seed)
    pds = generate_tabular_dataset(str(b), n, n_features=d, n_classes=k,
                                   seed=seed)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(pds.features, jds.features)
    np.testing.assert_array_equal(pds.labels, jds.labels)
    loaded = load_tabular_dataset(str(a))
    jloaded = jload_table(str(b))
    for got, want in ((loaded, jds), (jloaded, pds)):
        assert got.features.dtype == np.float32
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.n_classes == k and got.feature_names == want.feature_names


@pytest.mark.parametrize("labels", ["int", "float", "str"])
def test_csv_loads_as_jax_loads_it(tmp_path, labels):
    ds = generate_tabular_dataset("", 64, n_features=4, seed=3)
    p = tmp_path / "t.csv"
    lab = {"int": lambda v: str(v), "float": lambda v: f"{v + 0.25}",
           "str": lambda v: f"class_{v}"}[labels]
    with open(p, "w") as f:
        f.write("f0,f1,f2,f3,label\n")
        for row, y in zip(ds.features, ds.labels):
            f.write(",".join(f"{v:.6f}" for v in row) + f",{lab(y)}\n")
    got, want = load_tabular_dataset(str(p)), jload_table(str(p))
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype
    assert (got.n_classes, got.feature_names) == \
        (want.n_classes, want.feature_names)
    np.testing.assert_allclose(got.features, ds.features, atol=1e-5)
    with pytest.raises(ValueError, match="unrecognized tabular"):
        load_tabular_dataset(str(tmp_path / "t.parquet"))


# ---- the template

def test_dropout_masks_are_jax_bits_step_after_step():
    n_hidden, batch, units = 3, 64, 24
    key = threefry.prng_key(1)
    jkey = jax.random.PRNGKey(1)
    for step, keep in enumerate((0.7, 0.5, 1.0, 0.83)):
        key, masks = _drop_masks(key, torch.tensor(keep), n_hidden, batch,
                                 units)
        jkey, sk = jax.random.split(jkey)
        lk = jax.random.split(sk, max(n_hidden, 1))
        kp = jnp.float32(keep)
        for li in range(n_hidden):
            want = np.asarray(jax.random.bernoulli(lk[li], kp,
                                                   (batch, units)) / kp)
            np.testing.assert_array_equal(masks[li].numpy(), want)
        np.testing.assert_array_equal(key.numpy(),
                                      np.asarray(jkey).astype(np.int64))
    # K lanes at their own keep probabilities: each lane's masks are its
    # own key's
    keys = torch.stack([threefry.prng_key(1), threefry.prng_key(5)])
    keeps = torch.tensor([0.6, 0.9])
    nxt, masks = _drop_masks(keys, keeps, n_hidden, batch, units)
    assert masks.shape == (n_hidden, 2, batch, units)
    for lane in range(2):
        k1, m1 = _drop_masks(keys[lane], keeps[lane], n_hidden, batch,
                             units)
        np.testing.assert_array_equal(masks[:, lane].numpy(), m1.numpy())
        np.testing.assert_array_equal(nxt[lane].numpy(), k1.numpy())


def test_two_epochs_at_dropout_follow_jax(table):
    tr, va = table
    blob0 = _jax_init_blob(tr)
    jm = JTabularMLP(**KNOBS)
    jm.load_parameters(blob0)
    jctx = JTrainContext()
    jm.train(tr, jctx)
    pm = JaxTabularMLP(device="cpu", **KNOBS)
    pm.load_parameters(blob0)
    ctx = TrainContext()
    pm.train(tr, ctx)
    jl = np.asarray(jctx.logger.get_values("loss"))
    pl = np.asarray(ctx.logger.get_values("loss"))
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[1] < pl[0]
    queries = list(jload_table(va).features[:64])
    np.testing.assert_allclose(np.asarray(pm.predict(queries)),
                               np.asarray(jm.predict(queries)), atol=1e-5)
    assert pm.evaluate(va) == pytest.approx(jm.evaluate(va), abs=1e-9)
    # the blob: JAX's layout, the same leaves to f32 rounding
    pb, jb = pm.dump_parameters(), jm.dump_parameters()
    assert set(pb) == set(jb) == {"params", "mean", "std", "meta"}
    np.testing.assert_array_equal(pb["mean"], jb["mean"])
    jleaves = jax.tree_util.tree_leaves_with_path(jb["params"])
    pleaves = jax.tree_util.tree_leaves_with_path(pb["params"])
    assert [p for p, _ in jleaves] == [p for p, _ in pleaves]
    for (_, a), (_, b) in zip(jleaves, pleaves):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_blobs_cross_both_ways_with_equal_predictions(table, writer):
    tr, va = table
    queries = list(jload_table(va).features[:40])
    if writer == "port":
        src = JaxTabularMLP(device="cpu", **KNOBS)
        src.train(tr)
        blob = src.dump_parameters()
        dst = JTabularMLP(**KNOBS)
    else:
        src = JTabularMLP(**KNOBS)
        src.train(tr)
        blob = src.dump_parameters()
        dst = JaxTabularMLP(device="cpu", **KNOBS)
    want = np.asarray(src.predict(queries))
    for encode, decode in ((params_to_bytes, jax_from_bytes),
                           (jax_to_bytes, params_from_bytes)):
        dst.load_parameters(decode(encode(blob)))
        np.testing.assert_allclose(np.asarray(dst.predict(queries)), want,
                                   atol=1e-5)


def test_warm_start_and_regression_refusal(table, tmp_path):
    tr, _ = table
    donor = JaxTabularMLP(device="cpu", **KNOBS)
    donor.train(tr)
    knobs = dict(KNOBS, share_params=True, max_epochs=1)
    m = JaxTabularMLP(device="cpu", **knobs)
    m.train(tr, TrainContext(shared_params=donor.dump_parameters()))
    j = JTabularMLP(**knobs)
    j.train(tr, JTrainContext(shared_params=donor.dump_parameters()))
    np.testing.assert_allclose(
        m.dump_parameters()["params"]["Dense_2"]["kernel"],
        j.dump_parameters()["params"]["Dense_2"]["kernel"], atol=1e-5)
    reg = tmp_path / "reg.npz"
    ds = generate_tabular_dataset("", 32, seed=0)
    np.savez_compressed(reg, features=ds.features,
                        labels=ds.features[:, 0], n_classes=np.asarray(0))
    with pytest.raises(ValueError, match="regression"):
        JaxTabularMLP(device="cpu", **KNOBS).train(str(reg))


# ---- the gang

def _result_tuples(results):
    return [(r.trial_no, r.budget_scale, r.meta.get("rung"),
             r.meta.get("parent_trial_no")) for r in results]


def test_gang_asha_culls_match_process_mode(gang_table):
    assert supports_gang(JaxTabularMLP)
    kc = JaxTabularMLP.get_knob_config()
    a_gang = make_advisor(kc, "bohb", total_trials=8, seed=5)
    e_gang = GangEngine(JaxTabularMLP, a_gang, *gang_table, gang_size=4,
                        mode="gang", knob_overrides=TAB_PINS, device="cpu")
    r_gang = e_gang.run()
    a_proc = make_advisor(kc, "bohb", total_trials=8, seed=5)
    e_proc = GangEngine(JaxTabularMLP, a_proc, *gang_table, gang_size=4,
                        mode="sequential", knob_overrides=TAB_PINS,
                        device="cpu")
    r_proc = e_proc.run()
    assert _result_tuples(r_gang) == _result_tuples(r_proc)
    np.testing.assert_allclose([r.score for r in r_gang],
                               [r.score for r in r_proc], atol=1e-6)
    promoted = {r.meta.get("parent_trial_no") for r in r_gang
                if r.meta.get("parent_trial_no") is not None}
    assert promoted == {r.meta.get("parent_trial_no") for r in r_proc
                        if r.meta.get("parent_trial_no") is not None}
    assert promoted, "fixture must exercise at least one promotion"
    assert {r.trial_no for r in r_gang} - promoted == \
        {r.trial_no for r in r_proc} - promoted
    assert e_gang.n_buckets == 1
    assert list(e_gang.compile_counts().values()) == [1]
    assert a_gang.best_effort.score == pytest.approx(
        a_proc.best_effort.score, abs=1e-6)


def test_one_lane_gang_equals_sequential_tune_model(gang_table):
    tr, va = gang_table
    seq = tune_model(JaxTabularMLP, tr, va, total_trials=3,
                     advisor_type="random", seed=7, knob_overrides=TAB_PINS,
                     device="cpu")
    gang = tune_model(JaxTabularMLP, tr, va, total_trials=3,
                      advisor_type="random", seed=7, gang_size=1,
                      knob_overrides=TAB_PINS, device="cpu")
    assert [t.knobs for t in gang.trials] == [t.knobs for t in seq.trials]
    assert [t.score for t in gang.trials] == [t.score for t in seq.trials]


def test_a_lane_steps_like_its_sequential_twin(gang_table):
    tr, va = gang_table
    knobs = dict(KNOBS, **TAB_PINS)
    hps = [(0.1, 3e-3), (0.4, 1e-2), (0.0, 3e-2)]
    spec = JaxTabularMLP.make_gang_spec(knobs, tr, va, device="cpu")
    lanes = [spec.init_lane(torch.Generator().manual_seed(0), {})
             for _ in hps]
    stacked = {"params": {n: torch.stack([s["params"][n] for s in lanes])
                          for n in lanes[0]["params"]},
               "opt": {"count": torch.zeros(3, dtype=torch.int32),
                       "mu": {n: torch.zeros(3, *t.shape) for n, t in
                              lanes[0]["params"].items()},
                       "nu": {n: torch.zeros(3, *t.shape) for n, t in
                              lanes[0]["params"].items()}},
               "rng": torch.stack([s["rng"] for s in lanes])}
    hp = {"dropout": torch.tensor([d for d, _ in hps]),
          "learning_rate": torch.tensor([lr for _, lr in hps])}
    twins = [spec.init_lane(torch.Generator().manual_seed(0), {})
             for _ in hps]
    for batch in list(spec.epoch_batches(0))[:4]:
        stacked, lane_loss = spec.train_lanes(
            stacked, hp, {k: np.stack([v] * 3) for k, v in batch.items()})
        for i, (d, lr) in enumerate(hps):
            twins[i], loss = spec.train_step(
                twins[i], {"dropout": torch.tensor(d),
                           "learning_rate": torch.tensor(lr)}, batch)
            np.testing.assert_allclose(float(lane_loss[i]), float(loss),
                                       rtol=1e-6)
            np.testing.assert_array_equal(stacked["rng"][i].numpy(),
                                          twins[i]["rng"].numpy())


# ---- through the workers

def train_and_serve(tmp_path, template, task, train, val, queries,
                    pins, trials=2):
    """A tuning job of ``template`` through the port's ``TrainWorker``
    (a sqlite MetaStore, a file ParamStore), its best trial served by two
    ``InferenceWorker``s behind the port's ``Predictor``. Returns (the
    Predictor's answers, the best trial's direct ``predict``)."""
    import threading

    from rafiki_tpu_torch.serving import queues
    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.store.meta_store import MetaStore
    from rafiki_tpu_torch.store.param_store import ParamStore
    from rafiki_tpu_torch.worker.inference import InferenceWorker
    from rafiki_tpu_torch.worker.train import TrainWorker

    meta = MetaStore(str(tmp_path / "meta.db"))
    job = meta.create_train_job("u0", "zoo", 1, task,
                                {"TRIAL_COUNT": trials}, "tr", "va")
    sub = meta.create_sub_train_job(job["id"], "m0")["id"]
    store = ParamStore.from_uri(f"file://{tmp_path / 'params'}")
    worker = TrainWorker(
        template, make_advisor(template.get_knob_config(), "random",
                               total_trials=trials, seed=0),
        train, val, param_store=store, meta_store=meta,
        sub_train_job_id=sub, model_id="m0", worker_id="t0",
        knob_overrides=pins, device="cpu")
    assert worker.run() == trials
    rows = meta.get_trials_of_sub_train_job(sub)
    assert [t["status"] for t in rows] == ["COMPLETED"] * trials
    best = meta.get_best_trials_of_train_job(job["id"], 1)[0]
    hub = queues.InProcQueueHub()
    workers = [InferenceWorker(template, best["id"], best["knobs"], store,
                               hub, f"w{i}", device="cpu")
               for i in range(2)]
    loops = [threading.Thread(target=w.run, kwargs={"poll_timeout": 0.01})
             for w in workers]
    for t in loops:
        t.start()
    try:
        served, info = Predictor(hub, ["w0", "w1"],
                                 gather_timeout=60.0).predict(queries)
    finally:
        for w in workers:
            w.stop()
        for t in loops:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in loops)
    assert info["workers_answered"] == 2
    direct = template(device="cpu", **best["knobs"])
    direct.load_parameters(store.load(best["id"]))
    return served, direct.predict(queries)


def test_a_tabular_job_trains_and_serves_through_the_workers(gang_table,
                                                             tmp_path):
    tr, va = gang_table
    queries = jload_table(va).features[:24].tolist()
    served, direct = train_and_serve(
        tmp_path, JaxTabularMLP, "TABULAR_CLASSIFICATION", tr, va, queries,
        dict(TAB_PINS, quick_train=True))
    np.testing.assert_array_equal(np.asarray(served), np.asarray(direct))
