"""The port's gang engine on the feed-forward template, case for case
with ``tests/test_tuning.py``, and against the JAX package's engine.

- a 1-lane gang scores EXACTLY as the port's sequential ``tune_model``
  (the executor runs the template's own step, no lane axis);
- gang culls and promotions equal ``mode="sequential"`` (JAX holds this
  on the tabular template, which the port has not ported yet; here the
  feed-forward one, BOHB, K = 4, with promotions warm-started in lanes);
- one executor per static bucket, the ``max_trials`` cap mid-session,
  override typos, the fallback warning, the gauges, the train worker's
  ``run_gang`` through a MetaStore;
- port against JAX: one advisor seed through both packages' engines
  from the same init lanes (the JAX spec's, carried over by
  ``store/params.lane_params_from_jax``) gives the same trials, and
  scores within 1e-6 (masked accuracy over 96 images, f32; the two
  frameworks sum the matmuls in another order);
- a lane of a K = 4 gang steps like its sequential twin: per-step
  losses within 1e-6 relative.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import rafiki_tpu.advisor as JA
from rafiki_tpu.models.mlp import JaxFeedForward as JFeedForward
from rafiki_tpu.tuning import GangEngine as JGangEngine
from rafiki_tpu_torch.advisor import make_advisor
from rafiki_tpu_torch.data.dataset import \
    generate_image_classification_dataset
from rafiki_tpu_torch.model.dev import tune_model
from rafiki_tpu_torch.model.optim import lane_adam_init
from rafiki_tpu_torch.models.mlp import JaxFeedForward
from rafiki_tpu_torch.obs.metrics import MetricsRegistry
from rafiki_tpu_torch.store.params import (lane_params_from_jax,
                                           lane_params_to_jax)
from rafiki_tpu_torch.tuning import GangEngine, supports_gang
from rafiki_tpu_torch.tuning.gang import _LaneExec

torch.set_num_threads(1)

#: shape pins putting every proposal in ONE static bucket (the advisor
#: still searches learning_rate, the traceable knob)
MLP_PINS = {"hidden_layer_count": 1, "hidden_layer_units": 24,
            "batch_size": 32}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def image_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("gang_img")
    tr, va = str(d / "tr.npz"), str(d / "va.npz")
    generate_image_classification_dataset(tr, 256, seed=0)
    generate_image_classification_dataset(va, 96, seed=1)
    return tr, va


def result_tuples(results):
    return [(r.trial_no, r.budget_scale, r.meta.get("rung"),
             r.meta.get("parent_trial_no")) for r in results]


def _engine(data, advisor, k, mode="gang", **kw):
    return GangEngine(JaxFeedForward, advisor, *data, gang_size=k,
                      mode=mode, device="cpu", **kw)


def test_supports_gang_detection():
    from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
    from rafiki_tpu_torch.models.resnet import ResNetClassifier

    assert supports_gang(JaxFeedForward)
    assert supports_gang(LlamaLoRA)
    # gang_epochs without make_gang_spec is not enough
    assert callable(getattr(ResNetClassifier, "gang_epochs", None))
    assert not supports_gang(ResNetClassifier)
    with pytest.raises(ValueError, match="make_gang_spec"):
        GangEngine(ResNetClassifier, object(), "tr", "va", mode="gang",
                   device="cpu")


def test_one_lane_gang_scores_equal_sequential_tune_model(image_data):
    tr, va = image_data
    seq = tune_model(JaxFeedForward, tr, va, total_trials=3,
                     advisor_type="random", seed=7, device="cpu")
    adv = make_advisor(JaxFeedForward.get_knob_config(), "random",
                       total_trials=3, seed=7)
    results = _engine(image_data, adv, 1).run()
    assert [r.knobs for r in results] == [t.knobs for t in seq.trials]
    assert [r.score for r in results] == [t.score for t in seq.trials]
    assert adv.best_effort.score == seq.best_score


def test_gang_asha_culls_match_process_mode(image_data):
    kc = JaxFeedForward.get_knob_config()
    a_gang = make_advisor(kc, "bohb", total_trials=8, seed=5)
    e_gang = _engine(image_data, a_gang, 4, knob_overrides=MLP_PINS)
    r_gang = e_gang.run()
    a_proc = make_advisor(kc, "bohb", total_trials=8, seed=5)
    e_proc = _engine(image_data, a_proc, 4, mode="sequential",
                     knob_overrides=MLP_PINS)
    r_proc = e_proc.run()
    assert result_tuples(r_gang) == result_tuples(r_proc)
    np.testing.assert_allclose([r.score for r in r_gang],
                               [r.score for r in r_proc], atol=1e-6)
    promoted_gang = {r.meta.get("parent_trial_no") for r in r_gang
                     if r.meta.get("parent_trial_no") is not None}
    promoted_proc = {r.meta.get("parent_trial_no") for r in r_proc
                     if r.meta.get("parent_trial_no") is not None}
    assert promoted_gang == promoted_proc
    assert promoted_gang, "fixture must exercise at least one promotion"
    assert {r.trial_no for r in r_gang} - promoted_gang == \
        {r.trial_no for r in r_proc} - promoted_proc
    assert e_gang.stats["promotions"] == e_proc.stats["promotions"] > 0
    assert e_gang.n_buckets == 1
    assert list(e_gang.compile_counts().values()) == [1]
    assert a_gang.best_effort.score == pytest.approx(
        a_proc.best_effort.score, abs=1e-6)


def test_compile_count_equals_static_buckets_not_trials(image_data,
                                                        monkeypatch):
    """With batch_size free (a shape knob) the trials spread over
    buckets: one executor per bucket, built once, never per trial or
    per refill."""
    built = []
    real_init = _LaneExec.__init__

    def counted(self, *a, **kw):
        built.append(1)
        real_init(self, *a, **kw)

    monkeypatch.setattr(_LaneExec, "__init__", counted)
    pins = {"hidden_layer_count": 1, "hidden_layer_units": 24}
    adv = make_advisor(JaxFeedForward.get_knob_config(), "random",
                       total_trials=6, seed=2)
    eng = _engine(image_data, adv, 2, knob_overrides=pins)
    results = eng.run()
    assert len(results) == 6
    batch_sizes = {r.knobs["batch_size"] for r in results}
    assert len(batch_sizes) >= 2, "seed must spread over buckets"
    assert eng.n_buckets == len(batch_sizes) == len(built)
    assert len(results) > eng.n_buckets
    assert list(eng.compile_counts().values()) == [1] * len(batch_sizes)


def test_gang_max_trials_cap_enforced_mid_session(image_data):
    adv = make_advisor(JaxFeedForward.get_knob_config(), "random",
                       total_trials=64, seed=0)
    eng = _engine(image_data, adv, 2, knob_overrides=MLP_PINS)
    results = eng.run(max_trials=4)
    assert len(results) == 4
    assert eng.stats["trials_started"] == 4
    assert not adv._outstanding


def test_tune_model_gang_path_and_override_validation(image_data):
    tr, va = image_data
    res = tune_model(JaxFeedForward, tr, va, total_trials=4,
                     advisor_type="random", seed=3, gang_size=2,
                     knob_overrides=MLP_PINS, device="cpu")
    assert len(res.trials) == 4
    assert res.best_score == max(t.score for t in res.trials)
    assert res.best_params and "params" in res.best_params
    for gang_size in (0, 2):
        with pytest.raises(ValueError,
                           match="knob_overrides.*learnin_rate"):
            tune_model(JaxFeedForward, tr, va, total_trials=1,
                       gang_size=gang_size, device="cpu",
                       knob_overrides={"learnin_rate": 1e-3})


def test_tune_model_gang_falls_back_without_spec():
    from rafiki_tpu_torch.model.knob import FixedKnob

    calls = []

    class _Toy:
        def __init__(self, device=None, **knobs):
            self.knobs = knobs

        @staticmethod
        def get_knob_config():
            return {"c": FixedKnob(1)}

        def train(self, dataset_path, ctx=None):
            calls.append("train")

        def evaluate(self, dataset_path):
            return 0.5

        def dump_parameters(self):
            return {"w": np.zeros(1)}

    with pytest.warns(UserWarning, match="no gang spec"):
        res = tune_model(_Toy, "tr", "va", total_trials=2,
                         advisor_type="random", gang_size=4, device="cpu")
    assert calls == ["train", "train"]
    assert res.best_score == 0.5


def test_gang_obs_gauges_ride_metrics_registry(image_data):
    reg = MetricsRegistry()
    adv = make_advisor(JaxFeedForward.get_knob_config(), "bohb",
                       total_trials=6, seed=1)
    eng = _engine(image_data, adv, 3, knob_overrides=MLP_PINS,
                  metrics=reg)
    results = eng.run()
    snap = reg.snapshot()
    assert snap["gang_lanes_active"] == 0  # drained at exit
    assert snap["trials_per_hour"] > 0
    assert snap["gang_samples_per_s"] > 0
    assert snap["gang_lanes_culled_total"] == sum(
        1 for r in results if r.budget_scale < 1.0 - 1e-9)
    assert eng.stats["trials_completed"] == len(results)


def test_train_worker_gang_mode(image_data, tmp_path):
    """``run_gang`` reports one completed trial per lane through the
    worker's MetaStore rows, ParamStore blobs and counters."""
    from rafiki_tpu_torch.store.meta_store import MetaStore
    from rafiki_tpu_torch.worker.train import TrainWorker

    meta = MetaStore(str(tmp_path / "meta.db"))
    user = meta.create_user("gang@x", "pw", "ADMIN")
    job = meta.create_train_job(user["id"], "gang", 1,
                                "IMAGE_CLASSIFICATION", {"TRIAL_COUNT": 4},
                                "d1", "d2")
    model = meta.create_model(user["id"], "ff", "IMAGE_CLASSIFICATION",
                              "JaxFeedForward", b"")
    sub = meta.create_sub_train_job(job["id"], model["id"])
    adv = make_advisor(JaxFeedForward.get_knob_config(), "random",
                       total_trials=4, seed=9)
    worker = TrainWorker(JaxFeedForward, adv, *image_data,
                         meta_store=meta, sub_train_job_id=sub["id"],
                         model_id=model["id"], knob_overrides=MLP_PINS,
                         checkpoint_interval_s=0, device="cpu")
    n = worker.run_gang(gang_size=2)
    assert n == 4 == worker.trials_run
    snap = worker.metrics.snapshot()
    assert snap["trials_completed"] == 4
    assert snap["gang_lanes_active"] == 0
    assert snap["trials_per_hour"] > 0
    rows = meta.get_trials_of_sub_train_job(sub["id"])
    assert len(rows) == 4
    assert all(t["status"] == "COMPLETED" for t in rows)
    by_no = {r.trial_no: r for r in adv.results}
    for t in rows:
        assert t["score"] == pytest.approx(by_no[t["trial_no"]].score)
        blob = worker.param_store.load(t["id"])
        assert blob is not None and "params" in blob


# ---- port against JAX

def _jax_init(knobs, data):
    """The JAX spec's init lane (PRNGKey(0)), as numpy."""
    spec = JFeedForward.make_gang_spec(dict(knobs), *data)
    lane = spec.init_lane(jax.random.PRNGKey(0), {
        "learning_rate": np.float32(knobs["learning_rate"])})
    return jax.tree_util.tree_map(np.asarray, lane["params"])


def _from_jax_init(data):
    """The port template whose lanes start from the JAX spec's init."""

    class FromJax(JaxFeedForward):
        @classmethod
        def make_gang_spec(cls, knobs, tr, va, device=None):
            spec = super().make_gang_spec(knobs, tr, va, device=device)
            fresh = spec.init_lane(torch.Generator().manual_seed(0), {})
            jinit = _jax_init(knobs, data)

            def init_lane(gen, hp):
                params = lane_params_from_jax(jinit, fresh["params"])
                return {"params": params, "opt": lane_adam_init(params)}

            return dataclasses.replace(spec, init_lane=init_lane)

    FromJax.__name__ = "JaxFeedForward"
    return FromJax


def test_port_gang_matches_jax_gang(image_data):
    pins = dict(MLP_PINS, share_params=False)
    jadv = JA.make_advisor(JFeedForward.get_knob_config(), "random",
                           total_trials=8, seed=11)
    jres = JGangEngine(JFeedForward, jadv, *image_data, gang_size=4,
                       knob_overrides=pins).run()
    padv = make_advisor(JaxFeedForward.get_knob_config(), "random",
                        total_trials=8, seed=11)
    peng = GangEngine(_from_jax_init(image_data), padv, *image_data,
                      gang_size=4, knob_overrides=pins, device="cpu")
    pres = peng.run()
    assert [(r.trial_no, r.knobs, r.budget_scale) for r in pres] == \
        [(r.trial_no, r.knobs, r.budget_scale) for r in jres]
    np.testing.assert_allclose([r.score for r in pres],
                               [r.score for r in jres], atol=1e-6)
    assert len({r.score for r in pres}) > 1, "lanes must train apart"


def test_lane_state_crosses_both_ways(image_data):
    """A JAX gang's stacked lane params (leading K) load into a port
    executor and come back out unchanged."""
    knobs = dict(MLP_PINS, max_epochs=1, learning_rate=1e-3)
    jinit = _jax_init(knobs, image_data)
    stacked = jax.tree_util.tree_map(
        lambda a: np.stack([a, 2 * a, 3 * a]), jinit)
    spec = JaxFeedForward.make_gang_spec(knobs, *image_data, device="cpu")
    names = list(spec.init_lane(torch.Generator(), {})["params"])
    port = lane_params_from_jax(stacked, names)
    assert all(t.shape[0] == 3 for t in port.values())
    back = lane_params_to_jax(port)
    for layer, leaves in stacked.items():
        for leaf, want in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], want)


def test_lane_steps_like_its_sequential_twin(image_data):
    """Lane 2 of a K = 4 gang (the lanes at four rates) against the
    one-lane step at lane 2's rate, on the same batches."""
    knobs = dict(MLP_PINS, max_epochs=2, learning_rate=1e-3)
    spec = JaxFeedForward.make_gang_spec(knobs, *image_data, device="cpu")
    rates = [3e-4, 1e-3, 3e-3, 1e-2]
    ex = _LaneExec(spec, 4, CPU)
    for i, lr in enumerate(rates):
        ex.fill_lane(i, dict(knobs, learning_rate=lr), None)
    twin = spec.init_lane(torch.Generator().manual_seed(0), {})
    hp = {"learning_rate": torch.tensor(rates[2])}
    for epoch in range(2):
        for batch in spec.epoch_batches(epoch):
            stacked = {k: np.stack([v] * 4) for k, v in batch.items()}
            ex.state, lanes = spec.train_lanes(ex.state, ex.hp, stacked)
            twin, loss = spec.train_step(twin, hp, batch)
            np.testing.assert_allclose(float(lanes[2]), float(loss),
                                       rtol=1e-6)
    for name, t in twin["params"].items():
        np.testing.assert_allclose(ex.state["params"][name][2].numpy(),
                                   t.numpy(), rtol=1e-5, atol=1e-7)
