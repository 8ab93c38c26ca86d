"""The port's gang lanes over the Llama template, case for case with
``tests/test_gang_llama.py`` at its ``LLAMA_PINS`` size, and against the
JAX package's engine.

- a 1-lane gang ``tune_model`` scores EXACTLY as the sequential one;
- ``gang_blockers`` names JAX's blockers, word for word, and no more: a
  ``remat_policy`` schedule is a bucket of its own, one executor each,
  and an admission lever (``"full"`` admits a gang ``"none"`` refuses
  at the same device limit);
- one executor per bucket; the winner's blob serves in the multi-adapter
  engine token-identically beside a sequentially trained twin, and the
  per-lane gauges carry one ``lane=<i>`` series per lane;
- batched proposals are seed-deterministic; an override typo and a
  pinned blocker are named; the worker's gang admission refuses a gang
  over the device limit and runs its trials sequentially;
- the gang estimator's lane terms are within 5 % of the lane state a
  4-lane executor holds;
- port against JAX (K = 2, from the JAX spec's base, loaded into the
  port's modules): the same trials, scores (inverse perplexity, f32)
  within 1e-4 relative; a K = 2 lane's losses step for step within
  1e-5 relative of its sequential twin's.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rafiki_tpu.advisor as JA
from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu.tuning import GangEngine as JGangEngine
from rafiki_tpu_torch.advisor import make_advisor
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.dev import tune_model
from rafiki_tpu_torch.model.knob import sample_knobs
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.models.llama_lora import (LlamaLoRA,
                                                estimate_gang_device_bytes)
from rafiki_tpu_torch.obs.metrics import MetricsRegistry
from rafiki_tpu_torch.tuning import GangEngine, supports_gang
from rafiki_tpu_torch.tuning.gang import _LaneExec

torch.set_num_threads(1)

LLAMA_PINS = {"hidden_dim": 64, "depth": 2, "n_heads": 4, "kv_ratio": 2,
              "lora_rank": 4, "max_len": 32, "batch_size": 16,
              "model_parallel": 1, "sequence_parallel": 1,
              "pipeline_stages": 1, "grad_accum": 1, "loss_chunk": 0,
              "pretrained_path": "", "tokenizer_path": "",
              "rope_scaling": "", "rope_theta": 10000.0,
              "remat": False, "remat_policy": "none",
              "overlap_collectives": False, "bf16": False,
              "quantize_int8": False, "kv_cache_int8": False,
              "adapters_only": False, "quick_train": True}


@pytest.fixture(scope="module")
def text_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("gang_llama")
    tr, va = str(d / "tr.jsonl"), str(d / "va.jsonl")
    generate_text_classification_dataset(tr, 48, seed=0)
    generate_text_classification_dataset(va, 16, seed=1)
    return tr, va


def _engine(data, advisor, k, template=LlamaLoRA, **kw):
    return GangEngine(template, advisor, *data, gang_size=k, mode="gang",
                      device="cpu", **kw)


def test_llama_supports_gang_and_names_blockers():
    assert supports_gang(LlamaLoRA)
    blockers = LlamaLoRA.gang_blockers({**LLAMA_PINS, "grad_accum": 2,
                                        "model_parallel": 2})
    joined = "; ".join(blockers)
    assert "grad_accum" in joined and "model_parallel" in joined
    assert LlamaLoRA.gang_blockers(dict(LLAMA_PINS)) == []
    # JAX's entries word for word, for every knob set: the checkpointing
    # schedules block nothing in either package
    for knobs in ({**LLAMA_PINS, "grad_accum": 2, "model_parallel": 2,
                   "loss_chunk": 8, "pretrained_path": "x.safetensors"},
                  {**LLAMA_PINS, "remat_policy": "full"},
                  {**LLAMA_PINS, "remat_policy": "policy", "remat": True},
                  {**LLAMA_PINS, "moe_experts": 4, "sequence_parallel": 2,
                   "pipeline_stages": 2}):
        assert LlamaLoRA.gang_blockers(knobs) == \
            JLlamaLoRA.gang_blockers(knobs)
    assert LlamaLoRA.gang_blockers({**LLAMA_PINS,
                                    "remat_policy": "full"}) == []


def test_one_lane_gang_scores_equal_sequential_tune_model(text_data):
    tr, va = text_data
    kw = dict(advisor_type="random", total_trials=2, seed=7,
              knob_overrides=LLAMA_PINS, device="cpu")
    seq = tune_model(LlamaLoRA, tr, va, **kw)
    gang = tune_model(LlamaLoRA, tr, va, gang_size=1, **kw)
    assert [t.knobs for t in gang.trials] == [t.knobs for t in seq.trials]
    assert [t.score for t in gang.trials] == [t.score for t in seq.trials]
    assert gang.best_score == seq.best_score


def test_compile_count_equals_buckets_remat_by_gang_sweep(text_data):
    """``tests/test_gang_llama.py``'s case: sweeping remat_policy (a
    static schedule knob) at K = 2 builds one executor per static
    bucket; the policy forks buckets, gang_size and the traceable knobs
    never do."""
    pins = {k: v for k, v in LLAMA_PINS.items() if k != "remat_policy"}
    adv = make_advisor(LlamaLoRA.get_knob_config(), "random",
                       total_trials=4, seed=4)
    eng = _engine(text_data, adv, 2, knob_overrides=pins)
    results = eng.run()
    assert len(results) == 4
    policies = {r.knobs["remat_policy"] for r in results}
    assert len(policies) >= 2, "seed must spread over policies"
    assert eng.n_buckets == len(policies)
    assert len(results) > eng.n_buckets
    assert list(eng.compile_counts().values()) == [1] * len(policies)
    assert not eng._blocked_buckets


def _need(total):
    """The device limit the train worker admits an estimate at."""
    from rafiki_tpu_torch.worker.admission import train_reserve

    return total + train_reserve(total)


def test_remat_policy_is_an_admission_lever(text_data, monkeypatch):
    """``tests/test_gang_llama.py``'s case: at a device limit between the
    two estimates, a gang refused at remat_policy="none" is admitted at
    "full"; the refused bucket falls back to sequential trials."""
    from rafiki_tpu_torch.worker.train import TrainWorker

    none_total = LlamaLoRA(device="cpu", **LLAMA_PINS
                           ).estimate_device_budget(1, gang_size=2)["total"]
    full_total = LlamaLoRA(
        device="cpu", **{**LLAMA_PINS, "remat_policy": "full"}
    ).estimate_device_budget(1, gang_size=2)["total"]
    assert full_total < none_total, \
        "full remat must shrink the estimated gang footprint"
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", str(
        (_need(none_total) + _need(full_total)) // 2))

    def run_worker(policy, n_trials):
        adv = make_advisor(LlamaLoRA.get_knob_config(), "random",
                           total_trials=n_trials, seed=6)
        worker = TrainWorker(
            LlamaLoRA, adv, *text_data, checkpoint_interval_s=0,
            knob_overrides={**LLAMA_PINS, "remat_policy": policy},
            device="cpu")
        n = worker.run_gang(gang_size=2, max_trials=n_trials)
        return n, worker.gang_engine

    n_full, eng_full = run_worker("full", 2)
    assert n_full == 2
    assert not eng_full._blocked_buckets, "full remat must be admitted"
    assert eng_full.n_buckets == 1  # ran as a real gang

    n_none, eng_none = run_worker("none", 1)
    assert n_none == 1  # refusal falls back, it does not strand trials
    reasons = list(eng_none._blocked_buckets.values())
    assert reasons and "remat_policy" in reasons[0]
    assert eng_none.n_buckets == 0  # nothing built as a gang


def test_compile_count_equals_buckets_by_gang_sweep(text_data):
    """Sweeping a static knob the port trains (bf16) at K = 2: one
    executor per bucket, never per trial or lane."""
    pins = {k: v for k, v in LLAMA_PINS.items() if k != "bf16"}
    adv = make_advisor(LlamaLoRA.get_knob_config(), "random",
                       total_trials=4, seed=4)
    eng = _engine(text_data, adv, 2, knob_overrides=pins)
    results = eng.run()
    assert len(results) == 4
    dtypes = {r.knobs["bf16"] for r in results}
    assert len(dtypes) == 2, "seed must spread over both dtypes"
    assert eng.n_buckets == 2 < len(results)
    assert list(eng.compile_counts().values()) == [1, 1]


def test_gang_winner_blob_serves_in_multi_adapter_engine(
        text_data, monkeypatch):
    monkeypatch.setenv("RAFIKI_DEVICE_PEAK_FLOPS", "1e12")
    tr, va = text_data
    pins = {**LLAMA_PINS, "adapters_only": True}
    reg = MetricsRegistry()
    adv = make_advisor(LlamaLoRA.get_knob_config(), "random",
                       total_trials=2, seed=4)
    eng = _engine(text_data, adv, 2, knob_overrides=pins, metrics=reg)
    results = eng.run()

    snap = reg.snapshot()
    assert snap["gang_lanes_active"] == 0
    assert snap["trials_per_hour"] > 0
    assert "gang_samples_per_s" in snap
    prom = reg.render_prometheus()
    for lane in (0, 1):
        assert f'lane_tokens_per_s{{lane="{lane}"}}' in prom
        assert f'lane_est_mfu{{lane="{lane}"}}' in prom

    best = max(results, key=lambda r: r.score)
    blob = eng._blobs[f"gang-{best.trial_no}"]
    twin = LlamaLoRA(device="cpu", **best.knobs)
    twin.train(tr, TrainContext())
    served = LlamaLoRA(device="cpu", **best.knobs)
    served.load_parameters(blob)
    multi = served.make_multi_adapter_engine(
        [served._params, twin._params], max_slots=2, max_new_tokens=6)
    prompt = "tok1 tok2 tok3"
    multi.submit("gang", prompt, adapter_id=0)
    multi.submit("seq", prompt, adapter_id=1)
    got = {}
    for _ in range(400):
        if not multi.busy:
            break
        multi.step()
        for rid, text in multi.poll():
            got[rid] = text
    assert set(got) == {"gang", "seq"}
    assert got["gang"] == got["seq"], \
        "gang-trained adapter diverged from its sequential twin"


def test_propose_batch_seed_determinism_llama_knob_space():
    kc = LlamaLoRA.get_knob_config()
    for advisor_type in ("random", "bohb"):
        a = make_advisor(kc, advisor_type, total_trials=8, seed=11)
        b = make_advisor(kc, advisor_type, total_trials=8, seed=11)
        pa = a.propose_batch(4) + a.propose_batch(4)
        pb = b.propose_batch(4) + b.propose_batch(4)
        assert [p.knobs for p in pa] == [p.knobs for p in pb]
        assert [p.trial_no for p in pa] == [p.trial_no for p in pb]


def test_llama_gang_override_typo_rejected(text_data):
    tr, va = text_data
    with pytest.raises(ValueError, match="knob_overrides.*lora_rnk"):
        tune_model(LlamaLoRA, tr, va, total_trials=1, gang_size=2,
                   knob_overrides={"lora_rnk": 4}, device="cpu")


def test_tune_model_warning_names_blocking_knob(text_data, monkeypatch):
    tr, va = text_data
    monkeypatch.setattr(LlamaLoRA, "train", lambda self, *a, **k: None)
    monkeypatch.setattr(LlamaLoRA, "evaluate", lambda self, *a, **k: 0.5)
    monkeypatch.setattr(LlamaLoRA, "dump_parameters", lambda self: None)
    with pytest.warns(UserWarning, match="model_parallel"):
        res = tune_model(LlamaLoRA, tr, va, advisor_type="random",
                         total_trials=1, seed=0, gang_size=2,
                         knob_overrides={**LLAMA_PINS,
                                         "model_parallel": 2},
                         device="cpu")
    assert len(res.trials) == 1  # the sequential fallback still tunes


def test_gang_admission_refuses_over_the_device_limit(text_data,
                                                      monkeypatch):
    """At a device limit between one trial's estimate and a 2-lane
    gang's, the worker's admission refuses the gang and its trials run
    sequentially, each admitted alone."""
    from rafiki_tpu_torch.worker.train import TrainWorker

    one = LlamaLoRA(device="cpu", **LLAMA_PINS).estimate_device_budget(1)
    two = LlamaLoRA(device="cpu", **LLAMA_PINS).estimate_device_budget(
        1, gang_size=2)
    assert two["total"] > one["total"]
    monkeypatch.setenv("RAFIKI_DEVICE_HBM_BYTES", str(
        (_need(one["total"]) + _need(two["total"])) // 2))
    adv = make_advisor(LlamaLoRA.get_knob_config(), "random",
                       total_trials=2, seed=6)
    worker = TrainWorker(LlamaLoRA, adv, *text_data,
                         checkpoint_interval_s=0, knob_overrides=LLAMA_PINS,
                         device="cpu")
    assert worker.run_gang(gang_size=2, max_trials=2) == 2
    reasons = list(worker.gang_engine._blocked_buckets.values())
    assert reasons and "2-lane gang exceeds" in reasons[0]
    assert worker.gang_engine.n_buckets == 0
    assert len(adv.results) == 2


def test_gang_estimator_matches_measured_resident_pool(text_data):
    knobs = {**sample_knobs(LlamaLoRA.get_knob_config(),
                            random.Random(0)), **LLAMA_PINS}
    est = estimate_gang_device_bytes(LlamaLoRA(device="cpu", **knobs), 4)
    assert est == LlamaLoRA(device="cpu", **knobs).estimate_device_budget(
        1, gang_size=4)
    spec = LlamaLoRA.make_gang_spec(knobs, *text_data, device="cpu")
    ex = _LaneExec(spec, 4, torch.device("cpu"))
    for i in range(4):
        ex.fill_lane(i, knobs, None)
    measured = sum(t.numel() * t.element_size()
                   for t in jax.tree_util.tree_leaves(ex.state))
    predicted = est["params"] + est["opt"] - est["base"]
    assert abs(measured - predicted) / predicted < 0.05, \
        (measured, predicted)
    one = LlamaLoRA(device="cpu", **knobs).estimate_device_budget(1)
    for key in ("grads", "opt", "activations"):
        assert est[key] == 4 * one[key], key


# ---- port against JAX

def _jax_base(knobs):
    """The JAX spec's frozen base: ``module.init(PRNGKey(0))``."""
    module = JLlamaLoRA(**knobs)._module()
    return jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, int(knobs["max_len"])), jnp.int32))["params"])


def _from_jax_base(base):
    """The port template whose modules start from the JAX base."""

    class FromJax(LlamaLoRA):
        def _module(self, quantized=False, n_adapters=0):
            m = super()._module(quantized, n_adapters)
            if not quantized and not n_adapters:
                ll._load_leaves(m, base)
            return m

    FromJax.__name__ = "LlamaLoRA"
    return FromJax


def test_port_gang_matches_jax_gang(text_data):
    pins = {**LLAMA_PINS, "share_params": False}
    jadv = JA.make_advisor(JLlamaLoRA.get_knob_config(), "random",
                           total_trials=2, seed=5)
    jres = JGangEngine(JLlamaLoRA, jadv, *text_data, gang_size=2,
                       knob_overrides=pins).run()
    padv = make_advisor(LlamaLoRA.get_knob_config(), "random",
                        total_trials=2, seed=5)
    pres = _engine(text_data, padv, 2, template=_from_jax_base(
        _jax_base(pins)), knob_overrides=pins).run()
    assert [(r.trial_no, r.knobs, r.budget_scale) for r in pres] == \
        [(r.trial_no, r.knobs, r.budget_scale) for r in jres]
    np.testing.assert_allclose([r.score for r in pres],
                               [r.score for r in jres], rtol=1e-4)


def test_lane_steps_like_its_sequential_twin(text_data):
    knobs = dict(LLAMA_PINS, learning_rate=1e-3, lora_scale=1.0,
                 max_epochs=2)
    spec = LlamaLoRA.make_gang_spec(knobs, *text_data, device="cpu")
    hps = [(3e-3, 0.5), (1e-2, 2.0)]
    ex = _LaneExec(spec, 2, torch.device("cpu"))
    for i, (lr, scale) in enumerate(hps):
        ex.fill_lane(i, dict(knobs, learning_rate=lr, lora_scale=scale),
                     None)
    twin = spec.init_lane(torch.Generator(), {})
    hp = {"learning_rate": torch.tensor(hps[1][0]),
          "lora_scale": torch.tensor(hps[1][1])}
    steps = 0
    for epoch in range(2):
        for batch in spec.epoch_batches(epoch):
            stacked = {k: np.stack([v] * 2) for k, v in batch.items()}
            ex.state, lanes = spec.train_lanes(ex.state, ex.hp, stacked)
            twin, loss = spec.train_step(twin, hp, batch)
            np.testing.assert_allclose(float(lanes[1]), float(loss),
                                       rtol=1e-5)
            steps += 1
    assert steps >= 4
    for name, t in twin["params"].items():
        np.testing.assert_allclose(ex.state["params"][name][1].numpy(),
                                   t.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
