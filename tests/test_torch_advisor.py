"""Port parity: ``rafiki_tpu_torch.advisor`` against the JAX advisors.

For each registry entry, a port and a JAX advisor built on the same knob
config and seed take the same scripted feedback stream — scores computed
from the proposed knobs, every fifth proposal reported errored — and
must hand out identical proposals (knobs, ``budget_scale``,
``warm_start_trial_id``, ``meta``) round for round, then agree on the
best trial. BOHB runs long enough on a small space for its TPE sampler
(scipy's ``gaussian_kde``) to take over from random draws; Bayes-GP past
its initial random points, so the port's own Gaussian process picks
among the candidates. Also held here: ``make_advisor("auto")`` per
template, and the port's ``AdvisorClient`` driving the JAX advisor
service over HTTP.
"""

import math

import pytest
import scipy.stats
import torch

import rafiki_tpu.advisor as J
import rafiki_tpu_torch.advisor as P
from rafiki_tpu.advisor.service import AdvisorService
from rafiki_tpu.model import knob as jk
from rafiki_tpu.models.bert import BertClassifier as JBert
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlama
from rafiki_tpu.models.vit import ViTBase16 as JViT
from rafiki_tpu_torch.advisor.service import AdvisorClient
from rafiki_tpu_torch.model import knob as pk
from rafiki_tpu_torch.models.bert import BertClassifier
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.models.vit import ViTBase16

torch.set_num_threads(1)

SMALL = {"lr": jk.FloatKnob(1e-4, 1e-1, is_exp=True),
         "wd": jk.FloatKnob(0.0, 1.0),
         "n": jk.IntegerKnob(1, 9),
         "quick_train": jk.PolicyKnob("QUICK_TRAIN"),
         "share_params": jk.PolicyKnob("SHARE_PARAMS")}


def _score(knobs, t):
    """A deterministic score with structure for the models to find."""
    s = 0.01 * t
    for name, v in sorted(knobs.items()):
        if isinstance(v, bool):
            s += 0.1 * v
        elif isinstance(v, (int, float)):
            s += math.sin(1.7 * math.log1p(abs(float(v))) + len(name))
    return s


def _drive(kind, config_json, rounds, seed=0):
    """Both advisors through ``rounds`` rounds; returns the proposal
    pairs and the advisors."""
    ja = J.make_advisor(jk.knob_config_from_json(config_json), kind,
                        seed=seed)
    pa = P.make_advisor(pk.knob_config_from_json(config_json), kind,
                        seed=seed)
    pairs = []
    for t in range(rounds):
        a, b = ja.propose(), pa.propose()
        pairs.append((a.to_json(), b.to_json()))
        if not a.is_valid:
            break
        if t % 5 == 3:
            ja.trial_errored(a.trial_no)
            pa.trial_errored(b.trial_no)
            continue
        s = _score(a.knobs, t)
        ja.feedback(J.TrialResult(a.trial_no, a.knobs, s, f"t{t}",
                                  a.budget_scale, a.meta))
        pa.feedback(P.TrialResult(b.trial_no, b.knobs, s, f"t{t}",
                                  b.budget_scale, b.meta))
    return pairs, ja, pa


CASES = {"random": (JViT, 16), "arch_evo": (JViT, 24),
         "bayes_gp": (JViT, 14), "bohb": (SMALL, 48)}


def test_registry_is_filled_as_jax_fills_it():
    assert sorted(P.ADVISOR_REGISTRY) == sorted(J.ADVISOR_REGISTRY)
    for name, cls in P.ADVISOR_REGISTRY.items():
        assert cls.name == J.ADVISOR_REGISTRY[name].name == name


@pytest.mark.parametrize("kind", sorted(CASES))
def test_same_seed_and_feedback_give_the_same_proposals(kind, monkeypatch):
    kdes = []
    real_kde = scipy.stats.gaussian_kde

    def counted(*a, **kw):
        kdes.append(1)
        return real_kde(*a, **kw)

    monkeypatch.setattr(scipy.stats, "gaussian_kde", counted)
    space, rounds = CASES[kind]
    config = space if isinstance(space, dict) else space.get_knob_config()
    pairs, ja, pa = _drive(kind, jk.knob_config_to_json(config), rounds)
    assert len(pairs) == rounds >= 12
    for t, (want, got) in enumerate(pairs):
        assert got == want, f"round {t}"
    assert pa.best.to_json() == ja.best.to_json()
    assert pa.best_effort.to_json() == ja.best_effort.to_json()
    assert pa.finished == ja.finished
    if kind == "bohb":
        assert kdes, "the TPE sampler never ran"
        assert {p[0]["budget_scale"] for p in pairs} == set(ja.budgets)
    if kind in ("random", "arch_evo"):
        assert any(p[0]["warm_start_trial_id"] for p in pairs)


@pytest.mark.parametrize("kind", ["random", "bohb"])
def test_trial_budget_and_batches_match_jax(kind):
    config = jk.knob_config_to_json(JViT.get_knob_config())
    ja = J.make_advisor(jk.knob_config_from_json(config), kind,
                        total_trials=7, seed=3)
    pa = P.make_advisor(pk.knob_config_from_json(config), kind,
                        total_trials=7, seed=3)
    for k in (3, 2, 4):
        jb, pb = ja.propose_batch(k), pa.propose_batch(k)
        assert [p.to_json() for p in pb] == [p.to_json() for p in jb]
        results = [(J.TrialResult(p.trial_no, p.knobs, _score(p.knobs, 0),
                                  f"t{p.trial_no}", p.budget_scale, p.meta),
                    P.TrialResult(p.trial_no, p.knobs, _score(p.knobs, 0),
                                  f"t{p.trial_no}", p.budget_scale, p.meta))
                   for p in jb]
        ja.feedback_batch([r for r, _ in results])
        pa.feedback_batch([r for _, r in results])
    assert pa.propose().to_json() == ja.propose().to_json()
    assert not pa.propose().is_valid and pa.finished == ja.finished


def test_auto_resolves_the_same_type_per_template():
    for jt, pt in ((JViT, ViTBase16), (JBert, BertClassifier),
                   (JLlama, LlamaLoRA)):
        want = type(J.make_advisor(jt.get_knob_config(), "auto")).name
        assert type(P.make_advisor(pt.get_knob_config(),
                                   "auto")).name == want == "bohb"
    no_policy = {"lr": pk.FloatKnob(0.1, 1.0)}
    fixed = {"e": pk.FixedKnob(3)}
    assert type(P.make_advisor(no_policy, "auto")).name == "bayes_gp"
    assert type(P.make_advisor(fixed, "auto")).name == "random"
    with pytest.raises(ValueError, match="unknown advisor type"):
        P.make_advisor(fixed, "nope")


def test_port_client_drives_the_jax_advisor_service():
    config = JViT.get_knob_config()
    service = AdvisorService(J.make_advisor(config, "bohb", total_trials=6,
                                            seed=5))
    host, port = service.start()
    try:
        client = AdvisorClient(f"http://{host}:{port}")
        local = P.make_advisor(ViTBase16.get_knob_config(), "bohb",
                               total_trials=6, seed=5)
        for t in range(4):
            got, want = client.propose(), local.propose()
            assert got.to_json() == want.to_json()
            if t == 1:
                client.trial_errored(got.trial_no)
                local.trial_errored(want.trial_no)
                continue
            r = P.TrialResult(got.trial_no, got.knobs, 0.1 * t, f"t{t}",
                              got.budget_scale, got.meta)
            client.feedback(r)
            local.feedback(r)
        batch = client.propose_batch(2)
        assert [p.to_json() for p in batch] == \
            [p.to_json() for p in local.propose_batch(2)]
        client.feedback_batch([P.TrialResult(p.trial_no, p.knobs, 0.5,
                                             f"b{p.trial_no}",
                                             p.budget_scale, p.meta)
                               for p in batch])
        status = client.status()
        assert status["n_results"] == 5 and status["finished"] is True
        assert not client.propose().is_valid
    finally:
        service.stop()
