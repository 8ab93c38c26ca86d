"""Port parity: ``rafiki_tpu_torch.model.knob`` and the templates' knob
configs against the JAX package.

Every knob class is built on both sides from the same arguments; their
JSON, samples (from one ``random.Random`` seed each), unit-cube maps and
validation answers must be equal, value for value. The port templates'
``get_knob_config`` must serialize exactly as JAX's, and the helpers
(``validate_knobs``, ``shape_signature``, ``static_signature``, the
unit-vector maps, ``validate_override_keys``) must give equal results
and equal error messages.
"""

import json
import random

import pytest
import torch

from rafiki_tpu.model import knob as jk
from rafiki_tpu.models.bert import BertClassifier as JBert
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlama
from rafiki_tpu.models.vit import ViTBase16 as JViT
from rafiki_tpu_torch.model import knob as pk
from rafiki_tpu_torch.models.bert import BertClassifier
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.models.vit import ViTBase16

torch.set_num_threads(1)

KNOBS = [
    ("FixedKnob", (3,), {}),
    ("FixedKnob", ("x",), {"shape_relevant": True}),
    ("CategoricalKnob", ([16, 32, 64],), {"shape_relevant": True}),
    ("CategoricalKnob", ([True, False],), {}),
    ("CategoricalKnob", (["none", "full"],), {}),
    ("IntegerKnob", (2, 12), {"shape_relevant": True}),
    ("IntegerKnob", (32, 512), {"is_exp": True}),
    ("IntegerKnob", (4, 4), {}),
    ("FloatKnob", (1e-5, 1e-2), {"is_exp": True}),
    ("FloatKnob", (0.0, 0.3), {"traceable": True}),
    ("FloatKnob", (0.5, 0.5), {}),
    ("PolicyKnob", ("QUICK_TRAIN",), {}),
]


def _config(mod):
    return {"lr": mod.FloatKnob(1e-5, 1e-1, is_exp=True),
            "hidden": mod.IntegerKnob(32, 512, is_exp=True,
                                      shape_relevant=True),
            "act": mod.CategoricalKnob(["relu", "gelu", "tanh"]),
            "scale": mod.FloatKnob(0.25, 4.0, is_exp=True, traceable=True),
            "epochs": mod.FixedKnob(3),
            "early_stop": mod.PolicyKnob("EARLY_STOP")}


@pytest.mark.parametrize("cls,args,kw", KNOBS,
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(KNOBS)])
def test_knob_class_matches_jax(cls, args, kw):
    j, p = getattr(jk, cls)(*args, **kw), getattr(pk, cls)(*args, **kw)
    assert p.to_json() == j.to_json()
    assert json.dumps(p.to_json()) == json.dumps(j.to_json())
    assert pk.BaseKnob.from_json(j.to_json()).to_json() == j.to_json()
    assert p.is_constant == j.is_constant
    jr, pr = random.Random(7), random.Random(7)
    samples = [j.sample(jr) for _ in range(40)]
    assert [p.sample(pr) for _ in range(40)] == samples
    for v in samples:
        assert p.to_unit(v) == j.to_unit(v)
        assert p.validate(v) == j.validate(v)
    for u in (-0.5, 0.0, 0.13, 0.5, 0.77, 1.0, 1.5):
        assert p.from_unit(u) == j.from_unit(u)
    for v in (0, 1, -3, 7.5, 1e-3, "x", True, None, 16, 4):
        try:
            want = j.validate(v)
        except TypeError as e:
            with pytest.raises(TypeError, match=str(e)[:20]):
                p.validate(v)
        else:
            assert p.validate(v) == want


@pytest.mark.parametrize("template", ["vit", "bert", "llama"])
def test_template_knob_configs_serialize_as_jax(template):
    j, p = {"vit": (JViT, ViTBase16), "bert": (JBert, BertClassifier),
            "llama": (JLlama, LlamaLoRA)}[template]
    want = json.dumps(jk.knob_config_to_json(j.get_knob_config()))
    got = json.dumps(pk.knob_config_to_json(p.get_knob_config()))
    assert got == want
    rng_j, rng_p = random.Random(3), random.Random(3)
    for _ in range(5):
        knobs = jk.sample_knobs(j.get_knob_config(), rng_j)
        assert pk.sample_knobs(p.get_knob_config(), rng_p) == knobs
        j.validate_knobs(knobs)
        p.validate_knobs(knobs)


def test_helpers_match_jax():
    jc, pc = _config(jk), _config(pk)
    assert pk.knob_config_to_json(pc) == jk.knob_config_to_json(jc)
    assert pk.knob_config_from_json(jk.knob_config_to_json(jc)) == pc
    assert pk.tunable_knobs(pc) == jk.tunable_knobs(jc)
    assert pk.traceable_knobs(pc) == jk.traceable_knobs(jc)
    jr, pr = random.Random(11), random.Random(11)
    for _ in range(20):
        knobs = jk.sample_knobs(jc, jr)
        assert pk.sample_knobs(pc, pr) == knobs
        assert pk.shape_signature(pc, knobs) == jk.shape_signature(jc, knobs)
        assert pk.static_signature(pc, knobs) == \
            jk.static_signature(jc, knobs)
        vec = jk.knobs_to_unit_vector(jc, knobs)
        assert pk.knobs_to_unit_vector(pc, knobs) == vec
        assert pk.knobs_from_unit_vector(pc, vec, random.Random(1)) == \
            jk.knobs_from_unit_vector(jc, vec, random.Random(1))


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_validation_errors_match_jax():
    jc, pc = _config(jk), _config(pk)
    good = jk.sample_knobs(jc, random.Random(1))
    missing = dict(good)
    del missing["lr"]
    for bad in ({**good, "lr": 5.0}, {**good, "act": "swish"},
                {**good, "epochs": 4}, missing, {**good, "bogus": 1},
                {**good, "hidden": 40.5}, {**good, "early_stop": 1}):
        assert _error(pk.validate_knobs, pc, bad) == \
            _error(jk.validate_knobs, jc, bad)
    assert _error(pk.validate_override_keys, pc, {"lrr": 1}) == \
        _error(jk.validate_override_keys, jc, {"lrr": 1})
    pk.validate_override_keys(pc, {"lr": 0.1})
    pk.validate_override_keys(pc, None)
    for mod_args in ((1, 0), (0, 1, True)):
        assert _error(pk.IntegerKnob, *mod_args) == \
            _error(jk.IntegerKnob, *mod_args)
        assert _error(pk.FloatKnob, *mod_args) == \
            _error(jk.FloatKnob, *mod_args)
    assert _error(pk.CategoricalKnob, []) == _error(jk.CategoricalKnob, [])
    assert _error(pk.FixedKnob, 1, True, True) == \
        _error(jk.FixedKnob, 1, True, True)
    assert _error(pk.BaseKnob.from_json, {"kind": "nope"}) == \
        _error(jk.BaseKnob.from_json, {"kind": "nope"})
    assert _error(pk.knobs_from_unit_vector, pc, [0.5]) == \
        _error(jk.knobs_from_unit_vector, jc, [0.5])
