"""Hyperparameter knobs: the per-template search-space language.

The port's own copy of ``rafiki_tpu/model/knob.py``, whole: ``BaseKnob``,
``FixedKnob``, ``CategoricalKnob``, ``IntegerKnob``, ``FloatKnob``,
``PolicyKnob``, ``knob_config_to_json`` / ``knob_config_from_json``,
``sample_knobs``, ``validate_knobs``, ``tunable_knobs``,
``knobs_to_unit_vector`` / ``knobs_from_unit_vector``,
``shape_signature``, ``traceable_knobs``, ``static_signature`` and
``validate_override_keys``. Knob configs travel as the same JSON, so the
JAX advisor service and the port's worker read each other's, and one
``random.Random`` stream samples the same values on both sides.

``shape_relevant`` marks knobs that change the model's array shapes (the
warm-start gate: only identical shapes share parameters); ``traceable``
marks knobs a gang-compiled step could take as a per-lane operand
(learning rate, LoRA scale). The two are exclusive.
"""

from __future__ import annotations

import math
import random as _random
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Union)

KnobValue = Union[int, float, str, bool]


class BaseKnob:
    """A single hyperparameter's declared domain."""

    #: subclasses set this; used for JSON round-trip dispatch
    kind: str = "base"

    def __init__(self, shape_relevant: bool = False,
                 traceable: bool = False) -> None:
        if shape_relevant and traceable:
            raise ValueError(
                "a knob cannot be both shape_relevant and traceable: "
                "shape changes force a recompile, traced operands must not")
        self.shape_relevant = shape_relevant
        self.traceable = traceable

    # ---- sampling / optimization interface ----
    def sample(self, rng: _random.Random) -> KnobValue:
        raise NotImplementedError

    def to_unit(self, value: KnobValue) -> float:
        """Map a concrete value into [0, 1] for continuous optimizers."""
        raise NotImplementedError

    def from_unit(self, u: float) -> KnobValue:
        """Inverse of :meth:`to_unit` (clipping u into [0, 1])."""
        raise NotImplementedError

    @property
    def is_constant(self) -> bool:
        return False

    def validate(self, value: KnobValue) -> bool:
        raise NotImplementedError

    # ---- wire format ----
    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "BaseKnob":
        kind = d["kind"]
        cls = _KNOB_KINDS.get(kind)
        if cls is None:
            raise ValueError(f"unknown knob kind: {kind!r}")
        return cls._from_json(d)

    @classmethod
    def _from_json(cls, d: Dict[str, Any]) -> "BaseKnob":
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_json()})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BaseKnob) and self.to_json() == other.to_json()

    def __hash__(self) -> int:
        return hash(repr(sorted(self.to_json().items(), key=str)))


class FixedKnob(BaseKnob):
    """A knob pinned to one value (not searched)."""

    kind = "fixed"

    def __init__(self, value: KnobValue, shape_relevant: bool = False,
                 traceable: bool = False) -> None:
        super().__init__(shape_relevant, traceable)
        self.value = value

    def sample(self, rng: _random.Random) -> KnobValue:
        return self.value

    def to_unit(self, value: KnobValue) -> float:
        return 0.0

    def from_unit(self, u: float) -> KnobValue:
        return self.value

    @property
    def is_constant(self) -> bool:
        return True

    def validate(self, value: KnobValue) -> bool:
        return value == self.value

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value,
                "shape_relevant": self.shape_relevant,
                "traceable": self.traceable}

    @classmethod
    def _from_json(cls, d: Dict[str, Any]) -> "FixedKnob":
        return cls(d["value"], d.get("shape_relevant", False),
                   d.get("traceable", False))


class CategoricalKnob(BaseKnob):
    """A knob over an explicit finite set of values."""

    kind = "categorical"

    def __init__(self, values: Sequence[KnobValue],
                 shape_relevant: bool = False,
                 traceable: bool = False) -> None:
        super().__init__(shape_relevant, traceable)
        if not values:
            raise ValueError("CategoricalKnob requires at least one value")
        self.values = list(values)

    def sample(self, rng: _random.Random) -> KnobValue:
        return rng.choice(self.values)

    def to_unit(self, value: KnobValue) -> float:
        idx = self.values.index(value)
        if len(self.values) == 1:
            return 0.0
        return idx / (len(self.values) - 1)

    def from_unit(self, u: float) -> KnobValue:
        u = min(max(u, 0.0), 1.0)
        idx = min(int(round(u * (len(self.values) - 1))), len(self.values) - 1)
        return self.values[idx]

    @property
    def is_constant(self) -> bool:
        return len(self.values) == 1

    def validate(self, value: KnobValue) -> bool:
        return value in self.values

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "values": self.values,
                "shape_relevant": self.shape_relevant,
                "traceable": self.traceable}

    @classmethod
    def _from_json(cls, d: Dict[str, Any]) -> "CategoricalKnob":
        return cls(d["values"], d.get("shape_relevant", False),
                   d.get("traceable", False))


class IntegerKnob(BaseKnob):
    """An integer range [value_min, value_max], optionally log-scaled."""

    kind = "integer"

    def __init__(self, value_min: int, value_max: int, is_exp: bool = False,
                 shape_relevant: bool = False,
                 traceable: bool = False) -> None:
        super().__init__(shape_relevant, traceable)
        if value_min > value_max:
            raise ValueError("value_min must be <= value_max")
        if is_exp and value_min <= 0:
            raise ValueError("log-scaled IntegerKnob requires value_min > 0")
        self.value_min = int(value_min)
        self.value_max = int(value_max)
        self.is_exp = is_exp

    def sample(self, rng: _random.Random) -> int:
        return self.from_unit(rng.random())

    def to_unit(self, value: KnobValue) -> float:
        v = float(value)
        if self.value_min == self.value_max:
            return 0.0
        if self.is_exp:
            return (math.log(v) - math.log(self.value_min)) / (
                math.log(self.value_max) - math.log(self.value_min))
        return (v - self.value_min) / (self.value_max - self.value_min)

    def from_unit(self, u: float) -> int:
        u = min(max(u, 0.0), 1.0)
        if self.is_exp:
            v = math.exp(math.log(self.value_min) + u * (
                math.log(self.value_max) - math.log(self.value_min)))
        else:
            v = self.value_min + u * (self.value_max - self.value_min)
        return int(min(max(round(v), self.value_min), self.value_max))

    @property
    def is_constant(self) -> bool:
        return self.value_min == self.value_max

    def validate(self, value: KnobValue) -> bool:
        return (isinstance(value, int) and not isinstance(value, bool)
                and self.value_min <= value <= self.value_max)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value_min": self.value_min,
                "value_max": self.value_max, "is_exp": self.is_exp,
                "shape_relevant": self.shape_relevant,
                "traceable": self.traceable}

    @classmethod
    def _from_json(cls, d: Dict[str, Any]) -> "IntegerKnob":
        return cls(d["value_min"], d["value_max"], d.get("is_exp", False),
                   d.get("shape_relevant", False),
                   d.get("traceable", False))


class FloatKnob(BaseKnob):
    """A float range [value_min, value_max], optionally log-scaled."""

    kind = "float"

    def __init__(self, value_min: float, value_max: float,
                 is_exp: bool = False, shape_relevant: bool = False,
                 traceable: bool = False) -> None:
        super().__init__(shape_relevant, traceable)
        if value_min > value_max:
            raise ValueError("value_min must be <= value_max")
        if is_exp and value_min <= 0:
            raise ValueError("log-scaled FloatKnob requires value_min > 0")
        self.value_min = float(value_min)
        self.value_max = float(value_max)
        self.is_exp = is_exp

    def sample(self, rng: _random.Random) -> float:
        return self.from_unit(rng.random())

    def to_unit(self, value: KnobValue) -> float:
        v = float(value)
        if self.value_min == self.value_max:
            return 0.0
        if self.is_exp:
            return (math.log(v) - math.log(self.value_min)) / (
                math.log(self.value_max) - math.log(self.value_min))
        return (v - self.value_min) / (self.value_max - self.value_min)

    def from_unit(self, u: float) -> float:
        u = min(max(u, 0.0), 1.0)
        if self.is_exp:
            return math.exp(math.log(self.value_min) + u * (
                math.log(self.value_max) - math.log(self.value_min)))
        return self.value_min + u * (self.value_max - self.value_min)

    @property
    def is_constant(self) -> bool:
        return self.value_min == self.value_max

    def validate(self, value: KnobValue) -> bool:
        return (isinstance(value, (int, float)) and not isinstance(value, bool)
                and self.value_min <= float(value) <= self.value_max)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value_min": self.value_min,
                "value_max": self.value_max, "is_exp": self.is_exp,
                "shape_relevant": self.shape_relevant,
                "traceable": self.traceable}

    @classmethod
    def _from_json(cls, d: Dict[str, Any]) -> "FloatKnob":
        return cls(d["value_min"], d["value_max"], d.get("is_exp", False),
                   d.get("shape_relevant", False),
                   d.get("traceable", False))


class PolicyKnob(BaseKnob):
    """Declares that the model implements a *policy* the system may toggle.

    Mirrors the reference's PolicyKnob: e.g. ``PolicyKnob('EARLY_STOP')``
    says the model honors early stopping when the advisor asks for it. The
    advisor/worker decide the boolean; the model reads it like any knob.
    """

    kind = "policy"

    KNOWN_POLICIES = (
        "EARLY_STOP",          # train fewer epochs when advisor probes cheaply
        "SHARE_PARAMS",        # accept warm-start params from ParamStore
        "QUICK_TRAIN",         # budget-scaled training (BOHB rungs)
        "SKIP_TRAIN",          # evaluate loaded params only
        "QUICK_EVAL",          # subsample eval set
        "DOWNSCALE",           # reduced model for low rungs
        "ADAPTERS_ONLY",       # strict-LoRA training (multi-adapter serving)
    )

    def __init__(self, policy: str, shape_relevant: bool = False,
                 traceable: bool = False) -> None:
        super().__init__(shape_relevant, traceable)
        self.policy = policy

    def sample(self, rng: _random.Random) -> bool:
        return False  # policies default off; advisors enable deliberately

    def to_unit(self, value: KnobValue) -> float:
        return 1.0 if value else 0.0

    def from_unit(self, u: float) -> bool:
        return u >= 0.5

    def validate(self, value: KnobValue) -> bool:
        return isinstance(value, bool)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "policy": self.policy,
                "shape_relevant": self.shape_relevant,
                "traceable": self.traceable}

    @classmethod
    def _from_json(cls, d: Dict[str, Any]) -> "PolicyKnob":
        return cls(d["policy"], d.get("shape_relevant", False),
                   d.get("traceable", False))


_KNOB_KINDS = {c.kind: c for c in
               (FixedKnob, CategoricalKnob, IntegerKnob, FloatKnob, PolicyKnob)}

KnobConfig = Dict[str, BaseKnob]
Knobs = Dict[str, KnobValue]


# ---------------------------------------------------------------------------
# KnobConfig helpers (module-level; a knob config is a plain dict)
# ---------------------------------------------------------------------------

def knob_config_to_json(knob_config: KnobConfig) -> Dict[str, Any]:
    return {name: knob.to_json() for name, knob in knob_config.items()}

def knob_config_from_json(d: Dict[str, Any]) -> KnobConfig:
    return {name: BaseKnob.from_json(kd) for name, kd in d.items()}

def sample_knobs(knob_config: KnobConfig,
                 rng: Optional[_random.Random] = None) -> Knobs:
    rng = rng or _random.Random()
    return {name: knob.sample(rng) for name, knob in knob_config.items()}

def validate_knobs(knob_config: KnobConfig, knobs: Knobs) -> None:
    """Raise ValueError if ``knobs`` is not a full, in-domain assignment."""
    missing = set(knob_config) - set(knobs)
    if missing:
        raise ValueError(f"missing knobs: {sorted(missing)}")
    extra = set(knobs) - set(knob_config)
    if extra:
        raise ValueError(f"unknown knobs: {sorted(extra)}")
    for name, knob in knob_config.items():
        if not knob.validate(knobs[name]):
            raise ValueError(
                f"knob {name!r}={knobs[name]!r} out of domain for {knob!r}")

def tunable_knobs(knob_config: KnobConfig) -> List[str]:
    """Names of non-constant, non-policy knobs, in sorted order.

    This is the optimizer-visible dimensionality; sorted so every process
    agrees on the unit-cube axis order without coordination.
    """
    return sorted(name for name, knob in knob_config.items()
                  if not knob.is_constant and not isinstance(knob, PolicyKnob))

def knobs_to_unit_vector(knob_config: KnobConfig, knobs: Knobs) -> List[float]:
    return [knob_config[name].to_unit(knobs[name])
            for name in tunable_knobs(knob_config)]

def knobs_from_unit_vector(knob_config: KnobConfig, vector: Sequence[float],
                           rng: Optional[_random.Random] = None) -> Knobs:
    """Expand a unit-cube point into a full assignment (constants filled in,
    policies defaulted off)."""
    names = tunable_knobs(knob_config)
    if len(vector) != len(names):
        raise ValueError(f"expected {len(names)} dims, got {len(vector)}")
    rng = rng or _random.Random()
    knobs: Knobs = {}
    for name, knob in knob_config.items():
        if name in names:
            knobs[name] = knob.from_unit(vector[names.index(name)])
        elif isinstance(knob, PolicyKnob):
            knobs[name] = False
        else:
            knobs[name] = knob.sample(rng)
    return knobs

def shape_signature(knob_config: KnobConfig, knobs: Knobs) -> str:
    """Stable key over shape-relevant knob values.

    Trials with equal signatures build identically shaped models, so one
    trial's parameters can warm-start the other.
    """
    items = sorted((n, knobs[n]) for n, k in knob_config.items()
                   if k.shape_relevant)
    return repr(items)


def traceable_knobs(knob_config: KnobConfig) -> List[str]:
    """Names of knobs declared ``traceable``, in sorted order.

    These are the per-lane operands of a gang-compiled train step;
    sorted so every process packs lane hyperparameter arrays in the same
    axis order without coordination."""
    return sorted(n for n, k in knob_config.items() if k.traceable)


def static_signature(knob_config: KnobConfig, knobs: Knobs) -> str:
    """Stable key over NON-traceable knob values — the compile bucket.

    Two proposals with equal static signatures differ only in traced
    operands, so they can run as lanes of the same vmapped executable:
    one compile per bucket, not per trial. A superset of
    :func:`shape_signature` — non-shape static knobs like an optimizer
    choice also fork the compiled program — EXCEPT policy knobs: those
    are system toggles handled outside the traced step by contract
    (budget scaling, warm-start gating), and BOHB flips them per rung,
    so keying on them would force a recompile at every rung boundary."""
    items = sorted((n, knobs.get(n)) for n, k in knob_config.items()
                   if not k.traceable and not isinstance(k, PolicyKnob))
    return repr(items)


def validate_override_keys(known: Iterable[str],
                           overrides: Optional[Mapping[str, Any]],
                           context: str = "knob_overrides") -> None:
    """Reject override keys that name no known knob.

    One validator for every override surface — the admin API
    (``ServicesManager`` job-level pins) and the dev loop
    (``tune_model(knob_overrides=)``) — so a typo'd key fails fast
    everywhere instead of silently letting the advisor search the
    dimension the user believes is pinned."""
    if not overrides:
        return
    known = set(known)
    unknown = set(overrides) - known
    if unknown:
        raise ValueError(
            f"{context} {sorted(unknown)} match no knob "
            f"(known: {sorted(known)})")
