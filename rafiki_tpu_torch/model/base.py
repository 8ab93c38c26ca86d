"""What the system injects into a trial's ``train`` call, how a
template's knobs are checked, and how a model class travels to a worker.

The port's own copy of ``TrainContext``, ``BaseModel.validate_knobs``
(here :func:`validate_template_knobs`, which the templates' own
``validate_knobs`` class methods call), ``serialize_model_class`` and
``load_model_class`` from ``rafiki_tpu/model/base.py``: a class is
uploaded as the UTF-8 source of its defining module and imported again
from that source by the admin and by each worker. ``devices`` is the
trial's slot (a mesh is built over it where a template shards: the
``model_parallel`` knob of ``LlamaLoRA``); ``profile_dir`` is where the
train worker writes the trial's ``torch.profiler`` trace. The port has no ``BaseModel``:
``load_model_class`` accepts any class with the serving surface a worker
calls (``load_parameters`` and ``predict``).
"""

from __future__ import annotations

import hashlib
import importlib.util
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.model.knob import Knobs, validate_knobs
from rafiki_tpu_torch.model.log import ModelLogger

Params = Dict[str, Any]  # nested dicts of numpy arrays (JAX's layout)


@dataclass
class TrainContext:
    #: fraction of the full training budget to spend (BOHB rung scaling)
    budget_scale: float = 1.0
    #: warm-start parameters (SHARE_PARAMS policy): a dumped blob
    shared_params: Optional[Params] = None
    #: per-trial structured metric logger
    logger: ModelLogger = field(default_factory=ModelLogger)
    #: trial identity, for checkpoints and log correlation
    trial_id: Optional[str] = None
    #: the slot's devices (``torch.device`` or names; one may repeat); None
    #: is every visible card (JAX's ``jax.local_devices()``), or one CPU
    #: device on a template built with ``device="cpu"``
    devices: Optional[List[Any]] = None
    #: called with (epoch, score) between epochs; False stops training
    should_continue: Optional[Any] = None
    #: when set, the train worker records a ``torch.profiler`` trace of
    #: ``train`` here; templates may drop their own artifacts here too
    profile_dir: Optional[str] = None
    #: preemption safety: templates call ``ctx.checkpoint(
    #: self.dump_parameters, frac_done=(e + 1) / epochs, tree=...)`` at
    #: epoch boundaries with a zero-argument blob factory
    checkpoint: Optional[Any] = None


def validate_template_knobs(model_class: type, knobs: Knobs) -> None:
    """Raise ValueError unless ``knobs`` is a full, in-domain assignment
    of ``model_class.get_knob_config()`` (JAX's
    ``BaseModel.validate_knobs``)."""
    validate_knobs(model_class.get_knob_config(), knobs)


def serialize_model_class(model_class: type) -> bytes:
    """Capture a model class as the UTF-8 source of its defining
    module."""
    import inspect

    src = inspect.getsource(sys.modules[model_class.__module__])
    return src.encode("utf-8")


_MODULE_DIR: Optional[Path] = None


def _module_dir() -> Path:
    global _MODULE_DIR
    if _MODULE_DIR is None:
        _MODULE_DIR = Path(tempfile.mkdtemp(prefix="rafiki_torch_models_"))
    return _MODULE_DIR


def load_model_class(model_bytes: bytes, class_name: str,
                     module_hint: str = "rafiki_model") -> type:
    """Materialize a model class from serialized module source.

    The module is written to a private temp directory and imported under
    a content-hashed name, so repeated loads of the same bytes share a
    module and different models never collide."""
    digest = hashlib.sha256(model_bytes).hexdigest()[:16]
    mod_name = f"_rafiki_torch_model_{module_hint}_{digest}"
    if mod_name in sys.modules:
        mod = sys.modules[mod_name]
    else:
        path = _module_dir() / f"{mod_name}.py"
        path.write_bytes(model_bytes)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        assert spec is not None and spec.loader is not None
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
        except Exception:
            del sys.modules[mod_name]
            raise
    clazz = getattr(mod, class_name, None)
    if not (isinstance(clazz, type)
            and all(callable(getattr(clazz, m, None))
                    for m in ("load_parameters", "predict"))):
        raise ValueError(f"{class_name!r} is not a model template (a class "
                         "with load_parameters and predict) in the "
                         "uploaded module")
    return clazz
