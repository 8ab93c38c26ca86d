"""Model zoo: the port's templates by the names users type.

The port's counterpart of ``get_model_template`` and
``list_model_templates`` from ``rafiki_tpu/models/__init__.py``, over the
JAX ``_ZOO``'s names. Templates are imported lazily (a worker imports
only the one it runs). The templates this port has not ported yet
(``NOT_PORTED``) raise ``NotPorted`` naming themselves; an unknown name
raises JAX's ``KeyError`` listing the zoo.
"""

from typing import Dict

_ZOO = {
    "JaxFeedForward": ("rafiki_tpu_torch.models.mlp", "JaxFeedForward"),
    "ResNetClassifier": ("rafiki_tpu_torch.models.resnet",
                         "ResNetClassifier"),
    "VGGClassifier": ("rafiki_tpu_torch.models.vgg", "VGGClassifier"),
    "DenseNetClassifier": ("rafiki_tpu_torch.models.densenet",
                           "DenseNetClassifier"),
    "ViTBase16": ("rafiki_tpu_torch.models.vit", "ViTBase16"),
    "BertClassifier": ("rafiki_tpu_torch.models.bert", "BertClassifier"),
    "LlamaLoRA": ("rafiki_tpu_torch.models.llama_lora", "LlamaLoRA"),
}

#: the JAX zoo's templates without a port yet, and the JAX module of each
NOT_PORTED = {
    "BigramHMM": "models/pos_tagging.py",
    "BiLSTMTagger": "models/pos_tagging.py",
    "SklearnDecisionTree": "models/sklearn_models.py",
    "SklearnGBDT": "models/sklearn_models.py",
    "SklearnSVM": "models/sklearn_models.py",
    "JaxTabularMLP": "models/tabular.py",
}


def get_model_template(name: str) -> type:
    import importlib

    if name in NOT_PORTED:
        from rafiki_tpu_torch.serving.decode_engine import NotPorted

        raise NotPorted(f"template {name!r} ({NOT_PORTED[name]}) is not "
                        "ported yet")
    if name not in _ZOO:
        known = sorted([*_ZOO, *NOT_PORTED])
        raise KeyError(f"unknown template {name!r}; known: {known}")
    mod_name, cls_name = _ZOO[name]
    return getattr(importlib.import_module(mod_name), cls_name)


def list_model_templates() -> Dict[str, str]:
    """Every zoo name: ``module.Class`` for a ported template, ``"not
    ported"`` for the others."""
    out = {name: f"{mod}.{cls}" for name, (mod, cls) in _ZOO.items()}
    out.update({name: "not ported" for name in NOT_PORTED})
    return out
