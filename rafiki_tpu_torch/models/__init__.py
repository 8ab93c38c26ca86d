"""Model zoo: the port's templates by the names users type.

The port's counterpart of ``get_model_template`` and
``list_model_templates`` from ``rafiki_tpu/models/__init__.py``, over the
JAX ``_ZOO``'s thirteen names, every one ported. Templates are imported
lazily (a worker imports only the one it runs); an unknown name raises
JAX's ``KeyError`` listing the zoo.
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
    "BigramHMM": ("rafiki_tpu_torch.models.pos_tagging", "BigramHMM"),
    "BiLSTMTagger": ("rafiki_tpu_torch.models.pos_tagging", "BiLSTMTagger"),
    "SklearnDecisionTree": ("rafiki_tpu_torch.models.sklearn_models",
                            "SklearnDecisionTree"),
    "SklearnGBDT": ("rafiki_tpu_torch.models.sklearn_models", "SklearnGBDT"),
    "SklearnSVM": ("rafiki_tpu_torch.models.sklearn_models", "SklearnSVM"),
    "JaxTabularMLP": ("rafiki_tpu_torch.models.tabular", "JaxTabularMLP"),
}


def get_model_template(name: str) -> type:
    import importlib

    if name not in _ZOO:
        raise KeyError(f"unknown template {name!r}; known: {sorted(_ZOO)}")
    mod_name, cls_name = _ZOO[name]
    return getattr(importlib.import_module(mod_name), cls_name)


def list_model_templates() -> Dict[str, str]:
    """Every zoo name, as ``module.Class``."""
    return {name: f"{mod}.{cls}" for name, (mod, cls) in _ZOO.items()}
