"""Weight bridge between the JAX package's Llama params and the port.

The JAX ``params`` pytree, as ``LlamaLoRA.dump_parameters()["params"]``
returns it (nested dicts of numpy arrays), names its leaves by flax module
path::

    block_{i}/attn/{wq,wk,wv,wo}/{kernel,lora_a,lora_b}
    block_{i}/{gate,up,down}/{kernel,lora_a,lora_b}
    block_{i}/RMSNorm_0/scale   (attention norm)
    block_{i}/RMSNorm_1/scale   (MLP norm)
    final_norm/scale, lm_head/kernel, tok_embed/embedding

The port's ``Llama`` names its submodules the same way, so a leaf's
``state_dict`` key is its path joined with ``.``, and the arrays keep the
JAX layouts (``(d_in, features)`` kernels). The Flax-msgpack byte codec
(``rafiki_tpu/store/param_store.py``) waits for the worker slice.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Mapping

import numpy as np
import torch

#: leaf names that feed a matmul: cast to the compute dtype once, at load
MATMUL_LEAVES = ("kernel", "lora_a", "lora_b")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = v
    return flat


def llama_params_from_jax(tree: Mapping[str, Any],
                          dtype: torch.dtype = torch.float32,
                          trainable: Collection[str] = ()
                          ) -> Dict[str, torch.Tensor]:
    """JAX params pytree → the port ``Llama``'s ``state_dict`` (CPU
    tensors; ``load_state_dict`` moves them to the model's device).

    With a bf16 ``dtype`` the matmul weights are cast to bf16 here, once —
    the same rounding the JAX module applies on every call
    (``kernel.astype(x.dtype)``) to a frozen leaf. Leaves named in
    ``trainable`` (``state_dict`` keys) stay f32: they are the master
    weights a fine-tune updates, cast per call by ``LoRADense``. Norm
    scales and the embedding table stay f32 (the embedding output is cast
    after the lookup, as in JAX)."""
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(tree).items():
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if key.rsplit(".", 1)[-1] in MATMUL_LEAVES and key not in trainable:
            t = t.to(dtype)
        out[key] = t
    return out


def llama_params_to_jax(state: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The inverse: a port ``state_dict`` → the JAX nested-dict params
    pytree of float32 numpy arrays (bf16 weights widen exactly)."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree
