"""Weight bridge between the JAX package's flax params and the port.

A JAX ``params`` pytree, as a template's ``dump_parameters()["params"]``
returns it (nested dicts of numpy arrays), names its leaves by flax module
path. The port's modules name their submodules the same way, so a leaf's
``state_dict`` key is its path joined with ``.``, and the arrays keep the
JAX layouts (``(d_in, features)`` kernels): :func:`params_from_jax` and
:func:`params_to_jax` map one to the other, exactly, for any template.
ViT and BERT keep every leaf f32 and cast per call, as JAX does, e.g.::

    patch_embed/{kernel,bias}, cls, pos_embed, final_norm/{scale,bias},
    head/{kernel,bias}, block_{i}/LayerNorm_{0,1}/{scale,bias},
    block_{i}/attn/{qkv,proj}/{kernel,bias}, block_{i}/Dense_{0,1}/...
    (BERT: tok_embed/embedding, block_{i}/{qkv,proj}/...)

Llama's leaves are::

    block_{i}/attn/{wq,wk,wv,wo}/{kernel,lora_a,lora_b}
    block_{i}/{gate,up,down}/{kernel,lora_a,lora_b}
    block_{i}/RMSNorm_0/scale   (attention norm)
    block_{i}/RMSNorm_1/scale   (MLP norm)
    final_norm/scale, lm_head/kernel, tok_embed/embedding

and :func:`llama_params_from_jax` casts its matmul leaves to the compute
dtype once, at load. The int8 serving tree of ``quantize_llama_params``
names a quantized site's base ``qkernel`` (int8) and ``qscale`` (f32)
instead of ``kernel``: both keep their types through the bridge. The
Flax-msgpack byte codec (``rafiki_tpu/store/param_store.py``) waits for
the worker slice.
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


def f32_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A nested-dict params tree as f32 numpy copies."""
    return {k: f32_tree(v) if isinstance(v, Mapping)
            else np.array(v, dtype=np.float32) for k, v in tree.items()}


def _leaf_tensor(leaf: Any) -> torch.Tensor:
    """One leaf as a tensor: int8 stays int8 (a ``qkernel``), everything
    else becomes f32. A torch tensor stays on its device; an array
    becomes a CPU tensor of its own."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf))
    return t if t.dtype == torch.int8 else t.float()


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params pytree → a ``state_dict`` of f32 tensors (int8 leaves
    stay int8), on the CPU unless a leaf already is a tensor elsewhere
    (``load_state_dict`` moves them to the model's device)."""
    return {key: _leaf_tensor(leaf) for key, leaf in _flatten(tree).items()}


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
    out = params_from_jax(tree)
    for key, t in out.items():
        if key.rsplit(".", 1)[-1] in MATMUL_LEAVES and key not in trainable:
            out[key] = t.to(dtype)
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
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
