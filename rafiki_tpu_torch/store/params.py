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
dtype once, at load.

The BatchNorm CNNs' blob (``rafiki_tpu/models/_cnn_base.py``) holds two
trees, ``params`` and ``batch_stats``; :func:`cnn_params_from_jax` and
:func:`cnn_params_to_jax` map it to and from one ``state_dict``, where
BatchNorm's ``mean`` / ``var`` are buffers beside its ``scale`` /
``bias``. Flax's conv kernels are HWIO and the port's OIHW: the bridge
transposes every 4-D leaf, exactly. Leaves keep flax's auto-names::

    stem/kernel, stem_bn/{scale,bias}, head/{kernel,bias},
    stage{i}_block{j}/{Conv_k/kernel, BatchNorm_k/{scale,bias},
                       shortcut/kernel, shortcut_bn/{scale,bias}}
    (VGG: Conv_k, BatchNorm_k; DenseNet: _DenseLayer_k/{Conv,BatchNorm}_m
     and the transitions' Conv_k / BatchNorm_k in creation order)
    batch_stats: the same BatchNorm paths, each {mean,var}

and the trees come back with every level's keys sorted as strings, the
order ``jax.tree_util`` gives the JAX template's dump (``block_10``
before ``block_2``). The int8 serving tree of ``quantize_llama_params``
names a quantized site's base ``qkernel`` (int8) and ``qscale`` (f32)
instead of ``kernel``: both keep their types through the bridge. The
trees come from, and go to, the Flax-msgpack byte codec of
``store/param_store.py``.

The BiLSTM tagger's cells are flax ``OptimizedLSTMCell``s, one per
direction (``OptimizedLSTMCell_0`` forward, ``_1`` backward), each with
input kernels ``ii``/``if``/``ig``/``io`` (no bias) and recurrent
kernels ``hi``/``hf``/``hg``/``ho`` with biases; :func:`lstm_params_from_jax`
and :func:`lstm_params_to_jax` map them to and from one bidirectional
``torch.nn.LSTM`` layer, gates in its order i, f, g, o: ``weight_ih`` the
transposed input kernels stacked, ``weight_hh`` the recurrent ones,
``bias_hh`` their biases and ``bias_ih`` zeros (flax has one bias per
gate; the port never trains ``bias_ih``).

A gang lane's trainable leaves (``rafiki_tpu_torch/tuning``) cross with
:func:`lane_params_from_jax` and :func:`lane_params_to_jax`: one lane or
K lanes stacked (every leaf with a leading K, as JAX's vmapped lane
state holds them), as a nested flax tree (the feed-forward lanes) or as
JAX's flat LoRA-lane dict, keyed by lowercased ``/``-joined paths
(``block_0/rmsnorm_0/scale``).
"""

from __future__ import annotations

import warnings
from typing import Any, Collection, Dict, List, Mapping, Sequence

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


def _frozen_f32(v: Any) -> bool:
    """A read-only f32 array: a view into an immutable blob (what
    ``params_from_bytes`` gives), safe to hold without a copy."""
    return isinstance(v, np.ndarray) and v.dtype == np.float32 \
        and not v.flags.writeable


def f32_tree(tree: Mapping[str, Any], copy: bool = True) -> Dict[str, Any]:
    """A nested-dict params tree as f32 numpy copies; with ``copy=False``
    read-only f32 leaves are kept as they are (an 8B tree read from a
    blob is not copied again on the host)."""
    return {k: f32_tree(v, copy) if isinstance(v, Mapping)
            else v if not copy and _frozen_f32(v)
            else np.array(v, dtype=np.float32) for k, v in tree.items()}


def _leaf_tensor(leaf: Any) -> torch.Tensor:
    """One leaf as a tensor: int8 stays int8 (a ``qkernel``), everything
    else becomes f32. A torch tensor stays on its device; an f32 array
    (read-only or not) is viewed, not copied — the callers only read it
    (a cast, or ``load_state_dict``'s copy), and an 8B tree is not held
    twice on the host; any other array becomes a CPU tensor of its
    own."""
    if isinstance(leaf, torch.Tensor):
        t = leaf
    elif isinstance(leaf, np.ndarray) and leaf.dtype == np.float32:
        with warnings.catch_warnings():  # "not writable": only read
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(leaf)
    else:
        t = torch.from_numpy(np.array(leaf))
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


#: a BatchNorm's running statistics: the blob's ``batch_stats`` leaves
BATCH_STATS_LEAVES = ("mean", "var")


def _sorted_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def cnn_params_from_jax(blob: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A CNN template's ``{"params", "batch_stats", ...}`` blob → the port
    module's ``state_dict`` (f32 CPU tensors; 4-D kernels HWIO → OIHW)."""
    out = params_from_jax(blob["params"])
    out.update(params_from_jax(blob["batch_stats"]))
    return {k: t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t
            for k, t in out.items()}


def cnn_params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: ``{"params": tree, "batch_stats": tree}`` of f32 numpy
    arrays in flax's layout, keys sorted as ``jax.tree_util`` sorts
    them."""
    trees: Dict[str, Dict[str, torch.Tensor]] = {"params": {},
                                                  "batch_stats": {}}
    for key, t in state.items():
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0).contiguous()
        kind = "batch_stats" if key.rsplit(".", 1)[-1] in \
            BATCH_STATS_LEAVES else "params"
        trees[kind][key] = t
    return {kind: _sorted_tree(params_to_jax(tree))
            for kind, tree in trees.items()}


#: torch.nn.LSTM's gate order, as flax names the cell's leaves
LSTM_GATES = ("i", "f", "g", "o")


def lstm_params_from_jax(cells: Sequence[Mapping[str, Any]]
                         ) -> Dict[str, torch.Tensor]:
    """flax ``OptimizedLSTMCell`` trees, the forward cell then (for a
    bidirectional layer) the backward one → layer 0 of a
    ``torch.nn.LSTM`` ``state_dict`` (f32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for d, cell in enumerate(cells):
        sfx = "_l0" + ("_reverse" if d else "")
        leaf = {k: _leaf_tensor(v["kernel"]) for k, v in cell.items()}
        out["weight_ih" + sfx] = torch.cat(
            [leaf["i" + g].t() for g in LSTM_GATES]).contiguous()
        out["weight_hh" + sfx] = torch.cat(
            [leaf["h" + g].t() for g in LSTM_GATES]).contiguous()
        out["bias_hh" + sfx] = torch.cat(
            [_leaf_tensor(cell["h" + g]["bias"]) for g in LSTM_GATES])
        out["bias_ih" + sfx] = torch.zeros_like(out["bias_hh" + sfx])
    return out


def lstm_params_to_jax(state: Mapping[str, torch.Tensor]
                       ) -> List[Dict[str, Any]]:
    """The inverse: the cells of layer 0 (forward, then backward when
    the LSTM is bidirectional) as flax trees of f32 numpy arrays, keys
    sorted. A nonzero ``bias_ih`` has no flax leaf and raises."""
    cells = []
    for sfx in ("_l0", "_l0_reverse"):
        if "weight_ih" + sfx not in state:
            continue
        if bool(torch.any(state["bias_ih" + sfx] != 0)):
            raise ValueError(f"bias_ih{sfx} is not zero: flax's "
                             "OptimizedLSTMCell has no input bias")
        wi = state["weight_ih" + sfx].chunk(4)
        wh = state["weight_hh" + sfx].chunk(4)
        bh = state["bias_hh" + sfx].chunk(4)
        cell: Dict[str, Any] = {}
        for g, a, b, c in zip(LSTM_GATES, wi, wh, bh):
            cell["h" + g] = {"bias": c, "kernel": b.t()}
            cell["i" + g] = {"kernel": a.t()}
        cells.append(_sorted_tree({
            k: {n: t.detach().to("cpu", torch.float32).contiguous().numpy()
                for n, t in v.items()} for k, v in cell.items()}))
    return cells


def _lane_key(key: str) -> str:
    return key.replace(".", "/").lower()


def lane_params_from_jax(tree: Mapping[str, Any], names: Collection[str]
                         ) -> Dict[str, torch.Tensor]:
    """A JAX gang lane's params, or K lanes' stacked params, → the port
    lane state's ``{state_dict key: f32 tensor}`` for the keys ``names``
    (matched without regard to case: JAX's LoRA-lane keys are
    lowercased). Leaves are copied (CPU tensors)."""
    flat = {_lane_key(k): v for k, v in _flatten(tree).items()}
    return {n: torch.tensor(np.asarray(flat[_lane_key(n)],
                                       dtype=np.float32))
            for n in names}


def lane_params_to_jax(params: Mapping[str, torch.Tensor],
                       flat: bool = False) -> Dict[str, Any]:
    """The inverse: a port lane's (or K lanes') params as f32 numpy, the
    nested flax tree, or with ``flat`` JAX's LoRA-lane dict."""
    if flat:
        return {_lane_key(n): np.array(t.detach().to("cpu", torch.float32))
                for n, t in params.items()}
    return params_to_jax({n: t.detach().clone() for n, t in params.items()})
