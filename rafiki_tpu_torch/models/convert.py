"""Pretrained-weight import: HF-convention Llama safetensors into the
port's params tree, and the export back out.

The port's own copy of ``rafiki_tpu/models/convert.py``: ``hf_name_for``,
``_resolve_checkpoint`` (a single ``.safetensors`` file, a
``*.index.json`` of a sharded checkpoint, or a directory of either),
``read_hf_rope_config``, ``read_hf_rope_theta``,
``import_llama_safetensors`` and ``export_llama_safetensors``, over the
port's own safetensors reader and writer (``store/safetensors_io.py``).

- Names: ``model.layers.{i}.self_attn.q_proj.weight`` ↔
  ``block_{i}/attn/wq/kernel`` and so on. HF ``nn.Linear`` weights are
  (out, in) and the tree's kernels (in, out), so projections transpose
  on the way through; embeddings and RMSNorm scales pass straight.
- The import reads one tensor at a time from the memory-mapped files,
  so a checkpoint is never whole in host memory; BF16 widens to f32
  exactly. Leaves with no checkpoint counterpart (the LoRA adapters)
  keep their values; a missing tensor or a shape mismatch raises.
- There is no mesh argument: the port trains on one card, and the
  sharded import is a later slice.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.store.safetensors_io import SafeFile, save_file

_BLOCK_RE = re.compile(r"^block_(\d+)$")


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def structure_copy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A nested dict's structure, copied; its leaves shared."""
    return {k: structure_copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...],
              value: Any) -> None:
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def hf_name_for(path: Tuple[str, ...]) -> Optional[Tuple[str, bool]]:
    """(HF tensor name, needs_transpose) for one of the tree's param
    paths, or None for leaves with no checkpoint counterpart (LoRA
    adapters, MoE). Raises on a path that looks importable but matches
    no rule: a silent drop would load a half-initialized model."""
    if path[-1] in ("lora_a", "lora_b") or "moe" in path:
        return None
    joined = "/".join(path)
    if joined == "tok_embed/embedding":
        return "model.embed_tokens.weight", False
    if joined == "final_norm/scale":
        return "model.norm.weight", False
    if joined == "lm_head/kernel":
        return "lm_head.weight", True
    m = _BLOCK_RE.match(path[0])
    if m:
        i = int(m.group(1))
        rest = "/".join(path[1:])
        proj = {"attn/wq/kernel": "self_attn.q_proj",
                "attn/wk/kernel": "self_attn.k_proj",
                "attn/wv/kernel": "self_attn.v_proj",
                "attn/wo/kernel": "self_attn.o_proj",
                "gate/kernel": "mlp.gate_proj",
                "up/kernel": "mlp.up_proj",
                "down/kernel": "mlp.down_proj"}.get(rest)
        if proj:
            return f"model.layers.{i}.{proj}.weight", True
        norm = {"RMSNorm_0/scale": "input_layernorm",
                "RMSNorm_1/scale": "post_attention_layernorm"}.get(rest)
        if norm:
            return f"model.layers.{i}.{norm}.weight", False
    raise KeyError(f"no HF mapping for param path {joined!r}")


def _resolve_checkpoint(path: str) -> Dict[str, str]:
    """Tensor name → safetensors file for every layout HF ships: a
    single ``.safetensors`` file, a ``*.index.json`` (sharded multi-file
    checkpoints), or a directory holding either."""
    def from_index(idx_path: str) -> Dict[str, str]:
        with open(idx_path) as f:
            index = json.load(f)
        base = os.path.dirname(os.path.abspath(idx_path))
        return {name: os.path.join(base, fname)
                for name, fname in index["weight_map"].items()}

    def from_files(files) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for fp in files:
            for name in SafeFile(fp).keys():
                out[name] = fp
        return out

    if os.path.isdir(path):
        idx = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(idx):
            return from_index(idx)
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(
                f"{path}: no .safetensors or index.json found")
        return from_files(files)
    if path.endswith(".index.json"):
        return from_index(path)
    return from_files([path])


def read_hf_rope_config(path: str
                        ) -> Tuple[Optional[float], Optional[Dict]]:
    """``(rope_theta, rope_scaling)`` from the ``config.json`` beside an
    HF checkpoint (file, index or directory); (None, None) when absent
    or unreadable. A mismatched theta or unapplied scaling loads cleanly
    and generates garbage, so callers cross-check the knobs."""
    d = path if os.path.isdir(path) else os.path.dirname(
        os.path.abspath(path))
    cfg = os.path.join(d, "config.json")
    try:
        with open(cfg) as f:
            c = json.load(f)
        theta = c.get("rope_theta")
        scaling = c.get("rope_scaling")
        return (float(theta) if theta is not None else None,
                dict(scaling) if isinstance(scaling, dict) else None)
    except (OSError, ValueError, TypeError, AttributeError):
        return None, None


def read_hf_rope_theta(path: str) -> Optional[float]:
    """The ``rope_theta`` of :func:`read_hf_rope_config`."""
    return read_hf_rope_config(path)[0]


def _read(sf: SafeFile, name: str, transpose: bool) -> np.ndarray:
    """One checkpoint tensor as a contiguous f32 numpy array (the port's
    trees are f32), transposed when asked; BF16 and F16 widen exactly.
    The widening and the transpose are one ``copy_`` out of the
    memory-mapped bytes (torch runs it on every core); the result owns
    its memory."""
    src = sf.get_tensor_view(name)
    if transpose:
        src = src.t()
    out = torch.empty(tuple(src.shape), dtype=torch.float32)
    out.copy_(src)
    return out.numpy()


def import_llama_safetensors(path: str, params: Dict[str, Any]
                             ) -> Dict[str, Any]:
    """Load an HF-convention Llama checkpoint into ``params``' structure.

    ``path``: a ``.safetensors`` file, a ``*.index.json``, or a
    checkpoint directory. ``params``: a nested-dict tree whose leaves
    (numpy arrays or torch tensors) give the shapes to read; leaves
    missing from the checkpoint keep their values, every imported leaf
    becomes an f32 numpy array. Tensors are read one at a time from the
    memory-mapped files."""
    name_to_file = _resolve_checkpoint(path)
    files: Dict[str, SafeFile] = {}
    out = structure_copy(params)
    for p, leaf in _flatten(params):
        mapped = hf_name_for(p)
        if mapped is None:
            continue
        name, transpose = mapped
        if name not in name_to_file:
            raise KeyError(f"checkpoint {path!r} is missing {name!r} "
                           f"(for param {'/'.join(p)})")
        fp = name_to_file[name]
        if fp not in files:
            files[fp] = SafeFile(fp)
        sf = files[fp]
        shape = tuple(leaf.shape)
        want = tuple(reversed(shape)) if transpose else shape
        if sf.shape(name) != want:
            raise ValueError(
                f"{name}: checkpoint shape {sf.shape(name)} != expected "
                f"{want} for param {'/'.join(p)}")
        _set_path(out, p, _read(sf, name, transpose))
    return out


def export_llama_safetensors(params: Dict[str, Any], path: str) -> None:
    """Write ``params`` as an HF-convention Llama checkpoint (LoRA
    adapters are skipped: merge or ship them separately). Leaves may be
    numpy arrays or torch tensors of any device; each is written in its
    own dtype (a bf16 tensor as BF16)."""
    tensors: Dict[str, Any] = {}
    for p, leaf in _flatten(params):
        mapped = hf_name_for(p)
        if mapped is None:
            continue
        name, transpose = mapped
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            tensors[name] = t.t().contiguous() if transpose else t
        else:
            arr = np.asarray(leaf)
            tensors[name] = np.ascontiguousarray(arr.T if transpose
                                                 else arr)
    save_file(tensors, path)
