"""Port parity: the safetensors reader and writer, the HF-convention
Llama import and export, and ``LlamaLoRA.train`` from a pretrained base.

- ``store/safetensors_io.py`` against the ``safetensors`` package
  (imported here only: the port must not need it): each reads the
  other's files, F32, F16 and BF16, values bit for bit.
- ``models/convert.py`` against ``rafiki_tpu/models/convert.py``: a JAX
  export imports into the port as the same tree and the reverse, bit
  for bit; single-file, ``index.json`` and directory layouts; a missing
  tensor and a shape mismatch raise; ``read_hf_rope_config`` agrees.
- ``LlamaLoRA.train`` with a BPE tokenizer and ``pretrained_path``
  (f32): the JAX template's per-epoch loss within 1e-4 relative (the f32
  training legs' bound, ``tests/test_torch_llama_train.py``), the frozen
  base leaves equal to the checkpoint bit for bit and the trained ones
  within 1e-3 absolute: Adam normalizes a near-zero gradient to a step of
  about the learning rate (1e-2) either way, so an f32 rounding of such a
  gradient moves that element; here one element in 256 of one leaf sits
  3.3e-4 from JAX's, the rest within 1e-4.
"""

import json
import logging

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.data.bpe import ByteBPETokenizer as JBPE
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models import convert as jconv
from rafiki_tpu.models.llama_lora import Llama as JLlama
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import convert as pconv
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.store import safetensors_io as sio
from rafiki_tpu_torch.store.params import llama_params_from_jax

torch.set_num_threads(1)

CFG = dict(vocab_size=512, max_len=32, hidden_dim=64, depth=2,
           n_heads=4, n_kv_heads=2, mlp_dim=128, lora_rank=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def params():
    module = JLlama(**CFG)
    p = module.init(jax.random.PRNGKey(7),
                    jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    return {"f32": f32, "f16": rng.standard_normal((3, 4, 2)).astype(
                np.float16),
            "bf16": rng.standard_normal((6, 3)).astype(np.float32).astype(
                ml_dtypes.bfloat16),
            "scalar": np.array(3.5, np.float32),
            "empty": np.zeros((0, 4), np.float32)}


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if t.dtype == ml_dtypes.bfloat16:
        return t.view(np.uint16)
    return t


def test_reader_and_writer_agree_with_the_safetensors_package(tmp_path):
    arrays = _tensors()
    theirs = str(tmp_path / "theirs.safetensors")
    st_save(arrays, theirs, metadata={"format": "pt"})
    f = sio.SafeFile(theirs)
    assert sorted(f.keys()) == sorted(arrays)
    assert f.metadata() == {"format": "pt"}
    for name, a in arrays.items():
        got = f.get_tensor_view(name)
        assert tuple(got.shape) == a.shape and f.shape(name) == a.shape
        np.testing.assert_array_equal(_bits(got), _bits(a), err_msg=name)
    assert f.dtype("bf16") == "BF16" and \
        f.get_tensor_view("bf16").dtype == torch.bfloat16
    mine = str(tmp_path / "mine.safetensors")
    sio.save_file({k: _as_torch(a) if k in ("bf16", "f16") else a
                   for k, a in arrays.items()}, mine,
                  metadata={"format": "pt"})
    back = st_load(mine)
    assert sorted(back) == sorted(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(_bits(back[name]), _bits(a),
                                      err_msg=name)
        assert back[name].dtype == a.dtype, name
    header, base = sio.read_header(mine)
    assert base % 8 == 0 and header["__metadata__"] == {"format": "pt"}


def test_reader_is_loud_on_a_bad_file(tmp_path):
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\x01\x00")
    with pytest.raises(ValueError, match="too short"):
        sio.SafeFile(str(short))
    path = str(tmp_path / "x.safetensors")
    sio.save_file({"a": np.zeros((2, 2), np.float32)}, path)
    f = sio.SafeFile(path)
    f._entries["a"]["shape"] = [3, 2]
    with pytest.raises(ValueError, match="bytes"):
        f.get_tensor_view("a")
    with pytest.raises(ValueError, match="cannot write"):
        sio.save_file({"i": np.zeros(2, np.int32)}, path)


def test_hf_names_equal_jax(params):
    for path in _flat(params):
        p = tuple(path.split("/"))
        assert pconv.hf_name_for(p) == jconv.hf_name_for(p), path
    with pytest.raises(KeyError):
        pconv.hf_name_for(("block_0", "mystery", "kernel"))


def test_jax_export_imports_into_the_port_and_back(params, tmp_path):
    path = str(tmp_path / "jax.safetensors")
    jconv.export_llama_safetensors(params, path)
    got = pconv.import_llama_safetensors(path, params)
    for key, want in _flat(params).items():
        np.testing.assert_array_equal(_flat(got)[key], want, err_msg=key)
        assert _flat(got)[key].dtype == np.float32
    mine = str(tmp_path / "port.safetensors")
    pconv.export_llama_safetensors(params, mine)
    assert sorted(st_load(mine)) == sorted(st_load(path))
    for name, a in st_load(path).items():
        np.testing.assert_array_equal(st_load(mine)[name], a, err_msg=name)
    back = jconv.import_llama_safetensors(mine, params)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(kp))


def test_bf16_torch_export_widens_exactly(params, tmp_path):
    """A bf16 tree (torch tensors) exports as BF16 and imports as the
    exact f32 widening, into the shapes of an f32 tree, and JAX's import
    reads the same values."""
    tree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16), params)
    path = str(tmp_path / "bf16.safetensors")
    pconv.export_llama_safetensors(tree, path)
    assert sio.SafeFile(path).dtype("lm_head.weight") == "BF16"
    got = _flat(pconv.import_llama_safetensors(path, params))
    want = _flat(jax.tree_util.tree_map(
        lambda t: t.float().numpy(), tree))
    jgot = _flat(jconv.import_llama_safetensors(path, params))
    for key in want:
        if "lora_" in key:  # no checkpoint counterpart: kept as given
            want[key] = _flat(params)[key]
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(jgot[key], want[key], err_msg=key)


def test_index_and_directory_layouts(params, tmp_path):
    """A sharded checkpoint as HF ships it (``model-0000i-of-0000n``
    files and ``model.safetensors.index.json``), and a directory of bare
    shards with no index: both resolve tensor by tensor as in JAX."""
    single = str(tmp_path / "full.safetensors")
    jconv.export_llama_safetensors(params, single)
    tensors = st_load(single)
    names = sorted(tensors)
    d = tmp_path / "sharded"
    d.mkdir()
    shards = [names[:len(names) // 2], names[len(names) // 2:]]
    weight_map = {}
    for i, part in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        sio.save_file({n: tensors[n] for n in part}, str(d / fname))
        weight_map.update({n: fname for n in part})
    (d / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    bare = tmp_path / "bare"
    bare.mkdir()
    for i, part in enumerate(shards):
        st_save({n: tensors[n] for n in part},
                str(bare / f"part{i}.safetensors"))
    for path in (str(d), str(d / "model.safetensors.index.json"),
                 str(bare)):
        assert pconv._resolve_checkpoint(path) == \
            jconv._resolve_checkpoint(path)
        got = _flat(pconv.import_llama_safetensors(path, params))
        for key, want in _flat(params).items():
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pconv._resolve_checkpoint(str(tmp_path / "empty"))


def test_missing_tensor_and_shape_mismatch_are_loud(params, tmp_path):
    partial = str(tmp_path / "partial.safetensors")
    sio.save_file({"model.embed_tokens.weight": np.zeros(
        (CFG["vocab_size"], CFG["hidden_dim"]), np.float32)}, partial)
    with pytest.raises(KeyError, match="missing"):
        pconv.import_llama_safetensors(partial, params)
    path = str(tmp_path / "ckpt.safetensors")
    jconv.export_llama_safetensors(params, path)
    wrong = JLlama(**{**CFG, "hidden_dim": 128}).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    wrong = jax.tree_util.tree_map(np.asarray, wrong)
    with pytest.raises(ValueError, match="shape"):
        pconv.import_llama_safetensors(path, wrong)


@pytest.mark.parametrize("config", [
    None, "{not json", {"rope_theta": 500000.0},
    {"rope_theta": 500000.0,
     "rope_scaling": {"rope_type": "llama3", "factor": 8}},
    {"rope_scaling": "linear"}])
def test_read_hf_rope_config_equals_jax(tmp_path, config):
    if config is not None:
        (tmp_path / "config.json").write_text(
            config if isinstance(config, str) else json.dumps(config))
    (tmp_path / "model.safetensors").write_bytes(b"")
    for path in (str(tmp_path), str(tmp_path / "model.safetensors")):
        assert pconv.read_hf_rope_config(path) == \
            jconv.read_hf_rope_config(path)
        assert pconv.read_hf_rope_theta(path) == \
            jconv.read_hf_rope_theta(path)


KNOBS = {"max_epochs": 1, "vocab_size": 0, "hidden_dim": 64, "depth": 2,
         "n_heads": 4, "kv_ratio": 2, "lora_rank": 4, "max_len": 32,
         "model_parallel": 1, "learning_rate": 1e-2, "batch_size": 8,
         "bf16": False, "quick_train": True, "share_params": False}


@pytest.fixture(scope="module")
def pretrained_setup(tmp_path_factory):
    """The config #5 slice of ``tests/test_convert.py``: a corpus, a BPE
    artifact trained on it, and a "pretrained" base exported from a
    throwaway init, beside a ``config.json`` with another rope theta."""
    d = tmp_path_factory.mktemp("pretrained")
    ds = str(d / "corpus.jsonl")
    generate_text_classification_dataset(ds, 48, seed=0)
    texts = [rec["text"] for line in open(ds) if line.strip()
             for rec in [json.loads(line)] if "text" in rec]
    JBPE.train(texts, vocab_size=300).save(str(d / "bpe.json"))
    knobs = {**KNOBS, "tokenizer_path": str(d / "bpe.json")}
    module = JLlamaLoRA(**knobs)._module()
    base = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    ckpt = d / "ckpt"
    ckpt.mkdir()
    jconv.export_llama_safetensors(base, str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps({"rope_theta": 500000.0}))
    return ds, knobs, base, str(ckpt)


def test_train_from_a_pretrained_base_matches_jax(pretrained_setup, caplog):
    ds, knobs, base, ckpt = pretrained_setup
    knobs = {**knobs, "pretrained_path": ckpt}
    jm = JLlamaLoRA(**knobs)
    jctx = JTrainContext()
    jm.train(ds, jctx)
    # the port's fresh init is the JAX template's PRNGKey(0) init (the
    # adapters keep it; every base leaf comes from the checkpoint)
    init = jax.tree_util.tree_map(np.asarray, jm._module().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"])
    pm = ll.LlamaLoRA(device="cpu", **knobs)
    assert pm.tokenizer.vocab_size == jm.tokenizer.vocab_size
    build = pm._module

    def module_with_jax_init(quantized=False):
        m = build(quantized)
        m.load_state_dict(llama_params_from_jax(init, m.dtype))
        return m

    pm._module = module_with_jax_init
    pctx = TrainContext()
    with caplog.at_level(logging.WARNING):
        pm.train(ds, pctx)
    assert any("rope_theta=500000.0" in r.message for r in caplog.records)
    want = jctx.logger.get_values("loss")
    got = pctx.logger.get_values("loss")
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jp, pp, bp = (_flat(t) for t in (jm._params, pm._params, base))
    assert pp.keys() == jp.keys()
    for key in pp:
        if "lora_" in key or "norm" in key.lower() or \
                key.startswith("lm_head"):
            np.testing.assert_allclose(pp[key], jp[key], rtol=0, atol=1e-3,
                                       err_msg=key)
        else:  # frozen: the checkpoint's tensor, bit for bit
            np.testing.assert_array_equal(pp[key], bp[key], err_msg=key)
    blob = pm.dump_parameters()
    assert blob["meta"]["bpe_merges"] == [list(m)
                                          for m in jm.tokenizer.merges]
    out = pm.predict(["the quick"])
    assert isinstance(out[0], str) and "<" not in out[0]


def test_pretrained_base_is_not_reloaded_over_a_warm_start(
        pretrained_setup):
    """The checkpoint loads only on a fresh, non-warm start: a model
    that already holds weights trains from them."""
    ds, knobs, base, ckpt = pretrained_setup
    pm = ll.LlamaLoRA(device="cpu", **knobs)
    pm.train(ds)
    first = _flat(pm._params)
    pm.knobs["pretrained_path"] = ckpt
    pm.train(ds)
    again = _flat(pm._params)
    assert not np.array_equal(again["tok_embed/embedding"],
                              _flat(base)["tok_embed/embedding"])
    np.testing.assert_array_equal(again["tok_embed/embedding"],
                                  first["tok_embed/embedding"])
