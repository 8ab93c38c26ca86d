"""The port's standing rules, enforced.

- Nothing under ``rafiki_tpu_torch/``, and not ``chip_smoke.py``, imports
  JAX, Flax, optax or the JAX package, nor msgpack, ml_dtypes,
  safetensors, PIL or scikit-learn (the card's machine has none of them:
  the port's codec, its safetensors reader and writer, its PNG codec and
  its tree, boosting and SVM fits are its own).
- Entry points resolve ``device=None`` to the CUDA card and raise when
  there is none, instead of serving from the CPU; the host templates
  (the HMM and the three scikit-learn-free fits) take no device.
- A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises — it never runs the plain version.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from rafiki_tpu_torch.models.bert import Bert, BertClassifier
from rafiki_tpu_torch.models.llama_lora import Llama, LlamaLoRA
from rafiki_tpu_torch.models.vit import ViT, ViTBase16
from rafiki_tpu_torch.ops import _build
from rafiki_tpu_torch.ops import attention as fa
from rafiki_tpu_torch.ops import paged_attention as pa
from rafiki_tpu_torch.ops import patch_embed as pe
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine
from rafiki_tpu_torch.utils.device import resolve_device

from test_decode_engine import KNOBS

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rafiki_tpu", "msgpack",
             "ml_dtypes", "safetensors", "PIL", "sklearn")


def _port_sources():
    files = sorted((ROOT / "rafiki_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 10 and all(f.is_file() for f in files)
    scanned = {str(f.relative_to(ROOT)) for f in files}
    assert {"rafiki_tpu_torch/chaos/__init__.py",
            "rafiki_tpu_torch/chaos/scaleout.py",
            "rafiki_tpu_torch/chaos/sloload.py",
            "rafiki_tpu_torch/chaos/dummy_service.py",
            "rafiki_tpu_torch/chaos/control_driver.py",
            "rafiki_tpu_torch/admin/autoscaler.py",
            "rafiki_tpu_torch/store/db.py",
            "rafiki_tpu_torch/models/tabular.py",
            "rafiki_tpu_torch/models/pos_tagging.py",
            "rafiki_tpu_torch/models/sklearn_models.py",
            "rafiki_tpu_torch/models/_tree_fit.py",
            "rafiki_tpu_torch/models/_svm_fit.py"} <= scanned
    bad = [(str(f.relative_to(ROOT)), mod)
           for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _tiny_llama(**kw):
    return Llama(vocab_size=16, max_len=8, hidden_dim=8, depth=1,
                 n_heads=2, n_kv_heads=1, mlp_dim=16, **kw)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaLoRA(**KNOBS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_llama()
    cpu_model = _tiny_llama(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cpu_model, max_slots=2, max_len=8)
    # asked for explicitly, the CPU is fine
    assert DecodeEngine(cpu_model, max_slots=2, max_len=8,
                        device="cpu").device.type == "cpu"


def test_zoo_card_templates_refuse_and_host_templates_need_no_card(
        monkeypatch):
    from rafiki_tpu_torch.models import get_model_template

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("JaxTabularMLP", "BiLSTMTagger"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model_template(name)()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model_template(name)(device="cuda")
        assert get_model_template(name)(device="cpu").device.type == "cpu"
    for name in ("BigramHMM", "SklearnDecisionTree", "SklearnGBDT",
                 "SklearnSVM"):
        assert get_model_template(name)().knobs == {}
        assert get_model_template(name)(device="cuda").knobs == {}


def _operands(window):
    q = torch.zeros((2, 3, 4, 8) if window else (2, 4, 8))
    pool = torch.zeros(5, 4, 2, 8)
    tab = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros((2, 3) if window else (2,), dtype=torch.int32)
    return q, pool, pool.clone(), tab, pos, 0.5


@pytest.fixture()
def kernel_path(monkeypatch):
    """Route CPU tensors down the kernel path (as a CUDA tensor would
    go), with the plain versions booby-trapped."""
    def plain_ran(*a, **k):
        raise AssertionError("the plain version ran on the kernel path")

    monkeypatch.setattr(pa, "_runs_kernel", lambda t: True)
    monkeypatch.setattr(pa, "_paged_window_reference", plain_ran)
    monkeypatch.setattr(pa, "_paged_attention_reference", plain_ran)
    pa._library.cache_clear()
    yield
    pa._library.cache_clear()


@pytest.mark.parametrize("window", [False, True], ids=["decode", "window"])
def test_kernel_wrappers_raise_without_the_library(kernel_path,
                                                   monkeypatch, window):
    """No nvcc (or a failed build): the wrapper raises; the launch
    counter does not move."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "lib_path",
                        lambda name: Path("/nonexistent") / f"lib{name}.so")
    fn = pa.paged_window_attention if window else pa.paged_decode_attention
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*_operands(window))
    assert fn.launches == before


@pytest.mark.parametrize("window", [False, True], ids=["decode", "window"])
def test_kernel_wrappers_reject_non_cuda_tensors(kernel_path, monkeypatch,
                                                 window):
    """With a library at hand, operands that are not CUDA tensors are
    refused before any pointer reaches the kernel."""
    monkeypatch.setattr(_build, "library", lambda name: _FakeLib())
    fn = pa.paged_window_attention if window else pa.paged_decode_attention
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*_operands(window))


class _FakeLib:
    """Accepts the ctypes declarations; any call would be a bug."""

    def __getattr__(self, name):
        return _FakeFn()


class _FakeFn:
    def __call__(self, *a):
        raise AssertionError("a kernel was launched on CPU operands")


def test_plain_path_is_taken_only_for_cpu_tensors():
    assert not pa._runs_kernel(torch.zeros(1))
    assert pa._runs_kernel(torch.zeros(1, device="meta"))
    out = pa.paged_decode_attention(*_operands(False))
    assert out.shape == (2, 4, 8) and np.isfinite(out.numpy()).all()


def test_vit_and_bert_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ViTBase16(patch_size=4, hidden_dim=8),
                 lambda: BertClassifier(vocab_size=64),
                 lambda: ViT(patch_size=4, hidden_dim=8, depth=1,
                             n_heads=2, mlp_dim=8, n_classes=2,
                             image_shape=(8, 8, 3)),
                 lambda: Bert(vocab_size=64, max_len=8, hidden_dim=8,
                              depth=1, n_heads=2, mlp_dim=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # asked for explicitly, the CPU is fine
    assert ViTBase16(device="cpu").device.type == "cpu"
    assert BertClassifier(device="cpu").device.type == "cpu"


@pytest.fixture()
def b4_b7_kernel_path(monkeypatch):
    """Route CPU tensors down B4's and B7's kernel paths, with their plain
    versions booby-trapped."""
    def plain_ran(*a, **k):
        raise AssertionError("the plain version ran on the kernel path")

    for mod in (fa, pe):
        monkeypatch.setattr(mod, "_runs_kernel", lambda t: True)
        mod._library.cache_clear()
    monkeypatch.setattr(fa, "_flash_fwd_reference", plain_ran)
    monkeypatch.setattr(pe, "_matmul_bias_reference", plain_ran)
    yield
    for mod in (fa, pe):
        mod._library.cache_clear()


def _b4_b7_calls():
    x = torch.zeros(1, 4, 8, 16)
    lens = torch.full((1,), 8, dtype=torch.int32)
    return {
        "matmul_bias": (pe.matmul_bias, lambda: pe.matmul_bias(
            torch.zeros(6, 5), torch.zeros(5, 3), torch.zeros(3))),
        "flash_attention_fwd_mh": (fa.flash_attention_fwd_mh, lambda:
                                   fa.flash_attention_fwd_mh(
                                       x, x, x, lens, 0.25, False, 2)),
    }


@pytest.mark.parametrize("name", list(_b4_b7_calls()))
def test_b4_b7_wrappers_raise_without_the_library(b4_b7_kernel_path,
                                                  monkeypatch, name):
    """No nvcc (or a failed build): the wrapper raises; the launch counter
    does not move."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "lib_path",
                        lambda lib: Path("/nonexistent") / f"lib{lib}.so")
    fn, call = _b4_b7_calls()[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("name", list(_b4_b7_calls()))
def test_b4_b7_wrappers_reject_non_cuda_tensors(b4_b7_kernel_path,
                                                monkeypatch, name):
    monkeypatch.setattr(_build, "library", lambda lib: _FakeLib())
    fn, call = _b4_b7_calls()[name]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert fn.launches == before


# ---- the control plane's processes and the data plane are the port's own

def test_the_manager_spawns_only_the_ports_modules():
    import importlib.util

    from rafiki_tpu_torch.admin import services_manager as psm

    targets = set(psm.SPAWN_TARGETS.values())
    assert len(targets) == 4
    for module in targets:
        assert module.split(".")[0] == "rafiki_tpu_torch", module
        assert importlib.util.find_spec(module) is not None, module


def _code_strings(path):
    """String constants of a module, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_port_code_names_a_jax_package_module():
    """No string the port's code uses (a spawn target, an import by
    name, a package-data lookup) names a module of the JAX package."""
    import re

    jax_module = re.compile(r"^rafiki_tpu\.\w")
    bad = [(str(f.relative_to(ROOT)), s) for f in _port_sources()
           for s in _code_strings(f) if jax_module.match(s)]
    assert not bad, bad


def test_the_kvd_is_built_from_the_ports_source_into_its_build_dir():
    from rafiki_tpu_torch.native import client as pclient

    assert pclient.SOURCE == ROOT / "rafiki_tpu_torch" / "native" / \
        "kv_server.cc"
    assert pclient.SOURCE.is_file()
    assert pclient.BUILD_DIR == ROOT / "build" / "rafiki_tpu_torch"


def test_the_control_plane_modules_are_scanned():
    scanned = {str(f.relative_to(ROOT)) for f in _port_sources()}
    for rel in ("constants.py", "admin/admin.py", "admin/app.py",
                "admin/services_manager.py", "admin/device_probe.py",
                "admin/proc.py", "client/client.py", "parallel/mesh.py",
                "serving/predictor.py", "serving/router.py",
                "serving/breaker.py", "advisor/service.py",
                "obs/http.py", "native/client.py", "cli.py",
                "admin/stack.py", "models/__init__.py", "models/_cnn_base.py",
                "models/resnet.py", "models/vgg.py", "models/densenet.py",
                "models/mlp.py", "data/png.py", "data/stream.py",
                "data/dataset.py"):
        assert f"rafiki_tpu_torch/{rel}" in scanned, rel


def test_the_image_templates_refuse_to_fall_back_to_cpu(monkeypatch):
    from rafiki_tpu_torch.models.densenet import DenseNet, DenseNetClassifier
    from rafiki_tpu_torch.models.mlp import JaxFeedForward
    from rafiki_tpu_torch.models.resnet import ResNet, ResNetClassifier
    from rafiki_tpu_torch.models.vgg import VGG, VGGClassifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ResNetClassifier, VGGClassifier, DenseNetClassifier,
                 JaxFeedForward,
                 lambda: ResNet(stage_sizes=(1,), width=8, n_classes=2),
                 lambda: VGG(stage_sizes=(1,), width=8, n_classes=2),
                 lambda: DenseNet(block_sizes=(1,), growth=4, n_classes=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for cls in (ResNetClassifier, VGGClassifier, DenseNetClassifier,
                JaxFeedForward):
        assert cls(device="cpu").device.type == "cpu"
