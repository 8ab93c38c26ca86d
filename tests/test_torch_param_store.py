"""The port's Flax-msgpack codec against flax on the CPU.

``rafiki_tpu_torch.store.param_store`` writes and reads the param-store
and queue wire in plain Python: its bytes must equal
``flax.serialization.msgpack_serialize``'s, byte for byte, and it must
read what flax writes (and flax what it writes) back equal — chunked
leaves and bfloat16 leaves included, and with flax's refusals.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from rafiki_tpu.store import param_store as jps
from rafiki_tpu_torch.store import param_store as ps

torch.set_num_threads(1)

DTYPES = ["float32", "float16", "int8", "int32", "int64", "uint8", "bool"]


def _ints():
    """Every msgpack int width, both signs, at and around each edge."""
    edges = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**63 - 1, 2**64 - 1]
    neg = [-1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
           -2**63]
    return edges + neg


def _message(seed):
    """A queue-message-like tree of every leaf kind, from a numpy seed."""
    rng = np.random.default_rng(seed)
    arrays = {d: (rng.integers(0, 2, (2, 3)).astype(d) if d == "bool"
                  else rng.standard_normal((3, 2)).astype(d)
                  if d.startswith("float")
                  else rng.integers(-100, 100, (4,)).astype(d)
                  if d.startswith("int") else
                  rng.integers(0, 256, (5,)).astype(d))
              for d in DTYPES}
    return {
        "id": f"q{seed}", "queries": ["tok1 tok2", "é" * 40, "x" * 300],
        "ints": _ints(), "float": float(rng.standard_normal()),
        "flag": True, "off": False, "none": None,
        "bytes": bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
        "big_bin": b"\x01" * 70000, "long_str": "s" * 70000,
        "np_scalars": [np.float32(1.5), np.int8(-3), np.bool_(True),
                       np.float64(2.25), np.int64(7), np.uint16(9)],
        "arrays": arrays, "empty": np.zeros((0, 3), np.float32),
        "zero_d": np.array(3.0, np.float32), "complex": 1 + 2j,
        "nested": [{"b": 1, "a": [1, {"z": None, "y": [2.5]}]}, []],
        "map16": {str(i): i for i in range(20)}, "list16": list(range(20)),
        "sampling": {"temperature": 0.0, "top_k": 0, "top_p": 1.0},
        # float runs (a reply's probabilities) take the vectorized path;
        # a run with one int in it does not
        "probs": [rng.random(1000).tolist(), [0.5] * 20 + [1],
                  [float("inf"), float("nan")] + [0.0] * 30],
    }


def _blob(seed):
    """A params-blob-like tree: nested dicts of f32 arrays plus meta."""
    rng = np.random.default_rng(seed)
    return {"params": {f"block_{i}": {
        "attn": {n: {"kernel": rng.standard_normal((8, 8)).astype(
            np.float32)} for n in ("wq", "wk")},
        "RMSNorm_0": {"scale": np.ones(8, np.float32)}}
        for i in (2, 0, 1)},
        "meta": {"id2tok": {"3": "tok3", "1": "tok1"}}}


def _equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, (np.ndarray, np.generic)):
        return type(a) is type(b) and a.dtype == b.dtype and \
            np.array_equal(a, b)
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b  # NaN
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("make", [_message, _blob], ids=["message", "blob"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bytes_equal_flax_and_round_trip_both_ways(make, seed):
    tree = make(seed)
    want = serialization.msgpack_serialize(tree)
    got = ps.params_to_bytes(tree)
    assert got == want
    # flax's bytes read by the port, and the port's by flax, come back
    # equal to what the other side reads
    from_flax = ps.params_from_bytes(want)
    assert _equal(from_flax, serialization.msgpack_restore(want))
    assert _equal(serialization.msgpack_restore(got), from_flax)
    assert ps.params_to_bytes(from_flax) == want


def test_arrays_read_back_are_views_of_the_blob():
    blob = ps.params_to_bytes({"w": np.arange(6, dtype=np.float32)})
    w = ps.params_from_bytes(blob)["w"]
    assert not w.flags.writeable
    assert np.shares_memory(w, np.frombuffer(blob, np.uint8))


def test_torch_leaves_write_as_their_numpy_arrays():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert ps.params_to_bytes({"t": t, "i": t.to(torch.int32)}) == \
        serialization.msgpack_serialize({"t": t.numpy(),
                                         "i": t.numpy().astype(np.int32)})


def test_bfloat16_leaves_read_as_torch_and_write_back_identical():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    flax_bytes = serialization.msgpack_serialize(
        {"x": x, "f": np.ones(2, np.float32)})
    got = ps.params_from_bytes(flax_bytes)
    assert got["x"].dtype == torch.bfloat16 and got["x"].shape == (3, 5)
    np.testing.assert_array_equal(got["x"].float().numpy(),
                                  x.astype(np.float32))
    assert ps.params_to_bytes(got) == flax_bytes
    # a bf16 numpy scalar reads as a 0-d tensor (it writes back as a 0-d
    # array: torch has no scalar type to carry it)
    s = ps.params_from_bytes(serialization.msgpack_serialize(
        {"s": x[0, 0]}))["s"]
    assert s.dtype == torch.bfloat16 and s.dim() == 0
    assert float(s) == float(x[0, 0])
    back = serialization.msgpack_restore(ps.params_to_bytes(
        {"t": got["x"]}))["t"]
    assert back.dtype == ml_dtypes.bfloat16 and np.array_equal(back, x)


@pytest.mark.parametrize("chunk", [48, 64, 1000])
def test_chunked_leaves_equal_flax(monkeypatch, chunk):
    """Arrays over MAX_CHUNK_SIZE (dict values and the root) are split as
    flax splits them — the chunked dicts in insertion order — and joined
    back on read; arrays inside lists stay whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(ps, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(chunk)
    tree = {"emb": rng.standard_normal((13, 7)).astype(np.float32),
            "n": {"ids": np.arange(40, dtype=np.int64),
                  "small": np.ones(2, np.float32)},
            "l": [np.zeros(100, np.float32)], "bf": torch.randn(
                9, 11).to(torch.bfloat16)}
    want = serialization.msgpack_serialize(
        dict(tree, bf=tree["bf"].view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)))
    assert ps.params_to_bytes(tree) == want
    got = ps.params_from_bytes(want)
    np.testing.assert_array_equal(got["emb"], tree["emb"])
    np.testing.assert_array_equal(got["n"]["ids"], tree["n"]["ids"])
    assert torch.equal(got["bf"], tree["bf"])
    root = np.arange(100, dtype=np.float32)
    assert ps.params_to_bytes(root) == serialization.msgpack_serialize(root)
    np.testing.assert_array_equal(ps.params_from_bytes(
        ps.params_to_bytes(root)), root)


def test_refusals_flax_makes():
    for bad in ({"a": (1, 2)}, (1,)):
        with pytest.raises(TypeError):
            serialization.msgpack_serialize(bad)
        with pytest.raises(TypeError, match="tuple"):
            ps.params_to_bytes(bad)
    with pytest.raises(OverflowError):
        ps.params_to_bytes({"a": 2 ** 64})
    with pytest.raises(OverflowError):
        ps.params_to_bytes({"a": -2 ** 63 - 1})
    # int map keys pack, but neither side reads them back
    raw = serialization.msgpack_serialize({1: 2})
    assert ps.params_to_bytes({1: 2}) == raw
    with pytest.raises(ValueError, match="map key"):
        serialization.msgpack_restore(raw)
    with pytest.raises(ValueError, match="map key"):
        ps.params_from_bytes(raw)
    with pytest.raises(ValueError):
        ps.params_from_bytes(raw + b"\xc0")  # extra bytes
    with pytest.raises(ValueError):
        ps.params_from_bytes(raw[:-1])  # truncated


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_backend_directories_move_between_packages(tmp_path, writer):
    tree = _blob(3)
    src = (jps if writer == "jax" else ps).ParamStore.from_uri(
        f"file://{tmp_path}")
    src.save("trial/1", tree)
    src.save("trial 2", {"params": {}, "meta": {"n": 1}})
    dst = (ps if writer == "jax" else jps).ParamStore.from_uri(
        f"file://{tmp_path}")
    assert sorted(dst.keys()) == ["trial 2", "trial/1"]
    assert _equal(dst.load("trial/1"), serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)))
    assert dst.exists("trial 2") and dst.load("missing") is None


def test_param_store_surface():
    store = ps.ParamStore.from_uri("mem://")
    store.save("a", {"w": np.ones(3, np.float32)})
    assert store.exists("a") and store.copy("a", "b")
    np.testing.assert_array_equal(store.load("b")["w"], np.ones(3))
    store.delete("a")
    assert not store.exists("a") and store.keys() == ["b"]
    assert not store.copy("missing", "c")
    # a mem:// store has no sharded checkpoints: the callers save blobs
    assert store.sharded_checkpointer() is None
    assert store.sharded_ref("b") is None
    assert not store.save_sharded_async("b", {"w": np.ones(3)})
    assert not store.exists_sharded("b") and not store.copy_sharded("b", "c")
