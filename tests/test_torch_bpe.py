"""Port parity: the byte-level BPE tokenizer and its native encoder.

- ``rafiki_tpu_torch.data.bpe.ByteBPETokenizer`` against the JAX
  package's: the same merges trained from a seeded corpus, the same ids
  for text with non-ASCII characters, the same text decoded from ids that
  cut a multi-byte character (invalid UTF-8, replaced), artifacts that
  load both ways.
- The native encoder (``native/bpe_encoder.cc``, built with ``g++``) id
  for id against the Python merge loop.
- A JAX ``LlamaLoRA`` trained with a BPE artifact: its blob (with
  ``meta["bpe_merges"]``) loads in the port, which serves it with the
  JAX template's greedy texts (``predict`` and the paged decode engine),
  exactly.
"""

import json

import numpy as np
import pytest
import torch

from rafiki_tpu.data import bpe as jbpe
from rafiki_tpu.data import generate_text_classification_dataset
from rafiki_tpu.models.llama_lora import LlamaLoRA as JLlamaLoRA
from rafiki_tpu_torch.data import bpe as pbpe
from rafiki_tpu_torch.models import llama_lora as ll
from rafiki_tpu_torch.native import client as native

from test_decode_engine import KNOBS

torch.set_num_threads(1)

WORDS = ("the quick brown fox jumps over lazy dogs while naïve cafés "
         "serve crème brûlée — 東京 タワー Ωmega ∑ 🙂 tab\there").split(" ")


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        k = int(rng.integers(3, 14))
        words = [WORDS[int(i)] for i in rng.integers(0, len(WORDS), k)]
        sep = rng.choice(["  ", " ", "\n", " \t"], p=[0.1, 0.7, 0.1, 0.1])
        lines.append(sep.join(words))
    return lines


@pytest.fixture(scope="module")
def corpus():
    return _corpus(200, seed=0)


@pytest.fixture(scope="module")
def merges(corpus):
    return jbpe.ByteBPETokenizer.train(corpus, vocab_size=420).merges


def test_training_gives_jax_merges(corpus, merges):
    port = pbpe.ByteBPETokenizer.train(corpus, vocab_size=420)
    # the corpus runs out of repeating pairs before 420: training stops
    assert port.merges == merges and 50 < len(merges) <= 420 - 259
    assert port.vocab_size == 259 + len(merges)
    assert (pbpe.PAD_ID, pbpe.BOS_ID, pbpe.EOS_ID, pbpe.N_SPECIAL) == \
        (jbpe.PAD_ID, jbpe.BOS_ID, jbpe.EOS_ID, jbpe.N_SPECIAL)
    assert pbpe._CHUNK_RE.pattern == jbpe._CHUNK_RE.pattern


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_ids_and_texts_equal_jax(corpus, merges, native):
    jtok = jbpe.ByteBPETokenizer(merges)
    ptok = pbpe.ByteBPETokenizer(merges, native=native)
    assert (ptok._native is not None) == native
    texts = _corpus(60, seed=1) + ["", " ", "  lead", "trail  ", "\n\n",
                                   "unseen wörds ✓ ok"]
    for t in texts:
        ids = ptok.encode_ids(t)
        assert ids == jtok.encode_ids(t), t
        assert ptok.decode(ids) == t  # lossless
        assert ptok.encode(t, 12) == jtok.encode(t, 12)
    got = ptok.encode_batch(texts, 16)
    want = jtok.encode_batch(texts, 16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # ids cutting a multi-byte character: invalid UTF-8, replaced alike
    ids = ptok.encode_ids("東京 🙂")
    raw = [pbpe.N_SPECIAL + b for b in "東京".encode()]
    for cut in (raw[:1], raw[:2], raw[1:4], ids[:-1] + raw[:1],
                [0, 1, 2, 999999, -1] + raw[:2]):
        assert ptok.decode(cut) == jtok.decode(cut)


def test_artifacts_load_both_ways(merges, tmp_path):
    jtok = jbpe.ByteBPETokenizer(merges)
    jtok.save(str(tmp_path / "jax.json"))
    ptok = pbpe.ByteBPETokenizer.load(str(tmp_path / "jax.json"))
    assert ptok.merges == jtok.merges
    ptok.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert jbpe.ByteBPETokenizer.load(str(tmp_path / "port.json")).merges \
        == merges
    (tmp_path / "bad.json").write_text(json.dumps({"merges": []}))
    with pytest.raises(ValueError, match="rafiki-bpe-v1"):
        pbpe.ByteBPETokenizer.load(str(tmp_path / "bad.json"))


def test_train_file_equals_train(corpus, merges, tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(corpus), encoding="utf-8")
    assert pbpe.ByteBPETokenizer.train_file(str(path), 420).merges == \
        jbpe.ByteBPETokenizer.train_file(str(path), 420).merges


def test_native_encoder_identical_to_the_python_loop(merges):
    """Every chunk of a seeded corpus, and random byte strings (every
    byte value, any length), through both encoders."""
    nat = pbpe._native_encoder(merges)
    loop = pbpe.ByteBPETokenizer(merges, native=False)
    chunks = {c.encode() for line in _corpus(300, seed=2)
              for c in pbpe._CHUNK_RE.findall(line)}
    rng = np.random.default_rng(3)
    chunks |= {bytes(rng.integers(0, 256, int(n)).astype(np.uint8))
               for n in rng.integers(0, 40, 200)}
    for c in sorted(chunks):
        assert nat.encode_chunk(c) == loop._bpe_chunk(c), c
    # an empty merge table: bytes pass through
    assert pbpe._native_encoder([]).encode_chunk(b"ab") == (100, 101)


def test_native_build_failure_raises(merges, monkeypatch):
    """No quiet fallback to the Python loop: a failed build raises."""
    def broken(*a, **kw):
        raise RuntimeError("g++ failed building bpe_encoder.cc")
    monkeypatch.setattr(native, "ensure_built", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        pbpe.ByteBPETokenizer(merges)
    assert pbpe.ByteBPETokenizer(merges, native=False)._native is None


def test_native_library_builds_from_the_checkout():
    lib = native.ensure_built(target="librbpe.so")
    assert lib.name == "librbpe.so" and lib.parent == native.BUILD_DIR
    assert lib.stat().st_mtime >= native.TARGETS["librbpe.so"][0].stat(
        ).st_mtime


@pytest.fixture(scope="module")
def bpe_lm(tmp_path_factory):
    """A JAX LlamaLoRA trained one epoch with a BPE artifact trained on
    its own corpus."""
    d = tmp_path_factory.mktemp("bpe_lm")
    ds = str(d / "train.jsonl")
    generate_text_classification_dataset(ds, 48, seed=0)
    texts = [rec["text"] for line in open(ds) if line.strip()
             for rec in [json.loads(line)] if "text" in rec]
    tok = jbpe.ByteBPETokenizer.train(texts, vocab_size=320)
    tok.save(str(d / "bpe.json"))
    knobs = {**KNOBS, "vocab_size": 0, "tokenizer_path": str(d / "bpe.json")}
    m = JLlamaLoRA(**knobs)
    m.train(ds)
    return m, knobs


def test_jax_bpe_blob_serves_in_the_port(bpe_lm):
    jm, knobs = bpe_lm
    blob = jm.dump_parameters()
    assert blob["meta"]["bpe_merges"]
    # the blob alone rebuilds the tokenizer: no artifact path needed
    bare = {**{k: v for k, v in knobs.items() if k != "tokenizer_path"},
            "vocab_size": jm.tokenizer.vocab_size}
    pm = ll.LlamaLoRA(device="cpu", **bare)
    pm.load_parameters(blob)
    assert pm._bpe and pm.tokenizer.merges == jm.tokenizer.merges
    assert ll._same_tokenizer(pm.tokenizer, ll.LlamaLoRA(
        device="cpu", **knobs).tokenizer)
    assert not ll._same_tokenizer(pm.tokenizer, ll.HashTokenizer(320))
    queries = ["the quick", "tok1 tok2 tok3", "naïve café", "a"]
    assert pm.predict(queries, max_new_tokens=6) == \
        jm.predict(queries, max_new_tokens=6)
    texts = {}
    for name, model in (("jax", jm), ("port", pm)):
        eng = model.make_decode_engine(max_slots=2, max_new_tokens=6,
                                       kv_page_size=8)
        for i, q in enumerate(queries):
            eng.submit(i, q)
        done = {}
        for _ in range(200):
            eng.step()
            done.update(dict(eng.poll()))
            if len(done) == len(queries):
                break
        texts[name] = done
    assert texts["port"] == texts["jax"] and len(texts["port"]) == 4
    assert not any("<" in t for t in texts["port"].values())
    # the port's dump carries the merges back, and the JAX template
    # serves it
    back = JLlamaLoRA(**bare)
    back.load_parameters(pm.dump_parameters())
    assert back.predict(queries, max_new_tokens=6) == \
        jm.predict(queries, max_new_tokens=6)
