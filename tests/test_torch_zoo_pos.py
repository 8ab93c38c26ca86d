"""The port's POS-tagging templates against the JAX package's, on the
CPU.

- the corpus generator writes JAX's bytes, and the loader reads JAX's
  sentences;
- ``BigramHMM``: the float64 log tables bit-equal to JAX's, the same
  tags (an empty sentence, unknown words), blobs crossing;
- ``BiLSTMTagger``: flax's ``OptimizedLSTMCell`` leaves map to
  ``torch.nn.LSTM``'s and back exactly; from JAX's initial tree the
  logits at every valid position within 1e-5, one epoch's loss within
  1e-5 relative (f32), equal tags for rows of length 0 and rows longer
  than ``max_len``; blobs cross both ways through both codecs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.data import CorpusDataset as JCorpusDataset
from rafiki_tpu.data import generate_corpus_dataset as jgen_corpus
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models import pos_tagging as jpos
from rafiki_tpu.store.param_store import params_from_bytes as jax_from_bytes
from rafiki_tpu.store.param_store import params_to_bytes as jax_to_bytes
from rafiki_tpu_torch.data.dataset import (CorpusDataset,
                                           generate_corpus_dataset)
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import pos_tagging
from rafiki_tpu_torch.store.param_store import (params_from_bytes,
                                               params_to_bytes)
from rafiki_tpu_torch.store.params import (lstm_params_from_jax,
                                           lstm_params_to_jax)

torch.set_num_threads(1)

HMM_KNOBS = {"emission_k": 0.01, "transition_k": 0.1, "min_word_count": 1}
LSTM_KNOBS = {"max_epochs": 1, "vocab_size": 1024, "embed_dim": 16,
              "hidden_dim": 24, "learning_rate": 5e-3, "batch_size": 16,
              "max_len": 12, "quick_train": False, "share_params": False}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_corpus")
    tr, va = str(d / "tr.jsonl"), str(d / "va.jsonl")
    jgen_corpus(tr, 300, seed=0)
    ds = jgen_corpus(va, 60, seed=1)
    return tr, va, ds


def _queries(ds):
    """Validation sentences plus an empty one, one longer than max_len
    and one of unknown words."""
    q = [list(toks) for toks, _ in ds.sentences[:24]]
    return q + [[], ["w1", "w2", "w3"] * 9, ["never", "seen"]]


def _jax_init_blob(tags):
    jm = jpos.BiLSTMTagger(**LSTM_KNOBS)
    jm._tags = list(tags)
    ids, lens = jm._encode([["w1"]])
    init = jm._module().init(jax.random.PRNGKey(0), jnp.asarray(ids),
                             jnp.asarray(lens))["params"]
    return {"params": jax.tree_util.tree_map(np.asarray, init),
            "meta": {"tags": list(tags)}}


# ---- the corpus

@pytest.mark.parametrize("shape", [(40, 200, 8, 12, 0), (50, 4096, 45, 32, 3)])
def test_generated_corpus_is_jax_bytes(tmp_path, shape):
    n, vocab, n_tags, max_len, seed = shape
    a, b = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jds = jgen_corpus(str(a), n, vocab_size=vocab, n_tags=n_tags,
                      max_len=max_len, seed=seed)
    pds = generate_corpus_dataset(str(b), n, vocab_size=vocab,
                                  n_tags=n_tags, max_len=max_len, seed=seed)
    assert a.read_bytes() == b.read_bytes()
    assert pds.sentences == jds.sentences and pds.tag_names == jds.tag_names
    loaded = CorpusDataset.load(str(a))
    assert loaded.sentences == JCorpusDataset.load(str(b)).sentences
    assert len(loaded) == n
    with pytest.raises(ValueError, match="vocab_size"):
        generate_corpus_dataset("", 4, vocab_size=3, n_tags=8)


# ---- the HMM

def test_hmm_tables_are_jax_bits_and_tags_equal(corpus):
    tr, va, ds = corpus
    jm = jpos.BigramHMM(**HMM_KNOBS)
    jm.train(tr)
    pm = pos_tagging.BigramHMM(device="cpu", **HMM_KNOBS)
    ctx = TrainContext()
    pm.train(tr, ctx)
    assert ctx.logger.get_values("loss") == [0.0]
    np.testing.assert_array_equal(pm._log_emit, jm._log_emit)
    np.testing.assert_array_equal(pm._log_trans, jm._log_trans)
    assert pm._vocab == jm._vocab
    q = _queries(ds)
    assert pm.predict(q) == jm.predict(q)
    assert pm.evaluate(va) == jm.evaluate(va) > 0.7
    # min_word_count 3 puts rare words at <unk>
    knobs = dict(HMM_KNOBS, min_word_count=3)
    jm3, pm3 = jpos.BigramHMM(**knobs), pos_tagging.BigramHMM(**knobs)
    jm3.train(tr)
    pm3.train(tr)
    np.testing.assert_array_equal(pm3._log_emit, jm3._log_emit)
    assert pm3.predict(q) == jm3.predict(q)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hmm_blobs_cross_both_ways(corpus, writer):
    tr, _, ds = corpus
    src = (pos_tagging.BigramHMM(**HMM_KNOBS) if writer == "port"
           else jpos.BigramHMM(**HMM_KNOBS))
    src.train(tr)
    dst = (jpos.BigramHMM(**HMM_KNOBS) if writer == "port"
           else pos_tagging.BigramHMM(**HMM_KNOBS))
    q = _queries(ds)
    for encode, decode in ((params_to_bytes, jax_from_bytes),
                           (jax_to_bytes, params_from_bytes)):
        dst.load_parameters(decode(encode(src.dump_parameters())))
        assert dst.predict(q) == src.predict(q)
    with pytest.raises(RuntimeError, match="not trained"):
        pos_tagging.BigramHMM().dump_parameters()


# ---- the BiLSTM

def test_lstm_leaves_map_exactly_both_ways():
    rng = np.random.default_rng(0)
    cells = [{g: ({"kernel": rng.normal(size=(5, 3)).astype(np.float32)}
                  if g[0] == "i" else
                  {"kernel": rng.normal(size=(3, 3)).astype(np.float32),
                   "bias": rng.normal(size=3).astype(np.float32)})
              for g in ("hf", "hg", "hi", "ho", "if", "ig", "ii", "io")}
             for _ in range(2)]
    state = lstm_params_from_jax(cells)
    lstm = torch.nn.LSTM(5, 3, batch_first=True, bidirectional=True)
    lstm.load_state_dict(state)
    # torch's gate order i, f, g, o: rows [H:2H] of weight_ih are `if`
    np.testing.assert_array_equal(
        state["weight_ih_l0_reverse"][3:6].numpy(), cells[1]["if"]["kernel"].T)
    back = lstm_params_to_jax(lstm.state_dict())
    for got, want in zip(back, cells):
        assert list(got) == sorted(want)
        for k in want:
            for leaf in want[k]:
                np.testing.assert_array_equal(got[k][leaf], want[k][leaf])
    bad = dict(state, bias_ih_l0=torch.ones(12))
    with pytest.raises(ValueError, match="bias_ih_l0"):
        lstm_params_to_jax(bad)


def test_bilstm_logits_loss_and_tags_follow_jax(corpus):
    tr, va, ds = corpus
    blob0 = _jax_init_blob(ds.tag_names)
    jm = jpos.BiLSTMTagger(**LSTM_KNOBS)
    jm.load_parameters(blob0)
    pm = pos_tagging.BiLSTMTagger(device="cpu", **LSTM_KNOBS)
    pm.load_parameters(blob0)
    ids, lens = jm._encode(_queries(ds))
    np.testing.assert_array_equal(pm._encode(_queries(ds))[0], ids)
    assert lens.min() == 0 and lens.max() == LSTM_KNOBS["max_len"]
    want = np.asarray(jm._module().apply({"params": jm._params}, ids, lens))
    got = pm._serving_net()(torch.from_numpy(ids),
                            torch.from_numpy(lens)).numpy()
    valid = np.arange(ids.shape[1])[None, :] < lens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5)
    assert pm.predict(_queries(ds)) == jm.predict(_queries(ds))
    jctx, ctx = JTrainContext(), TrainContext()
    jm.train(tr, jctx)
    pm.train(tr, ctx)
    np.testing.assert_allclose(ctx.logger.get_values("loss"),
                               jctx.logger.get_values("loss"), rtol=1e-5)
    q = _queries(ds)
    assert pm.predict(q) == jm.predict(q)
    assert pm.predict([[]]) == [[]]
    assert len(pm.predict(q)[-2]) == LSTM_KNOBS["max_len"]
    assert pm.evaluate(va) == pytest.approx(jm.evaluate(va), abs=1e-9)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jm.dump_parameters()["params"])
    pleaves = jax.tree_util.tree_leaves_with_path(
        pm.dump_parameters()["params"])
    assert [p for p, _ in jleaves] == [p for p, _ in pleaves]
    for (_, a), (_, b) in zip(jleaves, pleaves):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bilstm_blobs_cross_both_ways(corpus, writer):
    tr, _, ds = corpus
    if writer == "port":
        src = pos_tagging.BiLSTMTagger(device="cpu", **LSTM_KNOBS)
        dst = jpos.BiLSTMTagger(**LSTM_KNOBS)
    else:
        src = jpos.BiLSTMTagger(**LSTM_KNOBS)
        dst = pos_tagging.BiLSTMTagger(device="cpu", **LSTM_KNOBS)
    src.train(tr)
    q = _queries(ds)
    for encode, decode in ((params_to_bytes, jax_from_bytes),
                           (jax_to_bytes, params_from_bytes)):
        dst.load_parameters(decode(encode(src.dump_parameters())))
        assert dst.predict(q) == src.predict(q)


def test_bilstm_warm_start_and_hash(corpus):
    tr, _, ds = corpus
    assert [pos_tagging._hash_token(w, 4096) for w in ("w1", "é", "")] \
        == [jpos._hash_token(w, 4096) for w in ("w1", "é", "")]
    donor = pos_tagging.BiLSTMTagger(device="cpu", **LSTM_KNOBS)
    donor.train(tr)
    knobs = dict(LSTM_KNOBS, share_params=True)
    jm = jpos.BiLSTMTagger(**knobs)
    jm.train(tr, JTrainContext(shared_params=donor.dump_parameters()))
    pm = pos_tagging.BiLSTMTagger(device="cpu", **knobs)
    pm.train(tr, TrainContext(shared_params=donor.dump_parameters()))
    assert pm.predict(_queries(ds)) == jm.predict(_queries(ds))


@pytest.mark.parametrize("name", ["BigramHMM", "BiLSTMTagger"])
def test_a_pos_job_trains_and_serves_through_the_workers(corpus, tmp_path,
                                                         name):
    from test_torch_zoo_tabular import train_and_serve

    tr, va, ds = corpus
    # pins inside the knob domains (a job validates them)
    pins = ({} if name == "BigramHMM" else
            {"vocab_size": 1024, "embed_dim": 32, "hidden_dim": 64,
             "batch_size": 32, "quick_train": True})
    q = _queries(ds)
    served, direct = train_and_serve(
        tmp_path, getattr(pos_tagging, name), "POS_TAGGING", tr, va, q,
        pins)
    assert served == direct
    # the job's max_len is the knob's fixed 32: all 27 tokens are tagged
    assert served[-3] == [] and len(served[-2]) == 27
