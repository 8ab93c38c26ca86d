"""Port parity: seeded sampling in the ``rafiki_tpu_torch`` decode engine.

- ``utils/threefry.py`` against ``jax.random`` of the installed JAX
  (``jax_threefry_partitionable`` on): ``PRNGKey``, ``fold_in``, 32-bit
  ``bits`` and f32 ``uniform`` bit for bit over a grid of seeds,
  positions and shapes up to Llama-3-8B's vocabulary of 128256. The
  Gumbel floats may differ by an ulp (two logarithms), so categorical
  draws are held equal as tokens.
- ``_select_next`` against the JAX engine's on seeded f32 logits, every
  combination of temperature, top-k, top-p and seed: the same tokens.
- Sampled engine runs on ``trained_lm`` against the JAX engine (the
  cases of ``tests/test_decode_engine.py``'s sampling tests): equal
  tokens; invariant under repetition, ``steps_per_sync``, batch
  composition and arrival order; ``top_k=1`` and a tiny ``top_p`` are
  greedy.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.serving import decode_engine as jde
from rafiki_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from rafiki_tpu_torch.models.llama_lora import LlamaLoRA
from rafiki_tpu_torch.serving import decode_engine as pde
from rafiki_tpu_torch.serving.decode_engine import DecodeEngine
from rafiki_tpu_torch.utils import threefry as tf

from test_decode_engine import KNOBS

torch.set_num_threads(1)

L = int(KNOBS["max_len"])
SEEDS = (0, 1, 13, 1234, 2 ** 31 - 1)
POSITIONS = (0, 1, 31, 2047)
SHAPES = ((1,), (7,), (3, 5), (1024,), (128256,))


def _np(key):
    return np.asarray(key).astype(np.int64)


def test_prng_key_and_fold_in_bit_exact():
    assert jax.config.jax_threefry_partitionable
    base = jax.random.PRNGKey(0)
    for seed in SEEDS:
        np.testing.assert_array_equal(tf.prng_key(seed).numpy(),
                                      _np(jax.random.PRNGKey(seed)))
        for pos in POSITIONS:
            want = jax.random.fold_in(jax.random.fold_in(base, seed), pos)
            got = tf.fold_in(tf.fold_in(tf.prng_key(0), seed), pos)
            np.testing.assert_array_equal(got.numpy(), _np(want))
    # batched: one key per row, as the engine folds (seed, pos) per slot
    seeds = np.array(SEEDS, np.int32)
    pos = np.array([0, 3, 31, 2047, 5], np.int32)
    want = jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.fold_in(base, s), p))(seeds, pos)
    got = tf.fold_in(tf.fold_in(tf.prng_key(0), torch.from_numpy(seeds)),
                     torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_random_bits_and_uniform_bit_exact(shape):
    tiny = float(np.finfo(np.float32).tiny)
    for seed, pos in itertools.product(SEEDS[:3], POSITIONS[:2]):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        tkey = tf.fold_in(tf.prng_key(seed), pos)
        np.testing.assert_array_equal(
            tf.random_bits(tkey, shape).numpy(),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32)
                       ).astype(np.int64))
        for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32,
                                                 lo, hi))
            got = tf.uniform(tkey, shape, lo, hi).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
        g = np.asarray(jax.random.gumbel(jkey, shape))
        np.testing.assert_allclose(tf.gumbel(tkey, shape).numpy(), g,
                                   rtol=1e-6, atol=1e-6)


def test_categorical_draws_equal_jax():
    rng = np.random.default_rng(0)
    for v in (8, 1000, 128256):
        logits = (rng.standard_normal((6, v)) * 3).astype(np.float32)
        seeds = np.arange(6, dtype=np.int32) * 977
        want = jax.vmap(jax.random.categorical)(
            jax.vmap(jax.random.PRNGKey)(seeds), jnp.asarray(logits))
        got = tf.categorical(tf.prng_key(torch.from_numpy(seeds)),
                             torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grid_rows():
    rows = list(itertools.product((0.0, 0.5, 1.0, 2.0), (0, 1, 5, 50),
                                  (1.0, 0.9, 0.5, 1e-6), (0, 7)))
    temp, top_k, top_p, seed = (np.array(c) for c in zip(*rows))
    return (temp.astype(np.float32), top_k.astype(np.int32),
            top_p.astype(np.float32), seed.astype(np.int32))


@pytest.mark.parametrize("vocab", [1024, 128256])
def test_select_next_picks_jax_tokens(vocab):
    """Every (temperature, top_k, top_p, seed) of the grid as a row of
    one call, at two positions per row."""
    temp, top_k, top_p, seed = _grid_rows()
    b = len(temp)
    if vocab > 1024:  # a slice of the grid at the full vocabulary
        sel = np.arange(0, b, 9)
        temp, top_k, top_p, seed = (a[sel] for a in (temp, top_k, top_p,
                                                     seed))
        b = len(sel)
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal((b, vocab)) * 4).astype(np.float32)
    for pos in (np.zeros(b, np.int32),
                rng.integers(0, 2048, size=b).astype(np.int32)):
        want = np.asarray(jde._select_next(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p), jnp.asarray(seed), jnp.asarray(pos)))
        got = pde._select_next(*(torch.from_numpy(a) for a in (
            logits, temp, top_k, top_p, seed, pos)))
        np.testing.assert_array_equal(got.numpy(), want)
        greedy = logits.argmax(-1)
        assert (got.numpy()[temp <= 0] == greedy[temp <= 0]).all()
        assert (got.numpy()[top_k == 1] == greedy[top_k == 1]).all()


@pytest.fixture(scope="module")
def port_lm(trained_lm):
    m = LlamaLoRA(device="cpu", **KNOBS)
    m.load_parameters(trained_lm.dump_parameters())
    return m


PROMPT = np.asarray([1, 5, 9], np.int32)
SAMP = {"max_new": 6, "temperature": 0.9, "top_k": 50, "top_p": 0.95,
        "seed": 1234}


def _run(eng, reqs, order=None):
    for i in (order or range(len(reqs))):
        rid, p, kw = reqs[i]
        kw = dict(kw)
        eng.submit(rid, p, kw.pop("max_new"), **kw)
    done = {}
    for _ in range(200):
        eng.step()
        done.update({rid: list(t) for rid, t in eng.poll()})
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"undrained: {sorted(done)}")


def _engines(trained_lm, port_lm, page=0, **kw):
    if page:
        jmod = trained_lm._module(kv_page_size=page, kv_pages=17)
        pmod = port_lm._serving_module_params(page, 17)
    else:
        jmod, pmod = trained_lm._module(), port_lm._serving_module_params()
    return (JaxDecodeEngine(jmod, trained_lm._params, max_slots=4,
                            max_len=L, **kw),
            DecodeEngine(pmod, max_slots=4, max_len=L, device="cpu", **kw))


CASES = {
    "seeded": [("x", PROMPT, SAMP)],
    "batch-mix": [("x", PROMPT, SAMP),
                  ("y", np.asarray([2, 8], np.int32),
                   {"max_new": 4, "temperature": 0.7, "top_k": 0,
                    "top_p": 1.0, "seed": 7}),
                  ("g", np.asarray([3, 4, 5, 6], np.int32),
                   {"max_new": 5, "temperature": 0.0, "top_k": 0,
                    "top_p": 1.0, "seed": 0})],
    "other-seeds": [(f"s{s}", PROMPT, {**SAMP, "seed": s})
                    for s in (4321, 77, 31337)],
    "top-k-2": [("x", PROMPT, {"max_new": 5, "temperature": 1.5,
                               "top_k": 2, "top_p": 1.0, "seed": 99})],
    "degenerate": [("k1", PROMPT, {"max_new": 6, "temperature": 2.0,
                                   "top_k": 1, "top_p": 1.0, "seed": 3}),
                   ("p0", PROMPT, {"max_new": 6, "temperature": 2.0,
                                   "top_k": 0, "top_p": 1e-6, "seed": 3}),
                   ("greedy", PROMPT, {"max_new": 6, "temperature": 0.0,
                                       "top_k": 0, "top_p": 1.0,
                                       "seed": 0})],
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampled_engine_tokens_equal_jax(trained_lm, port_lm, case):
    reqs = CASES[case]
    jeng, peng = _engines(trained_lm, port_lm, page=8)
    want = _run(jeng, reqs)
    got = _run(peng, reqs)
    assert got == want
    assert all(len(got[rid]) == kw["max_new"] for rid, _p, kw in reqs)
    if case == "other-seeds":  # the seed steers the draws
        assert len({tuple(t) for t in got.values()}) > 1
    if case == "degenerate":  # top_k=1 and a tiny nucleus are greedy
        assert got["k1"] == got["greedy"] == got["p0"]


def test_sampled_tokens_invariant_under_fusion_mix_and_order(trained_lm,
                                                            port_lm):
    """A draw depends on (seed, position) only: the same tokens for
    ``steps_per_sync`` 1 and 4, contiguous and paged, alone or beside
    other requests, whatever the arrival order; the JAX engine's tokens
    at K=1."""
    reqs = CASES["batch-mix"]
    jeng, peng = _engines(trained_lm, port_lm, steps_per_sync=1)
    want = _run(jeng, reqs)
    assert _run(peng, reqs) == want
    for page, k in ((0, 4), (8, 1), (8, 4)):
        _, peng = _engines(trained_lm, port_lm, page=page,
                           steps_per_sync=k)
        assert _run(peng, reqs, order=[2, 0, 1]) == want
    _, peng = _engines(trained_lm, port_lm, page=8)
    assert _run(peng, reqs[:1]) == {"x": want["x"]}


def test_greedy_calls_never_run_the_sampler(trained_lm, port_lm,
                                            monkeypatch):
    """The sampler's vocab sort runs only in calls where a live slot
    samples, as the JAX engine compiles a separate greedy program."""
    calls = []
    real = pde._select_next
    monkeypatch.setattr(pde, "_select_next",
                        lambda *a: calls.append(1) or real(*a))
    _, peng = _engines(trained_lm, port_lm, page=8)
    _run(peng, [("g", PROMPT, {"max_new": 6, "temperature": 0.0})])
    assert not calls
    _run(peng, [("s", PROMPT, SAMP)])
    assert calls
