"""The port's threefry2x32 (ops/prng.py) against jax.random, bit for bit:
keys, fold_in, random bits and uniforms over seeds and shapes; the Gumbel
noise to one float32 rounding of the two logarithms; the categorical draw,
for one key and for per-row keys, on the tested seeds. JAX runs with its
default ``jax_threefry_partitionable`` (True in 0.9), which the port
implements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mmtg_tpu_torch.ops import prng, sampling

SEEDS = [0, 1, 42, 2 ** 31 - 1, -5]
I32 = st.integers(-2 ** 31, 2 ** 31 - 1)


def _words(jkey):
    return np.asarray(jkey).astype(np.int64)


def test_the_jax_variant_is_the_one_implemented():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for data in (0, 7, -3, 2 ** 31 - 1, -2 ** 31):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            _words(jax.random.fold_in(jk, jnp.int32(data))))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    """The REPL's key chain: split, keep the first, draw from the second."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _words(jax.random.split(jk, num)))
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(tsub.numpy(), _words(jsub))
    np.testing.assert_array_equal(tk.numpy(), _words(jk))


@settings(max_examples=40, deadline=None)
@given(seed=I32, data=I32, n=st.integers(1, 40))
def test_fold_in_and_bits_match_jax_for_any_seed(seed, data, n):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(data))
    tk = prng.fold_in(prng.PRNGKey(seed), data)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    np.testing.assert_array_equal(
        prng.random_bits(tk, (n,)).numpy(),
        np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5), (64, 10)])
def test_bits_and_uniform_match_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    # a general range scales and shifts; XLA may contract the two into one
    # fused multiply-add, so allow one rounding of a value below 3
    np.testing.assert_allclose(
        prng.uniform(tk, shape, -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)),
        rtol=0, atol=2.4e-7)
    # two logarithms, each rounded by its own library: a few ulp of a value
    # of order 1-10
    np.testing.assert_allclose(prng.gumbel(tk, shape).numpy(),
                               np.asarray(jax.random.gumbel(jk, shape)),
                               rtol=0, atol=2e-6)


def test_batched_keys_draw_per_key():
    """A batch of keys draws each key's own array, and a batched fold_in is
    the elementwise one (what jax.vmap gives)."""
    base = prng.PRNGKey(3)
    seeds = torch.tensor([3, -1, 100, 0, 7])
    keys = prng.fold_in(base, seeds)
    assert keys.shape == (5, 2)
    for b, s in enumerate(seeds.tolist()):
        np.testing.assert_array_equal(keys[b].numpy(), prng.fold_in(base, s).numpy())
        np.testing.assert_array_equal(prng.random_bits(keys, (6,))[b].numpy(),
                                      prng.random_bits(keys[b], (6,)).numpy())
    steps = prng.fold_in(keys[:, None, :], torch.arange(4)[None, :])
    assert steps.shape == (5, 4, 2)
    np.testing.assert_array_equal(steps[2, 3].numpy(),
                                  prng.fold_in(keys[2], 3).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    rng = np.random.default_rng(seed & 0xFF)
    logits = (rng.standard_normal((6, 10)) * 3).astype(np.float32)
    logits[0, 3:] = -1e30  # a nucleus-masked tail
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.categorical(tk, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(jk, jnp.asarray(logits))))
    # per-row keys, as the decode step derives them: fold_in(fold_in(rng, seed_b), i)
    row_seeds = np.array([3, -1, 100, 0, 7, 2 ** 31 - 1], np.int32)
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.fold_in(jk, s), 5))(
        jnp.asarray(row_seeds))
    tkeys = prng.fold_in(prng.fold_in(tk, torch.from_numpy(row_seeds)), 5)
    np.testing.assert_array_equal(tkeys.numpy(), _words(jkeys))
    ref = jax.vmap(lambda k, l: jax.random.categorical(k, l))(jkeys, jnp.asarray(logits))
    np.testing.assert_array_equal(
        prng.categorical(tkeys, torch.from_numpy(logits)).numpy(), np.asarray(ref))


@pytest.mark.parametrize("per_row", [False, True], ids=["one_key", "per_row_keys"])
def test_sample_next_token_matches_jax(per_row):
    """The whole sampling step (penalty, temperature, bans, top-k, nucleus,
    draw) from a threefry key equals the JAX step's tokens."""
    from mmtg_tpu.ops import sampling as jsampling

    rng = np.random.default_rng(0)
    B, V = 5, 300
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    seen = rng.integers(0, 3, (B, V)).astype(np.int16)
    last = np.array([5, 0, 9, 150, 7], np.int32)  # row 1: PAD stays PAD
    jk, tk = jax.random.PRNGKey(4), prng.PRNGKey(4)
    if per_row:
        jk = jax.vmap(lambda s: jax.random.fold_in(jk, s))(jnp.arange(B))
        tk = prng.fold_in(tk, torch.arange(B))
    kw = dict(temperature=1.1, top_k=10, top_p=0.7, repetition_penalty=1.5)
    for extra in (kw, dict(kw, top_k=0)):
        ref = jsampling.sample_next_token(jk, jnp.asarray(logits), jnp.asarray(seen),
                                          jnp.asarray(last), per_row_keys=per_row,
                                          **extra)
        got = sampling.sample_next_token(tk, torch.from_numpy(logits),
                                         torch.from_numpy(seen),
                                         torch.from_numpy(last),
                                         per_row_keys=per_row, **extra)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampling_rejects_mismatched_keys():
    logits = torch.zeros(3, 200)
    seen = torch.zeros(3, 200, dtype=torch.int16)
    last = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError):  # one key where per-row keys are asked for
        sampling.sample_next_token(prng.PRNGKey(0), logits, seen, last, top_k=4,
                                   per_row_keys=True)
    with pytest.raises(ValueError):  # a torch.Generator cannot key rows
        sampling.sample_next_token(torch.Generator().manual_seed(0), logits, seen,
                                   last, top_k=4, per_row_keys=True)
    with pytest.raises(ValueError):  # keys that do not batch over the rows
        sampling.sample_next_token(prng.fold_in(prng.PRNGKey(0), torch.arange(2)),
                                   logits, seen, last, top_k=4, per_row_keys=True)
