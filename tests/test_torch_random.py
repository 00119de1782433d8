"""The port's threefry sampler (`nd/random.py`) vs `jax.random`.

Keys, splits and the 32-bit draws are integer functions and are held
bitwise to JAX (jax 0.9: `threefry2x32`, `jax_threefry_partitionable` on);
the uniform floats are built from those bits exactly and are bitwise too.
The Gumbel values go through `log`, which may round differently in the
last place, so they are held within a few float32 ulps and the categorical
draws token for token. Keys come from a numpy seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.optimize import infer_cache as jax_infer_cache  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)


def _keys(n=200, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 42, 2 ** 31 - 1, -1, -5,
                                  2 ** 33 + 3])
def test_prng_key_is_jax_prngkey(seed):
    assert np.array_equal(_u32(nd_random.prng_key(seed)),
                          np.asarray(jax.random.PRNGKey(seed)))


def test_threefry2x32_is_jax_hash():
    from jax._src import prng as jax_prng

    keys = _keys(64, seed=1)
    counts = _keys(64, seed=2)
    y1, y2 = jax_prng.threefry2x32_p.bind(
        jnp.asarray(keys[:, 0]), jnp.asarray(keys[:, 1]),
        jnp.asarray(counts[:, 0]), jnp.asarray(counts[:, 1]))
    t = torch.as_tensor(keys.astype(np.int64))
    c = torch.as_tensor(counts.astype(np.int64))
    g1, g2 = nd_random.threefry2x32(t[:, 0], t[:, 1], c[:, 0], c[:, 1])
    assert np.array_equal(_u32(g1), np.asarray(y1))
    assert np.array_equal(_u32(g2), np.asarray(y2))


@pytest.mark.parametrize("num", [2, 3])
def test_split_is_bitwise_jax_over_200_keys(num):
    keys = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(
        jnp.asarray(keys)))
    got = _u32(nd_random.split(nd_random.key_array(keys), num))
    assert got.shape == (200, num, 2)
    assert np.array_equal(got, want)


def test_split_of_one_key_chains_like_jax():
    """The sampler's `key, sub = split(key)` loop, 50 times from a seed."""
    jkey, tkey = jax.random.PRNGKey(9), nd_random.prng_key(9)
    for _ in range(50):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = nd_random.split(tkey)
        assert np.array_equal(_u32(tkey), np.asarray(jkey))
        assert np.array_equal(_u32(tsub), np.asarray(jsub))


@pytest.mark.parametrize("n", [1, 13, 256])
def test_random_bits_and_uniform_are_bitwise_jax(n):
    keys = _keys(120, seed=n)
    jk = jnp.asarray(keys)
    tk = nd_random.key_array(keys)
    bits = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk))
    assert np.array_equal(_u32(nd_random.random_bits(tk, n)), bits)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (n,), jnp.float32, minval=lo, maxval=hi))(jk))
        got = nd_random.uniform(tk, n, lo, hi).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gumbel_within_float32_rounding_of_jax():
    keys = _keys(150, seed=4)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (64,)))(
        jnp.asarray(keys)))
    got = nd_random.gumbel(nd_random.key_array(keys), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=4e-7)


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
@pytest.mark.parametrize("vocab", [13, 256])
def test_categorical_draws_are_jax_draws(seed, vocab):
    """The reference tests' seeds (rng_seed 0, 3, 7; 11), over 100 keys of
    each seed's stream and logits from a numpy seed."""
    key = jax.random.PRNGKey(seed)
    keys = np.asarray(jax.random.split(key, 100))
    logits = np.random.RandomState(seed).randn(100, vocab).astype(
        np.float32) * 2.0
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jnp.asarray(keys), jnp.asarray(logits)))
    got = nd_random.categorical(nd_random.key_array(keys),
                                torch.as_tensor(logits)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.0])
def test_sample_tokens_is_jax_sample_tokens(temp):
    keys = _keys(64, seed=5)
    logp = np.log(np.random.RandomState(5).dirichlet(
        np.ones(13), size=64)).astype(np.float32)
    temps = np.full((64,), temp, np.float32)
    temps[::3] = 0.0  # greedy rows beside sampled ones
    jt, jk = jax_infer_cache._sample_tokens(
        jnp.asarray(logp), jnp.asarray(keys), jnp.asarray(temps))
    tt, tk = nd_random.sample_tokens(torch.as_tensor(logp),
                                     nd_random.key_array(keys),
                                     torch.as_tensor(temps))
    assert tt.dtype == torch.int32
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(_u32(tk), np.asarray(jk))
