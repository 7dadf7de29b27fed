"""Threefry coins of the PyTorch port (ops/prng.py) vs `jax.random`: keys,
`fold_in`, 32-bit random bits and `bernoulli`, bitwise (tolerance: none),
for the salts and shapes the solver draws (the sorted rounds' per-pass
salts, the finishing rounds' 90_000 base, the largest int32 salt)."""

import jax
import numpy as np
import pytest
import torch

from image_compression_torch.ops import prng

SALTS = [0, 1, 7, 50_000, 90_000 + 3, 2 ** 31 - 1]
SHAPES = [(1,), (37,), (4096,), (27, 64), (3, 256)]


def _key_words(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_prng_key(seed):
    assert _key_words(jax.random.PRNGKey(seed)) == prng.prng_key(seed)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("salt", SALTS)
def test_fold_in_and_bernoulli_bitwise(salt, shape):
    """fold_in of each fixed key the solver uses (0, 2, 3), then the 32-bit
    words and the p = 0.5 coins of that key, equal to jax.random's."""
    for seed in (0, 2, 3):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
        tk = prng.fold_in(prng.prng_key(seed), salt)
        assert _key_words(jk) == tk
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jk, shape, np.uint32)).astype(np.int64),
            prng.random_bits(tk, shape).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, 0.5, shape)),
            prng.bernoulli(tk, 0.5, shape).numpy())


@pytest.mark.parametrize("p", [0.1, 0.3, 0.77])
def test_bernoulli_other_p_and_uniform(p):
    """The uniform floats and coins at other p hold bitwise too."""
    jk = jax.random.fold_in(jax.random.PRNGKey(0), 11)
    tk = prng.fold_in(prng.prng_key(0), 11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (500,))),
        prng.uniform(tk, (500,)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(jk, p, (500,))),
        prng.bernoulli(tk, p, (500,)).numpy())
    assert prng.bernoulli(tk, p, (3, 4), torch.device("cpu")).dtype == \
        torch.bool
