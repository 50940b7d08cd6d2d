"""The port's JAX-keyed randomness (pls_tpu_torch.utils.jax_prng) against jax.random.

jax_prng reproduces jax 0.9.0's threefry2x32 (partitionable layout) in
numpy.  Keys, splits, fold-ins and random bits must equal jax.random's bit
for bit, as must the JAX package's fold labels (across the one-to-two
round boundary of `_shuffle` at n = 1625/1626) and LSO partitions.
`PLSModel.cv_LSO` keyed by None or an int must cross-validate on the JAX
package's partitions (errors to 1e-10 in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu.cv.kfold import kfold_assignments as jax_kfold_assignments
from pls_tpu.cv.lso import random_partitions as jax_random_partitions
from pls_tpu_torch.utils import jax_prng

SEEDS = [0, 3, 7, 2**31 - 1, 2**40 + 5, -1]


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits(seed):
    k = jax.random.key(seed)
    assert np.array_equal(jax_prng.key(seed), _data(k))
    for n in (1, 2, 5, 33):
        assert np.array_equal(jax_prng.split(seed, n), _data(jax.random.split(k, n)))
        assert np.array_equal(jax_prng.random_bits32(seed, n),
                              np.asarray(jax.random.bits(k, (n,), jnp.uint32)))
    for d in (0, 1, 4, 2**32 - 1):
        assert np.array_equal(jax_prng.fold_in(seed, d), _data(jax.random.fold_in(k, d)))
    # a key array from jax_prng works where the seed did
    sub = jax_prng.split(seed, 3)[2]
    assert np.array_equal(jax_prng.split(sub, 4),
                          _data(jax.random.split(jax.random.split(k, 3)[2], 4)))


@pytest.mark.parametrize("n", [5, 23, 60, 1624, 1625, 1626, 2000])
@pytest.mark.parametrize("seed", [0, 3])
def test_kfold_assignments_match_jax(n, seed):
    k = min(10, n)
    mine = tt.kfold_assignments(n, k, seed)
    assert mine.dtype == torch.int64
    assert np.array_equal(mine.numpy(), np.asarray(jax_kfold_assignments(n, k, seed)))
    assert jax_prng.shuffle_rounds(n) == (1 if n <= 1625 else 2)
    # a JAX key (its data) gives the same labels as its seed
    assert np.array_equal(tt.kfold_assignments(n, k, jax_prng.key(seed)).numpy(), mine.numpy())


def test_kfold_assignments_unshuffled():
    assert np.array_equal(tt.kfold_assignments(7, 3).numpy(), np.asarray(jax_kfold_assignments(7, 3)))


@pytest.mark.parametrize("n_rows,trials,seed", [(10, 100, 0), (60, 600, 0), (60, 50, 7), (1700, 20, 1)])
def test_random_partitions_match_jax(n_rows, trials, seed):
    ref = np.asarray(jax_random_partitions(jax.random.key(seed), n_rows, trials))
    mine = tt.random_partitions(seed, n_rows, trials)
    assert np.array_equal(mine.numpy(), ref)
    assert np.array_equal(tt.random_partitions(jax_prng.key(seed), n_rows, trials).numpy(), ref)


def test_permutation_of_array_and_int():
    k = jax.random.key(11)
    x = np.arange(40) * 3
    assert np.array_equal(jax_prng.permutation(11, x), np.asarray(jax.random.permutation(k, x)))
    assert np.array_equal(jax_prng.permutation(11, 40), np.asarray(jax.random.permutation(k, 40)))
    with pytest.raises(ValueError):
        jax_prng.permutation(0, np.zeros((2, 2)))


@pytest.mark.parametrize("seed", [None, 7])
def test_cv_lso_rng_matches_jax_model(seed, toy):
    X, Y = toy
    ref = pt.PLSModel(jnp.asarray(X), jnp.asarray(Y), pt.KERNEL_TYPE1, 2).cv_LSO(0.3, 20, seed)
    mine = tt.PLSModel(torch.from_numpy(X), torch.from_numpy(Y), tt.KERNEL_TYPE1, 2).cv_LSO(
        0.3, 20, seed
    )
    assert mine.method == ref.method
    np.testing.assert_allclose(mine.errors.numpy(), np.asarray(ref.errors), atol=1e-10)
