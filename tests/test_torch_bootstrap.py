"""The port's bootstrap (pls_tpu_torch/cv/bootstrap.py) and the JAX-keyed
integer draws it rests on (`utils.jax_prng.randint`) against the JAX
package.

`randint` equals `jax.random.randint` bit for bit over keys, spans,
shapes and both int widths (int32, and int64 as jax draws with x64
enabled), also for a batch of keys as `jax.vmap` draws them.  The
bootstrap's per-replicate counts equal those of the JAX package's draws
on the same key, and its coefficient draws and percentile intervals equal
`pls_tpu.bootstrap_coefficient_intervals` to 1e-10 in float64 on the CPU,
for each method and through `PLSModel`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu_torch.cv.bootstrap import bootstrap_counts
from pls_tpu_torch.utils import jax_prng

SPANS = [(0, 10), (0, 60), (-7, 100), (0, 1000), (0, 2**31 - 1), (5, 5), (9, 3),
         (-2**31, 2**31 - 1), (0, 70_000), (0, 2**20 + 3)]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**40 + 3])
def test_randint_bit_identical(seed, dtype):
    for shape, (lo, hi) in zip([(10,), (60,), (3, 5), (1000,), (50,), (20,), (4,), (30,),
                                (2, 3, 7), (7,)], SPANS):
        ref = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi,
                                            dtype=getattr(jnp, dtype)))
        mine = jax_prng.randint(seed, shape, lo, hi, dtype)
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref, err_msg=f"{shape} [{lo}, {hi})")


def test_randint_batched_keys_and_key_data():
    keys = jax.random.split(jax.random.key(3), 5)
    for dtype in (jnp.int32, jnp.int64):
        ref = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (9,), 0, 9, dtype=dtype))(keys))
        mine = jax_prng.randint(jax_prng.split(3, 5), (9,), 0, 9, np.dtype(dtype))
        np.testing.assert_array_equal(mine, ref)
    data = np.asarray(jax.random.key_data(jax.random.key(11)))
    np.testing.assert_array_equal(jax_prng.randint(data, 6, 0, 4),
                                  np.asarray(jax.random.randint(jax.random.key(11), (6,), 0, 4,
                                                                dtype=jnp.int32)))
    with pytest.raises(TypeError):
        jax_prng.randint(0, 3, 0, 4, np.int16)


@pytest.mark.parametrize("int64", [False, True])
def test_bootstrap_counts_are_the_jax_draws(int64):
    N, R = 60, 12
    keys = jax.random.split(jax.random.key(5), R)
    dtype = jnp.int64 if int64 else jnp.int32
    ref = np.stack([np.bincount(np.asarray(jax.random.randint(k, (N,), 0, N, dtype=dtype)),
                                minlength=N) for k in keys])
    counts = bootstrap_counts(5, R, N, int64)
    np.testing.assert_array_equal(counts, ref)
    assert (counts.sum(1) == N).all()


@pytest.mark.parametrize("method", ["kernel1", "kernel2", "nipals", "simpls"])
def test_intervals_match_jax(method, toy):
    X, Y = toy
    ref = pt.bootstrap_coefficient_intervals(jnp.asarray(X), jnp.asarray(Y), 2, 24,
                                             jax.random.key(7), pt.METHOD(method), batch_size=5)
    mine = tt.bootstrap_coefficient_intervals(torch.from_numpy(X), torch.from_numpy(Y), 2, 24,
                                              jax_prng.key(7), tt.METHOD(method), batch_size=5)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    lower, upper, Bs = mine
    assert Bs.shape == (24, 15, 2) and bool((lower <= upper).all())


def test_intervals_nir_alpha_and_batches(nir):
    X, Y = nir
    ref = pt.bootstrap_coefficient_intervals(jnp.asarray(X), jnp.asarray(Y), 3, 40,
                                             jax.random.key(0), alpha=0.2)
    for bs in (None, 7):
        mine = tt.bootstrap_coefficient_intervals(torch.from_numpy(X), torch.from_numpy(Y), 3,
                                                  40, 0, alpha=0.2, batch_size=bs)
        for a, b in zip(mine, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


def test_model_bootstrap_matches_jax(toy):
    X, Y = toy
    ref = pt.PLSModel(jnp.asarray(X), jnp.asarray(Y), pt.KERNEL_TYPE1, 2)
    mine = tt.PLSModel(torch.from_numpy(X), torch.from_numpy(Y), tt.KERNEL_TYPE1, 2)
    for kw_ref, kw_mine in [({}, {}), (dict(key=jax.random.key(4), comp=1, alpha=0.1),
                                       dict(key=4, comp=1, alpha=0.1))]:
        a = mine.bootstrap_coefficient_intervals(30, batch_size=8, **kw_mine)
        b = ref.bootstrap_coefficient_intervals(30, batch_size=8, **kw_ref)
        for u, v in zip(a, b):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=0, atol=1e-10)


def test_weighted_fit_equals_resampled_fit(toy):
    """The algebra the bootstrap rests on: a √count-weighted fit equals the
    fit of the resampled rows (tests/test_bootstrap.py's check)."""
    X, Y = (torch.from_numpy(v) for v in toy)
    counts = torch.from_numpy(bootstrap_counts(9, 1, 10, True)[0])
    w = counts.double().sqrt()
    f_w = tt.fit_folds(X, Y, w[None], 2)
    idx = torch.repeat_interleave(torch.arange(10), counts)
    f_r = tt.fit(X[idx], Y[idx], 2)
    np.testing.assert_allclose(tt.coefficients(f_w)[0].numpy(), tt.coefficients(f_r).numpy(),
                               atol=1e-10)


def test_float32_draws_int32_unless_asked():
    X, Y = (torch.from_numpy(v) for v in (np.eye(6, 4) + 0.1, np.arange(6.0)[:, None]))
    b32 = tt.bootstrap_coefficients(X.float(), Y.float(), 2, 5, 1)
    b32_as64 = tt.bootstrap_coefficients(X.float(), Y.float(), 2, 5, 1, x64=True)
    b64 = tt.bootstrap_coefficients(X, Y, 2, 5, 1)
    b64_as32 = tt.bootstrap_coefficients(X, Y, 2, 5, 1, x64=False)
    np.testing.assert_allclose(b32.double().numpy(), b64_as32.numpy(), atol=1e-5)
    np.testing.assert_allclose(b32_as64.double().numpy(), b64.numpy(), atol=1e-5)
    assert not np.array_equal(bootstrap_counts(1, 5, 6, False), bootstrap_counts(1, 5, 6, True))
