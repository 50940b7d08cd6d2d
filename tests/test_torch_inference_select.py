"""The port's inference (cv/inference.py), variable selection (select.py)
and `jax_prng.normal` against the JAX package and jax.random.

Inputs are made from a seed with numpy; both packages run in float64 on
the CPU.  Coefficients, standard errors, t, p, R² and RMSECV agree to
1e-10 relative to their scale; selections and picks are equal.  Batches
of every size give the same numbers: the port's batches of one are
un-batched fits, its larger ones `fit_folds`.

The uniforms under `jax_prng.normal`'s draws equal `jax.random.uniform`'s
bit for bit.  `normal` takes them through torch's erfinv where XLA has its own
polynomial: over 200 000 draws (seed 3) the largest difference from
`jax.random.normal` was 5.8e-6 of the value in float32 (91 units in the
last place, in the tails) and 7.6e-13 in float64; the bounds below are
NORMAL_RTOL.  UVE's reliability takes noise 1e-10 times those draws
(float64: within 1e-12 of JAX's each), and is held at UVE_RTOL, 100× that
bound; the largest difference read over nine cases was 1.1e-14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu_torch.utils import jax_prng

RTOL = 1e-10
NORMAL_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
UVE_RTOL = 1e-10


def _data(seed=0, n=40, k=24, m=2, a=3, noise=0.3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + noise * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + noise * rng.normal(size=(n, m))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    return X, Y


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(mine, ref, rtol=RTOL):
    mine, ref = _np(mine), _np(ref)
    assert mine.shape == ref.shape
    scale = max(np.abs(ref[np.isfinite(ref)]).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(mine, ref, atol=rtol * scale, rtol=0)


# ---------- jax_prng.normal ----------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 3, 2**40 + 5])
def test_uniform_bits_equal_jax(dtype, seed):
    """The floats in [1, 2) under `normal`'s draws, minus 1, are
    `jax.random.uniform`'s bit for bit, on the host and in torch."""
    k = jax.random.key(seed)
    kd = np.asarray(jax.random.key_data(k))
    for n in (1, 513):
        ref = np.asarray(jax.random.uniform(k, (n,), dtype))
        assert np.array_equal(jax_prng._unit_floats(kd, n, dtype) - dtype(1.0), ref)
        tdt = getattr(torch, np.dtype(dtype).name)
        assert np.array_equal(jax_prng._unit_floats_torch(kd, n, tdt, "cpu").numpy() - 1.0, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("on_torch", [False, True], ids=["numpy", "torch"])
def test_normal_within_measured_bound(dtype, seed, on_torch):
    k = jax.random.key(seed)
    ref = np.asarray(jax.random.normal(k, (300, 70), dtype))
    got = jax_prng.normal(jax.random.key_data(k), (300, 70), dtype,
                          device="cpu" if on_torch else None)
    got = _np(got)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= NORMAL_RTOL[dtype] * np.abs(ref))
    # the uniforms under the draws are JAX's exactly: most values agree to an ulp
    assert np.mean(np.abs(got - ref) <= np.spacing(np.abs(ref))) > 0.5


def test_normal_device_path_equals_numpy_path_across_chunks(monkeypatch):
    monkeypatch.setattr(jax_prng, "_CHUNK", 1000)  # several chunks of the device hash
    for dt in (np.float32, np.float64):
        a = jax_prng.normal(5, (77, 61), dt)
        b = jax_prng.normal(5, (77, 61), getattr(torch, np.dtype(dt).name), device="cpu")
        assert np.array_equal(a, b.numpy())


# ---------- cv/inference.py ----------
@pytest.mark.parametrize("batch_size", [None, 1, 7])
@pytest.mark.parametrize("comp", [None, 2])
def test_jackknife_and_significance(batch_size, comp):
    X, Y = _data(1)
    ref = pt.coefficient_significance(jnp.asarray(X), jnp.asarray(Y), 3, comp=comp)
    got = tt.coefficient_significance(X, Y, 3, comp=comp, batch_size=batch_size, device="cpu")
    for g, r in zip(got, ref):
        _close(g, r)
    Bs = tt.jackknife_coefficients(X, Y, 3, comp=comp, batch_size=batch_size, device="cpu")
    _close(Bs, pt.jackknife_coefficients(jnp.asarray(X), jnp.asarray(Y), 3, comp=comp))


@pytest.mark.parametrize("method", [pt.KERNEL_TYPE1, pt.KERNEL_TYPE2])
def test_jackknife_methods(method):
    X, Y = _data(2, n=25)
    tmethod = tt.METHOD(method.value)
    _close(tt.jackknife_coefficients(X, Y[:, 0], 2, tmethod, device="cpu"),
           pt.jackknife_coefficients(jnp.asarray(X), jnp.asarray(Y[:, 0]), 2, method))


@pytest.mark.parametrize("batch_size", [None, 1, 4])
@pytest.mark.parametrize("seed", [0, 11])
def test_permutation_test(batch_size, seed):
    X, Y = _data(3)
    r2, null, p = pt.permutation_test(jnp.asarray(X), jnp.asarray(Y), 3, 9,
                                      jax.random.key(seed), comp=2)
    g2, gnull, gp = tt.permutation_test(X, Y, 3, 9, seed, comp=2, batch_size=batch_size,
                                        device="cpu")
    _close(g2, r2)
    _close(gnull, null)
    assert float(gp) == pytest.approx(float(p), abs=1e-12)


def test_permutation_test_takes_key_data():
    X, Y = _data(4, n=30)
    k = jax.random.fold_in(jax.random.key(2), 5)
    ref = pt.permutation_test(jnp.asarray(X), jnp.asarray(Y[:, 0]), 2, 5, k)
    got = tt.permutation_test(X, Y[:, 0], 2, 5, np.asarray(jax.random.key_data(k)),
                              device="cpu")
    for g, r in zip(got, ref):
        _close(g, r)


# ---------- select.py ----------
@pytest.mark.parametrize("n_intervals", [1, 4, 7])
def test_interval_edges_and_masks(n_intervals):
    assert np.array_equal(tt.select.interval_edges(24, n_intervals),
                          pt.select.interval_edges(24, n_intervals))
    assert np.array_equal(tt.interval_masks(24, n_intervals),
                          pt.interval_masks(24, n_intervals))


@pytest.mark.parametrize("batch_size", [None, 1, 3])
@pytest.mark.parametrize("key", [0, None])
def test_ipls(batch_size, key):
    X, Y = _data(5, n=48, k=30)
    ref = pt.ipls(X, Y, n_intervals=5, A=3, k=4, key=key)
    got = tt.ipls(X, Y, n_intervals=5, A=3, k=4, key=key, batch_size=batch_size,
                  device="cpu")
    assert np.array_equal(got.edges, ref.edges)
    _close(got.rmsecv, ref.rmsecv)
    _close(got.global_rmsecv, ref.global_rmsecv)
    assert (got.best_interval, got.best_ncomp) == (ref.best_interval, ref.best_ncomp)
    assert got.summary() == ref.summary()


def test_ipls_refuses_a_too_wide_model():
    X, Y = _data(5, n=20, k=12)
    with pytest.raises(ValueError, match="smallest interval width"):
        tt.ipls(X, Y, n_intervals=6, A=3, device="cpu")


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("batch_size", [None, 1])
def test_ipls_greedy(forward, batch_size):
    X, Y = _data(6, n=45, k=30)
    # the response depends on two intervals only, so the searches move
    Y = X[:, [2, 3, 20]] @ np.array([[1.0], [0.5], [-0.8]]) + 0.1 * _data(7, n=45, k=1)[0]
    kw = dict(n_intervals=6, A=2, k=3, key=1)
    if forward:
        ref = pt.ipls_forward(X, Y, max_intervals=3, **kw)
        got = tt.ipls_forward(X, Y, max_intervals=3, batch_size=batch_size, device="cpu", **kw)
    else:
        ref = pt.ipls_backward(X, Y, **kw)
        got = tt.ipls_backward(X, Y, batch_size=batch_size, device="cpu", **kw)
    assert got.selected == ref.selected and got.ncomp == ref.ncomp
    assert np.array_equal(got.mask, ref.mask)
    assert got.n_selected_channels == ref.n_selected_channels
    _close(got.rmsecv_path, ref.rmsecv_path)


@pytest.mark.parametrize("k,batch_size", [(None, None), (5, None), (5, 1), (4, 3)])
def test_uve_pls(k, batch_size):
    X, Y = _data(8, n=30, k=12)
    X[:, 6:] = np.random.default_rng(9).normal(size=(30, 6))  # uninformative half
    ref = pt.uve_pls(X, Y, 2, k, key=4)
    got = tt.uve_pls(X, Y, 2, k, key=4, batch_size=batch_size, device="cpu")
    _close(got.reliability, ref.reliability, UVE_RTOL)
    assert got.cutoff == pytest.approx(ref.cutoff, rel=UVE_RTOL)
    assert np.array_equal(got.selected, ref.selected)
    assert 0 < got.selected.sum() < 12


def test_batch_size_defaults_are_capped_by_the_budget():
    from pls_tpu_torch.utils.batching import fold_batch_size

    small, big = torch.zeros(40, 24), torch.zeros(10_000, 5_000)
    assert fold_batch_size(10, small, cap=8) == 8  # the JAX default, where it fits
    assert fold_batch_size(10, big, cap=8) == 1  # one un-batched fit past 128 MiB
    assert fold_batch_size(10, big, 4, cap=8) == 4  # a caller's size is taken as given
