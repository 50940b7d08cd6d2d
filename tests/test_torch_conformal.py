"""The port's conformal prediction intervals (cv/conformal.py) against the
JAX package.

Inputs are made from a seed with numpy; both packages run in float64 on
the CPU.  jackknife+, CV+ and split conformal give the same (lo, hi, pred)
to 1e-10 (relative to the responses' scale), for the default key 0 and a
given key; CV+'s fold labels and split conformal's permutation are
index-for-index those of `jax.random.permutation`.  Coverage on held-out
rows is checked as the JAX package's own tests do.  The `gpu` case runs
split conformal in float32 on the card (its one fit launches K1 A times)
against the float64 CPU run.
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


def _data(n=60, k=8, m=2, n_new=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + n_new, k))
    Y = X @ rng.normal(size=(k, m)) + 0.5 * rng.normal(size=(n + n_new, m))
    X, Y = X - X[:n].mean(0), Y - Y[:n].mean(0)
    return X[:n], Y[:n], X[n:], Y[n:]


def _close(mine, ref):
    mine, ref = mine.numpy(), np.asarray(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=RTOL * np.abs(ref).max())


def _both(fn_name, X, Y, Xn, A, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "key" in kw:
        jkw["key"] = jax.random.key(kw["key"])
    mine = getattr(tt, fn_name)(torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(Xn), A,
                                **tkw)
    ref = getattr(pt, fn_name)(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xn), A, **jkw)
    return mine, ref


@pytest.mark.parametrize("kw", [{}, {"alpha": 0.2, "comp": 2}, {"batch_size": 7}],
                         ids=["default", "alpha_comp", "batches"])
def test_jackknife_plus_matches_jax(kw):
    X, Y, Xn, _ = _data()
    mine, ref = _both("jackknife_plus_intervals", X, Y, Xn, 3, **kw)
    for a, b in zip(mine, ref):
        _close(a, b)


@pytest.mark.parametrize("kw", [{}, {"n_folds": 7, "key": 3}, {"alpha": 0.05, "comp": 1}],
                         ids=["default", "folds_key", "alpha_comp"])
def test_cv_plus_matches_jax(kw):
    X, Y, Xn, _ = _data()
    mine, ref = _both("cv_plus_intervals", X, Y, Xn, 3, **kw)
    for a, b in zip(mine, ref):
        _close(a, b)


@pytest.mark.parametrize("kw", [{}, {"calib_frac": 0.5, "key": 11}, {"alpha": 0.3},
                                {"method": "kernel2"}],
                         ids=["default", "frac_key", "alpha", "kernel2"])
def test_split_conformal_matches_jax(kw):
    X, Y, Xn, _ = _data()
    if "method" in kw:
        mine = tt.split_conformal_intervals(torch.as_tensor(X), torch.as_tensor(Y),
                                            torch.as_tensor(Xn), 3, method=tt.KERNEL_TYPE2)
        ref = pt.split_conformal_intervals(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xn), 3,
                                           method=pt.KERNEL_TYPE2)
    else:
        mine, ref = _both("split_conformal_intervals", X, Y, Xn, 3, **kw)
    for a, b in zip(mine, ref):
        _close(a, b)


@pytest.mark.parametrize("N,n_folds,seed", [(60, 10, 0), (37, 4, 5), (1000, 10, 123)])
def test_fold_labels_and_split_permutation_equal_jax(N, n_folds, seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(
        jax_prng.permutation(seed, np.arange(N) % n_folds),
        np.asarray(jax.random.permutation(k, jnp.arange(N) % n_folds)))
    np.testing.assert_array_equal(jax_prng.permutation(seed, N),
                                  np.asarray(jax.random.permutation(k, N)))


def test_coverage_and_ordering():
    X, Y, Xn, Yn = _data(n=200, n_new=300, m=1, seed=4)
    for fn in (tt.jackknife_plus_intervals, tt.cv_plus_intervals, tt.split_conformal_intervals):
        lo, hi, pred = (v.numpy() for v in fn(torch.as_tensor(X), torch.as_tensor(Y),
                                               torch.as_tensor(Xn), 4, alpha=0.1))
        assert lo.shape == hi.shape == pred.shape == Yn.shape
        assert (hi >= lo).all()
        assert ((Yn >= lo) & (Yn <= hi)).mean() >= 0.8  # ≥ 1 − 2α, the guarantee


def test_needs_the_card_without_tensors():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy data goes to it")
    X, Y, Xn, _ = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.split_conformal_intervals(X, Y, Xn, 2)


@pytest.mark.gpu
def test_split_conformal_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from pls_tpu_torch.ops import deflate

    X, Y, Xn, _ = _data(n=400, k=64)
    dev = torch.device("cuda", 0)
    before = deflate.launches["deflate_f32"]
    mine = tt.split_conformal_intervals(*(torch.as_tensor(v, dtype=torch.float32, device=dev)
                                          for v in (X, Y, Xn)), 3)
    assert deflate.launches["deflate_f32"] - before == 3
    ref = tt.split_conformal_intervals(torch.as_tensor(X), torch.as_tensor(Y),
                                       torch.as_tensor(Xn), 3)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4 * b.abs().max().item())
