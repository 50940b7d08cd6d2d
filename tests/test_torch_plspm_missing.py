"""The port's PLS path modelling (models/plspm.py) and missing-data PLS
(models/missing.py) against the JAX package.

Inputs are made from a seed with numpy; both packages run in float64 on
the CPU.  Weights, scores, loadings, paths, R², GoF and the bootstrap's
statistics agree to 1e-10 relative to their scale; the fixed-point loops
stop at the same iteration count (`n_iter`), and each bootstrap replicate
of the port's batch equals its own un-batched fit, as under the JAX
package's vmap.  The NaN-tolerant NIPALS, its scoring and prediction and
the EM imputation agree to 1e-10; its inner loops' tolerance test stops
both at the same iteration, which the states' agreement shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu.models import missing as jmissing
from pls_tpu_torch.models import missing as tmissing
from pls_tpu_torch.utils import jax_prng

RTOL = 1e-10


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(mine, ref, rtol=RTOL):
    mine, ref = _np(mine), _np(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=rtol * max(np.abs(ref).max(), 1e-300), rtol=0)


# ---------- plspm ----------
def _sem(seed=0, n=120):
    """Three latent variables (ξ → η1 → η2, ξ → η2), four blocks of three
    indicators (the last one measured by nothing in the model), z-scored."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=n)
    eta1 = 0.7 * xi + 0.5 * rng.normal(size=n)
    eta2 = 0.4 * xi + 0.5 * eta1 + 0.5 * rng.normal(size=n)
    cols = [lv[:, None] * rng.uniform(0.6, 1.0, 3) + 0.5 * rng.normal(size=(n, 3))
            for lv in (xi, eta1, eta2)]
    X = np.hstack(cols + [rng.normal(size=(n, 2))])
    X = (X - X.mean(0)) / X.std(0)
    blocks = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    path = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0]])
    return X, blocks, path


FIELDS = ("W", "scores", "loadings", "paths", "r2", "communality", "gof")


@pytest.mark.parametrize("scheme", ["centroid", "factorial", "path"])
@pytest.mark.parametrize("modes", ["A", ["A", "B", "A"], "B"])
def test_fit_plspm(scheme, modes):
    X, blocks, path = _sem(1)
    ref = pt.fit_plspm(X, blocks, path, modes=modes, scheme=scheme)
    got = tt.fit_plspm(X, blocks, path, modes=modes, scheme=scheme, device="cpu")
    for f in FIELDS:
        _close(getattr(got, f), getattr(ref, f))
    assert int(got.n_iter) == int(ref.n_iter) and bool(got.converged) == bool(ref.converged)
    _close(tt.plspm_scores(got, X[:7]), pt.plspm_scores(ref, X[:7]))


def test_fit_plspm_stopped_by_max_iter():
    X, blocks, path = _sem(2)
    ref = pt.fit_plspm(X, blocks, path, max_iter=2, tol=0.0)
    got = tt.fit_plspm(X, blocks, path, max_iter=2, tol=0.0, device="cpu")
    assert int(got.n_iter) == int(ref.n_iter) == 2 and not bool(got.converged)
    for f in FIELDS:
        _close(getattr(got, f), getattr(ref, f))


def test_plspm_refusals():
    X, blocks, path = _sem(3)
    with pytest.raises(ValueError, match="two blocks"):
        tt.fit_plspm(X, [[0, 1], [1, 2], [3]], path, device="cpu")
    with pytest.raises(ValueError, match="lower-triangular"):
        tt.fit_plspm(X, blocks, path.T, device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        tt.fit_plspm(X, blocks, path, scheme="mean", device="cpu")
    with pytest.raises(ValueError, match="modes"):
        tt.fit_plspm(X, blocks, path, modes=["A", "B"], device="cpu")


@pytest.mark.parametrize("scheme,modes", [("centroid", "A"), ("path", ["A", "B", "A"])])
def test_bootstrap_plspm(scheme, modes):
    X, blocks, path = _sem(4, n=60)
    ref = pt.bootstrap_plspm(X, blocks, path, 12, key=3, modes=modes, scheme=scheme)
    got = tt.bootstrap_plspm(X, blocks, path, 12, key=3, modes=modes, scheme=scheme,
                             device="cpu")
    for f in ("paths_se", "paths_lo", "paths_hi", "paths_t", "loadings_se", "samples"):
        _close(getattr(got, f), getattr(ref, f))


def test_bootstrap_replicates_equal_their_own_fits():
    """The batch's slowest replicate sets the iterations; the others keep
    their converged state, as each replicate's un-batched fit."""
    X, blocks, path = _sem(5, n=50)
    got = tt.bootstrap_plspm(X, blocks, path, 6, key=jax.random.key_data(jax.random.key(1)),
                             device="cpu")
    idx = jax_prng.randint(jax_prng.key(1), (6, 50), 0, 50, np.int64)
    iters = []
    for b in range(6):
        Xb = X[idx[b]]
        Xb = (Xb - Xb.mean(0)) / np.where(Xb.std(0) == 0, 1.0, Xb.std(0))
        one = tt.fit_plspm(Xb, blocks, path, device="cpu")
        iters.append(int(one.n_iter))
        _close(got.samples[b], one.paths)
    assert len(set(iters)) > 1  # replicates converge at different iterations


# ---------- missing ----------
def _gappy(seed=6, n=40, k=10, frac=0.1):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3))
    X = L @ rng.normal(size=(3, k)) + 0.2 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(3, 2)) + 0.2 * rng.normal(size=(n, 2))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    Xn = X.copy()
    Xn[rng.uniform(size=X.shape) < frac] = np.nan
    return X, Xn, Y


def test_nan_column_stats():
    _, Xn, _ = _gappy()
    Xn[:, 3] = np.nan  # a column with nothing present
    Xn[1:, 4] = np.nan  # one present value
    Xn[:, 5] = 2.0  # constant
    for g, r in zip(tt.nan_column_stats(Xn, device="cpu"), pt.nan_column_stats(jnp.asarray(Xn))):
        _close(g, r)


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25])
@pytest.mark.parametrize("A", [1, 3])
def test_fit_nipals_missing(frac, A):
    _, Xn, Y = _gappy(7, frac=frac)
    Yn = Y.copy()
    Yn[2, 1] = np.nan
    ref = jmissing.fit_nipals_missing(jnp.asarray(Xn), jnp.asarray(Yn), A)
    got = tt.fit_nipals_missing(Xn, Yn, A, device="cpu")
    for f in ("W", "P", "Q", "R", "T"):
        _close(getattr(got, f), getattr(ref, f))
    assert got.method == tt.NIPALS and len(tmissing.last_iterations) == A
    _close(tt.scores_missing(got, Xn[:9]), pt.scores_missing(ref, jnp.asarray(Xn[:9])))
    _close(tt.predict_missing(got, Xn[:9]), pt.predict_missing(ref, jnp.asarray(Xn[:9])))


def test_fit_nipals_missing_without_gaps_is_nipals():
    X, _, Y = _gappy(8)
    got = tt.fit_nipals_missing(X, Y, 3, device="cpu")
    ref = tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 3, tt.NIPALS)
    for f in ("W", "P", "Q", "T"):
        _close(getattr(got, f), getattr(ref, f), 1e-9)


def test_fit_nipals_missing_iteration_cap():
    _, Xn, Y = _gappy(9)
    ref = jmissing.fit_nipals_missing(jnp.asarray(Xn), jnp.asarray(Y), 2, max_iter=3)
    got = tt.fit_nipals_missing(Xn, Y, 2, max_iter=3, device="cpu")
    assert tmissing.last_iterations == [3, 3]
    for f in ("W", "P", "Q", "R", "T"):
        _close(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("n_outer", [1, 5])
def test_impute_pls(n_outer):
    _, Xn, Y = _gappy(10, frac=0.15)
    Xr, fr = pt.impute_pls(jnp.asarray(Xn), jnp.asarray(Y), 2, n_outer=n_outer)
    Xg, fg = tt.impute_pls(Xn, Y, 2, n_outer=n_outer, device="cpu")
    _close(Xg, Xr)
    for f in ("W", "P", "Q", "R", "T"):
        _close(getattr(fg, f), getattr(fr, f))
    present = np.isfinite(Xn)
    assert np.array_equal(_np(Xg)[present], Xn[present])
