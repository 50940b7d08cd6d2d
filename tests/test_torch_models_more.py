"""The port's model families multiblock, oplsda, plscox, recursive, npls and
o2pls against the JAX package.

Inputs are made from a seed with numpy; both packages fit in float64 on
the CPU.  States, block quantities, scores and predictions agree to 1e-10
relative to their scale, component signs aligned where a singular or
eigenvector's sign is free (O2PLS's SVD, OPLS-DA's dominant eigenvector
for three classes); class predictions are equal.
The Cox fits use tied times; their Newton steps are a fixed count, as in
the JAX package.  A JAX state carried across with
`convert.state_from_numpy` predicts what the JAX one predicts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu.models import multiblock as jmb, npls as jnpls, oplsda as joplsda
from pls_tpu_torch.convert import state_from_numpy
from pls_tpu_torch.models import multiblock as tmb, npls as tnpls, oplsda as toplsda

RTOL = 1e-10


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(mine, ref, rtol=RTOL, signs=False):
    mine, ref = _np(mine), _np(ref)
    assert mine.shape == ref.shape
    if not ref.size:
        return
    if signs:
        s = np.sign(np.sum(mine * ref, axis=0))
        mine = mine * np.where(s == 0, 1, s)
    np.testing.assert_allclose(mine, ref, atol=rtol * max(np.abs(ref).max(), 1e-300), rtol=0)


def _data(seed=0, n=50, k=12, m=2, a=3, noise=0.3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + noise * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + noise * rng.normal(size=(n, m))
    return (X - X.mean(0)) / X.std(0, ddof=1), (Y - Y.mean(0)) / Y.std(0, ddof=1)


def _same_fit(got, ref, rtol=RTOL):
    for f in ("W", "P", "Q", "R", "T"):
        _close(getattr(got, f), getattr(ref, f), rtol)


# ---------- multiblock ----------
@pytest.mark.parametrize("block_scale", [True, False])
@pytest.mark.parametrize("method", ["kernel1", "kernel2"])
def test_mbpls(block_scale, method):
    X, Y = _data(1, k=15)
    Xs = [X[:, :4], X[:, 4:11], X[:, 11:]]
    new = [x[:7] + 0.1 for x in Xs]
    ref = jmb.fit_mbpls([jnp.asarray(x) for x in Xs], jnp.asarray(Y), 3,
                        method=pt.METHOD(method), block_scale=block_scale)
    got = tt.fit_mbpls(Xs, Y, 3, method=tt.METHOD(method), block_scale=block_scale,
                       device="cpu")
    assert got.block_sizes == tuple(ref.block_sizes) and got.n_blocks == 3 and got.A == 3
    _same_fit(got.pls, ref.pls)
    _close(got.block_scales, ref.block_scales)
    for g, r in zip(tt.block_weights(got), jmb.block_weights(ref)):
        _close(g, r)
    _close(tt.block_scores(got, Xs), jmb.block_scores(ref, Xs))
    _close(tt.block_importance(got), jmb.block_importance(ref))
    for comp in (None, 2):
        _close(tt.predict_mbpls(got, new, comp), jmb.predict_mbpls(ref, new, comp))
    _close(tt.super_scores(got, new), jmb.super_scores(ref, new))
    back = state_from_numpy(tmb.MBPLSFit, ref, device="cpu")
    _close(tt.predict_mbpls(back, new), jmb.predict_mbpls(ref, new))


# ---------- oplsda ----------
def _classes(seed=2, n=60, k=10, n_classes=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    X = rng.normal(size=(n, k)) + 1.5 * np.eye(n_classes, k)[y]
    X[:, -1] += 2.0 * rng.normal(size=n)  # class-orthogonal variation
    return (X - X.mean(0)) / X.std(0, ddof=1), y


@pytest.mark.parametrize("n_classes,n_ortho,A", [(2, 1, 1), (3, 2, 2)])
def test_fit_oplsda(n_classes, n_ortho, A):
    X, y = _classes(n_classes=n_classes)
    ref = joplsda.fit_oplsda(jnp.asarray(X), jnp.asarray(y), n_classes, n_ortho, A)
    got = toplsda.fit_oplsda(torch.from_numpy(X), torch.from_numpy(y), n_classes, n_ortho, A)
    for f in ("W_o", "P_o", "T_o", "r2x_o"):
        _close(getattr(got, f), getattr(ref, f))
    _same_fit(got.pls, ref.pls)
    Xn = torch.from_numpy(X[:9] * 1.1)
    priors = np.full(n_classes, 1.0 / n_classes)
    _close(toplsda.decision_values(got, Xn), joplsda.decision_values(ref, jnp.asarray(X[:9] * 1.1)))
    assert np.array_equal(_np(toplsda.predict_classes(got, Xn, priors)),
                          np.asarray(joplsda.predict_classes(ref, jnp.asarray(X[:9] * 1.1),
                                                             jnp.asarray(priors))))
    _close(toplsda.predict_proba(got, Xn, comp=1),
           joplsda.predict_proba(ref, jnp.asarray(X[:9] * 1.1), comp=1))
    t = torch.from_numpy(X) @ got.pls.R[:, 0]
    for g, r in zip(tt.s_plot(torch.from_numpy(X), t), pt.s_plot(jnp.asarray(X), jnp.asarray(_np(t)))):
        _close(g, r)


@pytest.mark.parametrize("scale", [True, False])
def test_oplsda_classifier(scale):
    X, y = _classes(3, n_classes=3)
    labels = np.array(["a", "b", "c"])[y]
    ref = pt.OPLSDAClassifier(2, 1, scale=scale).fit(X, labels)
    got = tt.OPLSDAClassifier(2, 1, scale=scale, device="cpu").fit(X, labels)
    Xn = X[:11] + 0.2
    assert np.array_equal(got.classes_, ref.classes_)
    assert np.array_equal(got.predict(Xn), ref.predict(Xn))
    _close(got.decision_function(Xn), ref.decision_function(Xn))
    _close(got.predict_proba(Xn), ref.predict_proba(Xn))
    # three classes: the dominant eigenvector of XYᵀXY, and so the weights
    # it starts from (each predictive and orthogonal score, the S-plot),
    # has a free sign
    _close(got.transform(Xn), ref.transform(Xn), signs=True)
    _close(got.ortho_scores(Xn), ref.ortho_scores(Xn), signs=True)
    _close(got.r2x_ortho_, ref.r2x_ortho_)
    s = np.sign(np.sum(got.s_plot()[0] * ref.s_plot()[0]))
    for g, r in zip(got.s_plot(), ref.s_plot()):
        _close(s * g, r)
    assert got.score(X, labels) == ref.score(X, labels)


def test_oplsda_classifier_params_and_clone():
    sklearn_base = pytest.importorskip("sklearn.base")
    est = tt.OPLSDAClassifier(2, 3, device="cpu")
    assert est.get_params()["device"] == "cpu" and est.get_params()["n_ortho"] == 3
    c = sklearn_base.clone(est)
    assert c.device == "cpu" and c.n_components == 2
    with pytest.raises(ValueError, match="unknown parameter"):
        est.set_params(fit=1)
    assert sklearn_base.is_classifier(est)


# ---------- plscox ----------
def _survival(seed=4, n=80, k=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    risk = X[:, 0] - 0.5 * X[:, 1]
    time = np.round(rng.exponential(np.exp(-risk)), 1) + 0.1  # rounded: ties
    event = (rng.uniform(size=n) < 0.7).astype(float)
    return (X - X.mean(0)) / X.std(0, ddof=1), time, event


@pytest.mark.parametrize("A,n_newton", [(1, 20), (3, 10)])
def test_plscox(A, n_newton):
    X, time, event = _survival()
    assert len(np.unique(time)) < len(time)
    ref = pt.fit_plscox(X, time, event, A, n_newton=n_newton)
    got = tt.fit_plscox(X, time, event, A, n_newton=n_newton, device="cpu")
    _same_fit(got.pls, ref.pls)
    for f in ("gamma", "coef", "loglik"):
        _close(getattr(got, f), getattr(ref, f))
    # the gradient at the solution is rounding noise in both: held to its scale
    assert max(float(got.score_norm), float(ref.score_norm)) <= 1e-10 * abs(float(ref.loglik))
    _close(tt.predict_plscox(got, X[:5]), pt.predict_plscox(ref, X[:5]))
    risk = _np(tt.predict_plscox(got, X))
    assert tt.concordance_index(time, event, risk) == pytest.approx(
        pt.concordance_index(time, event, np.asarray(pt.predict_plscox(ref, X))), abs=1e-12)


def test_plscox_checks_event_before_the_device():
    X, time, event = _survival()
    with pytest.raises(ValueError, match="event and time disagree"):
        tt.fit_plscox(X, time, event[:-1], 2, device="cpu")
    with pytest.raises(ValueError, match="X and time disagree"):
        tt.fit_plscox(X[:-1], time, event, 2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tt.fit_plscox(X, time, event, 0, device="cpu")


@pytest.mark.parametrize("n", [1, 7])
def test_concordance_index(n):
    rng = np.random.default_rng(n)
    t, d, r = rng.integers(0, 5, n).astype(float), rng.integers(0, 2, n), rng.normal(size=n)
    assert tt.concordance_index(t, d, torch.from_numpy(r)) == pt.concordance_index(t, d, r)


# ---------- recursive ----------
@pytest.mark.parametrize("lam", [1.0, 0.9])
def test_recursive_pls(lam):
    X, Y = _data(5, n=90)
    ref = pt.RecursivePLS(12, 2, lam=lam, dtype=jnp.float64)
    got = tt.RecursivePLS(12, 2, lam=lam, dtype=torch.float64, device="cpu")
    for c in range(0, 90, 30):
        ref.update(X[c:c + 30], Y[c:c + 30])
        got.update(X[c:c + 30], Y[c:c + 30])
    _close(got.XX, ref.XX)
    _close(got.XY, ref.XY)
    assert float(got.n_eff) == pytest.approx(float(ref.n_eff), rel=1e-14)
    _same_fit(got.fit(3), ref.fit(3))
    with pytest.raises(ValueError, match="lam"):
        tt.RecursivePLS(3, 1, lam=0.0, device="cpu")


def test_recursive_pls_growing_window_is_the_batch_fit():
    X, Y = _data(6, n=60)
    r = tt.RecursivePLS(12, 2, dtype=torch.float64, device="cpu")
    for c in range(0, 60, 20):
        r.update(X[c:c + 20], Y[c:c + 20])
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    _same_fit(r.fit(3), tt.fit_from_stats(Xt.T @ Xt, Xt.T @ Yt, 3), 1e-9)


# ---------- npls ----------
@pytest.mark.parametrize("m", [1, 2])
def test_npls(m):
    rng = np.random.default_rng(7)
    a, b, c = rng.normal(size=(40, 2)), rng.normal(size=(5, 2)), rng.normal(size=(6, 2))
    X = np.einsum("ir,jr,kr->ijk", a, b, c) + 0.05 * rng.normal(size=(40, 5, 6))
    X -= X.mean(0)
    Y = a @ rng.normal(size=(2, m)) + 0.05 * rng.normal(size=(40, m))
    Y -= Y.mean(0)
    ref = jnpls.fit_npls(jnp.asarray(X), jnp.asarray(Y), 3)
    got = tt.fit_npls(X, Y, 3, device="cpu")
    for f in ("WJ", "WK", "T", "Q", "B"):
        _close(getattr(got, f), getattr(ref, f))
    assert got.method == ref.method and got.A == 3
    Xn = X[:6] * 0.9
    _close(tt.scores_npls(got, Xn), jnpls.scores_npls(ref, jnp.asarray(Xn)))
    _close(tt.predict_npls(got, Xn), jnpls.predict_npls(ref, jnp.asarray(Xn)))
    _close(tnpls.scores_npls(got, torch.from_numpy(X))[:, :2], _np(got.T)[:, :2], 1e-9)


# ---------- o2pls ----------
@pytest.mark.parametrize("n,nx,ny", [(1, 0, 0), (2, 1, 0), (2, 1, 2)])
def test_o2pls(n, nx, ny):
    rng = np.random.default_rng(8)
    L = rng.normal(size=(60, 2))
    X = np.hstack([L, rng.normal(size=(60, 2))]) @ rng.normal(size=(4, 14))
    X += 0.1 * rng.normal(size=X.shape)
    Y = np.hstack([L, rng.normal(size=(60, 1))]) @ rng.normal(size=(3, 5))
    Y += 0.1 * rng.normal(size=Y.shape)
    X, Y = X - X.mean(0), Y - Y.mean(0)
    ref = pt.fit_o2pls(X, Y, n, nx, ny)
    got = tt.fit_o2pls(X, Y, n, nx, ny, device="cpu")
    for f in ("W", "C", "T", "U", "W_Yosc", "P_Yosc", "T_Yosc", "C_Xosc", "Q_Xosc", "U_Xosc"):
        _close(getattr(got, f), getattr(ref, f), signs=True)
    for f in ("r2x_joint", "r2y_joint", "r2x_orth", "r2y_orth"):
        _close(getattr(got, f), getattr(ref, f))
    assert got.n_joint == n
    Xn, Yn = X[:8] + 0.3, Y[:8] - 0.2
    _close(tt.o2pls_predict_y(got, Xn), pt.o2pls_predict_y(ref, Xn))
    _close(tt.o2pls_predict_x(got, Yn), pt.o2pls_predict_x(ref, Yn))
    T, U = tt.o2pls_transform(got, Xn, Yn)
    Tr, Ur = pt.o2pls_transform(ref, Xn, Yn)
    _close(T, Tr, signs=True)
    _close(U, Ur, signs=True)
    assert tt.o2pls_transform(got, X_new=Xn)[1] is None


def test_o2pls_refusals():
    X, Y = _data(9)
    with pytest.raises(ValueError, match="n=3"):
        tt.fit_o2pls(X, Y, 3, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        tt.fit_o2pls(X[:-1], Y, 1, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        tt.fit_o2pls(X, Y, 1, -1, device="cpu")
