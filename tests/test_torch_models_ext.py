"""The port's model families behind the estimators against the JAX package:
robust (IRPLS), sparse, OPLS, kernel PLS, cross-decomposition (PLS-
canonical, CCA, PLS-SVD), PLS-GLM and PLS-DA.

Inputs are made from a seed with numpy; both packages fit in float64 on
the CPU.  The fits' states, weights and predictions agree to 1e-9
relative to their scale (1e-8 for the iterative fits whose loops compound
the rounding: IRLS weights, PLS-GLM, CCA's power iteration), component
signs aligned where an eigenvector's sign is free.  A JAX state carried
across with `convert.state_from_numpy` (OPLSFit, KPLSFit, CDFit,
PLSGLMFit) predicts what the JAX one predicts.  Mode B's pseudo-inverse
takes `jnp.linalg.pinv`'s cutoff: on a rank-deficient block it equals
JAX's where torch's default cutoff would not drop the null directions.
The `gpu` cases check that the IRLS fits launch K1 on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu.models import plsda as jplsda
from pls_tpu_torch.convert import state_from_numpy
from pls_tpu_torch.models import crossdecomp as tcd
from pls_tpu_torch.models import plsda as tplsda


def _data(seed=0, n=50, k=10, m=2, a=3, noise=0.3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + noise * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + noise * rng.normal(size=(n, m))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    return X, Y, rng.normal(size=(6, k))


def _T(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _J(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(mine, ref, rtol=1e-9, signs=False):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    ref = np.asarray(ref)
    assert mine.shape == ref.shape
    if not ref.size:
        return
    if signs:
        s = np.sign(np.sum(mine * ref, axis=0))
        s[s == 0] = 1
        mine = mine * s
    np.testing.assert_allclose(mine, ref, atol=rtol * max(np.abs(ref).max(), 1e-300))


# ---------- robust ----------
@pytest.mark.parametrize("loss,method", [("huber", "kernel1"), ("bisquare", "kernel2"),
                                         ("huber", "nipals")])
def test_fit_robust_matches_jax(loss, method):
    X, Y, _ = _data(seed=1)
    Y[:3] += 8.0  # three gross outliers
    ft, wt = tt.fit_robust(*_T(X, Y), 3, tt.METHOD(method), loss=loss, n_irls=6)
    fj, wj = pt.fit_robust(*_J(X, Y), 3, pt.METHOD(method), loss=loss, n_irls=6)
    _close(wt, wj, 1e-8)
    _close(tt.coefficients(ft), pt.coefficients(fj), 1e-8)
    assert (wt[:3] < 0.5).all() and wt.numpy().min() >= 0.0


def test_robust_median_of_even_count_averages():
    from pls_tpu_torch.models.robust import _median

    assert float(_median(torch.tensor([1.0, 2.0, 3.0, 10.0]))) == float(
        jnp.median(jnp.asarray([1.0, 2.0, 3.0, 10.0])))


# ---------- sparse ----------
@pytest.mark.parametrize("keep_x,keep_y", [(4, None), ((10, 3, 5), 1), (10, 2)])
def test_fit_spls_matches_jax(keep_x, keep_y):
    X, Y, Xn = _data(seed=2)
    ft = tt.fit_spls(*_T(X, Y), 3, keep_x, keep_y, n_iter=15)
    fj = pt.fit_spls(*_J(X, Y), 3, keep_x, keep_y, n_iter=15)
    for name in ("W", "P", "Q", "R", "T"):
        _close(getattr(ft, name), getattr(fj, name))
    np.testing.assert_array_equal(tt.selected_variables(ft).numpy(),
                                  np.asarray(pt.selected_variables(fj)))
    assert ft.method == tt.SPLS
    _close(tt.fitted_values(ft, torch.as_tensor(Xn)), pt.fitted_values(fj, jnp.asarray(Xn)))


def test_spls_refuses_bad_keeps():
    X, Y, _ = _data()
    with pytest.raises(ValueError, match="length A"):
        tt.fit_spls(*_T(X, Y), 3, (2, 2))
    with pytest.raises(ValueError, match=">= 1"):
        tt.fit_spls(*_T(X, Y), 2, 0)


# ---------- OPLS ----------
@pytest.mark.parametrize("n_ortho,A,m", [(2, 1, 1), (1, 2, 3), (0, 2, 2)])
def test_fit_opls_matches_jax(n_ortho, A, m):
    X, Y, Xn = _data(seed=3, m=m)
    ft = tt.fit_opls(*_T(X, Y), n_ortho, A)
    fj = pt.fit_opls(*_J(X, Y), n_ortho, A)
    for name in ("W_o", "P_o", "T_o", "r2x_o"):
        _close(getattr(ft, name), getattr(fj, name), signs=name != "r2x_o")
    _close(tt.coefficients(ft.pls), pt.coefficients(fj.pls))
    _close(tt.opls_predict(ft, torch.as_tensor(Xn)), pt.opls_predict(fj, jnp.asarray(Xn)))
    Xf, To = tt.opls_correct(ft, torch.as_tensor(Xn))
    Xfj, Toj = pt.opls_correct(fj, jnp.asarray(Xn))
    _close(Xf, Xfj)
    _close(To, Toj, signs=True)
    carried = state_from_numpy(tt.OPLSFit, fj, device="cpu")
    _close(tt.opls_predict(carried, torch.as_tensor(Xn)), pt.opls_predict(fj, jnp.asarray(Xn)))


# ---------- kernel PLS ----------
@pytest.mark.parametrize("kernel,kw,m", [("rbf", {}, 1), ("rbf", {"gamma": 0.3}, 2),
                                         ("poly", {"degree": 2, "coef0": 0.5}, 2),
                                         ("linear", {}, 1)])
def test_fit_kpls_matches_jax(kernel, kw, m):
    X, Y, Xn = _data(seed=4, m=m)
    _close(tt.kernel_matrix(*_T(X, Xn), kernel, **kw), pt.kernel_matrix(*_J(X, Xn), kernel, **kw))
    ft = tt.fit_kpls(*_T(X, Y), 3, kernel, **kw)
    fj = pt.fit_kpls(*_J(X, Y), 3, kernel, **kw)
    _close(ft.T, fj.T, signs=True)
    _close(ft.U, fj.U, signs=True)
    for comp in (None, 2):
        _close(tt.predict_kpls(ft, torch.as_tensor(Xn), comp),
               pt.predict_kpls(fj, jnp.asarray(Xn), comp))
    carried = state_from_numpy(tt.KPLSFit, fj, device="cpu")
    assert carried.kernel == kernel and carried.gamma == kw.get("gamma")
    _close(tt.predict_kpls(carried, torch.as_tensor(Xn)), pt.predict_kpls(fj, jnp.asarray(Xn)))


def test_kpls_refuses_a_out_of_range():
    X, Y, _ = _data(n=5)
    with pytest.raises(ValueError, match="0 < A < N"):
        tt.fit_kpls(*_T(X, Y), 5)


# ---------- cross-decomposition ----------
@pytest.mark.parametrize("kind", ["canonical", "cca", "svd"])
def test_crossdecomp_matches_jax(kind):
    X, Y, Xn = _data(seed=5, k=6, m=3)
    fit_t = {"canonical": tt.fit_plscanonical, "cca": tt.fit_cca, "svd": tt.fit_plssvd}[kind]
    fit_j = {"canonical": pt.fit_plscanonical, "cca": pt.fit_cca, "svd": pt.fit_plssvd}[kind]
    ft, fj = fit_t(*_T(X, Y), 2), fit_j(*_J(X, Y), 2)
    assert ft.mode == fj.mode
    for name in ("W", "C", "P", "Q", "T", "U", "R", "Ry"):
        _close(getattr(ft, name), getattr(fj, name), 1e-8)  # the sign fix leaves no freedom
    _close(tt.cd_coefficients(ft), pt.cd_coefficients(fj), 1e-8)
    _close(tt.cd_predict(ft, torch.as_tensor(Xn)), pt.cd_predict(fj, jnp.asarray(Xn)), 1e-8)
    xs, ys = tt.cd_transform(ft, torch.as_tensor(Xn), torch.as_tensor(Xn[:, :3]))
    xj, yj = pt.cd_transform(fj, jnp.asarray(Xn), jnp.asarray(Xn[:, :3]))
    _close(xs, xj, 1e-8)
    _close(ys, yj, 1e-8)
    carried = state_from_numpy(tt.CDFit, fj, device="cpu")
    _close(tt.cd_predict(carried, torch.as_tensor(Xn)), pt.cd_predict(fj, jnp.asarray(Xn)))


def test_power_iteration_counts_host_reads():
    X, Y, _ = _data(seed=6, k=6, m=3)
    tcd.counts["host_reads"] = 0
    tt.fit_plscanonical(*_T(X, Y), 2, max_iter=3)
    assert tcd.counts["host_reads"] == 2 * 3  # capped: three tests a component


def test_pinv_takes_jax_cutoff_on_a_rank_deficient_block():
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.normal(size=(40, 6)))
    V, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    # three singular values 3e-14 of the largest: below JAX's cutoff
    # (10·40·eps = 8.9e-14) but above torch's default (40·eps = 8.9e-15)
    B = (U * np.array([1.0, 0.5, 0.2, 3e-14, 3e-14, 3e-14])) @ V.T
    mine = tcd.pinv(torch.as_tensor(B)).numpy()
    ref = np.asarray(jnp.linalg.pinv(jnp.asarray(B)))
    np.testing.assert_allclose(mine, ref, atol=1e-8 * np.abs(ref).max())
    assert np.linalg.matrix_rank(mine, tol=1e-6 * np.abs(mine).max()) == 3
    torch_default = torch.linalg.pinv(torch.as_tensor(B)).numpy()
    assert np.abs(torch_default - ref).max() > 1e3 * np.abs(ref).max()


def test_cca_on_a_rank_deficient_block_matches_jax():
    rng = np.random.default_rng(8)
    L = rng.normal(size=(30, 2))
    X = np.hstack([L @ rng.normal(size=(2, 4)), rng.normal(size=(30, 2))])
    X = np.hstack([X, X[:, :1] + X[:, 1:2]])  # an exactly dependent column
    Y = L @ rng.normal(size=(2, 2)) + 0.2 * rng.normal(size=(30, 2))
    X, Y = X - X.mean(0), Y - Y.mean(0)
    ft, fj = tt.fit_cca(*_T(X, Y), 2), pt.fit_cca(*_J(X, Y), 2)
    _close(tt.cd_coefficients(ft), pt.cd_coefficients(fj), 1e-7)


# ---------- PLS-GLM ----------
@pytest.mark.parametrize("family,A", [("binomial", 2), ("binomial", 10), ("poisson", 3)])
def test_fit_plsglm_matches_jax(family, A):
    X, Y, Xn = _data(seed=9, n=80)
    eta = X[:, :3] @ np.array([1.0, -0.7, 0.4])
    rng = np.random.default_rng(9)
    y = (rng.uniform(size=80) < 1 / (1 + np.exp(-eta))).astype(float) if family == "binomial" \
        else rng.poisson(np.exp(0.3 * eta)).astype(float)
    ft = tt.fit_plsglm(torch.as_tensor(X), torch.as_tensor(y), A, family, n_irls=12)
    fj = pt.fit_plsglm(jnp.asarray(X), jnp.asarray(y), A, family, n_irls=12)
    _close(ft.coef, fj.coef, 1e-8)
    _close(ft.intercept, fj.intercept, 1e-8)
    _close(ft.deviance, fj.deviance, 1e-8)
    for linear in (False, True):
        _close(tt.predict_plsglm(ft, torch.as_tensor(Xn), linear=linear),
               pt.predict_plsglm(fj, jnp.asarray(Xn), linear=linear), 1e-8)
    carried = state_from_numpy(tt.PLSGLMFit, fj, device="cpu")
    assert carried.family == family and carried.pls.method == tt.KERNEL_TYPE1
    _close(tt.predict_plsglm(carried, torch.as_tensor(Xn)), pt.predict_plsglm(fj, jnp.asarray(Xn)))


# ---------- PLS-DA ----------
def test_plsda_functions_match_jax():
    X, _, Xn = _data(seed=10, n=60)
    labels = np.argmax(X[:, :3], axis=1)
    ft = tplsda.fit_plsda(torch.as_tensor(X), torch.as_tensor(labels), 3, 2)
    fj = jplsda.fit_plsda(jnp.asarray(X), jnp.asarray(labels), 3, 2)
    _close(tt.coefficients(ft), pt.coefficients(fj))
    pri = np.array([0.2, 0.3, 0.5])
    for comp in (None, 1):
        _close(tplsda.decision_values(ft, torch.as_tensor(Xn), comp),
               jplsda.decision_values(fj, jnp.asarray(Xn), comp))
        np.testing.assert_array_equal(
            tplsda.predict_classes(ft, torch.as_tensor(Xn), torch.as_tensor(pri), comp).numpy(),
            np.asarray(jplsda.predict_classes(fj, jnp.asarray(Xn), jnp.asarray(pri), comp)))
        _close(tplsda.predict_proba(ft, torch.as_tensor(Xn), None, comp),
               jplsda.predict_proba(fj, jnp.asarray(Xn), None, comp))
    oh = tplsda.one_hot(torch.tensor([0, 2, 1]), 3, torch.float64)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(jplsda.one_hot(jnp.asarray([0, 2, 1]), 3)))


# ---------- on the card ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from pls_tpu_torch.ops import deflate

    return deflate


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["robust", "plsglm"])
def test_irls_fits_launch_k1_per_reweighting(family):
    deflate = _card()
    X, Y, _ = _data(seed=11, n=500, k=64)
    dev = torch.device("cuda", 0)
    Xc, Yc = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (X, Y))
    before = deflate.launches["deflate_f32"]
    if family == "robust":
        f, w = tt.fit_robust(Xc, Yc, 3, n_irls=4)
        ref, wref = tt.fit_robust(*_T(X, Y), 3, n_irls=4)
        assert deflate.launches["deflate_f32"] - before == 3 * 5  # n_irls + 1 fits
        np.testing.assert_allclose(w.cpu().numpy(), wref.numpy(), atol=1e-3)
    else:
        y = (Y[:, 0] > 0).astype(float)
        f = tt.fit_plsglm(Xc, torch.as_tensor(y, device=dev), 3, n_irls=5).pls
        ref = tt.fit_plsglm(torch.as_tensor(X), torch.as_tensor(y), 3, n_irls=5).pls
        assert deflate.launches["deflate_f32"] - before == 3 * 5
    B, Bref = tt.coefficients(f).cpu().numpy(), tt.coefficients(ref).numpy()
    np.testing.assert_allclose(B, Bref, atol=1e-3 * np.abs(Bref).max())
