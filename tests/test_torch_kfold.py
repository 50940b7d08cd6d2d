"""The port's statistics-path fits and cross-validation against the JAX package.

Same numpy inputs (a z-scored synthetic set with M = 1 and M = 2, and the
toy data) through `pls_tpu` and `pls_tpu_torch` in float64 on the CPU:
the three `fit_from_stats*` fits, downdated LOO/LSO, k-fold by masked
refits, by block downdates and from streamed statistics, the one-pass
k-fold (PRESS, MSE, RMSE, B) and its residual pass, leave-group-out,
`compare_models`/`q_squared`/`rmsep` and the PLSModel entry points.
Errors, coefficients and summaries agree to 1e-10 (relative to the
largest entry); the selector's choices and labels are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu.cv.kfold as jk
import pls_tpu.cv.loo as jloo
import pls_tpu.cv.lso as jlso
import pls_tpu.cv.validation as jval
import pls_tpu.models.kernel_pls as jkp
import pls_tpu.models.streaming as js
import pls_tpu_torch as tt

TOL = 1e-10


def _synthetic(m=2, n=40, k=10, seed=3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3))
    X = L @ rng.normal(size=(3, k)) + 0.3 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(3, m)) + 0.3 * rng.normal(size=(n, m))
    return (X - X.mean(0)) / X.std(0, ddof=1), (Y - Y.mean(0)) / Y.std(0, ddof=1)


def _close(mine, ref, tol=TOL):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    ref = np.asarray(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _residuals(mine: tt.Residual, ref, tol=TOL):
    assert mine.method == ref.method
    _close(mine.errors, ref.errors, tol)
    assert np.array_equal(tt.optimal_num_components(mine).numpy(),
                          np.asarray(pt.optimal_num_components(ref)))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("m", [1, 2])
def test_fit_from_stats_family(m):
    X, Y = _synthetic(m)
    XX, XY = X.T @ X, X.T @ Y
    A = 4
    mine = tt.fit_from_stats(*_t(XX, XY), A)
    ref = jkp.fit_from_stats(*_j(XX, XY), A)
    _close(tt.coefficients(mine), pt.coefficients(ref))
    # the type-2 fit from X itself gives the same model
    _close(tt.coefficients(tt.fit(*_t(X, Y), A, tt.KERNEL_TYPE2)), pt.coefficients(ref))
    x, y = X[5], Y[5]
    mine = tt.fit_from_stats_downdated(*_t(XX, XY, x, y), A)
    ref = jkp.fit_from_stats_downdated(*_j(XX, XY, x, y), A)
    _close(tt.coefficients(mine), pt.coefficients(ref))
    Xf, Yf = X[7:15], Y[7:15]
    mine = tt.fit_from_stats_blockdowndated(*_t(XX, XY, Xf, Yf), A)
    ref = jkp.fit_from_stats_blockdowndated(*_j(XX, XY, Xf, Yf), A)
    _close(tt.coefficients(mine), pt.coefficients(ref))
    explicit = tt.fit_from_stats(*_t(XX - Xf.T @ Xf, XY - Xf.T @ Yf), A)
    _close(tt.coefficients(mine), tt.coefficients(explicit).numpy())
    if m == 1:  # no eigenvector sign: the state itself agrees
        for name in ("W", "P", "Q", "R"):
            _close(getattr(mine, name), getattr(ref, name))


def test_fit_from_stats_batched_folds_and_bf16():
    X, Y = _synthetic(2)
    XX, XY = _t(X.T @ X, X.T @ Y)
    Xt, Yt = _t(X, Y)
    batched = tt.fit_from_stats_downdated(XX, XY, Xt[:3], Yt[:3], 3)
    for i in range(3):
        one = tt.fit_from_stats_downdated(XX, XY, Xt[i], Yt[i], 3)
        _close(tt.coefficients(batched)[i], tt.coefficients(one).numpy())
    # bf16 fold block: float32 products on bf16-rounded operands, as the JAX package
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    Xb = torch.from_numpy(X32[7:15]).to(torch.bfloat16)
    mine = tt.fit_from_stats_blockdowndated(*_t(X32.T @ X32, X32.T @ Y32), Xb,
                                            torch.from_numpy(Y32[7:15]), 3)
    ref = jkp.fit_from_stats_blockdowndated(*_j(X32.T @ X32, X32.T @ Y32),
                                            jnp.asarray(X32[7:15], jnp.bfloat16),
                                            jnp.asarray(Y32[7:15]), 3)
    _close(tt.coefficients(mine), pt.coefficients(ref), 1e-5)
    mine = tt.fit_from_stats(XX, XY, 2, precision="dd")  # kernel_dd.fit_from_stats_dd
    ref = jkp.fit_from_stats(*_j(XX.numpy(), XY.numpy()), 2, precision="dd")
    _close(tt.coefficients(mine), pt.coefficients(ref), 1e-6)


def test_cv_loo_downdate_and_from_stats():
    X, Y = _synthetic(2)
    ref = jloo.cv_loo_downdate(*_j(X, Y), 3)
    mine = tt.cv_loo_downdate(*_t(X, Y), 3, batch_size=7)
    _residuals(mine, ref)
    idx = np.array([0, 5, 17, 39])
    ref = jloo.cv_loo_from_stats(*_j(X.T @ X, X.T @ Y, X[idx], Y[idx]), 3)
    mine = tt.cv_loo_from_stats(*_t(X.T @ X, X.T @ Y, X[idx], Y[idx]), 3)
    _close(mine.errors, ref.errors)
    _close(tt.cv_loo_downdate(*_t(X, Y), 3, fold_indices=idx).errors, ref.errors)
    # the type-2 masked-refit LOO is the same cross-validation
    _close(mine.errors, tt.cv_loo(*_t(X, Y), 3, tt.KERNEL_TYPE2).errors[:, idx].numpy())


@pytest.mark.parametrize("rng", ["gcc", "jax"])
def test_cv_lso_downdate(rng):
    X, Y = _synthetic(2)
    if rng == "gcc":
        parts = tt.GccRng().lso_partitions(40, 12)
        ref = jlso.cv_lso_downdate(*_j(X, Y), 3, 0.3, 12, partitions=parts)
        mine = tt.cv_lso_downdate(*_t(X, Y), 3, 0.3, 12, partitions=parts, batch_size=5)
    else:
        ref = jlso.cv_lso_downdate(*_j(X, Y), 3, 0.3, 12, key=jax.random.key(4))
        mine = tt.cv_lso_downdate(*_t(X, Y), 3, 0.3, 12, key=4)
    _residuals(mine, ref)
    with pytest.raises(ValueError):
        tt.cv_lso_downdate(*_t(X, Y), 3, 0.3, 12)


def test_cv_kfold_masked_downdate_and_from_stats():
    X, Y = _synthetic(2)
    ref = jk.cv_kfold(*_j(X, Y), 3, k=5, key=2)
    mine = tt.cv_kfold(*_t(X, Y), 3, k=5, key=2, batch_size=2)
    _residuals(mine, ref)
    ref = jk.cv_kfold_downdate(*_j(X, Y), 3, k=5, key=2)
    mine = tt.cv_kfold_downdate(*_t(X, Y), 3, k=5, key=2, batch_size=3)
    _residuals(mine, ref)
    # the block downdate is the masked type-2 refit
    _close(mine.errors, tt.cv_kfold(*_t(X, Y), 3, k=5, method=tt.KERNEL_TYPE2, key=2).errors.numpy())
    assign = tt.kfold_assignments(40, 5, 2).numpy()
    folds = [(X[assign == f], Y[assign == f]) for f in range(5)]
    ref = jk.cv_kfold_from_stats(*_j(X.T @ X, X.T @ Y), iter(folds), 3)
    mine = tt.cv_kfold_from_stats(*_t(X.T @ X, X.T @ Y), iter(folds), 3)
    assert mine.method == ref.method == "K-FOLD"
    _close(mine.errors, ref.errors)
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        tt.cv_kfold(*_t(X, Y), 3, k=5, assignments=np.full(40, 5))
    with pytest.raises(ValueError, match="k=1"):
        tt.cv_kfold_downdate(*_t(X, Y), 3, k=1)


def test_kfold_equals_loo_when_k_is_n(toy):
    X, Y = _t(*toy)
    _close(tt.cv_kfold(X, Y, 2, k=10, key=None).errors, tt.cv_loo(X, Y, 2).errors.numpy())


@pytest.mark.parametrize("zscore", [False, True])
def test_cv_kfold_onepass_and_residual_chunk(zscore):
    X, Y = _synthetic(2)
    if zscore:  # raw data with offsets: the closed-form z-scoring path
        X, Y = X * 2.0 + 3.0, Y - 1.5
    assign = tt.kfold_assignments(40, 4, 9).numpy()
    fm = tt.FoldStatsAccumulator(10, 2, 4, torch.float64, device="cpu")
    fr = js.FoldStatsAccumulator(10, 2, 4, jnp.float64)
    for i in range(0, 40, 16):
        fm.update(X[i : i + 16], Y[i : i + 16], assign[i : i + 16])
        fr.update(*_j(X[i : i + 16], Y[i : i + 16]), assign[i : i + 16])
    if zscore:
        fm, fr = fm.zscored(), fr.zscored()
    mine = tt.cv_kfold_onepass(fm, 3)
    ref = jk.cv_kfold_onepass(fr, 3)
    for name in ("press", "mse", "rmse", "B"):
        _close(getattr(mine, name), getattr(ref, name))
    assert mine.n_obs == ref.n_obs == 40 and np.array_equal(mine.nf, np.asarray(ref.nf))
    for f in range(4):
        _close(tt.coefficients(mine.fits[f]), pt.coefficients(ref.fits[f]))
    Xc, Yc = X, Y
    if zscore:
        Xc, Yc = (X - fm.mx.numpy()) / fm.sdx.numpy(), (Y - fm.my.numpy()) / fm.sdy.numpy()
    e_mine = tt.fold_residual_chunk(mine.B, *_t(Xc, Yc, assign))
    e_ref = jk.fold_residual_chunk(ref.B, *_j(Xc, Yc, assign))
    _close(e_mine, e_ref)
    # PRESS from statistics = Σ errors² of the residual pass
    _close(mine.press, (e_mine.numpy() ** 2).sum(0).T, 1e-9)


def test_cv_group_matches_jax():
    X, Y = _synthetic(2)
    groups = np.repeat([3, 9, 4, 11, 5], 8)
    ref = jk.cv_group(*_j(X, Y), jnp.asarray(groups), 3)
    mine = tt.cv_group(*_t(X, Y), groups, 3, batch_size=2)
    _residuals(mine, ref)
    with pytest.raises(ValueError, match="2 distinct"):
        tt.cv_group(*_t(X, Y), np.zeros(40), 3)


def test_compare_models_q_squared_rmsep(toy):
    X, Y = toy
    loo_r = jloo.cv_loo(*_j(X, Y), 2)
    lso_r = jlso.cv_lso(*_j(X, Y), 2, 0.3, 10, partitions=tt.GccRng().lso_partitions(10, 10))
    loo_m = tt.cv_loo(*_t(X, Y), 2)
    lso_m = tt.cv_lso(*_t(X, Y), 2, 0.3, 10, partitions=tt.GccRng().lso_partitions(10, 10))
    _close(tt.compare_models(loo_m, loo_m, 1, 2), jval.compare_models(loo_r, loo_r, 1, 2))
    for res_m, res_r in ((loo_m, loo_r), (lso_m, lso_r)):
        _close(tt.q_squared(res_m, torch.from_numpy(Y)), jval.q_squared(res_r, jnp.asarray(Y)))
        _close(tt.rmsep(res_m), jval.rmsep(res_r))
    # a 1-D Y is one response
    _close(tt.q_squared(tt.Residual(errors=loo_m.errors[:1], method="LOO"), Y[:, 0]),
           jval.q_squared(pt.Residual(errors=loo_r.errors[:1], method="LOO"), jnp.asarray(Y[:, 0])))
    with pytest.raises(ValueError, match="same observations"):
        tt.compare_models(loo_m, lso_m, 1, 1)


def test_model_cv_loo_downdate_and_kfold(toy):
    X, Y = toy
    ref_model = pt.PLSModel(*_j(X, Y), pt.KERNEL_TYPE1, 2)
    model = tt.PLSModel(*_t(X, Y), tt.KERNEL_TYPE1, 2)
    _residuals(model.cv_LOO(downdate=True), ref_model.cv_LOO(downdate=True))
    _residuals(model.cv_KFOLD(5, key=3), ref_model.cv_KFOLD(5, key=3))
    _residuals(model.cv_KFOLD(5, key=3, downdate=False), ref_model.cv_KFOLD(5, key=3, downdate=False))
    # a model of another method refuses the downdate path
    other = tt.PLSModel(*_t(X, Y), tt.METHOD.NIPALS, 2, _fit_state=model.fit_state)
    with pytest.raises(ValueError, match="downdate LOO"):
        other.cv_LOO(downdate=True)
