"""Hyper-parameter tuning: k-fold grid search over estimator parameters,
and nested CV.

Counterpart of `pls_tpu/tune.py`.  Folds come from one shuffled
permutation (`utils.jax_prng.permutation`, the JAX package's
`jax.random.permutation` bit for bit, so both packages take the same
rows), with equal test folds of N // n_folds rows; the leftover rows stay
in training.

`grid_search_cv` on a plain PLSRegressor factory takes the fast path: per
setting of the parameters other than n_components, one masked fit per
fold at the largest n_components, every n_components of the grid read off
it (truncation nesting), as the JAX package's vmapped
`_fold_errors_batched` does.  The folds go in batches under the policy
conformal's folds follow (`utils.batching.fold_batch_size`): as many as
keep a batch's per-fold z-scored copies of X near 128 MiB, so small data
takes one batched fit (`kernel_pls.fit_folds`, a leading fold axis) and
data of 128 MiB and more takes one un-batched fit per fold (K1 on the
card).  Other estimators take the generic loop of fit/predict calls.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.utils import jax_prng


def kfold_split(n: int, n_folds: int, key=None):
    """(train_idx, test_idx) numpy index pairs: equal test folds of
    n // n_folds rows of a permutation (shuffled under `key`, a JAX key's
    data or an int seed; None: unshuffled); the n % n_folds leftover rows
    are always in training."""
    if not (2 <= n_folds <= n):
        raise ValueError(f"need 2 <= n_folds <= N, got {n_folds} / {n}")
    perm = jax_prng.permutation(key, n) if key is not None else np.arange(n)
    fold_size = n // n_folds
    splits = []
    for f in range(n_folds):
        test = perm[f * fold_size : (f + 1) * fold_size]
        splits.append((np.setdiff1d(perm, test), test))
    return splits


@dataclass
class GridResult:
    """One grid point: its parameters, per-fold RMSE and their mean."""

    params: dict
    fold_rmse: np.ndarray
    rmse: float


def masked_zscore(D: torch.Tensor, mask: torch.Tensor, out: torch.Tensor | None = None):
    """(D z-scored, the stdevs): by the moments of the rows where `mask` is
    1, as ZScorer takes them on those rows alone (N−1 denominator, a zero
    stdev read as 1); every row is transformed."""
    m = mask[:, None]
    cnt = mask.sum()
    mean = (D * m).sum(0) / cnt
    sd = torch.sqrt((((D - mean) * m) ** 2).sum(0) / (cnt - 1))
    sd = torch.where(sd == 0, torch.ones_like(sd), sd)
    return torch.div(D - mean, sd, out=out), sd


def _fold_errors(X, Y, masks, test_idx, A, method, scale, power_iters, precision, x_storage):
    """The folds of one batch (`masks` (B, N), `test_idx` (B, T)): per
    fold, z-scoring on the training rows (ZScorer's statistics: N−1
    denominator, zero-stdev guard), a masked fit at A, and raw-unit test
    residuals at every truncation 1..A.  A batch of one fold is an
    un-batched fit (K1 on the card), a larger one a batched fit on per-fold
    z-scored copies of X.  Each copy is masked in place once its test rows
    are taken, so a fold holds one copy of X.  Returns (B, T, A, M)."""
    from pls_tpu_torch.models.kernel_pls import fit, fit_folds
    from pls_tpu_torch.models.predict import residuals_all_components

    B = masks.shape[0]
    m = masks[:, :, None]
    rows = test_idx[:, :, None]
    kw = dict(power_iters=power_iters, precision=precision, x_storage=x_storage)
    if scale:
        Xz = X.new_empty((B, *X.shape))
        Yz = Y.new_empty((B, *Y.shape))
        sdy = Y.new_empty((B, Y.shape[1]))
        for f in range(B):  # fold by fold: the temporaries are of X's size
            masked_zscore(X, masks[f], out=Xz[f])
            sdy[f] = masked_zscore(Y, masks[f], out=Yz[f])[1]
        Xt = torch.take_along_dim(Xz, rows, dim=1)
        Yt = torch.take_along_dim(Yz, rows, dim=1)
        Xz.mul_(m)
        Yz.mul_(m)
        f = (fit(Xz[0], Yz[0], A, method, **kw) if B == 1
             else fit_folds(Xz, Yz, masks, A, method, **kw))
        del Xz
    else:
        Xt = torch.take_along_dim(X[None], rows, dim=1)
        Yt = torch.take_along_dim(Y[None], rows, dim=1)
        sdy = Y.new_ones((B, Y.shape[1]))
        f = (fit(X, Y, A, method, row_mask=masks[0], **kw) if B == 1
             else fit_folds(X, Y, masks, A, method, **kw))
    err_z = residuals_all_components(f, Xt, Yt)  # (B, T, A, M); one fit broadcasts
    return err_z * sdy[:, None, None, :]  # the affine transform cancels: raw = z · sd_y


def _grid_search_cv_folds(make_estimator, param_grid, X, Y, splits, batch_size):
    """The fast path of grid_search_cv for plain PLSRegressor factories:
    per setting of the other parameters, one masked fit per fold at the
    largest n_components, every n_components read off it; the folds in
    batches of `fold_batch_size`."""
    from pls_tpu_torch.config import as_data
    from pls_tpu_torch.utils.batching import fold_batch_size

    N = X.shape[0]
    F = len(splits)
    T = splits[0][1].shape[0]
    masks = np.zeros((F, N), np.float32)
    test_idx = np.zeros((F, T), np.int64)
    for f, (train, test) in enumerate(splits):
        masks[f, train] = 1.0
        test_idx[f] = test
    names = list(param_grid)
    a_values = list(param_grid.get("n_components", []))
    other_names = [n for n in names if n != "n_components"]
    by_params: dict[tuple, GridResult] = {}
    for combo in itertools.product(*(param_grid[n] for n in other_names)):
        base = dict(zip(other_names, combo))
        est = make_estimator().set_params(**base)
        Xd = as_data(X, est.device)
        Yd = as_data(Y, Xd.device).to(Xd.dtype)
        A_list = a_values or [est.n_components]
        md = torch.as_tensor(masks, dtype=Xd.dtype, device=Xd.device)
        td = torch.as_tensor(test_idx, device=Xd.device)
        step = fold_batch_size(F, Xd, batch_size)
        sq = [(e * e).mean((1, 3)) for e in (  # (B, A_max) a batch
            _fold_errors(Xd, Yd, md[i : i + step], td[i : i + step], max(A_list), est.method,
                         est.scale, est.power_iters, est.precision, est.x_storage)
            for i in range(0, F, step))]
        rmse_fa = torch.sqrt(torch.cat(sq)).cpu().numpy()  # (F, A_max)
        for A in A_list:
            params = dict(base)
            if a_values:
                params["n_components"] = A
            fold_rmse = rmse_fa[:, A - 1]
            by_params[tuple(params[n] for n in names)] = GridResult(
                params, fold_rmse, float(fold_rmse.mean()))
    results = [by_params[v] for v in itertools.product(*(param_grid[n] for n in names))]
    return min(results, key=lambda r: r.rmse), results


def _rows(A, idx):
    """Rows `idx` of a tensor or an array."""
    return A[torch.as_tensor(idx, device=A.device)] if isinstance(A, torch.Tensor) else A[idx]


def _host(A) -> np.ndarray:
    return A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)


def _as_2d(Y):
    return Y[:, None] if Y.ndim == 1 else Y


def grid_search_cv(make_estimator, param_grid: dict, X, Y, *, n_folds: int = 5, key=None,
                   batched: bool | None = None, batch_size: int | None = None):
    """Exhaustive k-fold CV over the cartesian product of `param_grid`
    ({name: [values...]}).  `make_estimator` is a zero-argument factory of
    fresh estimators (set_params/fit/predict).  batched None takes the fast
    path for a plain PLSRegressor; False forces the estimator loop.  The
    fast path fits its folds in batches of `batch_size` (None:
    `utils.batching.fold_batch_size`, as many as keep a batch's copies of X
    near 128 MiB; 1: un-batched fits).  X, Y: tensors (on the estimator's
    device) or arrays.  Returns (best, results) with results in grid order;
    best has the least mean RMSE."""
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X)
    if not isinstance(Y, torch.Tensor):
        Y = np.asarray(Y)
    Y = _as_2d(Y)
    splits = kfold_split(X.shape[0], n_folds, key)
    if batched is None:
        from pls_tpu_torch.estimator import PLSRegressor

        # the exact type: a subclass may change fit/predict
        batched = type(make_estimator()) is PLSRegressor
    if batched:
        return _grid_search_cv_folds(make_estimator, param_grid, X, Y, splits, batch_size)
    names = list(param_grid)
    results: list[GridResult] = []
    for values in itertools.product(*(param_grid[n] for n in names)):
        params = dict(zip(names, values))
        fold_rmse = []
        for train, test in splits:
            est = make_estimator().set_params(**params)
            est.fit(_rows(X, train), _rows(Y, train))
            Yt = _host(_rows(Y, test))
            pred = np.asarray(est.predict(_rows(X, test))).reshape(Yt.shape)
            fold_rmse.append(float(np.sqrt(np.mean((pred - Yt) ** 2))))
        fold_rmse = np.asarray(fold_rmse)
        results.append(GridResult(params, fold_rmse, float(fold_rmse.mean())))
    return min(results, key=lambda r: r.rmse), results


@dataclass
class NestedCVResult:
    """chosen (k_outer,): each outer fold's inner choice; fold_rmsep
    (k_outer, M): the outer test RMSEP at it; rmsep (M,): the pooled outer
    RMSEP over all held-out rows."""

    chosen: np.ndarray
    fold_rmsep: np.ndarray
    rmsep: np.ndarray


def _keys(key):
    """(outer key, the k_outer inner keys' parent) of an int seed or a key."""
    k_out, k_in = jax_prng.split(jax_prng.key(key) if isinstance(key, (int, np.integer)) else key)
    return k_out, k_in


def nested_cv_components(
    X, Y, A_max: int, *, k_outer: int = 5, k_inner: int = 7, method=None,
    select: str = "wilcoxon", alpha: float = 0.1, key=0, power_iters: int | None = None,
    precision: str | None = "highest", device=None,
):
    """Nested CV for the number of PLS components: per outer fold, a
    `k_inner`-fold CV (`cv.kfold.cv_kfold`) on the outer-train rows picks
    A* ("wilcoxon": the per-response selector at `alpha`, the largest over
    responses; "min": the least PRESS summed over responses), and a fresh
    A*-component fit on them is scored on the outer-test rows.  X/Y are
    used as given (pre-scaled), on `device` (None: that of a tensor X,
    else the card)."""
    from pls_tpu_torch.cv.kfold import cv_kfold
    from pls_tpu_torch.cv.validation import optimal_num_components, validation
    from pls_tpu_torch.config import as_data
    from pls_tpu_torch.models.kernel_pls import fit
    from pls_tpu_torch.models.predict import residuals
    from pls_tpu_torch.types import METHOD, RESS

    method = METHOD.KERNEL_TYPE1 if method is None else method
    if select not in ("wilcoxon", "min"):
        raise ValueError(f"unknown select {select!r} ('wilcoxon' | 'min')")
    X = as_data(X, device)
    Y = _as_2d(as_data(Y, X.device).to(X.dtype))
    N, M = X.shape[0], Y.shape[1]
    k_out, k_in = _keys(key)
    splits = kfold_split(N, k_outer, k_out)
    inner_keys = jax_prng.split(k_in, k_outer)
    chosen = np.zeros(k_outer, dtype=int)
    fold_rmsep = np.zeros((k_outer, M))
    sq_sum = np.zeros(M)
    n_test_total = 0
    for o, (train, test) in enumerate(splits):
        Xtr, Ytr = _rows(X, train), _rows(Y, train)
        inner = cv_kfold(Xtr, Ytr, A_max, k_inner, method, key=inner_keys[o],
                         power_iters=power_iters, precision=precision)
        if select == "wilcoxon":
            a_star = int(optimal_num_components(inner, alpha).max())
        else:
            a_star = int(torch.argmin(validation(inner, RESS).sum(0))) + 1
        f = fit(Xtr, Ytr, a_star, method, power_iters=power_iters, precision=precision)
        err = _host(residuals(f, _rows(X, test), _rows(Y, test)))
        chosen[o] = a_star
        fold_rmsep[o] = np.sqrt(np.mean(err**2, axis=0))
        sq_sum += np.sum(err**2, axis=0)
        n_test_total += len(test)
    return NestedCVResult(chosen=chosen, fold_rmsep=fold_rmsep, rmsep=np.sqrt(sq_sum / n_test_total))


def nested_grid_search_cv(make_estimator, param_grid: dict, X, Y, *, k_outer: int = 5,
                          k_inner: int = 5, key=0):
    """Nested CV over an estimator grid: per outer fold, `grid_search_cv`
    on the outer-train rows picks the parameters and a fresh fit is scored
    on the outer-test rows.  `chosen` holds the winning parameter dicts."""
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X)
    if not isinstance(Y, torch.Tensor):
        Y = np.asarray(Y)
    Y = _as_2d(Y)
    k_out, k_in = _keys(key)
    splits = kfold_split(X.shape[0], k_outer, k_out)
    inner_keys = jax_prng.split(k_in, k_outer)
    chosen = np.empty(k_outer, dtype=object)
    M = Y.shape[1]
    fold_rmsep = np.zeros((k_outer, M))
    sq_sum = np.zeros(M)
    n_test_total = 0
    for o, (train, test) in enumerate(splits):
        best, _ = grid_search_cv(make_estimator, param_grid, _rows(X, train), _rows(Y, train),
                                 n_folds=k_inner, key=inner_keys[o])
        est = make_estimator().set_params(**best.params)
        est.fit(_rows(X, train), _rows(Y, train))
        Yt = _host(_rows(Y, test))
        err = np.asarray(est.predict(_rows(X, test))).reshape(Yt.shape) - Yt
        chosen[o] = best.params
        fold_rmsep[o] = np.sqrt(np.mean(err**2, axis=0))
        sq_sum += np.sum(err**2, axis=0)
        n_test_total += len(test)
    return NestedCVResult(chosen=chosen, fold_rmsep=fold_rmsep, rmsep=np.sqrt(sq_sum / n_test_total))


def tune_spls_keepx(X, Y, A: int, keep_grid, *, n_folds: int = 5, key=None, device=None):
    """Sparse-PLS keep_x by k-fold RMSE.  Returns (best, results)."""
    from pls_tpu_torch.estimator import SPLSRegressor

    return grid_search_cv(lambda: SPLSRegressor(n_components=A, device=device),
                          {"keep_x": list(keep_grid)}, X, Y, n_folds=n_folds, key=key)


def tune_kpls(X, Y, *, gamma_grid, ncomp_grid, kernel: str = "rbf", n_folds: int = 5, key=None,
              device=None):
    """Joint (gamma, n_components) selection for kernel PLS."""
    from pls_tpu_torch.estimator import KPLSRegressor

    return grid_search_cv(lambda: KPLSRegressor(kernel=kernel, device=device),
                          {"gamma": list(gamma_grid), "n_components": list(ncomp_grid)},
                          X, Y, n_folds=n_folds, key=key)
