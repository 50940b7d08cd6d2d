"""K-fold and leave-group-out cross-validation.

Counterpart of `pls_tpu/cv/kfold.py`.  Every row is held out once, so the
errors have LOO's (M, N, A) layout and feed cv/validation unchanged.

- `cv_kfold`, `cv_group`: one masked refit per fold (`fit_folds`, the
  model's own method), residuals of each row under its own fold's model.
- `cv_kfold_downdate`: kernel type 2 from XᵀX/XᵀY, fold f refit from
  (XX − XfᵀXf, XY − XfᵀYf) with the block downdate inside the matvec.
- `cv_kfold_from_stats`: the same from given statistics and streamed
  fold blocks.
- `cv_kfold_onepass`: PRESS from the per-fold statistics of one streaming
  pass (models/streaming.FoldStatsAccumulator), with no pass over X; then
  `fold_residual_chunk` gives the per-row errors in one more pass.

Fold labels (`kfold_assignments`) are the JAX package's: a
`jax.random.permutation` of arange(N) % k, drawn by `utils.jax_prng`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.cv.loo import global_stats
from pls_tpu_torch.models.kernel_pls import (
    _cast,
    _kernel2_loop,
    _prec_ctx,
    _wide,
    fit_folds,
    fit_from_stats_blockdowndated,
)
from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.types import METHOD, PLSFit, Residual
from pls_tpu_torch.utils.jax_prng import permutation
from pls_tpu_torch.utils.profiling import span


def kfold_assignments(n: int, k: int, key=None) -> torch.Tensor:
    """(N,) int64 fold labels in [0, k), sizes within one of each other:
    arange(n) % k shuffled under a JAX key or int seed (None: unshuffled
    blocks).  Equal to `pls_tpu/cv/kfold.py:35-45` for the same key."""
    base = np.arange(n) % k
    if key is not None:
        base = permutation(key, base)
    return torch.from_numpy(base.astype(np.int64))


def _check_assignments(assign, k: int) -> np.ndarray:
    """(N,) fold labels as numpy, checked to lie in [0, k): an
    out-of-range label would otherwise drop its row silently
    (`pls_tpu/cv/kfold.py:122-136`)."""
    a = assign.cpu().numpy() if isinstance(assign, torch.Tensor) else np.asarray(assign)
    if a.ndim != 1:
        raise ValueError(f"assignments must be 1-D, got shape {a.shape}")
    if a.size and (a.min() < 0 or a.max() >= k):
        raise ValueError(
            f"fold assignments must lie in [0, {k}); got range [{a.min()}, {a.max()}]"
        )
    return a


def _fold_blocks(assign: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(idx, mask), both (k, Nf_max): fold f's row indices padded with 0,
    and a flag on the real entries.  The padded rows are zeroed before
    use, so the padding is exact for the block downdate
    (`pls_tpu/cv/kfold.py:139-154`)."""
    counts = np.bincount(assign, minlength=k)
    idx = np.zeros((k, int(counts.max())), dtype=np.int64)
    mask = np.zeros(idx.shape, dtype=bool)
    for f in range(k):
        rows = np.flatnonzero(assign == f)
        idx[f, : len(rows)] = rows
        mask[f, : len(rows)] = True
    return idx, mask


def _check_k(k: int, N: int) -> None:
    if not (2 <= k <= N):
        raise ValueError(f"k={k} must satisfy 2 <= k <= N={N}")


def _cv_by_assignment(X, Y, assign: np.ndarray, n_folds: int, A, method, label, *,
                      batch_size, power_iters, precision, x_storage=None) -> Residual:
    """One masked refit per fold id in [0, n_folds); each row's residuals
    under its own fold's model.  Returns errors (M, N, A)."""
    N = X.shape[0]
    if batch_size is None:
        batch_size = min(n_folds, 32)
    a = torch.from_numpy(assign).to(X.device)
    own = None
    for lo in range(0, n_folds, batch_size):
        with span("pls.cv.fold_batch"):
            ids = torch.arange(lo, min(lo + batch_size, n_folds), device=X.device)
            f = fit_folds(X, Y, a[None, :] != ids[:, None], A, method, power_iters=power_iters,
                          precision=precision, x_storage=x_storage)
            res = residuals_all_components(f, X, Y)  # (F, N, A, M)
            if own is None:
                own = res.new_zeros(res.shape[1:])
            rows = torch.nonzero((a >= lo) & (a < lo + len(ids)))[:, 0]
            own[rows] = res[a[rows] - lo, rows]
    return Residual(errors=own.permute(2, 0, 1), method=label)


def cv_kfold(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    assignments=None,
    key=0,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """K-fold CV by masked refits (`pls_tpu/cv/kfold.py:85-119`).
    `assignments` (N,) overrides the JAX-keyed partition of `key`.
    Returns Residual errors (M, N, A), labelled "<k>-FOLD"."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    _check_k(k, N)
    if assignments is None:
        assignments = kfold_assignments(N, k, key)
    return _cv_by_assignment(
        X, Y, _check_assignments(assignments, k), k, A, method, f"{k}-FOLD",
        batch_size=batch_size, power_iters=power_iters, precision=precision,
        x_storage=x_storage,
    )


def cv_kfold_downdate(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    k: int = 10,
    *,
    assignments=None,
    key=0,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """K-fold CV from XᵀX/XᵀY by block downdates (kernel type 2;
    `pls_tpu/cv/kfold.py:157-243`): O(K²·A + Nf·K·A) per fold against
    the masked refit's O(N·K²).  Fold blocks are zero-padded to equal size
    and run `batch_size` at a time on a leading axis; their residuals are
    added back to their rows.  x_storage="bf16": X rounded to bfloat16 in
    the statistics, the downdates and the residuals, float32 accumulation.
    Returns errors (M, N, A)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    _check_k(k, N)
    with span("pls.cv.assign"):
        if assignments is None:
            assignments = kfold_assignments(N, k, key)
        idx_np, mask_np = _fold_blocks(_check_assignments(assignments, k), k)
        idx = torch.from_numpy(idx_np).to(X.device)
        mask = torch.from_numpy(mask_np).to(X.device)
    if batch_size is None:
        batch_size = min(k, 8)
    XX, XY, Xs, acc = global_stats(X, Y, x_storage, precision)
    own = None
    for lo in range(0, k, batch_size):
        with span("pls.cv.fold_batch"):
            fi, fm = idx[lo : lo + batch_size], mask[lo : lo + batch_size]
            m = fm.to(acc)[..., None]
            Xf = Xs[fi] * m.to(Xs.dtype)  # zero the padded rows (exact)
            Yf = Y[fi].to(acc) * m
            f = fit_from_stats_blockdowndated(XX, XY, Xf, Yf, A, power_iters=power_iters,
                                              precision=precision)
            errs = residuals_all_components(f, Xf.to(acc), Yf) * m[..., None]  # (F, Nf, A, M)
            if own is None:
                own = errs.new_zeros((N, *errs.shape[2:]))
            own.index_add_(0, fi.reshape(-1), errs.reshape(-1, *errs.shape[2:]))
    return Residual(errors=own.permute(2, 0, 1), method=f"{k}-FOLD")


def cv_kfold_from_stats(
    XX: torch.Tensor,
    XY: torch.Tensor,
    folds,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """K-fold CV from the global statistics and an iterable of held-out
    blocks (Xf, Yf), e.g. streamed from disk one fold at a time
    (`pls_tpu/cv/kfold.py:246-289`).  Each block must be part of XX/XY and
    may be bfloat16.  Folds run one after another; errors
    (M, ΣNf, A) in iteration order, labelled "K-FOLD"."""
    acc = XX.dtype
    outs = []
    for Xf, Yf in folds:
        Xf = torch.as_tensor(Xf, device=XX.device)
        Yf = torch.as_tensor(Yf, device=XX.device).to(acc)
        if Yf.ndim == 1:
            Yf = Yf[:, None]
        f = fit_from_stats_blockdowndated(XX, XY, Xf, Yf, A, power_iters=power_iters,
                                          precision=precision)
        outs.append(residuals_all_components(f, Xf.to(acc), Yf))  # (Nf, A, M)
    return Residual(errors=torch.cat(outs).permute(2, 0, 1), method="K-FOLD")


@dataclass
class KFoldOnePass:
    """Result of `cv_kfold_onepass` (`pls_tpu/cv/kfold.py:292-314`).
    press/mse/rmse: (M, A) float64 numpy,
    PRESS combined on the host in float64 (a difference of O(N) terms).
    B: (k, A, K, M) per-fold coefficients at every truncation, on the
    device.  fits: the k fold fits.  nf: (k,) held-out row counts."""

    press: np.ndarray
    mse: np.ndarray
    rmse: np.ndarray
    B: torch.Tensor
    fits: list
    nf: np.ndarray

    @property
    def n_obs(self) -> int:
        return int(self.nf.sum())


def cv_kfold_onepass(fold_stats, A: int, *, power_iters: int | None = None,
                     precision: str | None = "highest") -> KFoldOnePass:
    """K-fold PRESS/MSE/RMSE from per-fold statistics alone
    (`pls_tpu/cv/kfold.py:317-404`).  Fold f trains on (XX − XXf, XY − XYf)
    and its held-out sum of squares at truncation c is

        PRESS_f(c)[m] = YYf[m,m] − 2·B_c[:,m]·XYf[:,m] + B_c[:,m]ᵀ XXf B_c[:,m].

    The k fold fits run as one batch (matvec XX r − XXf r on a leading fold
    axis) under `precision`; the contractions run on the device in the
    statistics' dtype with full float32 products (TF32 off), as the JAX
    package pins HIGHEST there, and the three terms are combined on the host
    in float64, as `:387-391` does."""
    XXf, XYf, YYf = fold_stats.XXf, fold_stats.XYf, fold_stats.YYf
    k, K, M = XYf.shape
    XX, XY = XXf.sum(0), XYf.sum(0)
    XXw, XXfw, XYw, XYfw = _wide(precision, XX, XXf, XY, XYf)  # float64 for compensated/dd
    fit = _cast(_kernel2_loop(
        lambda r: r @ XXw.mT - (XXfw @ r[..., None])[..., 0],
        XYw[None] - XYfw, A, power_iters, precision,
    ), XX.dtype)
    del XXw, XXfw, XYw, XYfw  # the float64 copies (k·K² for XXf) before the products below
    with _prec_ctx("highest"):
        B = torch.cumsum(fit.R.mT[..., :, :, None] * fit.Q.mT[..., :, None, :], dim=1)  # (k, A, K, M)
        Bm = B.permute(0, 2, 1, 3).reshape(k, K, A * M)
        u = (XXf @ Bm).reshape(k, K, A, M).permute(0, 2, 1, 3)
        cross = (B * XYf[:, None]).sum(2)  # (k, A, M)
        quad = (u * B).sum(2)
    yy = torch.diagonal(YYf, dim1=-2, dim2=-1)  # (k, M)

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    press = (host(yy)[:, None, :] - 2.0 * host(cross) + host(quad)).sum(0).T  # (M, A)
    nf = fold_stats.nf.cpu().numpy() if isinstance(fold_stats.nf, torch.Tensor) else np.asarray(fold_stats.nf)
    fits = [
        PLSFit(W=fit.W[f], P=fit.P[f], Q=fit.Q[f], R=fit.R[f], T=fit.T[f], method=METHOD.KERNEL_TYPE2)
        for f in range(k)
    ]
    mse = press / float(nf.sum())
    return KFoldOnePass(press=press, mse=mse, rmse=np.sqrt(mse), B=B, fits=fits, nf=nf)


def fold_residual_chunk(B: torch.Tensor, Xc: torch.Tensor, Yc: torch.Tensor,
                        assign) -> torch.Tensor:
    """(n, A, M) residuals of one chunk, each row under its own fold's
    model at every truncation (`pls_tpu/cv/kfold.py:407-435`).  B (k, A,
    K, M) from KFoldOnePass; Xc (n, K), Yc (n, M), assign (n,) labels.
    The rows of each present fold are gathered and multiplied by that
    fold's B alone: no (n, k, A, M) intermediate and no k× masked
    product."""
    k, A, K, M = B.shape
    Bmat = B.permute(0, 2, 1, 3).reshape(k, K, A * M)
    Xw = Xc.to(Bmat.dtype)
    Yw = Yc.to(Bmat.dtype)
    if Yw.ndim == 1:
        Yw = Yw[:, None]
    a = torch.as_tensor(assign, device=Xc.device)
    out = Yw[:, None, :].repeat(1, A, 1)
    for f in torch.unique(a).tolist():
        rows = torch.nonzero(a == f)[:, 0]
        yh = (Xw.index_select(0, rows) @ Bmat[f]).reshape(-1, A, M)
        out.index_copy_(0, rows, out.index_select(0, rows) - yh)
    return out


def cv_group(
    X: torch.Tensor,
    Y: torch.Tensor,
    groups,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """Leave-group-out CV: each distinct value of `groups` (N,) is a fold
    (`pls_tpu/cv/kfold.py:438-464`).  Errors (M, N, A), labelled "GROUP"."""
    if Y.ndim == 1:
        Y = Y[:, None]
    g = groups.cpu().numpy() if isinstance(groups, torch.Tensor) else np.asarray(groups)
    uniq = np.unique(g)
    if len(uniq) < 2:
        raise ValueError("need at least 2 distinct groups")
    return _cv_by_assignment(
        X, Y, np.searchsorted(uniq, g), len(uniq), A, method, "GROUP",
        batch_size=batch_size, power_iters=power_iters, precision=precision,
    )
