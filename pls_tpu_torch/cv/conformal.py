"""Distribution-free prediction intervals: jackknife+, CV+ and split
conformal.

Counterpart of `pls_tpu/cv/conformal.py`:

- jackknife+ (Barber, Candès, Ramdas & Tibshirani 2021): per LOO fold i,
  the held-out residual Rᵢ and the fold model's prediction at the new
  points; the interval is [q⁻_α{ŷ₋ᵢ(x) − Rᵢ}, q⁺_α{ŷ₋ᵢ(x) + Rᵢ}];
- CV+: the same with `n_folds` fits instead of N;
- split conformal: one masked fit on the training rows, the residual
  quantile of the calibration rows, a constant width.

The folds run as batches of masked fits (`kernel_pls.fit_folds`), as LOO
CV does, where the JAX package maps its masked fit over them
(`utils.batching.padded_map`); a batch holds as many folds as keep its
masked copies of X near 128 MiB (`utils.batching.fold_batch_size`, the
policy the grid search's folds follow too), and a batch of one fold is an
un-batched masked fit.  The random fold
labels and the split come from `utils.jax_prng`, the JAX package's
`jax.random.key(0)`/`permutation` bit for bit, so both packages take the
same rows.  The un-batched fits (a fold of one, split conformal's fit,
and every method's full-data point prediction) go through
`kernel_pls.fit`: kernel type 1 on float32 X on the card launches K1 once
per component.

Inputs are in the caller's (typically z-scored) units; the estimator
(estimator.py) converts to raw units.  X, Y and X_new are tensors, or data
that goes to the card.
"""

from __future__ import annotations

import math

import torch

from pls_tpu_torch.config import resolve_device
from pls_tpu_torch.models.kernel_pls import fit, fit_masks
from pls_tpu_torch.models.predict import _promote, coefficients, fitted_values
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD
from pls_tpu_torch.utils import jax_prng
from pls_tpu_torch.utils.batching import chunked_map, fold_batch_size


def _inputs(X, Y, X_new):
    device = resolve_device(None, X)
    X = torch.as_tensor(X, device=device)
    Y = torch.as_tensor(Y, device=device)
    if Y.ndim == 1:
        Y = Y[:, None]
    return X, Y, torch.as_tensor(X_new, device=device)


def _order_stat(vals: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-based, clipped to 1..n) along axis 0: the JAX
    package's `jnp.sort(vals, 0)[k - 1]`."""
    k = min(max(k, 1), vals.shape[0])
    return torch.kthvalue(vals, k, dim=0).values


def _fold_coefficients(X, Y, masks, A, method, comp, precision) -> torch.Tensor:
    """(F, K, M) coefficients of the masked fits of `masks` (F, N)."""
    return coefficients(fit_masks(X, Y, masks, A, method, precision=precision), comp)


def _bounds(lows: torch.Tensor, highs: torch.Tensor, alpha: float):
    """jackknife+'s order statistics with the (N+1) finite-sample correction."""
    N = lows.shape[0]
    k_lo = math.floor(alpha * (N + 1))
    k_hi = math.ceil((1.0 - alpha) * (N + 1))
    return _order_stat(lows, max(k_lo, 1)), _order_stat(highs, min(k_hi, N))


def jackknife_plus_intervals(
    X, Y, X_new, A: int, *, alpha: float = 0.1, method: METHOD = KERNEL_TYPE1,
    comp: int | None = None, batch_size: int | None = None, precision: str | None = "highest",
):
    """Jackknife+ intervals for each row of X_new: (lo, hi, pred), each
    (n_new, M); `pred` is the full-data model's prediction.  Coverage
    ≥ 1−2α guaranteed, ≈ 1−α typical.  N masked fits in batches of
    `batch_size` (default at most 64, fewer where a batch's masked X would
    pass 128 MiB)."""
    X, Y, X_new = _inputs(X, Y, X_new)
    N = X.shape[0]
    rows = torch.arange(N, device=X.device)

    def folds(idx):
        B = _fold_coefficients(X, Y, rows[None, :] != idx[:, None], A, method, comp, precision)
        Xi, Xn, B = _promote(X[idx], X_new, B)
        resid = (Y[idx] - (Xi[:, None, :] @ B)[:, 0]).abs()  # (F, M)
        preds = Xn[None] @ B  # (F, n_new, M)
        return torch.cat([preds, resid[:, None, :]], dim=1)

    out = chunked_map(folds, rows, fold_batch_size(N, X, batch_size))
    preds, resids = out[:, :-1], out[:, -1]
    lo, hi = _bounds(preds - resids[:, None, :], preds + resids[:, None, :], alpha)
    pred = fitted_values(fit(X, Y, A, method, precision=precision), X_new, comp)
    return lo, hi, pred


def cv_plus_intervals(
    X, Y, X_new, A: int, *, n_folds: int = 10, alpha: float = 0.1, key=None,
    method: METHOD = KERNEL_TYPE1, comp: int | None = None, batch_size: int | None = None,
    precision: str | None = "highest",
):
    """CV+ intervals (the k-fold jackknife+, Barber et al. 2021 §3):
    `n_folds` masked fits (in batches as `jackknife_plus_intervals`), the
    same ≥ 1−2α guarantee.  Row i contributes ŷ(x) ± Rᵢ of the fold model
    that did not see it.  `key` is a JAX key's data or an int seed (None:
    key 0).  Returns (lo, hi, pred), each (n_new, M)."""
    X, Y, X_new = _inputs(X, Y, X_new)
    N = X.shape[0]
    n_folds = min(n_folds, N)
    k = jax_prng.key(0) if key is None else key
    fold_of = torch.as_tensor(jax_prng.permutation(k, torch.arange(N).numpy() % n_folds),
                              device=X.device)
    Bs = chunked_map(  # (F, K, M)
        lambda ids: _fold_coefficients(X, Y, fold_of[None, :] != ids[:, None], A, method, comp,
                                       precision),
        torch.arange(n_folds, device=X.device), fold_batch_size(n_folds, X, batch_size))
    Xp, Xn, Bs = _promote(X, X_new, Bs)
    # each row's held-out residual under its own fold's model
    fitted = torch.take_along_dim(Xp[None] @ Bs, fold_of[None, :, None], dim=0)[0]  # (N, M)
    resid = (Y - fitted).abs()
    preds_of_row = (Xn[None] @ Bs)[fold_of]  # (N, n_new, M)
    lo, hi = _bounds(preds_of_row - resid[:, None, :], preds_of_row + resid[:, None, :], alpha)
    pred = fitted_values(fit(X, Y, A, method, precision=precision), X_new, comp)
    return lo, hi, pred


def split_conformal_intervals(
    X, Y, X_new, A: int, *, alpha: float = 0.1, calib_frac: float = 0.3, key=None,
    method: METHOD = KERNEL_TYPE1, comp: int | None = None, precision: str | None = "highest",
):
    """Split-conformal intervals: one fit on the N − round(calib_frac·N)
    training rows, the ⌈(1−α)(n_cal+1)⌉-th calibration residual as a
    constant half-width per response.  `key` as `cv_plus_intervals`.
    Returns (lo, hi, pred), each (n_new, M)."""
    X, Y, X_new = _inputs(X, Y, X_new)
    N = X.shape[0]
    n_cal = max(int(round(calib_frac * N)), 1)
    k = jax_prng.key(0) if key is None else key
    perm = torch.as_tensor(jax_prng.permutation(k, N), device=X.device)
    cal_idx, tr_idx = perm[:n_cal], perm[n_cal:]
    mask = torch.zeros(N, dtype=X.dtype, device=X.device)
    mask[tr_idx] = 1.0
    B = coefficients(fit(X, Y, A, method, row_mask=mask, precision=precision), comp)
    Xc, Xn, B = _promote(X[cal_idx], X_new, B)
    scores = (Y[cal_idx] - Xc @ B).abs()  # (n_cal, M)
    q = _order_stat(scores, min(math.ceil((1.0 - alpha) * (n_cal + 1)), n_cal))  # (M,)
    pred = Xn @ B
    return pred - q[None, :], pred + q[None, :], pred
