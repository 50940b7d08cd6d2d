"""Prediction and diagnostics on a fitted PLS model.

Counterpart of `pls_tpu/models/predict.py` (reference pls.cpp:439-467,
and the diagnostics `vip`, `target_projection`, `selectivity_ratio` the
reference lacks).  Every function but the diagnostics also takes a fit
with a leading fold axis (from `kernel_pls.fit_folds`) together with
fold-batched data.
"""

from __future__ import annotations

import functools

import torch

from pls_tpu_torch.ops.stats import sst
from pls_tpu_torch.types import PLSFit


def _promote(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors in their common dtype, as JAX promotes mixed operands
    (a bf16-storage fit has float32 state while its data may be float64)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return [t.to(dtype) for t in tensors]


def _check_comp(fit: PLSFit, comp: int | None) -> int:
    """Resolve/validate a truncation count (the reference asserts
    A >= comp, pls.cpp:440,445)."""
    if comp is None:
        return fit.A
    if not (0 < comp <= fit.A):
        raise ValueError(f"comp={comp} outside 1..A={fit.A}")
    return comp


def scores(fit: PLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Latent-space scores T = Xn · R[:, :comp] (pls.cpp:439-442)."""
    comp = _check_comp(fit, comp)
    X_new, R = _promote(X_new, fit.R[..., :comp])
    return X_new @ R


def loadings_x(fit: PLSFit, comp: int | None = None) -> torch.Tensor:
    """X loadings P[:, :comp] (declared but never defined in the reference,
    pls.h:207-208)."""
    return fit.P[..., : _check_comp(fit, comp)]


def loadings_y(fit: PLSFit, comp: int | None = None) -> torch.Tensor:
    """Y loadings Q[:, :comp] (pls.h:210-211)."""
    return fit.Q[..., : _check_comp(fit, comp)]


def coefficients(fit: PLSFit, comp: int | None = None) -> torch.Tensor:
    """Regression coefficients B = R[:, :c] · Q[:, :c]ᵀ, (K, M)
    (pls.cpp:444-447)."""
    comp = _check_comp(fit, comp)
    return fit.R[..., :comp] @ fit.Q[..., :comp].mT


def fitted_values(fit: PLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Ŷ = Xn · B (pls.cpp:449-451)."""
    X_new, B = _promote(X_new, coefficients(fit, comp))
    return X_new @ B


def residuals(
    fit: PLSFit, X_new: torch.Tensor, Y_new: torch.Tensor, comp: int | None = None
) -> torch.Tensor:
    """Yn − Ŷ (pls.cpp:453-455)."""
    return Y_new - fitted_values(fit, X_new, comp)


def residuals_all_components(
    fit: PLSFit, X_new: torch.Tensor, Y_new: torch.Tensor
) -> torch.Tensor:
    """Residuals under every truncation 1..A in one pass: (..., n, A, M),
    from the prefix-sum identity Ŷ(c) = Σ_{j<c} sⱼ qⱼᵀ with s = Xn R."""
    X_new, R = _promote(X_new, fit.R)
    S = X_new @ R  # (..., n, A)
    contrib = S[..., :, :, None] * fit.Q.mT[..., None, :, :]  # (..., n, A, M)
    return Y_new[..., :, None, :] - torch.cumsum(contrib, dim=-2)


def coefficients_all_components(fit: PLSFit) -> torch.Tensor:
    """Coefficients for every truncation 1..A: (A, K, M), B(c) at [c-1]."""
    contrib = fit.R.mT[..., :, :, None] * fit.Q.mT[..., :, None, :]  # (A, K, M)
    return torch.cumsum(contrib, dim=-3)


def vip(fit: PLSFit, X: torch.Tensor | None = None, comp: int | None = None) -> torch.Tensor:
    """Variable importance in projection, (K,) (`pls_tpu/models/predict.py:104-134`):

        VIPⱼ = sqrt( K · Σₐ SSYₐ (wⱼₐ/‖wₐ‖)² / Σₐ SSYₐ ),  SSYₐ = ‖qₐ‖² tₐᵀtₐ.

    Needs the scores T; a fit without them (kernel type 2, fits from the
    statistics) needs the training X, from which T = X R."""
    comp = _check_comp(fit, comp)
    if fit.T.numel():
        T = fit.T[:, :comp]
    else:
        if X is None:
            raise ValueError("fit has no stored scores (type-2/from-stats); pass X")
        X, R = _promote(X, fit.R[:, :comp])
        T = X @ R
    ssy = (T * T).sum(0) * (fit.Q[:, :comp] ** 2).sum(0)  # (comp,)
    W = fit.W[:, :comp]
    frac = (W * W) / (W * W).sum(0)[None, :]
    frac, ssy = _promote(frac, ssy)
    return torch.sqrt(fit.K * (frac @ ssy) / ssy.sum())


def target_projection(fit: PLSFit, X: torch.Tensor, comp: int | None = None, y_col: int = 0):
    """Target projection (Kvalheim & Karstang 1989) onto the predictive
    direction of response `y_col` (`pls_tpu/models/predict.py:137-154`):
    w_TP = b/‖b‖, t_TP = X w_TP, p_TP = Xᵀt_TP / (t_TPᵀt_TP), with b that
    response's coefficients.  X is the (centred) training X.  Returns
    (t_TP (N,), p_TP (K,))."""
    comp = _check_comp(fit, comp)
    b = coefficients(fit, comp)[:, y_col]
    X, b = _promote(X, b)
    w_tp = b / torch.sqrt(b @ b)
    t_tp = X @ w_tp
    p_tp = (X.T @ t_tp) / (t_tp @ t_tp)
    return t_tp, p_tp


def selectivity_ratio(
    fit: PLSFit, X: torch.Tensor, comp: int | None = None, y_col: int = 0
) -> torch.Tensor:
    """Selectivity ratio per variable (Rajalahti et al. 2009), (K,)
    (`pls_tpu/models/predict.py:157-174`): SRⱼ = ‖t_TP p_TP,ⱼ‖² /
    ‖xⱼ − t_TP p_TP,ⱼ‖², a zero residual read as 1."""
    t_tp, p_tp = target_projection(fit, X, comp, y_col)
    X = X.to(t_tp.dtype)
    ss_exp = (t_tp @ t_tp) * p_tp**2
    resid = X - torch.outer(t_tp, p_tp)
    ss_res = (resid * resid).sum(0)
    return ss_exp / torch.where(ss_res == 0, torch.ones_like(ss_res), ss_res)


def sse(
    fit: PLSFit, X_new: torch.Tensor, Y_new: torch.Tensor, comp: int | None = None
) -> torch.Tensor:
    """Column-wise sum of squared residuals, (M,) (pls.cpp:457-459)."""
    r = residuals(fit, X_new, Y_new, comp)
    return (r * r).sum(-2)


def explained_variance(
    fit: PLSFit, X_new: torch.Tensor, Y_new: torch.Tensor, comp: int | None = None
) -> torch.Tensor:
    """1 − SSE/SST per response, (M,) (pls.cpp:461-467); SST uses Y_new's
    own column means, as the reference's `SST(Y_new)` does."""
    return 1.0 - sse(fit, X_new, Y_new, comp) / sst(Y_new)
