"""Prediction and diagnostics on a fitted PLS model.

Counterpart of `pls_tpu/models/predict.py:29-100, 177-192` (reference
pls.cpp:439-467).  Every function also takes a fit with a leading fold
axis (from `kernel_pls.fit_folds`) together with fold-batched data.
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
