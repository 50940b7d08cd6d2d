"""PLS-GLM: PLS regression for binomial and Poisson responses (Bastien,
Esposito Vinzi & Tenenhaus 2005), in the iteratively reweighted form.

Counterpart of `pls_tpu/models/plsglm.py`:

    repeat n_irls times:
        μ = g⁻¹(η) ;  W = μ(1−μ) (binomial) or μ (poisson), clipped at 1e-6
        z = η + (y − μ)/W
        weighted-centre X and z, fit an A-component weighted PLS of z on X
        η = b0 + X b

With A = K it is Fisher scoring (an unregularised GLM); fewer components
shrink as PLS does.  The JAX package's `lax.scan` over the iterations is
a Python loop of `kernel_pls.fit` calls: kernel type 1 on float32 X on the
card launches K1 A times per iteration.  The loop reads nothing back to
the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.models.kernel_pls import fit as _fit
from pls_tpu_torch.models.predict import _promote, coefficients
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD, PLSFit

__all__ = ["PLSGLMFit", "fit_plsglm", "predict_plsglm"]

_EPS = 1e-6


@dataclass(frozen=True)
class PLSGLMFit:
    """pls: the final weighted PLSFit; coef (K,) on the standardised X
    scale; intercept, deviance: 0-d tensors; family "binomial" or
    "poisson"."""

    pls: PLSFit
    coef: torch.Tensor
    intercept: torch.Tensor
    deviance: torch.Tensor
    family: str = "binomial"


def _inv_link(eta, family):
    if family == "binomial":
        return torch.sigmoid(eta)
    return torch.exp(torch.clamp(eta, -30.0, 30.0))


def _deviance(y, mu, family):
    if family == "binomial":
        ll = y * torch.log(torch.clamp(mu, _EPS, 1.0)) + (1 - y) * torch.log(
            torch.clamp(1 - mu, _EPS, 1.0))
        return -2.0 * ll.sum()
    term = torch.where(y > 0, y * torch.log(torch.clamp(y / mu, min=_EPS)), torch.zeros_like(y))
    return 2.0 * (term - (y - mu)).sum()


def fit_plsglm(
    X: torch.Tensor,
    y: torch.Tensor,
    A: int,
    family: str = "binomial",
    method: METHOD = KERNEL_TYPE1,
    *,
    n_irls: int = 25,
    precision: str | None = "highest",
) -> PLSGLMFit:
    """A PLS-GLM on centred/standardised X (N, K) and y (N,): {0,1} labels
    (binomial) or counts (poisson); A components per IRLS step."""
    if family not in ("binomial", "poisson"):
        raise ValueError(f"unknown family {family!r}")
    y = torch.as_tensor(y, dtype=X.dtype, device=X.device).reshape(-1)
    N = X.shape[0]
    ybar = torch.clamp(y.mean(), min=_EPS)
    if family == "binomial":
        ybar = torch.clamp(ybar, _EPS, 1 - _EPS)
        eta0 = torch.log(ybar / (1 - ybar))
    else:
        eta0 = torch.log(ybar)

    def irls_once(eta):
        mu = _inv_link(eta, family)
        w = torch.clamp(mu * (1 - mu) if family == "binomial" else mu, min=_EPS)
        z = eta + (y - mu) / w
        # weighted least squares of z on [1, X]: weighted-centre both sides
        sw = w.sum()
        xbar = (w @ X) / sw
        zbar = (w @ z) / sw
        f = _fit(X - xbar[None, :], (z - zbar)[:, None], A, method, sample_weight=w,
                 precision=precision)
        b = coefficients(f)[:, 0]
        b0 = zbar - xbar @ b
        return f, b, b0, b0 + X @ b

    # the first step outside the loop, as the JAX package's scan carries
    # its result: pls/coef/intercept/eta all describe the last iterate
    f, b, b0, eta = irls_once(eta0.expand(N).clone())
    for _ in range(max(n_irls - 1, 0)):
        f, b, b0, eta = irls_once(eta)
    return PLSGLMFit(pls=f, coef=b, intercept=b0,
                     deviance=_deviance(y, _inv_link(eta, family), family), family=family)


def predict_plsglm(fit: PLSGLMFit, X_new: torch.Tensor, *, linear: bool = False) -> torch.Tensor:
    """Predicted mean response (probability or rate) for new standardised
    X; linear=True gives the linear predictor η."""
    X_new, coef = _promote(X_new, fit.coef)
    eta = fit.intercept + X_new @ coef
    return eta if linear else _inv_link(eta, fit.family)
