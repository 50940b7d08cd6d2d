"""PLS-Cox: PLS dimension reduction for right-censored survival outcomes
(Nguyen & Rocke 2002; Bastien & Tenenhaus).

Counterpart of `pls_tpu/models/plscox.py`:

  1. the null Cox model's Breslow cumulative hazard Λ₀(tᵢ) and the
     martingale residuals Mᵢ = δᵢ − Λ₀(tᵢ);
  2. A PLS components of M on the standardised X (`kernel_pls.fit`, type
     1: K1 on float32 X on the card), on X's rows sorted by time;
  3. a Cox model on the A scores by a fixed number of Newton steps on the
     Breslow partial likelihood ((A, A) solves).

β = R γ gives the risk score η = Xβ of new samples.  The risk-set sums
Σ_{t_k ≥ t} f(k) are suffix cumulative sums over the time-sorted rows;
ties take their block's first (largest) risk set (Breslow).  The Newton
steps' solves are `torch.linalg.solve_ex`, which does not read its
status back to the host, so the loop runs without a host sync.
`concordance_index` is numpy on the host, O(N²) in memory, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models.kernel_pls import fit as _fit
from pls_tpu_torch.types import KERNEL_TYPE1, PLSFit

__all__ = ["PLSCoxFit", "fit_plscox", "predict_plscox", "concordance_index"]


@dataclass(frozen=True)
class PLSCoxFit:
    """PLS-Cox state.

    pls       : PLSFit of the martingale residuals on X (scores = X R)
    gamma     : (A,) Cox coefficients on the PLS scores
    coef      : (K,) composite risk coefficients β = R γ
    loglik    : () final Breslow partial log-likelihood
    score_norm: () ‖∂ℓ/∂γ‖∞ at the solution (convergence diagnostic)
    """

    pls: PLSFit
    gamma: torch.Tensor
    coef: torch.Tensor
    loglik: torch.Tensor
    score_norm: torch.Tensor


def _suffix_cumsum(v: torch.Tensor) -> torch.Tensor:
    """sᵢ = Σ_{j ≥ i} vⱼ along axis 0."""
    return torch.flip(torch.cumsum(torch.flip(v, [0]), 0), [0])


def _blocks(time_s: torch.Tensor):
    """(first, last): for each time-sorted position, the first and the last
    position of its tie block."""
    new = torch.ones_like(time_s, dtype=torch.bool)
    new[1:] = time_s[1:] != time_s[:-1]
    block = torch.cumsum(new.to(torch.int64), 0) - 1
    return (torch.searchsorted(block, block, side="left"),
            torch.searchsorted(block, block, side="right") - 1)


def _breslow_cumhaz(event_s, eta_s, first, last):
    """Breslow Λ₀ at each (sorted) sample's own time, tie-grouped."""
    risk = _suffix_cumsum(torch.exp(eta_s))
    # a death's increment uses its tie block's (first) risk set; Λ₀ at a
    # position sums the increments through the end of its block
    return torch.cumsum(event_s / risk[first], 0)[last]


def _cox_loglik_grad_hess(gamma, T_s, event_s, first):
    """Breslow partial log-likelihood, gradient and Hessian on the
    time-sorted scores T_s."""
    eta = T_s @ gamma
    w = torch.exp(eta)[:, None]  # (N, 1)
    s0 = _suffix_cumsum(w)[:, 0]
    s1 = _suffix_cumsum(w * T_s)  # (N, A)
    s2 = _suffix_cumsum(w[:, :, None] * T_s[:, :, None] * T_s[:, None, :])
    s0b, s1b, s2b = s0[first], s1[first], s2[first]
    d = event_s
    ll = (d * (eta - torch.log(s0b))).sum()
    xbar = s1b / s0b[:, None]
    grad = (d[:, None] * (T_s - xbar)).sum(0)
    V = s2b / s0b[:, None, None] - xbar[:, :, None] * xbar[:, None, :]
    hess = -(d[:, None, None] * V).sum(0)
    return ll, grad, hess


def fit_plscox(
    X,
    time,
    event,
    A: int = 2,
    *,
    n_newton: int = 20,
    precision: str | None = "highest",
    device=None,
) -> PLSCoxFit:
    """Fit a PLS-Cox survival model.  X: (N, K) standardised covariates;
    time: (N,) follow-up times; event: (N,) 1 = event observed, 0 =
    right-censored; A: PLS components (Cox covariates in stage 3)."""
    event_h = event if isinstance(event, torch.Tensor) else np.asarray(event)
    time_h = time if isinstance(time, torch.Tensor) else np.asarray(time)
    # checked here, before the data reaches the device, where a short
    # event would be gathered past its end
    if X.shape[0] != time_h.shape[0]:
        raise ValueError("X and time disagree on N")
    if event_h.reshape(-1).shape[0] != time_h.shape[0]:
        raise ValueError("event and time disagree on N")
    if not (1 <= A <= X.shape[1]):
        raise ValueError(f"A={A} out of range")
    X = as_data(X, device)
    time = torch.as_tensor(time_h, device=X.device)
    event = torch.as_tensor(event_h, device=X.device).reshape(-1).to(X.dtype)
    order = torch.argsort(time, stable=True)
    time_s, event_s, X_s = time[order], event[order], X[order]
    first, last = _blocks(time_s)

    # stage 1: null-model martingale residuals
    M = event_s - _breslow_cumhaz(event_s, torch.zeros_like(event_s), first, last)
    # stage 2: PLS of M on X
    f = _fit(X_s, (M - M.mean())[:, None], A, KERNEL_TYPE1, precision=precision)
    T_s = X_s @ f.R
    del X_s
    # stage 3: Newton on the Breslow partial likelihood over the scores
    ridge = 1e-10 * torch.eye(A, dtype=X.dtype, device=X.device)
    gamma = X.new_zeros(A)
    for _ in range(int(n_newton)):
        _, g, H = _cox_loglik_grad_hess(gamma, T_s, event_s, first)
        gamma = gamma - torch.linalg.solve_ex(H - ridge, g)[0]
    ll, g, _ = _cox_loglik_grad_hess(gamma, T_s, event_s, first)
    return PLSCoxFit(pls=f, gamma=gamma, coef=f.R @ gamma, loglik=ll,
                     score_norm=g.abs().max())


def predict_plscox(fit: PLSCoxFit, X_new) -> torch.Tensor:
    """Linear risk score η = X β (higher = higher hazard)."""
    X_new = as_data(X_new, fit.coef.device)
    return X_new @ fit.coef.to(X_new.dtype)


def concordance_index(time, event, risk) -> float:
    """Harrell's C-index of a risk score (higher risk should fail
    earlier).  O(N²) pairwise, on the host."""
    t, d, r = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
               for v in (time, event, risk))
    d = d.astype(bool)
    comparable = (t[:, None] < t[None, :]) & d[:, None]
    num = np.sum(comparable * (r[:, None] > r[None, :])) + 0.5 * np.sum(
        comparable * (r[:, None] == r[None, :])
    )
    den = np.sum(comparable)
    return float(num / den) if den else 0.5
