"""Sparse PLS: variable-selecting PLS by soft-thresholded weights (Lê Cao
et al. 2008, the mixOmics keepX formulation).

Counterpart of `pls_tpu/models/sparse.py`.  Per component the X weight
(and optionally the Y weight) is soft-thresholded so that exactly
`keep_x` (`keep_y`) variables survive, by a fixed `n_iter` alternating
iterations (the JAX package's `fori_loop`: a fixed count, so the Python
loop here reads nothing back to the host); then X and Y are
NIPALS-deflated.  The direct-score weights R (T = X R) come from the
Gram-Schmidt recurrence r = w − Σ_{j<a}(pⱼᵀw) rⱼ, so `models/predict.py`
serves the fit unchanged.  With keep_x = K and keep_y = M it is
classical NIPALS PLS2.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import _prec_ctx
from pls_tpu_torch.types import METHOD, PLSFit


def _soft_keep(v: torch.Tensor, keep: int) -> torch.Tensor:
    """Soft-threshold v so that its `keep` largest-|v| coordinates survive;
    keep >= len(v) leaves v as it is."""
    n = v.shape[0]
    if keep >= n:
        return v
    absv = v.abs()
    thr = torch.sort(absv).values[n - keep - 1]  # the (keep+1)-th largest magnitude
    return torch.sign(v) * torch.clamp(absv - thr, min=0.0)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(v @ v), min=1e-30)


def fit_spls(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    keep_x: int | tuple[int, ...],
    keep_y: int | tuple[int, ...] | None = None,
    *,
    n_iter: int = 20,
    precision: str | None = "highest",
) -> PLSFit:
    """An A-component sparse PLS fit (regression mode).  keep_x: X
    variables kept per component, one int or a length-A tuple; keep_y the
    same for Y (default all M).  Returns a PLSFit with method SPLS; W holds
    the sparse weights (`selected_variables` gives the support)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    K = X.shape[1]
    M = Y.shape[1]
    kx = (keep_x,) * A if isinstance(keep_x, int) else tuple(keep_x)
    if keep_y is None:
        keep_y = M
    ky = (keep_y,) * A if isinstance(keep_y, int) else tuple(keep_y)
    if len(kx) != A or len(ky) != A:
        raise ValueError(f"keep_x/keep_y must have length A={A}")
    if min(kx) < 1 or min(ky) < 1:
        raise ValueError("keep_x/keep_y entries must be >= 1")
    Y = Y.to(X.dtype)
    with _prec_ctx(precision):
        Xd, Yd = X, Y
        Ws, Ps, Qs, Ts, Rs = [], [], [], [], []
        for a in range(A):
            u = Yd[:, 0]
            w = X.new_zeros(K)
            for _ in range(n_iter):
                w = _unit(_soft_keep(Xd.T @ u, kx[a]))
                c = _unit(_soft_keep(Yd.T @ (Xd @ w), ky[a]))
                u = Yd @ c
            t = Xd @ w
            tt = t @ t
            p = (Xd.T @ t) / tt
            q = (Yd.T @ t) / tt
            r = w
            for pj, rj in zip(Ps, Rs):
                r = r - (pj @ w) * rj
            Xd = Xd - torch.outer(t, p)
            Yd = Yd - torch.outer(t, q)
            Ws.append(w)
            Ps.append(p)
            Qs.append(q)
            Ts.append(t)
            Rs.append(r)
    return PLSFit(
        W=torch.stack(Ws, 1), P=torch.stack(Ps, 1), Q=torch.stack(Qs, 1),
        R=torch.stack(Rs, 1), T=torch.stack(Ts, 1), method=METHOD.SPLS,
    )


def selected_variables(fit: PLSFit, comp: int | None = None) -> torch.Tensor:
    """(K,) bool: the X variables with a nonzero weight in any of the first
    `comp` components (the sPLS support)."""
    c = fit.A if comp is None else int(comp)
    return (fit.W[:, :c] != 0).any(1)
