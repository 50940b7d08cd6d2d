"""Missing-data PLS: NaN-tolerant NIPALS and iterative PLS imputation.

Counterpart of `pls_tpu/models/missing.py`:

1. `fit_nipals_missing`: NIPALS whose inner regressions run over the
   present entries only (Nelson, Taylor & MacGregor 1996).  With the mask
   m (1 = observed) and zero-filled data, each update is a product of the
   data and one of the mask:

       w = (Xdᵀ u) / (mXᵀ u²) ,  t = (Xd w) / (mX w²)
       q = (Ydᵀ t) / (mYᵀ t²) ,  p = (Xdᵀ t) / (mXᵀ t²)
       Xd ← mX ∘ (Xd − t pᵀ) ,   Yd ← mY ∘ (Yd − t qᵀ)

   With nothing missing it is `fit_nipals`.  The JAX package's inner
   `lax.while_loop` is a Python loop with one host read of the
   convergence test an iteration, as models/nipals.py's;
   `last_iterations` holds the iterations each component of the last fit
   took.  R = W (PᵀW)⁺ with `torch.linalg.pinv` at `jnp.linalg.pinv`'s
   cutoff.  The products with the mask are torch products: the masked
   quotients are not K1's pass.
2. `impute_pls`: alternate a dense NIPALS fit (`models/nipals.py`: K1
   after each component's inner loop on float32 X on the card) with
   replacing the missing entries by the reconstruction T Pᵀ.

`nan_column_stats` gives the NaN-aware mean and stdev to z-score gappy
data.  Data that is not a tensor goes to `device` (None: the card).
"""

from __future__ import annotations

import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models.crossdecomp import pinv
from pls_tpu_torch.models.nipals import fit_nipals
from pls_tpu_torch.types import METHOD, PLSFit

# inner iterations of each component of the last `fit_nipals_missing`
last_iterations: list = []


def nan_column_stats(X, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, stdev) per column over the present entries: unbiased
    (count−1); a column with fewer than 2 present values or zero variance
    gets stdev 1."""
    X = as_data(X, device)
    m = torch.isfinite(X)
    X0 = torch.where(m, X, 0.0)
    cnt = m.sum(0)
    mean = X0.sum(0) / torch.clamp(cnt, min=1)
    dev = torch.where(m, X0 - mean[None, :], 0.0)
    var = (dev * dev).sum(0) / torch.clamp(cnt - 1, min=1)
    sd = torch.sqrt(var)
    return mean, torch.where((cnt < 2) | (sd == 0), 1.0, sd)


def _masked(X: torch.Tensor):
    m = torch.isfinite(X)
    return m.to(X.dtype), torch.where(m, X, 0.0)


def fit_nipals_missing(
    X,
    Y,
    A: int,
    *,
    tol: float = 1e-12,
    max_iter: int = 500,
    device=None,
) -> PLSFit:
    """NaN-tolerant NIPALS PLS2.  X (N, K) and Y (N, M) may hold NaNs
    (centred/scaled, e.g. by `nan_column_stats`); returns a `PLSFit` for
    the predict/CV stack on complete new data."""
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    N, K = X.shape
    eps = torch.finfo(X.dtype).tiny
    mX, Xd = _masked(X)
    mY, Yd = _masked(Y)
    last_iterations.clear()
    Ws, Ps, Qs, Ts = [], [], [], []
    for _ in range(A):
        u = Yd[:, 0]
        w = X.new_zeros(K)
        it, delta = 0, float("inf")
        while it < max_iter and delta > tol:
            w_new = (Xd.T @ u) / (mX.T @ (u * u) + eps)
            w_new = w_new / torch.sqrt(w_new @ w_new)
            t = (Xd @ w_new) / (mX @ (w_new * w_new) + eps)
            qn = (Yd.T @ t) / (mY.T @ (t * t) + eps)
            qn = qn / torch.sqrt(qn @ qn)
            u = (Yd @ qn) / (mY @ (qn * qn) + eps)
            delta = float(torch.sqrt(((w_new - w) ** 2).sum()))  # the host read
            w = w_new
            it += 1
        last_iterations.append(it)
        t = (Xd @ w) / (mX @ (w * w) + eps)
        p = (Xd.T @ t) / (mX.T @ (t * t) + eps)
        q = (Yd.T @ t) / (mY.T @ (t * t) + eps)
        Xd = mX * (Xd - torch.outer(t, p))
        Yd = mY * (Yd - torch.outer(t, q))
        Ws.append(w)
        Ps.append(p)
        Qs.append(q)
        Ts.append(t)
    W, P = torch.stack(Ws, 1), torch.stack(Ps, 1)
    R = W @ pinv(P.T @ W)
    return PLSFit(W=W, P=P, Q=torch.stack(Qs, 1), R=R, T=torch.stack(Ts, 1),
                  method=METHOD.NIPALS)


def scores_missing(fit: PLSFit, X_new) -> torch.Tensor:
    """(n, A) scores of new data that may hold NaNs: single-component
    projections over each sample's present entries, deflating in turn."""
    m, Xd = _masked(as_data(X_new, fit.W.device))
    eps = torch.finfo(Xd.dtype).tiny
    W, P = fit.W.to(Xd.dtype), fit.P.to(Xd.dtype)
    ts = []
    for a in range(fit.A):
        w, p = W[:, a], P[:, a]
        t = (Xd @ w) / (m @ (w * w) + eps)
        Xd = m * (Xd - torch.outer(t, p))
        ts.append(t)
    return torch.stack(ts, 1)


def predict_missing(fit: PLSFit, X_new) -> torch.Tensor:
    """Ŷ for (possibly gappy) new data: masked scores × y-loadings."""
    S = scores_missing(fit, X_new)
    return S @ fit.Q.T.to(S.dtype)


def impute_pls(
    X,
    Y,
    A: int,
    *,
    n_outer: int = 30,
    method: METHOD = METHOD.NIPALS,
    device=None,
) -> tuple[torch.Tensor, PLSFit]:
    """EM-style completion of the missing entries of X against a PLS
    model: zero fill (the column means of centred data), then `n_outer`
    rounds of a dense NIPALS fit and replacing the missing entries by
    T Pᵀ.  X/Y centred/scaled (NaNs only in X).  Returns (X_completed,
    the final dense fit)."""
    del method  # NIPALS reconstruction is the one with X-deflation geometry
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    m = torch.isfinite(X)
    Xc = torch.where(m, X, 0.0)
    for _ in range(n_outer):
        f = fit_nipals(Xc, Y, A)
        Xc = torch.where(m, Xc, f.T @ f.P.T)
    return Xc, fit_nipals(Xc, Y, A)
