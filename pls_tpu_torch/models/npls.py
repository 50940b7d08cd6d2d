"""N-PLS: trilinear (three-way) partial least squares (Bro 1996).

Counterpart of `pls_tpu/models/npls.py`.  Each component's X-weight is a
rank-1 outer product wᴶ ⊗ wᴷ; per component a, on the deflated E (I, J,
K) and the working response u:

    S = Σᵢ uᵢ Eᵢ··                 (J × K)
    wᴷ = dominant right singular vector of S (fixed power iterations on
         SᵀS from the start Σⱼ S²ⱼ·) ;  wᴶ = S wᴷ / ‖S wᴷ‖
    tᵢ = Σⱼₖ Eᵢⱼₖ wᴶⱼ wᴷₖ
    [M > 1] q = Yᵀt/‖Yᵀt‖, u = Yq, repeated `u_iter` times
    E ← E − t ∘ (wᴶ ∘ wᴷ) ;  Ŷ = T B by least squares on the scores so far

The contractions are products on E unfolded to (I, J·K); the JAX
package's scans are Python loops with its iteration counts and ε; E is
deflated in place in a copy of X.  New-data scores replay the
contract-and-deflate with the stored weight pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.utils.checkpoint import register_checkpointable


@register_checkpointable
@dataclass(frozen=True)
class NPLSFit:
    """Trilinear PLS fit.

    WJ : (J, A) second-mode weights     WK : (K, A) third-mode weights
    T  : (I, A) sample scores           Q  : (M, A) y-weights
    B  : (A, M) inner regression (Ŷ = T B)
    """

    WJ: torch.Tensor
    WK: torch.Tensor
    T: torch.Tensor
    Q: torch.Tensor
    B: torch.Tensor
    method: str = "npls"

    @property
    def A(self) -> int:
        return self.WJ.shape[-1]


def _dominant_pair(S: torch.Tensor, n_iter: int):
    """Leading singular pair of S (J, K) by power iteration on SᵀS."""
    eps = torch.finfo(S.dtype).tiny
    v = (S * S).sum(0)  # deterministic, SᵀS-aligned start
    v = v / (torch.linalg.vector_norm(v) + eps)
    for _ in range(n_iter):
        v = S.T @ (S @ v)
        v = v / (torch.linalg.vector_norm(v) + eps)
    wj = S @ v
    return wj / (torch.linalg.vector_norm(wj) + eps), v


def _contract(E2: torch.Tensor, wj: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """t = Σⱼₖ Eᵢⱼₖ wᴶⱼ wᴷₖ on E unfolded to (I, J·K)."""
    return E2 @ torch.outer(wj, wk).reshape(-1)


def fit_npls(
    X,
    Y,
    A: int,
    *,
    n_iter: int = 30,
    u_iter: int = 10,
    device=None,
) -> NPLSFit:
    """Fit trilinear PLS: X (I, J, K) and Y (I, M), centred along mode 0
    by the caller."""
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    I, J, K = X.shape
    M = Y.shape[1]
    eps = torch.finfo(X.dtype).tiny
    E = X.reshape(I, J * K).clone()
    Yd = Y
    T = X.new_zeros((I, A))
    WJs, WKs, Ts, Qs = [], [], [], []
    Bc = None
    for a in range(A):
        u = Yd[:, 0]
        # M == 1 converges in one pass; M > 1 runs the u-iteration u_iter times
        for _ in range(1 if M == 1 else u_iter):
            S = (u @ E).reshape(J, K)
            wj, wk = _dominant_pair(S, n_iter)
            t = _contract(E, wj, wk)
            q = Yd.T @ t
            q = q / (torch.linalg.vector_norm(q) + eps)
            u = Yd @ q
        E.addr_(t, torch.outer(wj, wk).reshape(-1), alpha=-1)
        T[:, a] = t
        G = T.T @ T + torch.eye(A, dtype=X.dtype, device=X.device) * 1e-12
        Bc = torch.linalg.solve(G, T.T @ Y)
        Yd = Y - T @ Bc
        WJs.append(wj)
        WKs.append(wk)
        Ts.append(t)
        Qs.append(q)
    return NPLSFit(WJ=torch.stack(WJs, 1), WK=torch.stack(WKs, 1), T=torch.stack(Ts, 1),
                   Q=torch.stack(Qs, 1), B=Bc)


def scores_npls(fit: NPLSFit, X_new) -> torch.Tensor:
    """(n, A) scores of new (centred) tensors: contract and deflate with
    the stored weight pairs in turn."""
    X_new = as_data(X_new, fit.WJ.device)
    n = X_new.shape[0]
    E = X_new.reshape(n, -1).clone()
    WJ, WK = fit.WJ.to(E.dtype), fit.WK.to(E.dtype)
    ts = []
    for a in range(fit.A):
        t = _contract(E, WJ[:, a], WK[:, a])
        E.addr_(t, torch.outer(WJ[:, a], WK[:, a]).reshape(-1), alpha=-1)
        ts.append(t)
    return torch.stack(ts, 1)


def predict_npls(fit: NPLSFit, X_new) -> torch.Tensor:
    """Ŷ = T(X_new) B for new (centred) tensors."""
    S = scores_npls(fit, X_new)
    return S @ fit.B.to(S.dtype)
