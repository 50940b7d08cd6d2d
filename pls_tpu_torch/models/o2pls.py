"""O2PLS: bidirectional orthogonal PLS (Trygg 2003; the algorithm of el
Bouhaddani et al. 2016, OmicsPLS's `o2m`).

Counterpart of `pls_tpu/models/o2pls.py`.  Two blocks split into a joint
part, block-specific orthogonal parts and noise:

    X = T Wᵀ + T_Yosc P_Yoscᵀ + E        Y = U Cᵀ + U_Xosc Q_Xoscᵀ + F

with U ≈ T B_T and T ≈ U B_U, so prediction runs both ways.  Per
X-orthogonal component: W ← svdₙ(XᵀY).u, T = XW, w⊥ the dominant left
singular vector of (X − TWᵀ)ᵀT (from its n×n Gram matrix), t⊥ = Xw⊥,
p⊥ = Xᵀt⊥/t⊥ᵀt⊥, X ← X − t⊥p⊥ᵀ; Y symmetrically; then the joint model on
the filtered blocks, with the thin SVD of the K×M XᵀY and the two n×n
solves for B_T, B_U.  All torch products and `torch.linalg` calls; no
kernel.  Blocks that are not tensors go to `device` (None: the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models.kernel_pls import _prec_ctx
from pls_tpu_torch.models.predict import _promote
from pls_tpu_torch.ops.eigen import dominant_eigenvector

__all__ = ["O2PLSFit", "fit_o2pls", "predict_y", "predict_x", "transform"]


@dataclass(frozen=True)
class O2PLSFit:
    """O2PLS state.

    Joint:      W (K, n), C (M, n), scores T = X_f W, U = Y_f C on the
                filtered training blocks; inner regressions B_T, B_U (n, n).
    X-orth:     W_Yosc, P_Yosc (K, nx), scores T_Yosc (N, nx).
    Y-orth:     C_Xosc, Q_Xosc (M, ny), scores U_Xosc (N, ny).
    r2x/r2y_joint, r2x/r2y_orth: shares of each block's total sum of
                squares in the joint and orthogonal parts.
    """

    W: torch.Tensor
    C: torch.Tensor
    T: torch.Tensor
    U: torch.Tensor
    B_T: torch.Tensor
    B_U: torch.Tensor
    W_Yosc: torch.Tensor
    P_Yosc: torch.Tensor
    T_Yosc: torch.Tensor
    C_Xosc: torch.Tensor
    Q_Xosc: torch.Tensor
    U_Xosc: torch.Tensor
    r2x_joint: torch.Tensor
    r2y_joint: torch.Tensor
    r2x_orth: torch.Tensor
    r2y_orth: torch.Tensor

    @property
    def n_joint(self) -> int:
        return self.W.shape[-1]


def _svd_joint(XY: torch.Tensor, n: int):
    """Leading n left/right singular vectors of the K×M cross-product.  On
    the card by cuSOLVER's QR-based `gesvd`: torch's default there, the
    Jacobi `gesvdj`, left float32 predictions 4e-3 from float64 at
    100000×5000 against 500 columns (an H100), where the CPU's LAPACK
    stays within 2e-5."""
    u, _, vt = torch.linalg.svd(XY, full_matrices=False, driver="gesvd" if XY.is_cuda else None)
    return u[:, :n], vt[:n, :].T


def _dominant_left(G: torch.Tensor, power_iters):
    """Dominant left singular vector of skinny G (K, n) via the n×n Gram."""
    w = G @ dominant_eigenvector(G.T @ G, power_iters)
    return w / torch.sqrt(w @ w)


def _orth_filter(X, Y, n, steps, power_iters, x_side: bool):
    """`steps` orthogonal components stripped from X (x_side) or from Y:
    (the filtered block, weights, loadings, scores)."""
    Ws, Ps, Ts = [], [], []
    for _ in range(steps):
        W, C = _svd_joint(X.T @ Y, n)
        B, V = (X, W) if x_side else (Y, C)
        S = B @ V
        w_o = _dominant_left((B - S @ V.T).T @ S, power_iters)
        t_o = B @ w_o
        p_o = (B.T @ t_o) / (t_o @ t_o)
        B = B - torch.outer(t_o, p_o)
        X, Y = (B, Y) if x_side else (X, B)
        Ws.append(w_o)
        Ps.append(p_o)
        Ts.append(t_o)
    return (X if x_side else Y), Ws, Ps, Ts


def fit_o2pls(
    X,
    Y,
    n: int,
    nx: int = 0,
    ny: int = 0,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
    device=None,
) -> O2PLSFit:
    """`n` joint components plus `nx` X-orthogonal and `ny` Y-orthogonal
    ones.  Both blocks centred (z-scored) by the caller.  nx = ny = 0 is
    the PLS-SVD joint model."""
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but Y has {Y.shape[0]}")
    if not (1 <= n <= min(X.shape[1], Y.shape[1])):
        raise ValueError(f"n={n} must be in [1, min(K={X.shape[1]}, M={Y.shape[1]})]")
    if nx < 0 or ny < 0:
        raise ValueError("nx and ny must be >= 0")
    ssx_total = (X * X).sum()
    ssy_total = (Y * Y).sum()
    with _prec_ctx(precision):
        X, W_Y, P_Y, T_Y = _orth_filter(X, Y, n, nx, power_iters, True)
        Y, C_X, Q_X, U_X = _orth_filter(X, Y, n, ny, power_iters, False)
        W, C = _svd_joint(X.T @ Y, n)
        T = X @ W
        U = Y @ C
        B_T = torch.linalg.solve(T.T @ T, T.T @ U)
        B_U = torch.linalg.solve(U.T @ U, U.T @ T)

    def stack(vs, d):
        return torch.stack(vs, -1) if vs else X.new_zeros((d, 0))

    N, K, M = X.shape[0], X.shape[1], Y.shape[1]
    P_Yosc, Q_Xosc = stack(P_Y, K), stack(Q_X, M)
    T_Yosc, U_Xosc = stack(T_Y, N), stack(U_X, N)
    return O2PLSFit(
        W=W, C=C, T=T, U=U, B_T=B_T, B_U=B_U,
        W_Yosc=stack(W_Y, K), P_Yosc=P_Yosc, T_Yosc=T_Yosc,
        C_Xosc=stack(C_X, M), Q_Xosc=Q_Xosc, U_Xosc=U_Xosc,
        r2x_joint=(T * T).sum() / ssx_total,
        r2y_joint=(U * U).sum() / ssy_total,
        r2x_orth=(T_Yosc * T_Yosc).sum(0) * (P_Yosc ** 2).sum(0) / ssx_total,
        r2y_orth=(U_Xosc * U_Xosc).sum(0) * (Q_Xosc ** 2).sum(0) / ssy_total,
    )


def _correct(B: torch.Tensor, V: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """The orthogonal filter on new data, component by component."""
    B, V, P = _promote(B, V, P)
    for j in range(V.shape[1]):
        B = B - torch.outer(B @ V[:, j], P[:, j])
    return B


def transform(f: O2PLSFit, X_new=None, Y_new=None):
    """Joint scores of new data after orthogonal correction: (T_new,
    U_new); either is None where its block was not given."""
    T_new = U_new = None
    if X_new is not None:
        Xf = _correct(as_data(X_new, f.W.device), f.W_Yosc, f.P_Yosc)
        T_new = Xf @ f.W.to(Xf.dtype)
    if Y_new is not None:
        Yf = _correct(as_data(Y_new, f.C.device), f.C_Xosc, f.Q_Xosc)
        U_new = Yf @ f.C.to(Yf.dtype)
    return T_new, U_new


def predict_y(f: O2PLSFit, X_new) -> torch.Tensor:
    """Ŷ = T_new B_T Cᵀ with T_new the corrected joint X-scores."""
    T_new, _ = transform(f, X_new=X_new)
    return T_new @ f.B_T.to(T_new.dtype) @ f.C.T.to(T_new.dtype)


def predict_x(f: O2PLSFit, Y_new) -> torch.Tensor:
    """X̂ = U_new B_U Wᵀ, the Y→X direction."""
    _, U_new = transform(f, Y_new=Y_new)
    return U_new @ f.B_U.to(U_new.dtype) @ f.W.T.to(U_new.dtype)
