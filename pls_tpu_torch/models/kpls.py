"""Nonlinear kernel PLS in the dual (Rosipal & Trejo 2001, JMLR 2:97).

Counterpart of `pls_tpu/models/kpls.py`.  An N×N Gram matrix Kg[i,j] =
k(xᵢ, xⱼ) takes X's place; per component, on the centred Gram matrix Kc
and Y:

    c  = dominant eigenvector of Yᵀ Kc Y (M > 1); t = Kc Y c, normalised
    u  = Y (Yᵀ t)
    Kc ← (I − ttᵀ) Kc (I − ttᵀ) ;  Y ← Y − t (tᵀY)

Prediction (the paper's eq. 12): Ŷ = K̃_test U (Tᵀ Kc₀ U)⁻¹ Tᵀ Y₀, with the
test kernel centred against the training Gram matrix.  The JAX package's
`lax.scan` over components is a Python loop; memory is O(N²).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.models.kernel_pls import _prec_ctx
from pls_tpu_torch.ops.eigen import dominant_eigenvector


def kernel_matrix(
    X1: torch.Tensor,
    X2: torch.Tensor,
    kernel: str = "rbf",
    *,
    gamma: float | None = None,
    degree: int = 3,
    coef0: float = 1.0,
) -> torch.Tensor:
    """(n1, n2) Gram matrix between the rows of X1 and X2: "linear" x·z,
    "poly" (γ x·z + coef0)^degree, "rbf" exp(−γ‖x−z‖²); gamma defaults
    to 1/K."""
    if gamma is None:
        gamma = 1.0 / X1.shape[1]
    if kernel == "linear":
        return X1 @ X2.T
    if kernel == "poly":
        return (gamma * (X1 @ X2.T) + coef0) ** degree
    if kernel == "rbf":
        sq = (X1 * X1).sum(1)[:, None] - 2.0 * (X1 @ X2.T) + (X2 * X2).sum(1)[None, :]
        return torch.exp(-gamma * torch.clamp(sq, min=0.0))
    raise ValueError(f"unknown kernel {kernel!r}")


@dataclass(frozen=True)
class KPLSFit:
    """Dual-space state: T, U (N, A) scores; Kg (N, N) the uncentred
    training Gram matrix; Y (N, M) and X (N, K) the training data; and the
    kernel's hyper-parameters."""

    T: torch.Tensor
    U: torch.Tensor
    Kg: torch.Tensor
    Y: torch.Tensor
    X: torch.Tensor
    kernel: str = "rbf"
    gamma: float | None = None
    degree: int = 3
    coef0: float = 1.0

    @property
    def A(self) -> int:
        return self.T.shape[-1]


def _center_train(Kg: torch.Tensor) -> torch.Tensor:
    return Kg - Kg.mean(1, keepdim=True) - Kg.mean(0, keepdim=True) + Kg.mean()


def _center_test(Kt: torch.Tensor, Kg: torch.Tensor) -> torch.Tensor:
    """K̃_t = (Kt − (1/N)1 1ᵀKg)(I − (1/N)11ᵀ)."""
    Ac = Kt - Kg.mean(0, keepdim=True)
    return Ac - Ac.mean(1, keepdim=True)


def _kpls_loop(Kc, Y, A, power_iters, precision):
    M = Y.shape[1]
    Ts, Us = [], []
    with _prec_ctx(precision):
        Kd, Yd = Kc, Y
        for _ in range(A):
            if M == 1:
                t = Kd @ Yd[:, 0]
            else:
                c = dominant_eigenvector(Yd.T @ (Kd @ Yd), power_iters)
                t = Kd @ (Yd @ c)
            t = t / torch.sqrt(t @ t)
            u = Yd @ (Yd.T @ t)
            Kt = Kd - torch.outer(t, t @ Kd)
            Kd = Kt - torch.outer(Kt @ t, t)
            Yd = Yd - torch.outer(t, t @ Yd)
            Ts.append(t)
            Us.append(u)
    return torch.stack(Ts, 1), torch.stack(Us, 1)


def fit_kpls(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    kernel: str = "rbf",
    *,
    gamma: float | None = None,
    degree: int = 3,
    coef0: float = 1.0,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> KPLSFit:
    """An A-component kernel PLS fit.  Y centred; X need not be (the Gram
    matrix is centred in feature space)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if not (0 < A < N):
        raise ValueError(f"A={A} must satisfy 0 < A < N={N}")
    Y = Y.to(X.dtype)
    Kg = kernel_matrix(X, X, kernel, gamma=gamma, degree=degree, coef0=coef0)
    T, U = _kpls_loop(_center_train(Kg), Y, A, power_iters, precision)
    return KPLSFit(T=T, U=U, Kg=Kg, Y=Y, X=X, kernel=kernel, gamma=gamma, degree=degree,
                   coef0=coef0)


def predict_kpls(fit: KPLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Predicted Y for new X at truncation `comp` (default all A)."""
    c = fit.A if comp is None else int(comp)
    if not (0 < c <= fit.A):
        raise ValueError(f"comp={c} out of range 1..{fit.A}")
    Tc, Uc = fit.T[:, :c], fit.U[:, :c]
    Kt = kernel_matrix(X_new.to(fit.X.dtype), fit.X, fit.kernel, gamma=fit.gamma,
                       degree=fit.degree, coef0=fit.coef0)
    G = Tc.T @ (_center_train(fit.Kg) @ Uc)
    return _center_test(Kt, fit.Kg) @ (Uc @ torch.linalg.solve(G, Tc.T @ fit.Y))
