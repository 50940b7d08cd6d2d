"""Cross-decomposition: PLS-canonical (mode A), CCA (mode B), PLS-SVD.

Counterpart of `pls_tpu/models/crossdecomp.py`, the two-block power
method with scikit-learn's conventions (its per-component sign fix: the
largest-|coefficient| entry of the x weight made positive).  Per
component, on the deflated Xd, Yd:

    mode A (PLSCanonical):  w ∝ Xdᵀu,  c ∝ Ydᵀt
    mode B (CCA):           w ∝ Xd⁺u,  c ∝ Yd⁺t
    t = Xd w, u = Yd c ;  Xd ← Xd − t pᵀ, p = Xdᵀt/tᵀt ;  Yd ← Yd − u qᵀ, q = Ydᵀu/uᵀu

PLS-SVD takes the top-A singular triplets of XᵀY at once.

The JAX package's `lax.while_loop` (converged when the squared change of
w drops below `tol`, or after `max_iter`) is a Python loop here whose
test is one host read per iteration, counted in `counts["host_reads"]`.
Mode B's pseudo-inverses pass `jnp.linalg.pinv`'s default cutoff,
rtol = 10·max(m, n)·eps, which is not `torch.linalg.pinv`'s (eps·max(m, n)).
`CDFit` is registered with `utils/checkpoint.py` (`save_fit`/
`load_fit`), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.utils.checkpoint import register_checkpointable

# host reads of the power iteration's convergence test, over all fits
# since the last reset
counts = {"host_reads": 0}


@register_checkpointable
@dataclass(frozen=True)
class CDFit:
    """A two-block fit: W (K, A) / C (M, A) weights, P / Q loadings, T / U
    (N, A) scores, R (K, A) / Ry (M, A) rotations (new-data scores Xn R,
    Yn Ry), and the mode ("canonical", "cca" or "svd")."""

    W: torch.Tensor
    C: torch.Tensor
    P: torch.Tensor
    Q: torch.Tensor
    T: torch.Tensor
    U: torch.Tensor
    R: torch.Tensor
    Ry: torch.Tensor
    mode: str = "canonical"

    @property
    def A(self) -> int:
        return self.W.shape[-1]


def pinv(a: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.pinv(a)`: singular values below 10·max(m, n)·eps of the
    largest are dropped."""
    return torch.linalg.pinv(a, rtol=10 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps)


def _sign_fix(w, c):
    s = torch.sign(w[torch.argmax(w.abs())])
    s = torch.where(s == 0, torch.ones_like(s), s)
    return w * s, c * s


def _power_pair(Xd, Yd, mode_b: bool, tol: float, max_iter: int):
    """The dominant weight pair (w, c) by two-block power iteration."""
    eps = torch.finfo(Xd.dtype).eps
    Xc, Yc = (pinv(Xd), pinv(Yd)) if mode_b else (Xd.T, Yd.T)

    def body(u):
        w = Xc @ u if mode_b else Xc @ u / (u @ u + eps)
        w = w / (torch.sqrt(w @ w) + eps)
        t = Xd @ w
        c = Yc @ t if mode_b else Yc @ t / (t @ t + eps)
        c = c / (torch.sqrt(c @ c) + eps)
        return w, c, Yd @ c / (c @ c + eps)

    # seed from the first Y column with entries above eps (a centred
    # constant column would give u = 0)
    live = (Yd.abs() > eps).any(0).to(torch.int8)
    w_old = torch.full((Xd.shape[1],), 100.0, dtype=Xd.dtype, device=Xd.device)
    w, c, u = body(Yd[:, torch.argmax(live)])
    it = 1
    while True:
        d = w - w_old
        counts["host_reads"] += 1
        if not (it < max_iter and bool(d @ d > tol)):
            return w, c
        w_old = w
        w, c, u = body(u)
        it += 1


def _fit_cd(X, Y, A: int, mode_b: bool, tol: float, max_iter: int) -> CDFit:
    eps = torch.finfo(X.dtype).eps
    Y = Y.to(X.dtype)
    Xd, Yd = X, Y
    outs = []
    for _ in range(A):
        w, c = _sign_fix(*_power_pair(Xd, Yd, mode_b, tol, max_iter))
        t = Xd @ w
        u = Yd @ c
        p = (Xd.T @ t) / (t @ t + eps)
        q = (Yd.T @ u) / (u @ u + eps)
        Xd = Xd - torch.outer(t, p)
        Yd = Yd - torch.outer(u, q)
        outs.append((w, c, p, q, t, u))
    W, C, P, Q, T, U = (torch.stack(v, 1) for v in zip(*outs))
    # rotations map the original (centred) data to the scores: T = X R, U = Y Ry
    return CDFit(W=W, C=C, P=P, Q=Q, T=T, U=U, R=W @ pinv(P.T @ W), Ry=C @ pinv(Q.T @ C),
                 mode="cca" if mode_b else "canonical")


def fit_plscanonical(X, Y, A: int, *, tol: float = 1e-6, max_iter: int = 500) -> CDFit:
    """Two-block mode-A PLS with symmetric deflation; X, Y centred, A ≤
    min(N, K, M)."""
    return _fit_cd(X, Y if Y.ndim == 2 else Y[:, None], A, False, tol, max_iter)


def fit_cca(X, Y, A: int, *, tol: float = 1e-6, max_iter: int = 500) -> CDFit:
    """Canonical correlation analysis by mode-B power iteration (weights
    through the blocks' pseudo-inverses); A ≤ min(N, K, M)."""
    return _fit_cd(X, Y if Y.ndim == 2 else Y[:, None], A, True, tol, max_iter)


def fit_plssvd(X, Y, A: int) -> CDFit:
    """One-shot PLS-SVD: the top-A singular triplets of XᵀY; loadings and
    rotations equal the (orthonormal) weights."""
    Y = (Y if Y.ndim == 2 else Y[:, None]).to(X.dtype)
    Uc, _, Vt = torch.linalg.svd(X.T @ Y, full_matrices=False)
    W, C = Uc[:, :A], Vt[:A].T
    idx = torch.argmax(W.abs(), 0)
    s = torch.sign(W[idx, torch.arange(A, device=W.device)])
    s = torch.where(s == 0, torch.ones_like(s), s)
    W, C = W * s, C * s
    return CDFit(W=W, C=C, P=W, Q=C, T=X @ W, U=Y @ C, R=W, Ry=C, mode="svd")


def cd_coefficients(fit: CDFit) -> torch.Tensor:
    """(K, M) coefficients B, Ŷ = X B for centred data: R Qᵀ."""
    return fit.R @ fit.Q.T


def cd_transform(fit: CDFit, Xn, Yn=None):
    """Scores of new centred data: Xn R (and Yn Ry when Yn is given)."""
    xs = Xn @ fit.R
    return xs if Yn is None else (xs, Yn @ fit.Ry)


def cd_predict(fit: CDFit, Xn) -> torch.Tensor:
    """Ŷ for new centred data."""
    return Xn @ cd_coefficients(fit)
