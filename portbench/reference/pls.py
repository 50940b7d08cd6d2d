"""Plain PLS regression and its validation, in PyTorch, as stated.

The benchmark's yardstick for what the program's timed jobs produce.  It
imports nothing of the program (`pls_tpu_torch`), of the JAX package
(`pls_tpu`) or of JAX, and follows the published algorithms step by step:

- `kernel_pls`: Dayal & MacGregor's improved kernel algorithms #1 and #2
  (J. Chemometrics 11 (1997) 73-85), as the reference CLI states them
  (tjhladish/PLS, pls.cpp `Model::plsr`): per component w from XᵀY (the
  dominant eigenvector of XYᵀXY for several responses), r by Gram-Schmidt
  against the earlier components, t = X r, p = Xᵀt / tᵀt (#1) or p = XᵀX r
  / rᵀXᵀX r (#2), q = XYᵀr / tᵀt, and XY deflated by rank one;
- `loo_errors`, `lso_errors`, `kfold_errors`: the held-out errors of
  leave-one-out refits, of leave-some-out trials over given partitions, and
  of k folds each refitted by algorithm #2 from XᵀX and XᵀY downdated by
  the fold's rows;
- `rmse`, `wilcoxon`, `admissible_counts`: PRESS/RMSE, the one-sided
  Wilcoxon signed-rank test with the reference's normal approximation, and
  the component counts its selection rule allows.

Every product goes through `Arith.mm`, so the same code computes the
reference (float64, `F64`) and the benchmark's controls: float32 with every
product's operands rounded to TF32 (`TF32`), the precision the program
would drop to with TF32 switched on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Finite float32 x rounded to TF32's 10-bit mantissa, to nearest
    even.  Adding to the bits as int32 is the unsigned addition, and no
    finite value carries past the sign bit."""
    b = x.view(torch.int32)
    return ((b + (0xFFF + ((b >> 13) & 1))) & -0x2000).view(torch.float32)


@dataclass(frozen=True)
class Arith:
    """The dtype of the reference's arithmetic, and whether each product's
    operands are first rounded to TF32."""

    dtype: torch.dtype
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return to_tf32(a) @ to_tf32(b)
        return a @ b


F64 = Arith(torch.float64)
TF32 = Arith(torch.float32, tf32=True)


@dataclass
class Fit:
    """W, P, R (…, K, A), Q (…, M, A), T (…, N, A) (empty for #2)."""

    W: torch.Tensor
    P: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor

    def coefficients(self) -> torch.Tensor:
        """B at every truncation c = 1..A: (…, A, K, M)."""
        return torch.cumsum(self.R.mT[..., :, :, None] * self.Q.mT[..., :, None, :], dim=-3)


def _vec(ar: Arith, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return ar.mm(A, v[..., None])[..., 0]


def _components(XY: torch.Tensor, A: int, ar: Arith, project) -> Fit:
    """The component loop shared by both algorithms; `project(r)` gives
    (t or None, tt, unnormalised p) of one component."""
    K, M = XY.shape[-2:]
    Ws, Ps, Qs, Rs, Ts = [], [], [], [], []
    for a in range(A):
        if M == 1:
            w = XY[..., 0]
        else:
            vecs = torch.linalg.eigh(ar.mm(XY.mT, XY)).eigenvectors
            w = _vec(ar, XY, vecs[..., -1])
        w = w / torch.sqrt((w * w).sum(-1, keepdim=True))
        r = w
        if a:
            Pm, Rm = torch.stack(Ps, -2), torch.stack(Rs, -1)  # (…, a, K), (…, K, a)
            r = w - _vec(ar, Rm, _vec(ar, Pm, w))
        t, tt, p = project(r)
        p = p / tt[..., None]
        q = _vec(ar, XY.mT, r) / tt[..., None]
        XY = XY - tt[..., None, None] * p[..., :, None] * q[..., None, :]
        Ws.append(w)
        Ps.append(p)
        Qs.append(q)
        Rs.append(r)
        if t is not None:
            Ts.append(t)
    T = torch.stack(Ts, -1) if Ts else XY.new_zeros((*XY.shape[:-2], 0, A))
    return Fit(W=torch.stack(Ws, -1), P=torch.stack(Ps, -1), Q=torch.stack(Qs, -1),
               R=torch.stack(Rs, -1), T=T)


def kernel_pls(X: torch.Tensor, Y: torch.Tensor, A: int, ar: Arith = F64) -> Fit:
    """Algorithm #1 on X (…, N, K), Y (…, N, M), in `ar`'s arithmetic."""
    X, Y = X.to(ar.dtype), Y.to(ar.dtype)

    def project(r):
        t = _vec(ar, X, r)
        return t, (t * t).sum(-1), _vec(ar, X.mT, t)

    return _components(ar.mm(X.mT, Y), A, ar, project)


def kernel_pls_from_stats(XX: torch.Tensor, XY: torch.Tensor, A: int, ar: Arith = F64) -> Fit:
    """Algorithm #2 from XᵀX (…, K, K) and XᵀY (…, K, M)."""

    def project(r):
        p = _vec(ar, XX, r)
        return None, (r * p).sum(-1), p

    return _components(XY, A, ar, project)


def residuals(fit: Fit, X: torch.Tensor, Y: torch.Tensor, ar: Arith = F64) -> torch.Tensor:
    """Y − X B(c) for every truncation c = 1..A: (…, n, A, M)."""
    S = ar.mm(X.to(ar.dtype), fit.R)  # (…, n, A)
    return Y.to(ar.dtype)[..., :, None, :] - torch.cumsum(
        S[..., :, :, None] * fit.Q.mT[..., None, :, :], dim=-2)


def z_scores(X: torch.Tensor) -> torch.Tensor:
    """Column z-scores with the unbiased standard deviation; a constant
    column maps to 0."""
    d = X - X.mean(0)
    sd = torch.sqrt((d * d).sum(0) / (X.shape[0] - 1))
    return d / torch.where(sd == 0, torch.ones_like(sd), sd)


def explained_variance(fit: Fit, X: torch.Tensor, Y: torch.Tensor, ar: Arith = F64):
    """(A, M): 1 − SSE(c) / SST at every truncation."""
    E = residuals(fit, X, Y, ar)
    Yc = Y.to(ar.dtype) - Y.to(ar.dtype).mean(0)
    return 1 - (E * E).sum(0) / (Yc * Yc).sum(0)


def loo_errors(X, Y, A: int, ar: Arith = F64) -> torch.Tensor:
    """(M, N, A): row i's errors under the fit to the other N − 1 rows."""
    N = X.shape[0]
    keep = torch.tensor([[j for j in range(N) if j != i] for i in range(N)], device=X.device)
    fit = kernel_pls(X[keep], Y[keep], A, ar)
    E = residuals(fit, X[:, None, :], Y[:, None, :], ar)[:, 0]  # (N, A, M)
    return E.permute(2, 0, 1)


def lso_errors(X, Y, A: int, partitions: torch.Tensor, train: int, ar: Arith = F64,
               batch: int = 100) -> torch.Tensor:
    """(M, trials·test, A), trial-major: each trial fits its first `train`
    rows of `partitions` (trials, N) and is tested on the rest."""
    out = []
    for lo in range(0, partitions.shape[0], batch):
        part = partitions[lo:lo + batch].to(X.device)
        fit = kernel_pls(X[part[:, :train]], Y[part[:, :train]], A, ar)
        out.append(residuals(fit, X[part[:, train:]], Y[part[:, train:]], ar))  # (F, test, A, M)
    E = torch.cat(out)
    return E.permute(3, 0, 1, 2).reshape(Y.shape[1], -1, A)


def kfold_errors(X, Y, assign: torch.Tensor, k: int, A: int, ar: Arith = F64) -> torch.Tensor:
    """(M, N, A): fold f (the rows labelled f in `assign`) refitted by
    algorithm #2 from XᵀX − XfᵀXf and XᵀY − XfᵀYf, its rows' errors under
    that fit."""
    X, Y = X.to(ar.dtype), Y.to(ar.dtype)
    XX, XY = ar.mm(X.mT, X), ar.mm(X.mT, Y)
    E = X.new_zeros((X.shape[0], A, Y.shape[1]))
    for f in range(k):
        rows = torch.nonzero(assign.to(X.device) == f)[:, 0]
        Xf, Yf = X[rows], Y[rows]
        fit = kernel_pls_from_stats(XX - ar.mm(Xf.mT, Xf), XY - ar.mm(Xf.mT, Yf), A, ar)
        E[rows] = residuals(fit, Xf, Yf, ar)
    return E.permute(2, 0, 1)


def press(errors: torch.Tensor) -> torch.Tensor:
    """(M, A) sums of squared errors of (M, n, A)."""
    return (errors.double() ** 2).sum(1)


def rmse(errors: torch.Tensor) -> torch.Tensor:
    """(M, A) root mean squared errors."""
    return torch.sqrt(press(errors) / errors.shape[1])


def normalcdf(z: float) -> float:
    """The reference's Abramowitz & Stegun approximation (26.2.19 with
    four terms) of the standard normal distribution function."""
    a = abs(z)
    d = 1 + 0.196854 * a + 0.115194 * a**2 + 0.000344 * a**3 + 0.019527 * a**4
    p = 0.5 / d**4
    return p if z < 0 else 1 - p


def wilcoxon(e1: torch.Tensor, e2: torch.Tensor) -> float:
    """P{V at least as large as observed} for paired errors e1 (candidate)
    and e2: the signed-rank sum of |e1| − |e2|, ranked by magnitude with
    ties in their given order, under the normal approximation."""
    n = e1.shape[0]
    delta = e1.double().abs() - e2.double().abs()
    order = torch.argsort(delta.abs(), stable=True)
    ranks = torch.arange(1, n + 1, device=delta.device, dtype=torch.int64)
    d = int((ranks * torch.sign(delta[order]).to(torch.int64)).sum())
    t = n * (n + 1) / 2
    z = ((t - d) / 2 - t / 2) / math.sqrt(n * (n + 1) * (2 * n + 1) / 24)
    return 1 - normalcdf(z)


def admissible_counts(errors: torch.Tensor, alpha: float = 0.1, p_margin: float = 0.0,
                      press_margin: float = 0.0) -> list[set[int]]:
    """Per response, the component counts (1-based) that the selection rule
    gives: the least-PRESS count r (first minimum), unless a smaller count c
    is not significantly worse, P(c against r) > alpha, the first such c.
    A decision within a margin counts both ways: each r whose PRESS lies
    within `press_margin` (relative) of the least, and each c whose p-value
    lies within `p_margin` of alpha, so that rounding at a borderline
    decision is not read as a wrong choice."""
    P = press(errors)
    out = []
    for m in range(errors.shape[0]):
        allowed: set[int] = set()
        least = float(P[m].min())
        for r in range(errors.shape[2]):
            if float(P[m, r]) > least * (1 + press_margin) and r != int(P[m].argmin()):
                continue
            for c in range(r):
                p = wilcoxon(errors[m, :, r], errors[m, :, c])
                if p > alpha + p_margin:
                    allowed.add(c + 1)
                    break
                if p >= alpha - p_margin:
                    allowed.add(c + 1)
            else:
                allowed.add(r + 1)
        out.append(allowed)
    return out


def calibration(X_raw, Y_raw, A: int, partitions: torch.Tensor, train: int,
                ar: Arith = F64) -> dict:
    """The reference CLI's job on raw X and Y: z-score both, fit algorithm
    #1, the state and the explained variance, then the errors of
    leave-one-out and of the leave-some-out trials of `partitions`."""
    X = z_scores(X_raw.to(ar.dtype))
    Y = z_scores(Y_raw.to(ar.dtype))
    fit = kernel_pls(X, Y, A, ar)
    return {
        "state": {"P": fit.P, "W": fit.W, "R": fit.R, "Q": fit.Q, "T": fit.T,
                  "coefficients": fit.coefficients()[-1]},
        "ev": explained_variance(fit, X, Y, ar),
        "loo": loo_errors(X, Y, A, ar),
        "lso": lso_errors(X, Y, A, partitions, train, ar),
    }
