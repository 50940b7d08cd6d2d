"""Plain OPLS-DA, in PyTorch, as stated.

The benchmark's yardstick for the OPLS-DA cell.  It imports nothing of
the program (`pls_tpu_torch`), of the JAX package (`pls_tpu`) or of JAX;
the predictive fit is `reference/pls.py`'s, which is plain too.  TF32 is
switched off for every product it makes.  Following Trygg & Wold (J.
Chemometrics 16 (2002) 119-128) for the filter, Bylesjö et al. (J.
Chemometrics 20 (2006) 341-351) for OPLS-DA and Wiklund et al. (Anal.
Chem. 80 (2008) 115-122) for the S-plot:

- X z-scored with the column means and the N − 1 standard deviations (a
  constant column takes 1, so it maps to 0: the program's `ZScorer`);
- Y the one-hot indicators of the classes in sorted label order, centred
  by their column means (the class priors);
- the orthogonal filter, n_ortho components on the current X:
  w = XY q normalised, with XY = XᵀY and q the dominant eigenvector of
  XYᵀXY (`torch.linalg.eigh`); t = X w; p = Xᵀt / tᵀt;
  w_o = p − (wᵀp) w normalised; t_o = X w_o; p_o = Xᵀt_o / t_oᵀt_o;
  X ← X − t_o p_oᵀ;
- Dayal & MacGregor's kernel algorithm #1 of A components on the
  filtered X (`pls.kernel_pls`), and B = R[:, :c] Q[:, :c]ᵀ at every
  truncation c;
- `correct`: the filter applied to other rows, component by component,
  t_o = X w_o and X ← X − t_o p_oᵀ;
- the S-plot against the first predictive score t = X_f r₁ of the
  filtered training X: p(cov)_k = cov(t, x_k) and p(corr)_k = corr(t,
  x_k), N − 1 denominators, 0 for a column of no spread;
- the decision values of new spectra: z-scored with the training
  moments, filtered, times B, plus the class priors; the class is their
  argmax.

Departures from the papers:
- For several responses Trygg & Wold orthogonalise p against the whole
  Y-predictive weight space (the principal components of XᵀY's columns);
  here, as in the program, p is orthogonalised against the one dominant
  direction w = XY q.  With M classes this leaves M − 2 predictive
  directions that an orthogonal component may take part of.
- X is z-scored (unit variance), where metabolic phenotyping often uses
  Pareto scaling or none, and no normalisation of dilution (such as
  probabilistic quotient normalisation) comes first: the dilution is left
  to the filter.
- The weights come from XYᵀXY's eigenvector, not from NIPALS iterations,
  which converge to the same direction; an eigenvector's sign is
  arbitrary, so T_o, T and the S-plot compare up to sign.
- The S-plot's filtered training X is the filter's own last X, which
  equals the filter applied again to the z-scored training X (the
  program's `correct`) in exact arithmetic.

Also kept, unlimited: each component's relative eigengap (λ1 − λ2) / λ1
of the XYᵀXY whose eigenvector gives w (the filter's and the predictive
fit's, `gaps`), and each orthogonal component's ‖w_o‖ before its
normalisation (`wo_norms`): near zero, w_o's direction is ill defined in
any precision.

Every product goes through `Arith.mm`, so `fit(…, pls.TF32)` computes
the control: float32 with every product's operands rounded to TF32.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from portbench.reference import pls
from portbench.reference.plsda import eigengaps
from portbench.reference.pls import F64, Arith


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the products inside, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass
class Model:
    """The training moments (K,), the classes in sorted order, their
    priors (M,), the filter's W_o, P_o (K, n_ortho) and training T_o (N,
    n_ortho), the predictive fit on the filtered X, B at every truncation
    (A, K, M), the S-plot's (p_cov, p_corr) (K,) each, the eigengaps of
    the filter's and the fit's components, and the filter's ‖w_o‖ before
    normalisation (n_ortho,)."""

    mean: torch.Tensor
    sd: torch.Tensor
    classes: torch.Tensor
    priors: torch.Tensor
    W_o: torch.Tensor
    P_o: torch.Tensor
    T_o: torch.Tensor
    fit: pls.Fit
    B: torch.Tensor
    splot: tuple[torch.Tensor, torch.Tensor]
    gaps: torch.Tensor
    wo_norms: torch.Tensor

    def z(self, X: torch.Tensor) -> torch.Tensor:
        """X z-scored with the training moments."""
        return (X.to(self.mean.dtype) - self.mean) / self.sd

    def correct(self, X: torch.Tensor, ar: Arith = F64) -> tuple[torch.Tensor, torch.Tensor]:
        """(X filtered, T_o (n, n_ortho)) of z-scored X."""
        return correct(X, self.W_o, self.P_o, ar)

    def decision(self, X: torch.Tensor, ar: Arith = F64) -> torch.Tensor:
        """Decision values (n, M) of new X under B at all A components."""
        with _no_tf32():
            Xf, _ = self.correct(self.z(X), ar)
            return ar.mm(Xf, self.B[-1]) + self.priors


def _vec(ar: Arith, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return ar.mm(A, v[:, None])[:, 0]


def ortho_filter(X, Y, n_ortho: int, ar: Arith = F64):
    """(filtered X, W_o, P_o, T_o, eigengaps, ‖w_o‖ before normalisation)
    of n_ortho components on X (N, K) against Y (N, M ≥ 2)."""
    Ws, Ps, Ts, gaps, norms = [], [], [], [], []
    for _ in range(n_ortho):
        XY = ar.mm(X.mT, Y)
        lam, vecs = torch.linalg.eigh(ar.mm(XY.mT, XY))
        gaps.append((lam[-1] - lam[-2]) / lam[-1])
        w = _vec(ar, XY, vecs[:, -1])
        w = w / torch.sqrt((w * w).sum())
        t = _vec(ar, X, w)
        p = _vec(ar, X.mT, t) / (t * t).sum()
        w_o = p - (w * p).sum() * w
        norm = torch.sqrt((w_o * w_o).sum())
        w_o = w_o / norm
        t_o = _vec(ar, X, w_o)
        p_o = _vec(ar, X.mT, t_o) / (t_o * t_o).sum()
        X = X - t_o[:, None] * p_o[None, :]
        Ws.append(w_o)
        Ps.append(p_o)
        Ts.append(t_o)
        norms.append(norm)
    K, N = X.shape[1], X.shape[0]
    W_o = torch.stack(Ws, 1) if Ws else X.new_zeros((K, 0))
    P_o = torch.stack(Ps, 1) if Ps else X.new_zeros((K, 0))
    T_o = torch.stack(Ts, 1) if Ts else X.new_zeros((N, 0))
    return X, W_o, P_o, T_o, torch.stack(gaps).double(), torch.stack(norms).double()


def correct(X, W_o, P_o, ar: Arith = F64):
    """(X filtered, T_o) of X by the stored filter, component by
    component."""
    Ts = []
    for j in range(W_o.shape[1]):
        t_o = _vec(ar, X, W_o[:, j])
        X = X - t_o[:, None] * P_o[None, :, j]
        Ts.append(t_o)
    return X, torch.stack(Ts, 1) if Ts else X.new_zeros((X.shape[0], 0))


def s_plot(Xf: torch.Tensor, t: torch.Tensor, ar: Arith = F64):
    """(p_cov, p_corr) of the columns of Xf against the score t."""
    n = Xf.shape[0]
    tc = t - t.mean()
    Xc = Xf - Xf.mean(0)
    cov = _vec(ar, Xc.mT, tc) / (n - 1)
    sd_x = torch.sqrt((Xc * Xc).sum(0) / (n - 1))
    sd_t = torch.sqrt((tc * tc).sum() / (n - 1))
    pos = sd_x > 0
    return cov, torch.where(pos, cov / torch.where(pos, sd_x * sd_t, 1.0), 0.0)


def fit(X: torch.Tensor, labels: torch.Tensor, A: int, n_ortho: int,
        ar: Arith = F64) -> Model:
    """OPLS-DA of A predictive and n_ortho orthogonal components on X (N,
    K) and class labels (N,) of two classes or more, in `ar`'s arithmetic
    (with TF32 off: the `TF32` control rounds operands itself)."""
    with _no_tf32():
        Xz = X.to(ar.dtype)
        mean = Xz.mean(0)
        Xz = Xz - mean
        sd = torch.sqrt((Xz * Xz).sum(0) / (X.shape[0] - 1))
        sd = torch.where(sd == 0, torch.ones_like(sd), sd)
        Xz.div_(sd)
        classes, idx = torch.unique(labels.to(X.device), sorted=True, return_inverse=True)
        Y = torch.nn.functional.one_hot(idx, len(classes)).to(ar.dtype)
        priors = Y.mean(0)
        Yc = Y - priors
        Xf, W_o, P_o, T_o, ogaps, norms = ortho_filter(Xz, Yc, n_ortho, ar)
        del Xz
        f = pls.kernel_pls(Xf, Yc, A, ar)
        XY = ar.mm(Xf.mT, Yc)
        splot = s_plot(Xf, _vec(ar, Xf, f.R[:, 0]), ar)
        return Model(mean, sd, classes, priors, W_o, P_o, T_o, f, f.coefficients(), splot,
                     torch.cat([ogaps.cpu(), eigengaps(XY, f)]), norms.cpu())
