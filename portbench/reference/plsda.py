"""Plain PLS-DA, in PyTorch, as stated.

The benchmark's yardstick for the PLS-DA cell.  It imports nothing of the
program (`pls_tpu_torch`), of the JAX package (`pls_tpu`) or of JAX; the
PLS fit is `reference/pls.py`'s, which is plain too.  Following Barker &
Rayens (J. Chemometrics 17 (2003) 166-173) and the reference CLI's
conventions (tjhladish/PLS, main.cpp: X z-scored by column before the
fit):

- X z-scored with the column means and the N − 1 standard deviations (a
  constant column takes 1, so it maps to 0);
- Y the one-hot indicators of the classes in sorted label order, centred
  by their column means (the class priors);
- Dayal & MacGregor's kernel algorithm #1 for A components
  (`pls.kernel_pls`), and B = R[:, :c] Q[:, :c]ᵀ at every truncation c;
- the decision values of new spectra: z-scored with the training
  moments, times B, plus the class priors; the class is their argmax;
- each component's relative eigengap g_a = (λ1 − λ2) / λ1 of its
  XYᵀXY, the matrix whose dominant eigenvector gives w (`eigengaps`).

Departures from the published description: the indicators are centred
and X is z-scored, which Barker & Rayens leave to the user; the class is
the largest decision value with the priors added back (their centred
indicators' predictions plus the column means), with no further
discriminant model on the scores; and the eigenvector comes from the
improved kernel algorithm's XYᵀXY rather than NIPALS iterations, which
converge to the same direction.

Every product goes through `Arith.mm`, so `fit(…, pls.TF32)` computes
the control: float32 with every product's operands rounded to TF32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import pls
from portbench.reference.pls import F64, Arith


@dataclass
class Model:
    """The training moments (K,), the classes in sorted order, their
    priors (M,), the PLS fit on the z-scored X and centred indicators, B
    at every truncation (A, K, M), and each component's relative eigengap
    (A,)."""

    mean: torch.Tensor
    sd: torch.Tensor
    classes: torch.Tensor
    priors: torch.Tensor
    fit: pls.Fit
    B: torch.Tensor
    gaps: torch.Tensor

    def z(self, X: torch.Tensor) -> torch.Tensor:
        """X z-scored with the training moments."""
        return (X.to(self.mean.dtype) - self.mean) / self.sd

    def decision(self, X: torch.Tensor, ar: Arith = F64, comp: int | None = None) -> torch.Tensor:
        """Decision values (n, M) of new X under B at `comp` components
        (None: all)."""
        c = self.B.shape[0] if comp is None else comp
        return ar.mm(self.z(X), self.B[c - 1]) + self.priors

    def predict(self, X: torch.Tensor, ar: Arith = F64) -> torch.Tensor:
        """The classes of new X: the label of the largest decision value."""
        return self.classes[torch.argmax(self.decision(X, ar), 1)]


def fit(X: torch.Tensor, labels: torch.Tensor, A: int, ar: Arith = F64) -> Model:
    """PLS-DA of A components on X (N, K) and class labels (N,), in `ar`'s
    arithmetic."""
    X = X.to(ar.dtype)
    mean = X.mean(0)
    d = X - mean
    sd = torch.sqrt((d * d).sum(0) / (X.shape[0] - 1))
    sd = torch.where(sd == 0, torch.ones_like(sd), sd)
    Xz = d.div_(sd)
    classes, idx = torch.unique(labels.to(X.device), sorted=True, return_inverse=True)
    Y = torch.nn.functional.one_hot(idx, len(classes)).to(ar.dtype)
    priors = Y.mean(0)
    f = pls.kernel_pls(Xz, Y - priors, A, ar)
    XY = ar.mm(Xz.mT, Y - priors)
    return Model(mean, sd, classes, priors, f, f.coefficients(), eigengaps(XY, f))


def eigengaps(XY: torch.Tensor, f: pls.Fit) -> torch.Tensor:
    """(A,): each component's relative eigengap (λ1 − λ2) / λ1 of XYᵀXY,
    in float64, from XY = XᵀY (K, M) deflated as the fit deflates it,
    XY ← XY − tt p qᵀ with tt = tᵀt (M ≥ 2: PLS-DA has two classes at
    least)."""
    XY, P, Q, T = XY.double(), f.P.double(), f.Q.double(), f.T.double()
    tt = (T * T).sum(0)
    gaps = []
    for a in range(P.shape[1]):
        lam = torch.linalg.eigvalsh(XY.mT @ XY)
        gaps.append(float((lam[-1] - lam[-2]) / lam[-1]))
        XY = XY - tt[a] * P[:, a, None] * Q[None, :, a]
    return torch.tensor(gaps, dtype=torch.float64)
