"""Calibration transfer: Direct Standardization (DS), Piecewise DS (PDS;
Wang, Veltkamp & Kowalski 1991) and External Parameter Orthogonalization
(EPO; Roger, Chauchard & Bellon-Maurel 2003).

Counterpart of `pls_tpu/transfer.py`.  DS and PDS learn a linear map F
from transfer samples measured on both instruments, X_slave·F ≈ X_master;
EPO removes the subspace that difference spectra of the same samples
under varying conditions span.

- DS: one (K, K) ridge least-squares map (`torch.linalg.solve`).
- PDS: master channel j regressed on the slave window [j−w, j+w] by an
  A-component PLS model.  The JAX package vmaps the K local fits; here
  they are one batched kernel-PLS fit (`kernel_pls._fit_method`) on the
  (K, n, 2w+1) windows, the columns past the spectrum's edges zeroed
  (an exact zero column is an absent one).  A batch of fits runs torch
  products, as the JAX package's vmapped fits run XLA's: no kernel.  The
  bands go into F by `index_put_(..., accumulate=True)`; indices repeat
  only at the clipped edges, where the values added are zero.
- EPO: the top right singular vectors of the difference matrix D, from
  `eigh` of the K×K DᵀD.

Data that is not a tensor goes to `device` (None: the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models.kernel_pls import _fit_method
from pls_tpu_torch.models.predict import _promote, coefficients
from pls_tpu_torch.types import METHOD

__all__ = [
    "TransferModel",
    "direct_standardization",
    "piecewise_ds",
    "apply_transfer",
    "EPOModel",
    "epo",
    "epo_difference_matrix",
]


def _2d(X, device=None) -> torch.Tensor:
    X = as_data(X, device)
    return X.reshape(1, -1) if X.ndim == 1 else X


@dataclass(frozen=True)
class TransferModel:
    """Slave→master spectral map:
        X_master ≈ (X_slave − offset) · F + intercept

    F         : (K, K) transform (banded for PDS)
    offset    : (K,) slave-side centering (transfer-set slave mean)
    intercept : (K,) master-side mean added back after the map
    """

    F: torch.Tensor
    offset: torch.Tensor
    intercept: torch.Tensor

    def __call__(self, X_slave) -> torch.Tensor:
        return apply_transfer(self, X_slave)


def apply_transfer(model: TransferModel, X_slave) -> torch.Tensor:
    """Map slave-instrument spectra into master space."""
    X_slave, F, off, icp = _promote(_2d(X_slave, model.F.device), model.F, model.offset,
                                    model.intercept)
    return (X_slave - off[None, :]) @ F + icp[None, :]


def _paired(S_master, S_slave, device):
    Sm = _2d(S_master, device)
    Ss = _2d(S_slave, Sm.device).to(Sm.dtype)
    if Sm.shape != Ss.shape:
        raise ValueError(
            f"master {tuple(Sm.shape)} and slave {tuple(Ss.shape)} transfer sets must "
            "be paired (same shape)"
        )
    mu_s, mu_m = Ss.mean(0), Sm.mean(0)
    return Ss - mu_s[None, :], Sm - mu_m[None, :], mu_s, mu_m


def direct_standardization(
    S_master, S_slave, ridge: float = 1e-6, *, device=None
) -> TransferModel:
    """Global DS map from paired transfer spectra (n_transfer, K) measured
    on both instruments; ridge-regularised, so that with few transfer
    samples the regulariser picks the minimum-norm map."""
    Ssc, Smc, mu_s, mu_m = _paired(S_master, S_slave, device)
    K = Ssc.shape[1]
    G = Ssc.T @ Ssc + ridge * torch.eye(K, dtype=Ssc.dtype, device=Ssc.device)
    F = torch.linalg.solve(G, Ssc.T @ Smc)
    return TransferModel(F=F, offset=mu_s, intercept=mu_m)


def piecewise_ds(
    S_master,
    S_slave,
    window: int = 5,
    A: int = 2,
    *,
    precision: str | None = "highest",
    device=None,
) -> TransferModel:
    """PDS: banded slave→master map; master channel j is regressed on the
    slave window [j−window, j+window] by a local `A`-component PLS model,
    all K of them one batched fit.  A must be ≤ 2·window+1."""
    Ssc, Smc, mu_s, mu_m = _paired(S_master, S_slave, device)
    K = Ssc.shape[1]
    w = int(window)
    width = 2 * w + 1
    if not (1 <= A <= width):
        raise ValueError(f"A={A} must be in [1, 2*window+1={width}]")
    # windows: cols[j] = channels j−w..j+w, out-of-range ones column 0 zeroed
    idx = np.arange(K)[:, None] + np.arange(-w, w + 1)[None, :]  # (K, width)
    valid = torch.as_tensor((idx >= 0) & (idx < K), dtype=Ssc.dtype, device=Ssc.device)
    idx_c = torch.as_tensor(np.clip(idx, 0, K - 1), device=Ssc.device)
    Xb = (Ssc[:, idx_c] * valid[None, :, :]).permute(1, 0, 2)  # (K, n, width)
    Yb = Smc.T[:, :, None]  # (K, n, 1)
    f = _fit_method(Xb, Yb, A, METHOD.KERNEL_TYPE1, None, precision)
    B = coefficients(f)[..., 0]  # (K, width) local coefficient rows
    F = Ssc.new_zeros((K, K))
    cols = torch.arange(K, device=Ssc.device).repeat_interleave(width)
    F.index_put_((idx_c.reshape(-1), cols), (B * valid).reshape(-1), accumulate=True)
    return TransferModel(F=F, offset=mu_s, intercept=mu_m)


@dataclass(frozen=True)
class EPOModel:
    """EPO filter state.

    V        : (K, g) orthonormal basis of the external-effect subspace
               (top right singular vectors of the difference matrix)
    sv_ratio : (g,) fraction of the difference matrix's total squared
               singular value captured per component

    Applying the filter is X ← X − (X V) Vᵀ; the projector I − V Vᵀ is
    never formed."""

    V: torch.Tensor
    sv_ratio: torch.Tensor

    @property
    def n_components(self) -> int:
        return self.V.shape[1]

    def __call__(self, X) -> torch.Tensor:
        X, V = _promote(_2d(X, self.V.device), self.V)
        return X - (X @ V) @ V.T


def epo_difference_matrix(*condition_matrices, device=None) -> torch.Tensor:
    """Difference spectra for EPO from ≥2 matrices of the SAME samples
    (rows aligned) under different external conditions: each matrix minus
    the per-sample mean across conditions, stacked."""
    if len(condition_matrices) < 2:
        raise ValueError("need >= 2 condition matrices")
    first = _2d(condition_matrices[0], device)
    mats = [first] + [_2d(m, first.device).to(first.dtype) for m in condition_matrices[1:]]
    for m in mats[1:]:
        if m.shape != first.shape:
            raise ValueError("condition matrices must be row-aligned with equal shapes")
    mean = sum(mats) / len(mats)
    return torch.cat([m - mean for m in mats], dim=0)


def epo(D, n_components: int, *, device=None) -> EPOModel:
    """The EPO filter from difference spectra D (n_d, K) (build D with
    `epo_difference_matrix`): `n_components` external components removed,
    from `eigh` of DᵀD (symmetric PSD: real, orthonormal eigenvectors)."""
    D = _2d(D, device)
    if not (1 <= n_components <= min(D.shape)):
        raise ValueError(
            f"need 1 <= n_components <= min(n_d, K)={min(D.shape)}, got {n_components}"
        )
    evals, evecs = torch.linalg.eigh(D.T @ D)  # ascending
    V = evecs.flip(1)[:, :n_components]
    sv = evals.flip(0)[:n_components]
    return EPOModel(V=V, sv_ratio=sv / torch.clamp(evals.sum(), min=1e-30))
