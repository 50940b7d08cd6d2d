"""Model-space monitoring: Hotelling T², SPE (Q residuals), leverage, and
their control limits.

Counterpart of `pls_tpu/models/diagnostics.py`.  Per sample of new data
X_new (preprocessed as the training X was):

- Hotelling T²: Σₐ tₐ²/s²ₐ with t = X_new R and s²ₐ the training score
  variances; limit A(N−1)(N+1)/(N(N−A)) · F₁₋α(A, N−A);
- SPE: ‖x − t Pᵀ‖², the part of x off the latent plane; limit Box's
  moment-matched g·χ²_h from the training SPE's mean and variance;
- leverage: 1/N + t (TᵀT)⁻¹ tᵀ.

The per-sample statistics are torch on the tensors' device; the two
control limits are scipy on the host, once per fit, as in the JAX package
(`pls_tpu/models/diagnostics.py:147-167`).  `MonitorModel.check` is one
batch of products and compares on the device.  `MonitorModel` is
registered with `utils/checkpoint.py` (`save_fit`/`load_fit`), as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.models.predict import _check_comp, _promote
from pls_tpu_torch.types import PLSFit
from pls_tpu_torch.utils.checkpoint import register_checkpointable


def _train_scores(fit: PLSFit, X_train: torch.Tensor | None, comp: int) -> torch.Tensor:
    if fit.T.numel():
        return fit.T[:, :comp]
    if X_train is None:
        raise ValueError("fit has no stored scores (type-2/from-stats); pass X_train")
    X_train, R = _promote(X_train, fit.R[:, :comp])
    return X_train @ R


def _s2(T: torch.Tensor) -> torch.Tensor:
    """(comp,) training score variances."""
    return (T * T).sum(0) / (T.shape[0] - 1)


def x_residuals(fit: PLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """X-space reconstruction residuals E = Xn − (Xn R) Pᵀ, (n, K)."""
    comp = _check_comp(fit, comp)
    X_new, R, P = _promote(X_new, fit.R[:, :comp], fit.P[:, :comp])
    return X_new - (X_new @ R) @ P.T


def spe(fit: PLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Squared prediction error (Q residual) per sample, (n,)."""
    E = x_residuals(fit, X_new, comp)
    return (E * E).sum(-1)


def hotelling_t2(
    fit: PLSFit, X_new: torch.Tensor, comp: int | None = None,
    X_train: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hotelling T² per sample of X_new, (n,).  The score variances come
    from the fit's stored scores; a fit without them needs X_train."""
    comp = _check_comp(fit, comp)
    s2 = _s2(_train_scores(fit, X_train, comp))
    X_new, R, s2 = _promote(X_new, fit.R[:, :comp], s2)
    S = X_new @ R
    return (S * S / s2[None, :]).sum(-1)


def leverage(
    fit: PLSFit, X_new: torch.Tensor | None = None, comp: int | None = None,
    X_train: torch.Tensor | None = None,
) -> torch.Tensor:
    """Leverage hᵢ = 1/N + tᵢ(TᵀT)⁻¹tᵢᵀ per sample, (n,); X_new=None gives
    the training samples' own."""
    comp = _check_comp(fit, comp)
    T = _train_scores(fit, X_train, comp)
    if X_new is None:
        S = T
    else:
        X_new, R = _promote(X_new, fit.R[:, :comp])
        S = X_new @ R
    S, T = _promote(S, T)
    sol = torch.linalg.solve(T.T @ T, S.T).T
    return 1.0 / T.shape[0] + (S * sol).sum(-1)


def spe_contributions(fit: PLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Per-variable SPE contributions, (n, K); rows sum to `spe`."""
    E = x_residuals(fit, X_new, comp)
    return E * E


def t2_contributions(
    fit: PLSFit, X_new: torch.Tensor, comp: int | None = None,
    X_train: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-variable T² contributions, (n, K), in the complete-decomposition
    form x_ij · [R diag(1/s²) Rᵀ xᵢ]_j (Westerhuis, Gurden & Smilde 2000);
    rows sum to T²."""
    comp = _check_comp(fit, comp)
    s2 = _s2(_train_scores(fit, X_train, comp))
    X_new, R, s2 = _promote(X_new, fit.R[:, :comp], s2)
    S = X_new @ R
    return X_new * ((S / s2[None, :]) @ R.T)


def t2_limit(n_train: int, comp: int, alpha: float = 0.05) -> float:
    """F-based T² control limit at confidence 1−α."""
    from scipy.stats import f as f_dist

    if n_train <= comp:
        raise ValueError(f"need n_train > comp, got {n_train} <= {comp}")
    fq = float(f_dist.ppf(1.0 - alpha, comp, n_train - comp))
    return comp * (n_train - 1) * (n_train + 1) / (n_train * (n_train - comp)) * fq


def spe_limit(spe_train, alpha: float = 0.05) -> float:
    """Box's moment-matched g·χ²_h control limit from training SPE values
    (a tensor or an array; read on the host in float64)."""
    from scipy.stats import chi2

    if isinstance(spe_train, torch.Tensor):
        spe_train = spe_train.detach().cpu().double().numpy()
    q = np.asarray(spe_train, dtype=float)
    m, v = q.mean(), q.var(ddof=1)
    if v <= 0 or m <= 0:  # degenerate (e.g. an exact full-rank reconstruction)
        return float(m)
    g, h = v / (2.0 * m), 2.0 * m * m / v
    return float(g * chi2.ppf(1.0 - alpha, h))


@register_checkpointable
@dataclass(frozen=True)
class MonitorModel:
    """The serving-side admission gate: score projector, loadings, score
    variances and the two control limits (0-d tensors), on one device."""

    R: torch.Tensor        # (K, A)
    P: torch.Tensor        # (K, A)
    s2: torch.Tensor       # (A,)
    t2_lim: torch.Tensor   # ()
    spe_lim: torch.Tensor  # ()
    alpha: float = 0.05

    def _scores(self, X_new: torch.Tensor):
        X_new, R, P, s2 = _promote(X_new, self.R, self.P, self.s2)
        S = X_new @ R
        return X_new, S, X_new - S @ P.T, s2, R

    def check(self, X_new: torch.Tensor) -> dict:
        """Per-sample t2, spe (n,) and the flags t2_ok, spe_ok, ok (n,):
        `ok` means the sample lies inside the calibration domain at
        confidence 1−alpha."""
        _, S, E, s2, _ = self._scores(X_new)
        t2 = (S * S / s2[None, :]).sum(-1)
        q = (E * E).sum(-1)
        t2_ok = t2 <= self.t2_lim
        spe_ok = q <= self.spe_lim
        return {"t2": t2, "spe": q, "t2_ok": t2_ok, "spe_ok": spe_ok, "ok": t2_ok & spe_ok}

    def contributions(self, X_new: torch.Tensor) -> dict:
        """Per-variable contributions {'spe': (n, K), 't2': (n, K)}; rows sum
        to `check`'s statistics."""
        X_new, S, E, s2, R = self._scores(X_new)
        return {"spe": E * E, "t2": X_new * ((S / s2[None, :]) @ R.T)}


def fit_monitor(
    fit: PLSFit, X_train: torch.Tensor, comp: int | None = None, alpha: float = 0.05
) -> MonitorModel:
    """A `MonitorModel` from a fit and its (preprocessed) training X."""
    comp = _check_comp(fit, comp)
    T = _train_scores(fit, X_train, comp)
    q_train = spe(fit, X_train, comp)
    return MonitorModel(
        R=fit.R[:, :comp],
        P=fit.P[:, :comp],
        s2=_s2(T),
        t2_lim=torch.tensor(t2_limit(T.shape[0], comp, alpha), dtype=T.dtype, device=T.device),
        spe_lim=torch.tensor(spe_limit(q_train, alpha), dtype=T.dtype, device=T.device),
        alpha=alpha,
    )
