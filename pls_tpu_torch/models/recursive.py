"""Recursive (online-adaptive) PLS with exponential forgetting (Qin 1998,
block formulation).

Counterpart of `pls_tpu/models/recursive.py`.  Per chunk (Xc, Yc):

    XX ← λ·XX + XcᵀXc ,  XY ← λ·XY + XcᵀYc ,  n_eff ← λ·n_eff + c

and a refit from the statistics (`kernel_pls.fit_from_stats`, the X-free
type-2 loop: no kernel).  λ = 1 is the growing-window batch fit; λ < 1
an exponentially weighted window of effective length 1/(1−λ).  The
statistics live on `device` (None: the card), in `dtype` (float32 by
default, as in the JAX package); chunks are converted to both.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from pls_tpu_torch.config import resolve_device
from pls_tpu_torch.models.kernel_pls import fit_from_stats
from pls_tpu_torch.types import PLSFit


@dataclass
class RecursivePLS:
    """Streaming adaptive PLS: update(chunk) → fit() at any point.

    K, M   : design/response widths
    lam    : forgetting factor (1 = growing window / batch-equivalent)
    device : where the statistics live (None: the card)
    """

    K: int
    M: int
    lam: float = 1.0
    dtype: torch.dtype = torch.float32
    device: torch.device | str | None = None
    XX: torch.Tensor = field(init=False)
    XY: torch.Tensor = field(init=False)
    n_eff: torch.Tensor = field(init=False)

    def __post_init__(self):
        if not (0.0 < self.lam <= 1.0):
            raise ValueError(f"lam must be in (0, 1], got {self.lam}")
        self.device = resolve_device(self.device)
        self.XX = torch.zeros((self.K, self.K), dtype=self.dtype, device=self.device)
        self.XY = torch.zeros((self.K, self.M), dtype=self.dtype, device=self.device)
        self.n_eff = torch.zeros((), dtype=self.dtype, device=self.device)

    def update(self, X_chunk, Y_chunk) -> "RecursivePLS":
        X_chunk = torch.as_tensor(X_chunk, dtype=self.dtype, device=self.device)
        Y_chunk = torch.as_tensor(Y_chunk, dtype=self.dtype, device=self.device)
        if Y_chunk.ndim == 1:
            Y_chunk = Y_chunk[:, None]
        self.XX = self.lam * self.XX + X_chunk.T @ X_chunk
        self.XY = self.lam * self.XY + X_chunk.T @ Y_chunk
        self.n_eff = self.lam * self.n_eff + X_chunk.shape[0]
        return self

    def fit(self, A: int, **kw) -> PLSFit:
        """Refit from the current (forgetting-weighted) statistics."""
        return fit_from_stats(self.XX, self.XY, A, **kw)
