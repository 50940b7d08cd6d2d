"""Dominant eigenvector of the M×M cross-product XYᵀXY.

Counterpart of `pls_tpu/ops/eigen.py:26-63`.  XYᵀXY is symmetric positive
semi-definite, so its eigenpairs are real: `torch.linalg.eigh` (ascending
eigenvalues, dominant last) or a fixed-iteration power method.  Both take
a leading batch axis, which is how the CV folds' refits run together.

An eigenvector's sign is arbitrary, and `eigh` here may pick the other
sign than JAX's: every PLS quantity except the per-column signs of
W/P/Q/R/T is invariant to it.
"""

from __future__ import annotations

import torch


def dominant_eigenvector(C: torch.Tensor, power_iters: int | None = None) -> torch.Tensor:
    """Dominant eigenvector of symmetric PSD C (..., M, M) -> (..., M).

    power_iters=None selects exact `eigh`; an integer selects that many
    power-method iterations from a deterministic start vector: the column
    of C with the largest diagonal, plus 1e-30 so a zero column cannot
    stall."""
    if power_iters is None:
        return torch.linalg.eigh(C).eigenvectors[..., -1]
    j = torch.diagonal(C, dim1=-2, dim2=-1).argmax(-1)
    idx = j[..., None, None].expand(*C.shape[:-1], 1)
    v = torch.take_along_dim(C, idx, dim=-1)[..., 0] + 1e-30
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(power_iters):
        w = (C @ v[..., None])[..., 0]
        v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    return v
