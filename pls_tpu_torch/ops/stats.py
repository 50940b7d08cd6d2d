"""Column statistics: total sum of squares, stdev, z-scores.

Counterpart of `pls_tpu/ops/stats.py` (reference pls.cpp:69-111), with the
same fix of the reference's dead zero-stdev guard (DEVIATIONS.md #2): a
constant column z-scores to exactly 0 instead of NaN.
"""

from __future__ import annotations

import torch


def _as_col_vector(v, like: torch.Tensor) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(v, dtype=like.dtype, device=like.device))


def sst(mat: torch.Tensor, means=None) -> torch.Tensor:
    """Total sum of squares per column, sum((x - mean)^2), with the
    reference's N < 2 => zeros convention (pls.cpp:69-77)."""
    if mat.ndim == 1:
        mat = mat[:, None]
    means = mat.mean(0) if means is None else _as_col_vector(means, mat)
    if mat.shape[0] < 2:
        return mat.new_zeros(mat.shape[1])
    return ((mat - means[None, :]) ** 2).sum(0)


def colwise_stdev(mat: torch.Tensor, means=None) -> torch.Tensor:
    """Unbiased (N-1) sample standard deviation per column (pls.cpp:79-87)."""
    return torch.sqrt(sst(mat, means) / (mat.shape[0] - 1))


def _safe(stdev: torch.Tensor) -> torch.Tensor:
    return torch.where(stdev == 0, torch.ones_like(stdev), stdev)


def z_scores(obs: torch.Tensor, mean: torch.Tensor, stdev: torch.Tensor) -> torch.Tensor:
    """Z-score one observation row (pls.cpp:89-91), zero-stdev guarded."""
    return (obs - mean) / _safe(stdev)


def colwise_z_scores(mat: torch.Tensor, mean=None, stdev=None) -> torch.Tensor:
    """Z-score a matrix by column (pls.cpp:93-111); constant columns map to
    exactly 0.  1-D input is treated as one column (returned 2-D)."""
    if mat.ndim == 1:
        mat = mat[:, None]
    mean = mat.mean(0) if mean is None else _as_col_vector(mean, mat)
    stdev = colwise_stdev(mat, mean) if stdev is None else _as_col_vector(stdev, mat)
    return (mat - mean[None, :]) / _safe(stdev)[None, :]
