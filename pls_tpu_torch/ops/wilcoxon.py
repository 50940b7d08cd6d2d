"""Wilcoxon signed-rank test for comparing two sets of prediction errors.

Counterpart of `pls_tpu/ops/wilcoxon.py` (reference pls.cpp:162-211, after
Thomas 2003): given paired errors err_1 (the candidate) and err_2 (the
competitor), returns P{V larger than observed} under the normal
asymptotic; a small value is evidence that model 1 is better.

Batched over leading axes: err_1 and err_2 are (..., n).  The signed-rank
sum is taken in int64, so it is exact at any n and in any working dtype
(a float32 sum of ranks stops being exact past 2^24, which LSO's
trials·test_size observations reach).  Ties sort stably, as in the JAX
package.
"""

from __future__ import annotations

import math

import torch

from pls_tpu_torch.ops.special import normalcdf


def wilcoxon(err_1: torch.Tensor, err_2: torch.Tensor) -> torch.Tensor:
    """One-sided Wilcoxon signed-rank p-value(s), normal approximation
    (with the reference's A&S normal CDF), over the last axis."""
    n = err_1.shape[-1]
    delta = err_1.abs() - err_2.abs()
    order = torch.argsort(delta.abs(), dim=-1, stable=True)
    signs = torch.take_along_dim(torch.sign(delta), order, dim=-1).to(torch.int64)
    ranks = torch.arange(1, n + 1, device=err_1.device)
    d = (ranks * signs).sum(-1).to(torch.float64)
    t = n * (n + 1) / 2.0
    v = (t - d) / 2.0
    z = (v - t / 2.0) / math.sqrt(n * (n + 1) * (2 * n + 1) / 24.0)
    return (1.0 - normalcdf(z)).to(err_1.dtype)
