"""Column statistics: total sum of squares, stdev, z-scores; the Gram XᵀX.

Counterpart of `pls_tpu/ops/stats.py` (reference pls.cpp:69-111), with the
same fix of the reference's dead zero-stdev guard (DEVIATIONS.md #2): a
constant column z-scores to exactly 0 instead of NaN.

`gram` forms XᵀX for the downdated cross-validations (`cv/loo.global_stats`).
XᵀX is symmetric, so at wide K it computes only the upper block triangle:
strip i of the columns, Sᵢ, gives one product Xᵀ[Sᵢ] X[:, Sᵢ:] written into
row block i right of the diagonal, and the lower triangle is then copied
from the upper, inside the diagonal blocks too, so that the result is
exactly symmetric.  With b strips that is N·K²·(1 + 1/b) flops against the
whole product's 2·N·K².  Each entry stays one dot over all N rows, in the
dtype and the product precision of the caller.  The products read column
views of X (leading dimension K), so no copy of X is made.  `gram_plan`
picks the strips from K alone; below `_GRAM_MIN_K` columns it keeps the
one whole product `X.mT @ X`.  `gram_calls` counts the calls of each form.
"""

from __future__ import annotations

import torch

# `gram`'s strip width, a multiple of the SIMT sgemm's 128-column tiles,
# and the width below which it keeps the whole product: chip_smoke.py's
# sweep on an H100 (PERF.md §6).  At 100 000 × 5 000, 512 takes 54.5
# ms against the whole product's 97.0 (1280: 63.6, 256: 53.4); 512 is also
# the fastest width at 10 000 and 2 000 rows.  Below 1 024 columns the
# strips gain nothing at 10 000 rows: their launches cost what they save.
_GRAM_WIDTH = 512
_GRAM_MIN_K = 1024
gram_calls = {"triangle": 0, "full": 0}


def _as_col_vector(v, like: torch.Tensor) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(v, dtype=like.dtype, device=like.device))


def colwise_mean(mat: torch.Tensor) -> torch.Tensor:
    """Column means.  A bf16/f16 matrix is summed in float32 and scaled by
    the float32 reciprocal of N before rounding back, as `jnp.mean` does
    on XLA (whose simplifier turns the division by N into that product):
    a mean on a rounding tie of bf16 then lands where the JAX package's
    does, where a float32 division (torch's CPU mean) rounds it the other
    way."""
    if mat.dtype.itemsize >= 4:
        return mat.mean(0)
    inv_n = torch.tensor(1.0 / mat.shape[0], dtype=torch.float32, device=mat.device)
    return (mat.float().sum(0) * inv_n).to(mat.dtype)


def sst(mat: torch.Tensor, means=None) -> torch.Tensor:
    """Total sum of squares per column, sum((x - mean)^2), with the
    reference's N < 2 => zeros convention (pls.cpp:69-77)."""
    if mat.ndim == 1:
        mat = mat[:, None]
    means = colwise_mean(mat) if means is None else _as_col_vector(means, mat)
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
    mean = colwise_mean(mat) if mean is None else _as_col_vector(mean, mat)
    stdev = colwise_stdev(mat, mean) if stdev is None else _as_col_vector(stdev, mat)
    return (mat - mean[None, :]) / _safe(stdev)[None, :]


def gram_plan(K: int, width: int | None = None, min_k: int | None = None
              ) -> list[tuple[int, int, int, int]]:
    """The products that form K×K XᵀX, as (r0, r1, c0, c1): the block
    XᵀX[r0:r1, c0:c1].  round(K / width) strips of `width` columns, the last
    taking the rest (between width/2 and 3·width/2), each with the columns
    from its own to K; one whole product below `min_k` columns or where
    that rounds to one strip.  By default `_GRAM_WIDTH` and `_GRAM_MIN_K`."""
    width = _GRAM_WIDTH if width is None else width
    min_k = _GRAM_MIN_K if min_k is None else min_k
    strips = 1 if K < min_k else max(1, int(K / width + 0.5))
    bounds = [i * width for i in range(strips)] + [K]
    return [(lo, hi, lo, K) for lo, hi in zip(bounds, bounds[1:])]


def gram(X: torch.Tensor, plan: list[tuple[int, int, int, int]] | None = None) -> torch.Tensor:
    """XᵀX of (N, K) X by the products of `plan` (default `gram_plan(K)`),
    which cover the upper triangle; each diagonal block (r0 == c0) then
    mirrors its rows below the diagonal.  A one-product plan is `X.mT @ X`."""
    K = X.shape[1]
    plan = gram_plan(K) if plan is None else plan
    if len(plan) == 1:
        gram_calls["full"] += 1
        return X.mT @ X
    gram_calls["triangle"] += 1
    G = X.new_empty(K, K)
    for r0, r1, c0, c1 in plan:
        torch.mm(X[:, r0:r1].mT, X[:, c0:c1], out=G[r0:r1, c0:c1])
    for lo, hi, c0, _ in plan:
        if c0 == lo:
            D = G[lo:hi, lo:hi]
            D.copy_(torch.where(torch.ones_like(D, dtype=torch.bool).triu(), D, D.mT))
            G[hi:, lo:hi] = G[lo:hi, hi:].mT
    return G
