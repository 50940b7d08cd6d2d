"""Bootstrap resampling: percentile intervals for the coefficients.

Counterpart of `pls_tpu/cv/bootstrap.py`.  A replicate is a fit with
integer row weights, the times each row was drawn: for counts c, rows
scaled by √c give XᵀCX and XᵀCY, so the weighted fit equals the fit on
the resampled rows, and the replicates run as a leading batch axis of
`kernel_pls.fit_folds` (√counts in place of a mask), `batch_size` at a
time.

The draws are the JAX package's: replicate i takes `split(key, R)[i]`
and `randint(k, (N,), 0, N)` from `utils.jax_prng`, bit for bit.  `key`
is a JAX key's data or an int seed.  jax draws int64 when x64 is enabled,
which is how the JAX package runs in float64, and int32 otherwise: `x64`
picks one, and None takes int64 for a float64 X and int32 for others.
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.models.kernel_pls import fit_folds
from pls_tpu_torch.models.predict import coefficients
from pls_tpu_torch.types import METHOD
from pls_tpu_torch.utils.batching import chunked_map
from pls_tpu_torch.utils.jax_prng import randint, split


def bootstrap_counts(key, num_replicates: int, N: int, int64: bool) -> np.ndarray:
    """(num_replicates, N) int64: how many times each row is drawn in each
    replicate, from the JAX package's keys and draws."""
    idx = randint(split(key, num_replicates), (N,), 0, N, np.int64 if int64 else np.int32)
    counts = np.zeros((num_replicates, N), np.int64)
    np.add.at(counts, (np.arange(num_replicates)[:, None], idx), 1)
    return counts


def bootstrap_coefficients(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    num_replicates: int,
    key,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    batch_size: int | None = None,
    precision: str | None = "highest",
    x64: bool | None = None,
) -> torch.Tensor:
    """(num_replicates, K, M): the bootstrap distribution of B."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if batch_size is None:
        batch_size = min(num_replicates, 32)
    x64 = X.dtype == torch.float64 if x64 is None else x64
    counts = bootstrap_counts(key, num_replicates, N, x64)
    w = torch.from_numpy(counts).to(X.device, X.dtype).sqrt()

    def reps(wc: torch.Tensor) -> torch.Tensor:
        return coefficients(fit_folds(X, Y, wc, A, method, precision=precision))

    return chunked_map(reps, w, batch_size)


def bootstrap_coefficient_intervals(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    num_replicates: int,
    key,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    alpha: float = 0.05,
    batch_size: int | None = None,
    precision: str | None = "highest",
    x64: bool | None = None,
):
    """Percentile intervals: (lower, upper, Bs), the (K, M) bounds at the
    alpha/2 and 1 − alpha/2 quantiles (linear interpolation, as
    `jnp.quantile`'s default) and the (num_replicates, K, M) draws."""
    Bs = bootstrap_coefficients(X, Y, A, num_replicates, key, method,
                                batch_size=batch_size, precision=precision, x64=x64)
    lower = torch.quantile(Bs, alpha / 2, dim=0)
    upper = torch.quantile(Bs, 1 - alpha / 2, dim=0)
    return lower, upper, Bs
