"""Leave-some-out (Monte-Carlo) cross-validation, batched.

Counterpart of `pls_tpu/cv/lso.py:33-105` (reference `Model::cv_LSO`,
pls.cpp:512-549).  The trials are a leading batch axis over a
(num_trials, N) partition matrix: row t is a permutation of 0..N−1 whose
first `train_size` entries are the training rows (the reference's
`rand_nchoosek` layout, pls.cpp:218-227).  Partitions come from a
`torch.Generator` or from `utils.gcc_rng.GccRng`, which replays the
reference CLI's std::mt19937 + std::shuffle bit for bit.

Test size uses the reference's rounding, (frac·N + 0.5) truncated
(pls.cpp:516).  Errors are (M, num_trials·test_size, A), trial-major.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import fit_folds
from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.types import METHOD, Residual
from pls_tpu_torch.utils.batching import chunked_map, default_batch_size


def lso_sizes(n_rows: int, test_fraction: float) -> tuple[int, int]:
    """(train_size, test_size) with the reference's rounding (pls.cpp:516-518)."""
    test_size = int(test_fraction * n_rows + 0.5)
    train_size = n_rows - test_size
    if test_size == 0 or train_size == 0:
        raise ValueError(
            f"test_fraction={test_fraction} leaves an empty split for N={n_rows}"
        )
    return train_size, test_size


def random_partitions(
    generator: torch.Generator, n_rows: int, num_trials: int
) -> torch.Tensor:
    """(num_trials, N) of independent random permutations from `generator`
    (on the generator's device)."""
    u = torch.rand((num_trials, n_rows), generator=generator, device=generator.device)
    return torch.argsort(u, dim=1)


def cv_lso(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    test_fraction: float,
    num_trials: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    generator: torch.Generator | None = None,
    partitions=None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV.  Give either `generator` or `partitions` (a
    (num_trials, N) index matrix, e.g. `GccRng.lso_partitions` for the
    reference's exact partitions).  Returns Residual errors
    (M, num_trials·test_size, A)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N, K = X.shape
    train_size, test_size = lso_sizes(N, test_fraction)
    if partitions is None:
        if generator is None:
            raise ValueError("cv_lso needs either `generator` or `partitions`")
        partitions = random_partitions(generator, N, num_trials)
    partitions = torch.as_tensor(partitions, device=X.device)
    if tuple(partitions.shape) != (num_trials, N):
        raise ValueError(
            f"partitions shape {tuple(partitions.shape)} != {(num_trials, N)}"
        )
    if batch_size is None:
        batch_size = default_batch_size(num_trials, N, K, X.element_size())

    def trials(perms: torch.Tensor) -> torch.Tensor:
        masks = torch.zeros(perms.shape, dtype=X.dtype, device=X.device)
        masks.scatter_(1, perms[:, :train_size], 1.0)
        test_idx = perms[:, train_size:]
        f = fit_folds(
            X, Y, masks, A, method, power_iters=power_iters,
            precision=precision, x_storage=x_storage,
        )
        return residuals_all_components(f, X[test_idx], Y[test_idx])  # (F, test, A, M)

    errs = chunked_map(trials, partitions, batch_size)  # (trials, test, A, M)
    M = Y.shape[1]
    errors = errs.permute(3, 0, 1, 2).reshape(M, num_trials * test_size, A)
    return Residual(errors=errors, method="LSO")
