"""Leave-some-out (Monte-Carlo) cross-validation, batched.

Counterpart of `pls_tpu/cv/lso.py:33-105` (reference `Model::cv_LSO`,
pls.cpp:512-549).  The trials are a leading batch axis over a
(num_trials, N) partition matrix: row t is a permutation of 0..N−1 whose
first `train_size` entries are the training rows (the reference's
`rand_nchoosek` layout, pls.cpp:218-227).  Partitions come from
`utils.gcc_rng.GccRng`, which draws the reference CLI's std::mt19937 +
std::shuffle stream with libstdc++ itself, from a JAX key or int seed (`utils.jax_prng`,
the JAX package's `jax.random` partitions bit for bit), or from a
`torch.Generator`.

`cv_lso` refits each trial with its rows masked; `cv_lso_downdate`
(counterpart of `pls_tpu/cv/lso.py:108-194`) refits from XᵀX/XᵀY with the
trial's test block downdated inside the matvec (kernel type 2).

Test size uses the reference's rounding, (frac·N + 0.5) truncated
(pls.cpp:516).  Errors are (M, num_trials·test_size, A), trial-major.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import fit_folds, fit_from_stats_blockdowndated
from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.types import METHOD, Residual
from pls_tpu_torch.utils.jax_prng import permutation, split
from pls_tpu_torch.utils.batching import chunked_map, default_batch_size
from pls_tpu_torch.utils.profiling import span


def lso_sizes(n_rows: int, test_fraction: float) -> tuple[int, int]:
    """(train_size, test_size) with the reference's rounding (pls.cpp:516-518)."""
    test_size = int(test_fraction * n_rows + 0.5)
    train_size = n_rows - test_size
    if test_size == 0 or train_size == 0:
        raise ValueError(
            f"test_fraction={test_fraction} leaves an empty split for N={n_rows}"
        )
    return train_size, test_size


def random_partitions(rng, n_rows: int, num_trials: int) -> torch.Tensor:
    """(num_trials, N) of independent random permutations.  `rng` is a
    torch.Generator (result on its device), or a JAX key or int seed: then
    the JAX package's `random_partitions` (`pls_tpu/cv/lso.py:44-49`) bit
    for bit, on the CPU."""
    if isinstance(rng, torch.Generator):
        u = torch.rand((num_trials, n_rows), generator=rng, device=rng.device)
        return torch.argsort(u, dim=1)
    keys = split(rng, num_trials)
    return torch.from_numpy(permutation(keys, n_rows))


def _partitions(N, num_trials, generator, key, partitions, device) -> torch.Tensor:
    if partitions is None:
        rng = key if key is not None else generator
        if rng is None:
            raise ValueError("give `key`, `generator` or `partitions`")
        with span("pls.lso.partitions"):
            partitions = random_partitions(rng, N, num_trials)
    partitions = torch.as_tensor(partitions, device=device)
    if tuple(partitions.shape) != (num_trials, N):
        raise ValueError(
            f"partitions shape {tuple(partitions.shape)} != {(num_trials, N)}"
        )
    return partitions


def cv_lso(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    test_fraction: float,
    num_trials: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    generator: torch.Generator | None = None,
    key=None,
    partitions=None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV.  Give `key` (a JAX key or int seed), `generator` or
    `partitions` (a (num_trials, N) index matrix, e.g.
    `GccRng.lso_partitions` for the reference's exact partitions).  Returns
    Residual errors (M, num_trials·test_size, A)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    train_size, _ = lso_sizes(N, test_fraction)
    partitions = _partitions(N, num_trials, generator, key, partitions, X.device)
    errors = lso_errors(
        X, Y, A, partitions, train_size, method, batch_size=batch_size,
        power_iters=power_iters, precision=precision, x_storage=x_storage,
    )
    return Residual(errors=errors, method="LSO")


def lso_errors(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    partitions: torch.Tensor,
    train_size: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> torch.Tensor:
    """The held-out errors (M, trials·test, A) of the trials of
    `partitions` (trials, N) on the device of X, the first `train_size`
    entries of a row being its training rows; Y is (N, M).  `cv_lso`'s
    body, which the fold-sharded LSO (parallel/sharded.py) runs on its
    share of the trials."""
    N, K = X.shape
    num_trials = partitions.shape[0]
    if batch_size is None:
        batch_size = default_batch_size(num_trials, N, K, X.element_size())

    def trials(perms: torch.Tensor) -> torch.Tensor:
        with span("pls.cv.fold_batch"):
            masks = torch.zeros(perms.shape, dtype=X.dtype, device=X.device)
            masks.scatter_(1, perms[:, :train_size], 1.0)
            test_idx = perms[:, train_size:]
            f = fit_folds(
                X, Y, masks, A, method, power_iters=power_iters,
                precision=precision, x_storage=x_storage,
            )
            return residuals_all_components(f, X[test_idx], Y[test_idx])  # (F, test, A, M)

    errs = chunked_map(trials, partitions, batch_size)  # (trials, test, A, M)
    return errs.permute(3, 0, 1, 2).reshape(Y.shape[1], num_trials * (N - train_size), A)


def cv_lso_downdate(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    test_fraction: float,
    num_trials: int,
    *,
    key=None,
    generator: torch.Generator | None = None,
    partitions=None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV from XᵀX/XᵀY: trial t refits from
    (XX − XtᵀXt, XY − XtᵀYt), Xt its test block, with the downdate inside
    the matvec (`fit_from_stats_blockdowndated`, trials batched).  Kernel
    type 2.  x_storage="bf16" rounds X to bfloat16 for the statistics, the
    block downdates and the residuals, with float32 accumulation.  Same
    partitions, rounding and error layout as `cv_lso`."""
    from pls_tpu_torch.cv.loo import global_stats

    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    train_size, test_size = lso_sizes(N, test_fraction)
    test_idx = _partitions(N, num_trials, generator, key, partitions, X.device)[:, train_size:]
    if batch_size is None:
        batch_size = min(num_trials, 8)
    XX, XY, Xs, acc = global_stats(X, Y, x_storage)

    def trials(ti: torch.Tensor) -> torch.Tensor:
        Xt = Xs[ti]
        Yt = Y[ti].to(acc)
        f = fit_from_stats_blockdowndated(
            XX, XY, Xt, Yt, A, power_iters=power_iters, precision=precision
        )
        return residuals_all_components(f, Xt.to(acc), Yt)  # (F, test, A, M)

    errs = chunked_map(trials, test_idx, batch_size)
    M = Y.shape[1]
    errors = errs.permute(3, 0, 1, 2).reshape(M, num_trials * test_size, A)
    return Residual(errors=errors, method="LSO")
