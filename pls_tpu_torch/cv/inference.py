"""Statistical inference on PLS models: jackknife coefficient uncertainty
(Martens & Martens 2000) and the Y-permutation test (Lindgren et al.
1996).

Counterpart of `pls_tpu/cv/inference.py`:

- jackknife: the N leave-one-out fits' coefficients, and the Martens
  variance s²(b) = ((N−1)/N) Σᵢ (bᵢ − b̄)², t-statistics and
  normal-approximation p-values;
- permutation test: refits under `num_permutations` row permutations of
  Y, drawn as the JAX package draws them (`jax.random.split(key, P)`,
  then `jax.random.permutation(k, N)` per key, through
  `utils/jax_prng.py`), against the observed mean R²;
  p = (1 + #{null ≥ observed}) / (P + 1).

The fits run in batches (`utils.batching.fold_batch_size`): the JAX
default batch size (64 folds, 32 permutations) capped so that a batch's
copies of X stay near 128 MiB; a batch size the caller passes is taken as
given.  A batch of one is an un-batched fit, whose passes are K1 on
float32 X on the card.  Entry points take numpy or tensors: data that is
not a tensor goes to `device` (None: the card) through `config.as_data`.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models.kernel_pls import fit, fit_folds, fit_masks
from pls_tpu_torch.models.predict import coefficients, explained_variance, fitted_values
from pls_tpu_torch.ops.special import normalcdf_exact
from pls_tpu_torch.ops.stats import sst
from pls_tpu_torch.types import METHOD
from pls_tpu_torch.utils import jax_prng
from pls_tpu_torch.utils.batching import chunked_map, fold_batch_size


def _xy(X, Y, device):
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    return X, (Y[:, None] if Y.ndim == 1 else Y)


def jackknife_coefficients(
    X,
    Y,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    comp: int | None = None,
    batch_size: int | None = None,
    precision: str | None = "highest",
    device=None,
) -> torch.Tensor:
    """(N, K, M) leave-one-out coefficient estimates: fit i leaves row i
    out (a row mask, exact)."""
    X, Y = _xy(X, Y, device)
    N = X.shape[0]
    rows = torch.arange(N, device=X.device)

    def folds(idx):
        masks = rows[None, :] != idx[:, None]
        return coefficients(fit_masks(X, Y, masks, A, method, precision=precision), comp)

    return chunked_map(folds, rows, fold_batch_size(N, X, batch_size))


def coefficient_significance(
    X,
    Y,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    comp: int | None = None,
    batch_size: int | None = None,
    precision: str | None = "highest",
    device=None,
):
    """Martens-jackknife coefficient uncertainty: (B, se, t, p), the
    full-data coefficients (K, M), the jackknife standard error with the
    (N−1)/N factor, t = B/se, and two-sided normal p-values."""
    X, Y = _xy(X, Y, device)
    N = X.shape[0]
    B = coefficients(fit(X, Y, A, method, precision=precision), comp)
    Bs = jackknife_coefficients(X, Y, A, method, comp=comp, batch_size=batch_size,
                                precision=precision)
    Bbar = Bs.mean(0)
    se = torch.sqrt((N - 1) / N * ((Bs - Bbar) ** 2).sum(0))
    pos = se > 0
    t = torch.where(pos, B / torch.where(pos, se, 1.0), torch.inf * torch.sign(B))
    p = 2.0 * (1.0 - normalcdf_exact(t.abs()))
    return B, se, t, p


def permutation_test(
    X,
    Y,
    A: int,
    num_permutations: int,
    key,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    comp: int | None = None,
    batch_size: int | None = None,
    precision: str | None = "highest",
    device=None,
):
    """Y-permutation test: (r2_observed, r2_null (P,), p_value), the mean
    explained variance over Y's columns at truncation `comp` of the real
    fit and of the fits to the permuted Y's.  `key` is a JAX key's data
    or an int seed (`jax.random.key(seed)`)."""
    X, Y = _xy(X, Y, device)
    N = X.shape[0]
    r2_obs = explained_variance(fit(X, Y, A, method, precision=precision), X, Y, comp).mean()
    perms = torch.from_numpy(jax_prng.permutation(jax_prng.split(key, num_permutations), N))
    perms = perms.to(X.device)

    def null(idx):
        Yp = Y[idx]  # (b, N, M)
        if len(idx) == 1:
            f = fit(X, Yp[0], A, method, precision=precision)
        else:  # X shared by the batch: a view, the rows unmasked
            f = fit_folds(X.expand(len(idx), *X.shape), Yp, Yp.new_ones(len(idx), N), A,
                          method, precision=precision)
        res = Yp - fitted_values(f, X, comp)
        ss = torch.stack([sst(y) for y in Yp])
        return (1.0 - (res * res).sum(-2) / ss).mean(-1)

    r2_null = chunked_map(null, perms, fold_batch_size(num_permutations, X, batch_size, cap=32))
    p = (1.0 + (r2_null >= r2_obs).sum().to(r2_null.dtype)) / (num_permutations + 1.0)
    return r2_obs, r2_null, p
