"""Leave-one-out cross-validation, batched.

Counterpart of `pls_tpu/cv/loo.py:35-89` (reference `Model::cv_LOO`,
pls.cpp:469-491).  Fold i refits with row i masked out; a masked fit is
arithmetically the fit on the N−1 surviving rows, so the folds run as a
leading batch axis of `kernel_pls.fit_folds`, in chunks of `batch_size`
(the fold body, `make_loo_fold_fn`, also serves the sharded and the
resumable LOO).
Each fold records the held-out row's residual under every truncation
1..A, in the reference's (M, N, A) layout.

`cv_loo_downdate` and `cv_loo_from_stats` (counterparts of
`pls_tpu/cv/loo.py:92-197`, kernel type 2) refit fold i from XᵀX/XᵀY with
the rank-1 downdate XX r − xᵢ(xᵢᵀr) inside the matvec: O(K²) per fold and
component, and the folds of a batch share one product with XX.
`cv_loo_from_stats` needs only the statistics and the held-out rows, so
it serves data streamed from disk (models/streaming.py, utils/binio.py).
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import _prec_ctx, fit_folds, fit_from_stats_downdated
from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.ops.stats import gram
from pls_tpu_torch.types import METHOD, Residual
from pls_tpu_torch.utils.batching import chunked_map, default_batch_size
from pls_tpu_torch.utils.profiling import span


def make_loo_fold_fn(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
):
    """The fold body shared by every LOO flavour (local, sharded,
    resumable; `pls_tpu/cv/loo.py:35-61`): given a batch of row indices
    (F,), refit with each row masked out in turn and return each held-out
    row's residuals under every truncation, (F, A, M).  Y is (N, M)."""
    rows = torch.arange(X.shape[0], device=X.device)

    def folds(idx: torch.Tensor) -> torch.Tensor:
        with span("pls.cv.fold_batch"):
            masks = rows[None, :] != idx[:, None]
            f = fit_folds(
                X, Y, masks, A, method, power_iters=power_iters,
                precision=precision, x_storage=x_storage,
            )
            return residuals_all_components(f, X[idx][:, None, :], Y[idx][:, None, :])[:, 0]

    return folds


def cv_loo(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """LOO CV by batched masked refits.  Returns Residual errors (M, N, A)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N, K = X.shape
    if batch_size is None:
        batch_size = default_batch_size(N, N, K, X.element_size())
    folds = make_loo_fold_fn(
        X, Y, A, method, power_iters=power_iters, precision=precision, x_storage=x_storage,
    )
    errs = chunked_map(folds, torch.arange(N, device=X.device), batch_size)  # (N, A, M)
    return Residual(errors=errs.permute(2, 0, 1), method="LOO")


def global_stats(X: torch.Tensor, Y: torch.Tensor, x_storage: str | None, precision="highest"):
    """(XX, XY, Xs, acc): XᵀX and XᵀY in the accumulation dtype `acc`, and
    X as stored (`Xs`, bfloat16 for x_storage="bf16", whose products then
    run in float32 on Y rounded to bfloat16, as the JAX package's
    `preferred_element_type` products).  XᵀX by `ops.stats.gram`: its upper
    block triangle and a mirror at wide K."""
    acc = X.dtype if X.element_size() >= 4 else torch.float32
    if x_storage is not None and x_storage not in ("bf16", "bfloat16"):
        raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")
    with span("pls.cv.global_stats"), _prec_ctx(precision):
        Xs = X if x_storage is None else X.to(torch.bfloat16)
        if Xs.element_size() < 4:
            Xw = Xs.to(acc)
            return gram(Xw), Xw.mT @ Y.to(torch.bfloat16).to(acc), Xs, acc
        return gram(X), X.mT @ Y, Xs, acc


def cv_loo_downdate(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    *,
    fold_indices=None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """LOO CV by rank-1 downdates of XᵀX/XᵀY (kernel type 2).  x_storage=
    "bf16" rounds X to bfloat16 for the one pass over X (the statistics);
    the rows downdated stay in the accumulation dtype.  `fold_indices`
    picks the held-out rows (default every row).  Returns (M, F, A)."""
    if Y.ndim == 1:
        Y = Y[:, None]
    XX, XY, _, acc = global_stats(X, Y, x_storage, precision)
    idx = torch.arange(X.shape[0]) if fold_indices is None else torch.as_tensor(fold_indices)
    idx = idx.to(X.device)
    return cv_loo_from_stats(
        XX, XY, X.to(acc)[idx], Y.to(acc)[idx], A, batch_size=batch_size,
        power_iters=power_iters, precision=precision,
    )


def cv_loo_from_stats(
    XX: torch.Tensor,
    XY: torch.Tensor,
    fold_X: torch.Tensor,
    fold_Y: torch.Tensor,
    A: int,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """Batched LOO from the global statistics and the F held-out rows
    fold_X (F, K), fold_Y (F, M), each contained in XX/XY.  Returns
    Residual errors (M, F, A)."""
    if fold_Y.ndim == 1:
        fold_Y = fold_Y[:, None]
    F = fold_X.shape[0]
    if batch_size is None:
        batch_size = min(F, 128)

    def folds(i: torch.Tensor) -> torch.Tensor:
        x, y = fold_X[i], fold_Y[i]
        f = fit_from_stats_downdated(XX, XY, x, y, A, power_iters=power_iters, precision=precision)
        return residuals_all_components(f, x[:, None, :], y[:, None, :])[:, 0]  # (F, A, M)

    errs = chunked_map(folds, torch.arange(F, device=fold_X.device), batch_size)
    return Residual(errors=errs.permute(2, 0, 1), method="LOO")
