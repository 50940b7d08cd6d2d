"""Leave-one-out cross-validation, batched.

Counterpart of `pls_tpu/cv/loo.py:35-89` (reference `Model::cv_LOO`,
pls.cpp:469-491).  Fold i refits with row i masked out; a masked fit is
arithmetically the fit on the N−1 surviving rows, so the folds run as a
leading batch axis of `kernel_pls.fit_folds`, in chunks of `batch_size`.
Each fold records the held-out row's residual under every truncation
1..A, in the reference's (M, N, A) layout.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import fit_folds
from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.types import METHOD, Residual
from pls_tpu_torch.utils.batching import chunked_map, default_batch_size


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
    rows = torch.arange(N, device=X.device)

    def folds(idx: torch.Tensor) -> torch.Tensor:
        masks = rows[None, :] != idx[:, None]
        f = fit_folds(
            X, Y, masks, A, method, power_iters=power_iters,
            precision=precision, x_storage=x_storage,
        )
        return residuals_all_components(f, X[idx][:, None, :], Y[idx][:, None, :])[:, 0]

    errs = chunked_map(folds, rows, batch_size)  # (N, A, M)
    return Residual(errors=errs.permute(2, 0, 1), method="LOO")
