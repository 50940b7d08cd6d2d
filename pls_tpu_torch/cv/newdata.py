"""Hold-out / new-data validation.

Counterpart of `pls_tpu/cv/newdata.py` (reference `Model::cv_NEW_DATA`,
pls.cpp:493-510): no refits, the held-out (X, Y)'s residuals under the
fitted model for every truncation 1..A.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.types import PLSFit, Residual


def cv_new_data(fit: PLSFit, X_new: torch.Tensor, Y_new: torch.Tensor) -> Residual:
    if Y_new.ndim == 1:
        Y_new = Y_new[:, None]
    if X_new.shape[1] != fit.K or Y_new.shape[1] != fit.M:
        # the reference's column-compatibility assert (pls.cpp:497)
        raise ValueError(
            f"new data has {X_new.shape[1]} predictors / {Y_new.shape[1]} "
            f"responses; model expects {fit.K} / {fit.M}"
        )
    res = residuals_all_components(fit, X_new, Y_new)  # (n, A, M)
    return Residual(errors=res.permute(2, 0, 1), method="NEW DATA")
