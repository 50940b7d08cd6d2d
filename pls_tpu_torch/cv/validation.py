"""CV-error summaries and the optimal number of components.

Counterpart of `pls_tpu/cv/validation.py` (reference pls.cpp:229-305):
  validation(residual, out_type)    → (M, A) RESS (= PRESS) or MSE
  optimal_num_components(residual)  → per-Y optimal component count, 1-based
  print_validation(...)             → the "LOO Validation:" stderr tables

Selection rule (pls.cpp:263-289): per Y variable, take the component count
with the least PRESS (first minimum), then the fewest components whose
errors are not significantly worse under a one-sided Wilcoxon signed-rank
test at level α.  All M·A tests run as one batch.
"""

from __future__ import annotations

import sys

import torch

from pls_tpu_torch.ops.wilcoxon import wilcoxon
from pls_tpu_torch.types import MSE, RESS, VALIDATION_OUTPUT, Residual
from pls_tpu_torch.utils.reporting import format_eigen


def validation(residual: Residual, out_type: VALIDATION_OUTPUT = RESS) -> torch.Tensor:
    """Summarize CV errors into an (M, A) matrix (pls.cpp:235-261).
    RMSE = sqrt(MSE) is taken by the caller, as in the reference printer."""
    errs = residual.errors  # (M, n_obs, A)
    ssev = (errs * errs).sum(1)
    if out_type == MSE:
        ssev = ssev / residual.n_obs
    return ssev


def _optimal_from_errors(errs: torch.Tensor, alpha: float) -> torch.Tensor:
    """errs (M, n_obs, A) → (M,) 1-based component counts."""
    M, n, A = errs.shape
    press = (errs * errs).sum(1)  # (M, A)
    ref_min = press.argmin(-1)  # first minimum, like Eigen's minCoeff
    err_ref = torch.take_along_dim(errs, ref_min[:, None, None].expand(M, n, 1), dim=2)
    pvals = wilcoxon(err_ref.mT.expand(M, A, n), errs.mT)  # (M, A)
    ok = (torch.arange(A, device=errs.device)[None, :] < ref_min[:, None]) & (pvals > alpha)
    # earliest passing candidate, else ref_min (the reference's loop breaks
    # at the first success, pls.cpp:281-285)
    first_ok = ok.to(torch.int8).argmax(-1)
    return torch.where(ok.any(-1), first_ok, ref_min) + 1


def optimal_num_components(residual: Residual, alpha: float = 0.1) -> torch.Tensor:
    """Per-Y optimal number of components, 1-based (pls.cpp:263-289)."""
    return _optimal_from_errors(residual.errors, alpha)


def print_validation(
    residual: Residual,
    out_type: VALIDATION_OUTPUT = MSE,
    file=None,
    alpha: float = 0.1,
) -> None:
    """Print the validation table in the reference's layout (pls.cpp:291-305;
    stderr by default)."""
    file = sys.stderr if file is None else file
    em = validation(residual, out_type)
    label = {MSE: "RMSE ", RESS: "PRESS "}.get(out_type, "UNKNOWN ")
    if out_type == MSE:
        em = em.sqrt()
    print(f"{residual.method} Validation:", file=file)
    print(f"{label} Matrix (rows = Y variable; cols = # of components):", file=file)
    print(format_eigen(em.cpu().numpy()), file=file)
    opt = optimal_num_components(residual, alpha).tolist()
    # Eigen prints the integer column vector one entry per line, the first
    # after the tab (pls.cpp:304)
    body = "\n".join(str(int(v)) for v in opt)
    print(f"Optimal number of components (by Y variable):\t{body}", file=file)
