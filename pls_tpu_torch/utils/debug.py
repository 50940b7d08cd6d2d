"""Numerical-debug utilities.

Counterpart of `pls_tpu/utils/debug.py`:

- `debug_nans()`: a context manager under which the port's `fit` and
  `fit_folds` (models/kernel_pls.py) call `assert_finite` on the state
  they return.  JAX's `jax_debug_nans` raises at the operation that makes
  the first NaN; PyTorch has no such switch for forward operations, so
  here the check raises at the end of the fit, naming the field.
- `assert_finite(obj, name)`: raises FloatingPointError naming the first
  field (of a state dataclass, a dict, a list or a tuple, nested) that
  holds a non-finite value.
- `fit_health(fit)`: per-component score norms tᵀt, the scores'
  orthogonality defect, the deviation of PᵀW's diagonal from 1, and
  finiteness, as host scalars.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from pls_tpu_torch.types import PLSFit

# whether `fit`/`fit_folds` check their result (set by `debug_nans`)
state = {"check_fits": False}


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    prev = state["check_fits"]
    state["check_fits"] = enable
    try:
        yield
    finally:
        state["check_fits"] = prev


def _items(obj, path: str):
    """(path, tensor) pairs of the floating tensors in obj, nested."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _items(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _items(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _items(v, f"{path}[{i}]")


def assert_finite(obj, name: str = "tree") -> None:
    for path, t in _items(obj, ""):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def fit_health(fit: PLSFit) -> dict:
    """Diagnostics dict for a fitted model; all values are host scalars."""
    out: dict = {"finite": True}
    try:
        assert_finite(fit, "fit")
    except FloatingPointError:
        out["finite"] = False
    if fit.T.numel():
        tt = (fit.T * fit.T).sum(0)
        out["score_norms"] = [float(v) for v in tt]
        G = fit.T.T @ fit.T
        off = G - torch.diag(torch.diagonal(G))
        denom = float(torch.diagonal(G).max())
        out["score_orthogonality_defect"] = float(off.abs().max()) / denom if denom > 0 else 0.0
    # PᵀW is upper triangular with a unit diagonal for the kernel and NIPALS fits
    PtW = fit.P.T @ fit.W
    out["ptw_diag_deviation"] = float((torch.diagonal(PtW) - 1.0).abs().max())
    return out
