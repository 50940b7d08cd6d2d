"""Robust PLS by iteratively reweighted fits (IRPLS, Cummins & Andrews
1995).

Counterpart of `pls_tpu/models/robust.py`:

    repeat n_irls times:
        f  = weighted PLS fit(X, Y, w)           (the sample_weight path)
        rᵢ = ‖Yᵢ − Ŷᵢ‖ / √M
        uᵢ = rᵢ / (1.4826·median|r − med r|)
        wᵢ = ψ(uᵢ)/uᵢ                             (Huber or bisquare)

    huber    : w = min(1, c/|u|),            c = 1.345
    bisquare : w = (1 − (u/c)²)² for |u|<c,  c = 4.685

The JAX package's `lax.scan` over the reweightings is a Python loop of
`kernel_pls.fit` calls here, so each one is an un-batched fit: kernel
type 1 on float32 X on the card launches K1 once per component of every
reweighting, n_irls + 1 fits in all.  The loop reads nothing back to the
host; the medians are `torch.quantile(·, 0.5)`, which averages the two
middle values of an even count as `jnp.median` does (`torch.median`
returns the lower one).
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import fit as _fit
from pls_tpu_torch.models.predict import fitted_values
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD, PLSFit

_DEFAULT_C = {"huber": 1.345, "bisquare": 4.685}


def _weights(u: torch.Tensor, loss: str, c: float) -> torch.Tensor:
    au = u.abs()
    if loss == "huber":
        return torch.clamp(c / torch.clamp(au, min=1e-12), max=1.0)
    if loss == "bisquare":
        z = torch.clamp(au / c, 0.0, 1.0)
        return (1.0 - z * z) ** 2
    raise ValueError(f"unknown loss {loss!r}")


def _median(v: torch.Tensor) -> torch.Tensor:
    return torch.quantile(v, 0.5)


def fit_robust(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    method: METHOD = KERNEL_TYPE1,
    *,
    loss: str = "huber",
    c: float | None = None,
    n_irls: int = 10,
    precision: str | None = "highest",
) -> tuple[PLSFit, torch.Tensor]:
    """Iteratively reweighted robust PLS on centred/scaled X, Y.  Returns
    (fit, weights): the final weighted fit and the (N,) weights in [0, 1],
    small or zero for the samples the fit rejected."""
    if Y.ndim == 1:
        Y = Y[:, None]
    N, M = Y.shape
    if loss not in _DEFAULT_C:
        raise ValueError(f"unknown loss {loss!r}; expected huber|bisquare")
    cc = _DEFAULT_C[loss] if c is None else c
    w = torch.ones(N, dtype=X.dtype, device=X.device)
    for _ in range(n_irls):
        f = _fit(X, Y, A, method, sample_weight=w, precision=precision)
        r = Y - fitted_values(f, X)
        rn = torch.sqrt((r * r).sum(1) / M)
        med = _median(rn)
        scale = torch.clamp(1.4826 * _median((rn - med).abs()), min=1e-12)
        w = _weights(rn / scale, loss, cc).to(X.dtype)
    return _fit(X, Y, A, method, sample_weight=w, precision=precision), w
