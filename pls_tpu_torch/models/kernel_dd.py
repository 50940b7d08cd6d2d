"""precision="dd": the kernel-PLS component loop in float64.

Counterpart of `pls_tpu/models/kernel_dd.py`, the JAX package's analogue of
the reference's MPFR build (pls.h:11-28).  There every per-component
quantity and every X contraction is an unevaluated pair of float32 values
(about 49 mantissa bits), built from error-free transforms, because the
TPU has no float64.  The card and the CPU have float64, so here the same
inputs, X and Y rounded to float32 as the JAX package takes them, run the
plain component loop in float64: at least as accurate as the pairs, and a
float64 product on the H100 runs on its tensor cores.  The rounding and
the widening live in `kernel_pls._fit_kernel`, beside "compensated"'s, so
`fit_dd` and `fit(..., precision="dd")` are one path.  The state comes
back in the input's dtype (float32 for bfloat16 input).  No kernel takes
float64 X: the passes are torch products.  `fit_from_stats_dd` adds the
statistics' lo parts in float64 before the statistics fit.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.models.kernel_pls import _cast, _fit_kernel, _state_dtype, fit_from_stats
from pls_tpu_torch.types import PLSFit


def _f64_of_f32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float32, widened to float64."""
    return t.to(torch.float32).to(torch.float64)


def fit_dd(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    type1: bool = True,
    *,
    power_iters: int | None = None,
) -> PLSFit:
    """Kernel type 1 (or type 2) on X (N, K) and Y (N, M) rounded to
    float32, with the loop in float64: what `fit(..., precision="dd")`
    runs.  X and Y may carry a leading fold axis."""
    return _fit_kernel(X, Y[..., None] if Y.ndim == X.ndim - 1 else Y, A, type1, power_iters, "dd")


def fit_from_stats_dd(
    XX: torch.Tensor,
    XY: torch.Tensor,
    A: int,
    *,
    XX_lo: torch.Tensor | None = None,
    XY_lo: torch.Tensor | None = None,
    power_iters: int | None = None,
) -> PLSFit:
    """Kernel type 2 from XX (K, K) and XY (K, M), each read as float32
    and, where given, plus its lo part (`StatsAccumulator(compensated=True)`
    keeps them as `XXe`/`XYe`), summed in float64; the loop runs in
    float64 and the state comes back in XX's dtype."""
    if XY.ndim == XX.ndim - 1:
        XY = XY[..., None]
    XX64, XY64 = _f64_of_f32(XX), _f64_of_f32(XY)
    if XX_lo is not None:
        XX64 = XX64 + _f64_of_f32(XX_lo)
    if XY_lo is not None:
        XY64 = XY64 + _f64_of_f32(XY_lo.reshape(XY.shape))
    return _cast(fit_from_stats(XX64, XY64, A, power_iters=power_iters), _state_dtype(XX.dtype))
