"""Special functions.

Counterpart of `pls_tpu/ops/special.py`: `normalcdf` is the reference's
Abramowitz & Stegun 4-term rational approximation (pls.cpp:144-160), with
the powers written out as the JAX package's integer powers evaluate them,
so Wilcoxon p-values and component choices match bit for bit.
"""

from __future__ import annotations

import torch


def normalcdf(z: torch.Tensor) -> torch.Tensor:
    """A&S 26.2.19 approximation of the standard normal CDF."""
    c1, c2, c3, c4 = 0.196854, 0.115194, 0.000344, 0.019527
    zs = z.abs()
    z2 = zs * zs
    d = 1 + c1 * zs + c2 * z2 + c3 * (zs * z2) + c4 * (z2 * z2)
    d2 = d * d
    p = 0.5 / (d2 * d2)
    return torch.where(z < 0, p, 1.0 - p)


def normalcdf_exact(z: torch.Tensor) -> torch.Tensor:
    """Exact standard normal CDF."""
    return torch.special.ndtr(z)
