"""Carry a fitted model's weights between the JAX package and the port.

The JAX package's `PLSFit` is a pytree of W, P, Q, R, T arrays, and
`pls_tpu.PLSModel.save` writes them to an .npz (pls_tpu/model.py:364-416).
Its streaming accumulators (`pls_tpu/models/streaming.py`) carry
XᵀX/XᵀY statistics; `stats_from_numpy` turns their arrays into the
port's.  Everything goes through numpy, so neither package imports the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.config import resolve_device
from pls_tpu_torch.models.streaming import FoldStatsAccumulator, StatsAccumulator
from pls_tpu_torch.types import METHOD, PLSFit

FIELDS = ("W", "P", "Q", "R", "T")
STATS_FIELDS = ("XX", "XY", "YY", "sx", "sy")
FOLD_STATS_FIELDS = ("XXf", "XYf", "YYf", "sxf", "syf")


def fit_from_numpy(
    arrays: dict,
    method: METHOD | str,
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> PLSFit:
    """The port's PLSFit from numpy arrays W, P, Q, R, T (as in the JAX
    package's PLSFit or its .npz), on `device` (None: the card)."""
    device = resolve_device(device)
    return PLSFit(
        **{k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device) for k in FIELDS},
        method=METHOD(method),
    )


def fit_to_numpy(fit: PLSFit) -> dict:
    """numpy arrays W, P, Q, R, T of a PLSFit (the .npz's layout)."""
    return {k: getattr(fit, k).detach().cpu().numpy() for k in FIELDS}


def stats_from_numpy(
    arrays,
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
):
    """The port's StatsAccumulator or FoldStatsAccumulator from a JAX
    accumulator's arrays: an object or dict with XX, XY, YY, sx, sy, n
    (StatsAccumulator) or XXf, XYf, YYf, sxf, syf, nf
    (FoldStatsAccumulator), as numpy-convertible arrays, on `device`
    (None: the card)."""
    device = resolve_device(device)
    def get(name):
        v = arrays[name] if isinstance(arrays, dict) else getattr(arrays, name)
        return np.asarray(v)

    fold = (("XXf" in arrays) if isinstance(arrays, dict) else hasattr(arrays, "XXf"))
    names = FOLD_STATS_FIELDS if fold else STATS_FIELDS
    vals = {k: torch.tensor(get(k), dtype=dtype, device=device) for k in names}
    if fold:
        k, K, M = vals["XYf"].shape
        acc = FoldStatsAccumulator(K, M, k, vals["XXf"].dtype, device=device)
        acc.nf = torch.tensor(get("nf"), dtype=torch.int64, device=device)
    else:
        K, M = vals["XY"].shape
        acc = StatsAccumulator(K, M, vals["XX"].dtype, device=device)
        acc.n = int(get("n"))
    for name, v in vals.items():
        setattr(acc, name, v)
    return acc
