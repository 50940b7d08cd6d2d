"""Carry a fitted model's weights between the JAX package and the port.

The JAX package's `PLSFit` is a pytree of W, P, Q, R, T arrays, and
`pls_tpu.PLSModel.save` writes them to an .npz (pls_tpu/model.py:364-416).
Its streaming accumulators (`pls_tpu/models/streaming.py`) carry
XᵀX/XᵀY statistics; `stats_from_numpy` turns their arrays into the
port's.  The other model states (OPLSFit, KPLSFit, CDFit, PLSGLMFit,
MonitorModel, MBPLSFit, NPLSFit, O2PLSFit, PLSCoxFit, PLSPMFit,
TransferModel, EPOModel, ...) go across by their dataclass fields:
`state_from_numpy` and `state_to_numpy`.  Everything goes through numpy,
so neither package imports the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pls_tpu_torch.config import resolve_device
from pls_tpu_torch.models.streaming import FoldStatsAccumulator, StatsAccumulator
from pls_tpu_torch.types import METHOD, PLSFit

FIELDS = ("W", "P", "Q", "R", "T")
STATS_FIELDS = ("XX", "XY", "YY", "sx", "sy")
FOLD_STATS_FIELDS = ("XXf", "XYf", "YYf", "sxf", "syf")


def _get(src, name: str):
    """Field `name` of a dataclass (the JAX package's states), or entry
    `name` of a mapping (a dict, an .npz)."""
    return getattr(src, name) if dataclasses.is_dataclass(src) else src[name]


def fit_from_numpy(
    arrays,
    method: METHOD | str,
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> PLSFit:
    """The port's PLSFit from numpy-convertible W, P, Q, R, T: a mapping (a
    dict, the JAX package's .npz) or the JAX package's PLSFit itself, on
    `device` (None: the card).  `method` is a METHOD, its value, or the
    JAX package's METHOD."""
    device = resolve_device(device)
    return PLSFit(
        **{k: torch.tensor(np.asarray(_get(arrays, k)), dtype=dtype, device=device)
           for k in FIELDS},
        method=METHOD(getattr(method, "value", method)),
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


def state_from_numpy(
    cls,
    src,
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
):
    """A model state of the port's dataclass `cls` (OPLSFit, KPLSFit, CDFit,
    PLSGLMFit, MonitorModel and the other fit states) from `src`, the JAX package's state of the
    same name or a mapping of its fields, on `device` (None: the card).
    Array fields become tensors (in `dtype`, default the array's); a nested
    PLSFit (`pls`) goes through `fit_from_numpy`; str, int, float and None
    fields (kernel, gamma, mode, family, alpha...) are copied, a tuple or
    list (block_sizes) as a tuple."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = _get(src, f.name)
        if f.name == "pls":
            kw[f.name] = fit_from_numpy(v, _get(v, "method"), device=device, dtype=dtype)
        elif v is None or isinstance(v, (str, int, float)):
            kw[f.name] = v
        elif isinstance(v, (tuple, list)):  # static sizes (MBPLSFit.block_sizes)
            kw[f.name] = tuple(v)
        else:
            kw[f.name] = torch.tensor(np.asarray(v), dtype=dtype, device=device)
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """A port's model state as a dict of its fields: tensors as numpy
    arrays, a nested PLSFit as `fit_to_numpy`'s dict plus its method's
    value, other fields as they are."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, PLSFit):
            out[f.name] = {**fit_to_numpy(v), "method": v.method.value}
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = v
    return out
