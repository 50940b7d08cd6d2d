"""Carry a fitted model's weights between the JAX package and the port.

The JAX package's `PLSFit` is a pytree of W, P, Q, R, T arrays, and
`pls_tpu.PLSModel.save` writes them to an .npz (pls_tpu/model.py:364-416).
Both directions go through numpy, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.types import METHOD, PLSFit

FIELDS = ("W", "P", "Q", "R", "T")


def fit_from_numpy(
    arrays: dict,
    method: METHOD | str,
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> PLSFit:
    """The port's PLSFit from numpy arrays W, P, Q, R, T (as in the JAX
    package's PLSFit or its .npz)."""
    return PLSFit(
        **{k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device) for k in FIELDS},
        method=METHOD(method),
    )


def fit_to_numpy(fit: PLSFit) -> dict:
    """numpy arrays W, P, Q, R, T of a PLSFit (the .npz's layout)."""
    return {k: getattr(fit, k).detach().cpu().numpy() for k in FIELDS}
