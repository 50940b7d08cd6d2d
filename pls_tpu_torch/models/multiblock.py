"""Multiblock PLS (MB-PLS; Westerhuis, Kourti & MacGregor 1998).

Counterpart of `pls_tpu/models/multiblock.py`.  MB-PLS super scores are
those of ordinary PLS on the concatenated blocks, each block scaled up
front, so the fit is one kernel-PLS fit of the concatenation
(`kernel_pls.fit`: K1 on float32 X on the card for kernel type 1) and the
block quantities slice its weights:

    block weight  w_b = W[k_b] / ‖W[k_b]‖   (unit, per component)
    block score   t_b = (X_b / s_b) w_b
    block importance BIP_b = ‖W[k_b]‖²     (Σ_b BIP_b = 1 per component)

Block scaling divides block b by √K_b (default), so that each block has
the same total variance a priori; `block_scale=False` is plain PLS on the
concatenation.  Blocks that are not tensors go to `device` (None: the
card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models.kernel_pls import fit as _fit_pls
from pls_tpu_torch.models.predict import _promote
from pls_tpu_torch.models.predict import coefficients as _coefficients
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD, PLSFit
from pls_tpu_torch.utils.checkpoint import register_checkpointable


@register_checkpointable
@dataclass(frozen=True)
class MBPLSFit:
    """Multiblock fit: the concatenated super-model and the blocks.

    pls          : PLSFit on the (scaled) concatenated X, K = ΣK_b
    block_scales : (B,) the √K_b (or 1) factors applied per block
    block_sizes  : (K_1, …, K_B)
    """

    pls: PLSFit
    block_scales: torch.Tensor
    block_sizes: tuple = ()

    @property
    def A(self) -> int:
        return self.pls.A

    @property
    def n_blocks(self) -> int:
        return len(self.block_sizes)

    def _slices(self):
        off = np.concatenate([[0], np.cumsum(self.block_sizes)])
        return [slice(int(a), int(b)) for a, b in zip(off[:-1], off[1:])]


def _concat(Xs, scales: torch.Tensor) -> torch.Tensor:
    first = as_data(Xs[0], scales.device)
    blocks = [first] + [as_data(X, first.device) for X in Xs[1:]]
    blocks = _promote(*blocks, scales)
    return torch.cat([X / s for X, s in zip(blocks[:-1], blocks[-1])], dim=1)


def fit_mbpls(
    Xs,
    Y,
    A: int,
    *,
    method: METHOD = KERNEL_TYPE1,
    block_scale: bool = True,
    precision: str | None = "highest",
    device=None,
) -> MBPLSFit:
    """MB-PLS on blocks Xs = [X_1 (N, K_1), …, X_B (N, K_B)] against Y.
    The blocks share N and are centred/scaled column-wise by the caller;
    `block_scale` also divides block b by √K_b."""
    first = as_data(Xs[0], device)
    sizes = tuple(int(X.shape[1]) for X in Xs)
    if block_scale:
        scales = torch.as_tensor([np.sqrt(k) for k in sizes], dtype=first.dtype,
                                 device=first.device)
    else:
        scales = torch.ones(len(sizes), dtype=first.dtype, device=first.device)
    Xcat = _concat([first, *Xs[1:]], scales)
    pls = _fit_pls(Xcat, as_data(Y, first.device).to(first.dtype), A, method,
                   precision=precision)
    return MBPLSFit(pls=pls, block_scales=scales, block_sizes=sizes)


def block_weights(fit: MBPLSFit) -> list:
    """Unit-norm block weight matrices [(K_b, A)]: the super weights
    sliced per block and renormalised per component."""
    out = []
    for sl in fit._slices():
        Wb = fit.pls.W[sl, :]
        nrm = torch.sqrt((Wb * Wb).sum(0))
        out.append(Wb / torch.where(nrm == 0, 1.0, nrm)[None, :])
    return out


def block_scores(fit: MBPLSFit, Xs) -> torch.Tensor:
    """(N, B, A) block scores t_b = (X_b/s_b) w_b of (centred) blocks."""
    ts = []
    for X, s, Wb in zip(Xs, fit.block_scales, block_weights(fit)):
        X, s, Wb = _promote(as_data(X, Wb.device), s, Wb)
        ts.append((X / s) @ Wb)
    return torch.stack(ts, dim=1)


def block_importance(fit: MBPLSFit) -> torch.Tensor:
    """(B, A) block importance in projection: each block's share of each
    component's (unit) super-weight norm; columns sum to 1."""
    return torch.stack([(fit.pls.W[sl, :] ** 2).sum(0) for sl in fit._slices()], dim=0)


def predict_mbpls(fit: MBPLSFit, Xs_new, comp: int | None = None) -> torch.Tensor:
    """Ŷ for new (centred) blocks by the super-model's coefficients."""
    Xcat, B = _promote(_concat(Xs_new, fit.block_scales), _coefficients(fit.pls, comp))
    return Xcat @ B


def super_scores(fit: MBPLSFit, Xs_new) -> torch.Tensor:
    """(n, A) super scores of new (centred) blocks: X_cat R."""
    Xcat, R = _promote(_concat(Xs_new, fit.block_scales), fit.pls.R)
    return Xcat @ R
