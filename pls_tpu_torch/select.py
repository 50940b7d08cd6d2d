"""Variable selection: interval PLS (iPLS; Nørgaard et al. 2000) and UVE-PLS
(Centner et al. 1996).

Counterpart of `pls_tpu/select.py`.  A channel subset is a {0,1} column
mask: zeroed columns of X carry exact zeros through XᵀY, the weights and
the loadings, so a column-masked fit is the fit on the subset.

- `ipls`: k-fold RMSECV of one model per contiguous channel interval, and
  of the full-spectrum model;
- `ipls_forward` / `ipls_backward`: greedy growth / elimination of
  intervals while the RMSECV improves;
- `uve_pls`: K tiny noise columns appended to X (drawn as
  `jax.random.normal` draws them, `utils/jax_prng.normal`), coefficient
  stability |mean/std| over CV folds, real variables kept where it beats
  the best noise column's.

The JAX package maps over batches of candidates (and of UVE's folds) as
one program.  Here a batch is at most the JAX default (8 candidates, 32
folds), capped so that its copies of X stay near 128 MiB
(`utils.batching.fold_batch_size`); a batch size the caller passes is
taken as given.  A batch of one candidate runs its k folds as un-batched
fits of the column-masked X, whose passes are K1 on float32 X on the
card.  X and Y that are not tensors go to `device` (None: the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.cv.kfold import kfold_assignments
from pls_tpu_torch.models.kernel_pls import fit, fit_folds, fit_masks
from pls_tpu_torch.models.predict import coefficients, residuals_all_components
from pls_tpu_torch.types import METHOD
from pls_tpu_torch.utils import jax_prng
from pls_tpu_torch.utils.batching import fold_batch_size

__all__ = [
    "interval_edges",
    "interval_masks",
    "ipls",
    "ipls_forward",
    "ipls_backward",
    "IPLSResult",
    "IPLSSelection",
    "uve_pls",
    "UVEResult",
]


def interval_edges(K: int, n_intervals: int) -> np.ndarray:
    """(n_intervals+1,) channel edges of a balanced contiguous split
    (interval i covers columns edges[i]:edges[i+1]; sizes differ by ≤1)."""
    if not (1 <= n_intervals <= K):
        raise ValueError(f"n_intervals={n_intervals} must be in [1, K={K}]")
    return np.linspace(0, K, n_intervals + 1).round().astype(int)


def interval_masks(K: int, n_intervals: int) -> np.ndarray:
    """(n_intervals, K) {0,1} column masks for the balanced split."""
    edges = interval_edges(K, n_intervals)
    masks = np.zeros((n_intervals, K))
    for i in range(n_intervals):
        masks[i, edges[i] : edges[i + 1]] = 1.0
    return masks


def _press_for_masks(X, Y, masks, A, assign, k, method, precision, batch_size) -> torch.Tensor:
    """(C, A, M) k-fold PRESS of each candidate column mask (C, K): summed
    squared held-out residuals per candidate, truncation and response."""
    cmasks = torch.as_tensor(np.asarray(masks), dtype=X.dtype, device=X.device)
    C = cmasks.shape[0]
    step = fold_batch_size(C, X, batch_size, cap=8)
    out = []
    for c0 in range(0, C, step):
        Xm = X * cmasks[c0 : c0 + step, None, :]  # (b, N, K)
        press = X.new_zeros((Xm.shape[0], A, Y.shape[1]))
        for fid in range(k):
            keep = (assign != fid).to(X.dtype)
            if Xm.shape[0] == 1:
                f = fit(Xm[0], Y, A, method, row_mask=keep, precision=precision)
            else:
                m = keep[None, :, None]
                f = fit_folds(Xm * m, Y[None] * m, keep[None].expand(Xm.shape[0], -1), A,
                              method, precision=precision)
            res = residuals_all_components(f, Xm, Y)  # (b, N, A, M)
            press += (res * res * (1.0 - keep)[:, None, None]).sum(-3)
        out.append(press)
    return torch.cat(out)


def _rmsecv(press: torch.Tensor, N: int) -> np.ndarray:
    """(C, A) mean-over-M RMSECV of a (C, A, M) PRESS."""
    return torch.sqrt((press / N).mean(-1)).cpu().numpy()


@dataclass(frozen=True)
class IPLSResult:
    """Per-interval iPLS table."""

    edges: np.ndarray  # (n_intervals+1,) channel edges
    rmsecv: np.ndarray  # (n_intervals, A) mean-over-M RMSECV per comps 1..A
    global_rmsecv: np.ndarray  # (A,) full-spectrum model RMSECV
    best_interval: int  # argmin over intervals of min-over-comps RMSECV
    best_ncomp: int  # 1-based comps of the winning interval model

    def summary(self) -> str:
        lines = [
            f"iPLS: {len(self.edges) - 1} intervals, global best RMSECV "
            f"{self.global_rmsecv.min():.6g}"
        ]
        for i in range(len(self.edges) - 1):
            star = " *" if i == self.best_interval else ""
            lines.append(
                f"  [{self.edges[i]:4d}:{self.edges[i + 1]:4d})  "
                f"RMSECV {self.rmsecv[i].min():.6g}{star}"
            )
        return "\n".join(lines)


def _prep(X, Y, device):
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    return X, (Y[:, None] if Y.ndim == 1 else Y)


def _check_width(K: int, n_intervals: int, A: int) -> np.ndarray:
    edges = interval_edges(K, n_intervals)
    min_width = int(np.diff(edges).min())
    if A > min_width:
        raise ValueError(
            f"A={A} exceeds the smallest interval width {min_width}; lower A or n_intervals"
        )
    return edges


def ipls(
    X,
    Y,
    n_intervals: int = 10,
    A: int = 5,
    k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    key=0,
    precision: str | None = "highest",
    batch_size: int | None = None,
    device=None,
) -> IPLSResult:
    """Classic iPLS: k-fold RMSECV of one PLS model per channel interval,
    plus the full-spectrum model.  `A` must not exceed the smallest
    interval width.  `key`: a JAX key's data, an int seed, or None
    (unshuffled folds)."""
    X, Y = _prep(X, Y, device)
    N, K = X.shape
    edges = _check_width(K, n_intervals, A)
    masks = np.vstack([interval_masks(K, n_intervals), np.ones((1, K))])
    assign = kfold_assignments(N, k, key).to(X.device)
    rmse = _rmsecv(_press_for_masks(X, Y, masks, A, assign, k, method, precision, batch_size), N)
    per_interval, global_rmse = rmse[:-1], rmse[-1]
    flat_best = int(per_interval.min(axis=1).argmin())
    return IPLSResult(
        edges=edges,
        rmsecv=per_interval,
        global_rmsecv=global_rmse,
        best_interval=flat_best,
        best_ncomp=int(per_interval[flat_best].argmin()) + 1,
    )


@dataclass(frozen=True)
class IPLSSelection:
    """Result of a greedy interval search."""

    edges: np.ndarray
    selected: list[int] = field(default_factory=list)  # interval ids, pick order
    mask: np.ndarray = None  # (K,) {0,1} selected-channel mask
    rmsecv_path: np.ndarray = None  # best RMSECV after each greedy step
    ncomp: int = 0  # 1-based comps of the final model

    @property
    def n_selected_channels(self) -> int:
        return int(self.mask.sum())


def _greedy(
    X, Y, n_intervals, A, k, method, key, precision, batch_size, device,
    *, forward: bool, max_steps: int | None, tol: float,
) -> IPLSSelection:
    X, Y = _prep(X, Y, device)
    N, K = X.shape
    edges = _check_width(K, n_intervals, A)
    imasks = interval_masks(K, n_intervals)
    assign = kfold_assignments(N, k, key).to(X.device)

    def score(cands: np.ndarray) -> np.ndarray:
        return _rmsecv(_press_for_masks(X, Y, cands, A, assign, k, method, precision,
                                        batch_size), N)

    if forward:
        chosen: list[int] = []
        current = np.zeros(K)
        best_rmse = np.inf
        best_ncomp = 0
        path = []
        limit = max_steps or n_intervals
        while len(chosen) < limit:
            remaining = [i for i in range(n_intervals) if i not in chosen]
            if not remaining:
                break
            cands = np.vstack([np.minimum(current + imasks[i], 1.0) for i in remaining])
            rmse = score(cands)  # (C, A)
            per = rmse.min(axis=1)
            j = int(per.argmin())
            if per[j] >= best_rmse * (1.0 - tol) and chosen:
                break  # no meaningful improvement
            best_rmse = float(per[j])
            best_ncomp = int(rmse[j].argmin()) + 1
            chosen.append(remaining[j])
            current = cands[j]
            path.append(best_rmse)
        return IPLSSelection(edges=edges, selected=chosen, mask=current,
                             rmsecv_path=np.asarray(path), ncomp=best_ncomp)

    # backward elimination: start from the full spectrum
    chosen = list(range(n_intervals))
    current = np.ones(K)
    base = score(current[None, :])
    best_rmse = float(base.min())
    best_ncomp = int(base[0].argmin()) + 1
    path = [best_rmse]
    limit = max_steps or (n_intervals - 1)
    steps = 0
    while len(chosen) > 1 and steps < limit:
        cands = np.vstack([current - imasks[i] for i in chosen])
        rmse = score(cands)
        per = rmse.min(axis=1)
        j = int(per.argmin())
        if per[j] > best_rmse * (1.0 + tol):
            break  # every removal hurts
        best_rmse = min(best_rmse, float(per[j]))
        best_ncomp = int(rmse[j].argmin()) + 1
        current = cands[j]
        chosen.pop(j)
        path.append(float(per[j]))
        steps += 1
    return IPLSSelection(edges=edges, selected=sorted(chosen), mask=current,
                         rmsecv_path=np.asarray(path), ncomp=best_ncomp)


def ipls_forward(
    X, Y, n_intervals: int = 10, A: int = 5, k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1, *,
    key=0, max_intervals: int | None = None,
    tol: float = 1e-4, precision: str | None = "highest",
    batch_size: int | None = None, device=None,
) -> IPLSSelection:
    """Forward synergy-iPLS: greedily add the interval that most lowers
    k-fold RMSECV; stop when the improvement falls below `tol` (relative)
    or `max_intervals` is reached."""
    return _greedy(X, Y, n_intervals, A, k, method, key, precision, batch_size, device,
                   forward=True, max_steps=max_intervals, tol=tol)


def ipls_backward(
    X, Y, n_intervals: int = 10, A: int = 5, k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1, *,
    key=0, max_removals: int | None = None,
    tol: float = 1e-4, precision: str | None = "highest",
    batch_size: int | None = None, device=None,
) -> IPLSSelection:
    """Backward iPLS: greedily remove the interval whose removal lowers
    (or least worsens, within `tol`) the k-fold RMSECV."""
    return _greedy(X, Y, n_intervals, A, k, method, key, precision, batch_size, device,
                   forward=False, max_steps=max_removals, tol=tol)


@dataclass(frozen=True)
class UVEResult:
    """UVE-PLS screening result.

    reliability : (K,) |mean/std| of each real variable's coefficient
                  across CV folds
    cutoff      : max reliability among the appended noise variables
    selected    : (K,) bool — reliability > cutoff
    """

    reliability: np.ndarray
    cutoff: float
    selected: np.ndarray


def uve_pls(
    X,
    Y,
    A: int,
    k: int | None = None,
    *,
    key=0,
    noise_scale: float = 1e-10,
    method: METHOD = METHOD.KERNEL_TYPE1,
    precision: str | None = "highest",
    batch_size: int | None = None,
    device=None,
) -> UVEResult:
    """Uninformative Variable Elimination: append K noise variables of
    scale `noise_scale` to X, take the regression coefficients of the CV
    folds' fits (k=None: leave-one-out), and keep the real variables whose
    |mean/std| beats the best noise variable's.  `key`: a JAX key's data
    or an int seed."""
    X, Y = _prep(X, Y, device)
    N, K = X.shape
    k_noise, k_fold = jax_prng.split(key)  # as jax.random.split(key)
    noise = noise_scale * jax_prng.normal(k_noise, (N, K), X.dtype, device=X.device)
    Xa = torch.cat([X, noise], dim=1)
    del noise
    folds = N if k is None else k
    assign = kfold_assignments(N, folds, None if k is None else k_fold).to(X.device)
    fids = torch.arange(folds, device=X.device)

    def chunk(ids):
        masks = assign[None, :] != ids[:, None]
        return coefficients(fit_masks(Xa, Y, masks, A, method, precision=precision))

    step = fold_batch_size(folds, Xa, batch_size, cap=32)
    B = torch.cat([chunk(fids[i : i + step]) for i in range(0, folds, step)])  # (folds, 2K, M)
    mean = B.mean(0)
    std = B.std(0, correction=1)
    c = (mean / torch.where(std == 0, torch.inf, std)).abs()
    # multi-response: a variable is informative if stable for ANY response
    c = c.max(1).values
    c_real = c[:K].cpu().numpy()
    cutoff = float(c[K:].max())
    return UVEResult(reliability=c_real, cutoff=cutoff, selected=c_real > cutoff)
