"""PLS path modelling (PLS-PM / PLS-SEM; Wold 1982, Lohmöller 1989, the R
`plspm` package).

Counterpart of `pls_tpu/models/plspm.py`.  Blocks of manifest variables
each measure one latent variable; a lower-triangular path matrix is the
inner model.  Alternating estimation:

  1. outer scores  y_b = X_b w_b, standardised to unit variance
  2. inner proxies z_b = Σ_c e_bc y_c over the blocks adjacent to b
     (centroid: sign of the correlation; factorial: the correlation;
     path: regression coefficients on the predecessors, correlations
     with the successors)
  3. outer weights mode A: w_b ∝ X_bᵀ z_b; mode B: w_b ∝ (X_bᵀX_b)⁻¹ X_bᵀ z_b

until the weights stop changing; then the paths are each endogenous
block's least squares on its predecessors.

The JAX package's fixed-point `lax.while_loop` is a Python loop here whose
test is one host read an iteration.  Mode B's solve uses only its block's
rows of XᵀX (the JAX package solves the K×K masked Gram with an identity
outside the block, the same system), and only for the mode-B blocks.
`bootstrap_plspm` refits all resamples as one batch: the JAX package's
vmapped while-loop runs until the slowest replicate converges and keeps
a converged replicate's value; here a per-replicate active mask and
`torch.where` do the same, so that each replicate equals its un-batched
fit.  The resamples are `jax.random.randint(key, (n_boot, N), 0, N)`
drawn by `utils/jax_prng.randint` (int64 for float64 data, as with x64;
int32 otherwise, or as `x64` says).  Data that is not a tensor goes to
`device` (None: the card).  No kernel: the passes are products with L
(the blocks) columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.utils import jax_prng

__all__ = [
    "PLSPMFit",
    "fit_plspm",
    "plspm_scores",
    "PLSPMBootstrap",
    "bootstrap_plspm",
]


@dataclass(frozen=True)
class PLSPMFit:
    """PLS-PM state.

    W        : (K, L) block-masked outer weights (unit-variance scores)
    scores   : (N, L) latent variable scores (unit variance)
    loadings : (K,)   correlation of each manifest variable with its
                      block's score
    paths    : (L, L) inner path coefficients (paths[i, j]: j → i)
    r2       : (L,)   R² of each endogenous latent variable
    communality : (K,) squared loadings
    gof      : goodness of fit, √(mean communality · mean R²)
    n_iter   : iterations to convergence
    converged: bool
    """

    W: torch.Tensor
    scores: torch.Tensor
    loadings: torch.Tensor
    paths: torch.Tensor
    r2: torch.Tensor
    communality: torch.Tensor
    gof: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor


def _block_mask(blocks: list[list[int]], K: int) -> np.ndarray:
    mask = np.zeros((K, len(blocks)))
    seen: set[int] = set()
    for b, cols in enumerate(blocks):
        for j in cols:
            if j in seen:
                raise ValueError(f"manifest variable {j} is in two blocks")
            if not (0 <= j < K):
                raise ValueError(f"column {j} out of range for K={K}")
            seen.add(j)
            mask[j, b] = 1.0
    return mask


def _pred_solve(R: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """(..., L, L): row i holds the least-squares coefficients of score i
    on its predecessors (path[i]), from the correlations R (..., L, L): the
    predecessor-masked R with an identity elsewhere, one system a row."""
    L = path.shape[0]
    eye = torch.eye(L, dtype=R.dtype, device=R.device)
    PP = path[:, :, None] * path[:, None, :]  # (L, L, L): row i's outer(pred, pred)
    Rm = R[..., None, :, :] * PP + eye * (1.0 - path)[:, None, :]
    rhs = R * path  # row i: R[i] · pred_i
    return torch.linalg.solve_ex(Rm, rhs[..., None])[0][..., 0] * path


def _fit_core(X, mask, modeB, path, blocks, scheme: str, max_iter: int, tol: float):
    """The fit on X (..., N, K); a leading batch axis refits each
    resample with its own iterations."""
    N = X.shape[-2]
    batch = X.shape[:-2]
    sN = 1.0 / N
    adj = path + path.T
    b_cols = [torch.as_tensor(blocks[b], device=X.device) for b in range(len(blocks))
              if modeB[b]]
    b_ids = [b for b in range(len(blocks)) if modeB[b]]
    XtX = X.mT @ X * sN if b_ids else None

    def scores_of(W):
        S = X @ W
        sd = torch.sqrt((S * S).sum(-2) * sN)
        return S / sd[..., None, :], W / sd[..., None, :]

    def inner_weights(R):
        if scheme == "centroid":
            return torch.sign(R) * adj
        if scheme == "factorial":
            return R * adj
        return _pred_solve(R, path) + R * path.T

    def step(W):
        S, Wn = scores_of(W)
        R = S.mT @ S * sN
        Z = S @ inner_weights(R).mT
        XZ = X.mT @ Z * sN  # (..., K, L)
        Wnew = XZ * mask
        for b, cols in zip(b_ids, b_cols):
            G = XtX[..., cols[:, None], cols[None, :]]
            wb = torch.linalg.solve_ex(G, XZ[..., cols, b][..., None])[0][..., 0]
            Wnew[..., cols, b] = wb
        _, Wnew = scores_of(Wnew)
        delta = (Wnew.abs() - Wn.abs()).abs().amax((-2, -1))
        return Wnew, delta

    _, W = scores_of(mask.expand(*batch, *mask.shape))
    delta = torch.full(batch, torch.inf, dtype=X.dtype, device=X.device)
    it = torch.zeros(batch, dtype=torch.int64, device=X.device)
    while True:
        active = (delta > tol) & (it < max_iter)
        if not bool(active.any()):  # the host read
            break
        W_new, d_new = step(W)
        W = torch.where(active[..., None, None], W_new, W)
        delta = torch.where(active, d_new, delta)
        it = it + active.to(it.dtype)

    S, W = scores_of(W)
    R = S.mT @ S * sN
    # each score positively correlated with the majority of its manifests
    load_all = X.mT @ S * sN
    sign = torch.sign((load_all * mask).sum(-2))
    sign = torch.where(sign == 0, 1.0, sign)[..., None, :]
    S, W, load_all = S * sign, W * sign, load_all * sign
    loadings = (load_all * mask).sum(-1)
    paths = _pred_solve(R, path)
    endo = path.sum(1) > 0
    r2 = torch.where(endo, (paths * R).sum(-1), 0.0)
    communality = loadings ** 2
    in_block = mask.sum(1) > 0
    mean_comm = torch.where(in_block, communality, 0.0).sum(-1) / in_block.sum()
    gof = torch.sqrt(mean_comm * (r2.sum(-1) / max(int(endo.sum()), 1)))
    return PLSPMFit(W=W, scores=S, loadings=loadings, paths=paths, r2=r2,
                    communality=communality, gof=gof, n_iter=it, converged=delta <= tol)


def _model(X, blocks, path, modes, scheme):
    """(mask, modeB flags, path) on X's device, checked."""
    K = X.shape[-1]
    L = len(blocks)
    mask = torch.as_tensor(_block_mask(blocks, K), dtype=X.dtype, device=X.device)
    path = np.asarray(path.cpu() if isinstance(path, torch.Tensor) else path, dtype=float)
    if path.shape != (L, L):
        raise ValueError(f"path must be ({L}, {L}), got {path.shape}")
    if np.any(np.triu(path) != 0):
        raise ValueError("path must be strictly lower-triangular (j -> i)")
    if scheme not in ("centroid", "factorial", "path"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if isinstance(modes, str):
        modes = [modes] * L
    if len(modes) != L or any(m not in ("A", "B") for m in modes):
        raise ValueError("modes must be 'A'/'B' (one per block)")
    return mask, [m == "B" for m in modes], torch.as_tensor(path, dtype=X.dtype,
                                                           device=X.device)


def fit_plspm(
    X,
    blocks: list[list[int]],
    path,
    *,
    modes: str | list[str] = "A",
    scheme: str = "centroid",
    max_iter: int = 300,
    tol: float = 1e-9,
    device=None,
) -> PLSPMFit:
    """Fit a PLS path model.  X: (N, K) manifest variables, standardised
    by the caller; blocks[b]: the column indices of latent b's indicators
    (each column in at most one block); path: (L, L) strictly
    lower-triangular 0/1, path[i, j] = 1 for j → i; modes 'A'
    (reflective) or 'B' (formative), one for all or one per block;
    scheme 'centroid' | 'factorial' | 'path'."""
    X = as_data(X, device)
    mask, modeB, pathm = _model(X, blocks, path, modes, scheme)
    return _fit_core(X, mask, modeB, pathm, blocks, scheme, int(max_iter), float(tol))


def plspm_scores(fit: PLSPMFit, X_new) -> torch.Tensor:
    """Latent scores of new standardised manifest data."""
    X_new = as_data(X_new, fit.W.device)
    return X_new @ fit.W.to(X_new.dtype)


@dataclass(frozen=True)
class PLSPMBootstrap:
    """Bootstrap inference for a PLS path model.

    paths_se / loadings_se : standard errors over the resamples
    paths_lo, paths_hi     : percentile bounds of the path matrix
    paths_t                : estimate / se (0 where no path)
    samples                : (B, L, L) the resamples' path matrices
    """

    paths_se: torch.Tensor
    paths_lo: torch.Tensor
    paths_hi: torch.Tensor
    paths_t: torch.Tensor
    loadings_se: torch.Tensor
    samples: torch.Tensor


def bootstrap_plspm(
    X,
    blocks: list[list[int]],
    path,
    n_boot: int = 200,
    *,
    key=0,
    alpha: float = 0.05,
    modes: str | list[str] = "A",
    scheme: str = "centroid",
    max_iter: int = 300,
    tol: float = 1e-9,
    device=None,
    x64: bool | None = None,
) -> PLSPMBootstrap:
    """Bootstrap standard errors and percentile intervals of the path
    coefficients (and the loadings' standard errors): each resample
    re-standardised and refitted, all in one batch.  `key`: a JAX key's
    data or an int seed.  `x64`: draw the resamples as jax does with x64
    enabled (int64) or not (int32); None: int64 for float64 X, as
    `cv.bootstrap.bootstrap_coefficients` takes it."""
    X = as_data(X, device)
    N = X.shape[0]
    mask, modeB, pathm = _model(X, blocks, path, modes, scheme)
    x64 = X.dtype == torch.float64 if x64 is None else x64
    idx = jax_prng.randint(key, (n_boot, N), 0, N, np.int64 if x64 else np.int32)
    point = _fit_core(X, mask, modeB, pathm, blocks, scheme, int(max_iter), float(tol))
    Xb = X[torch.as_tensor(idx, dtype=torch.int64, device=X.device)]  # (B, N, K)
    mu = Xb.mean(-2, keepdim=True)
    sd = Xb.std(-2, correction=0, keepdim=True)
    Xb = (Xb - mu) / torch.where(sd == 0, 1.0, sd)
    f = _fit_core(Xb, mask, modeB, pathm, blocks, scheme, int(max_iter), float(tol))
    del Xb
    paths_b, loads_b = f.paths, f.loadings
    se = paths_b.std(0, correction=1)
    q = torch.tensor([alpha / 2, 1 - alpha / 2], dtype=X.dtype, device=X.device)
    lo, hi = torch.quantile(paths_b, q, dim=0)
    t = torch.where(se > 0, point.paths / torch.where(se == 0, 1.0, se), 0.0)
    return PLSPMBootstrap(paths_se=se, paths_lo=lo, paths_hi=hi, paths_t=t,
                          loadings_se=loads_b.std(0, correction=1), samples=paths_b)
