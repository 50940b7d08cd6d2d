"""Calibration-set sampling: Kennard–Stone, SPXY and duplex splits.

Counterpart of `pls_tpu/sampling.py`:

- `kennard_stone` (Kennard & Stone 1969): the farthest pair, then the
  candidate whose minimum distance to the selected set is largest;
- `spxy` (Galvão et al. 2005): Kennard–Stone under d = dX/max(dX) +
  dY/max(dY);
- `duplex` (Snee 1977): max-min additions alternating between the
  calibration and validation sets.

One engine serves all three, over a tuple of centred coordinate blocks
whose joint distance is Σ_b ‖·‖_b.  Each sample's minimum distance to the
selected set is one N-vector, updated per pick with one matrix-vector
product per block, d²(·, new) = ‖z‖² + ‖z_new‖² − 2·Z z_new (the JAX
package's formula, so that ties break as its do: `torch.argmax` also
returns the first maximum).  The farthest-pair seed streams blocks of
`_BLOCK` rows of the Gram products, never the N×N matrix.  The JAX
package's `lax.scan` over the picks is a Python loop whose argmax stays
on the device: the picks are read back once, at the end.  Data that is
not a tensor goes to `device` (None: the card); indices come back as
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.config import as_data

__all__ = ["kennard_stone", "spxy", "duplex", "ks_train_test_split"]

_BLOCK = 256  # farthest-pair row-block size (memory: 2 × BLOCK × N floats)


def _prep_blocks(*blocks):
    """Centre each coordinate block (translation-invariant distances,
    cancellation-safe norms): (blocks, squared-norm vectors)."""
    Zs = []
    for Z in blocks:
        Z = Z if Z.ndim == 2 else Z.reshape(1, -1)
        Zs.append(Z - Z.mean(0))
    return Zs, [(Z * Z).sum(1) for Z in Zs]


def _dist_to(Zs, sqs, idx: torch.Tensor) -> torch.Tensor:
    """(N,) joint distance Σ_b ‖z_b − z_b[idx]‖ to the row `idx` (a 0-d
    device index)."""
    d = 0.0
    for Z, sq in zip(Zs, sqs):
        z = Z.index_select(0, idx.reshape(1))[0]
        d2 = sq + sq.index_select(0, idx.reshape(1)) - 2.0 * (Z @ z)
        d = d + torch.sqrt(torch.clamp(d2, min=0.0))
    return d


def _farthest_pair(Zs, sqs, exclude: torch.Tensor | None = None):
    """(i, j), 0-d device indices of the pair maximising the joint
    distance, over blocks of rows; rows with `exclude` True never appear
    in the winning pair."""
    N = Zs[0].shape[0]
    Z0 = Zs[0]
    bonus = (Z0.new_zeros(N) if exclude is None
             else torch.where(exclude, -torch.inf, 0.0).to(Z0.dtype))
    dmax, jmax = [], []
    for r0 in range(0, N, _BLOCK):
        rows = slice(r0, min(N, r0 + _BLOCK))
        D = 0.0
        for Z, sq in zip(Zs, sqs):
            D2 = sq[rows][:, None] + sq[None, :] - 2.0 * (Z[rows] @ Z.T)
            D = D + torch.sqrt(torch.clamp(D2, min=0.0))
        D = D + bonus[None, :] + bonus[rows][:, None]
        j = torch.argmax(D, 1)
        dmax.append(D.gather(1, j[:, None])[:, 0])
        jmax.append(j)
    dmax, jmax = torch.cat(dmax), torch.cat(jmax)
    i = torch.argmax(dmax)
    return i, jmax[i]


def _mark(flags: torch.Tensor, *idx: torch.Tensor) -> None:
    """flags[idx] = True for 0-d device indices, without a host read."""
    flags.index_fill_(0, torch.stack(idx), True)


def _maxmin_core(Zs, sqs, n_select: int, i0, j0) -> np.ndarray:
    """Max-min selection from the seed pair (i0, j0) under the joint
    metric: (n_select,) indices in pick order."""
    N = Zs[0].shape[0]
    sel = torch.zeros(N, dtype=torch.bool, device=Zs[0].device)
    _mark(sel, i0, j0)
    mind = torch.minimum(_dist_to(Zs, sqs, i0), _dist_to(Zs, sqs, j0))
    picks = [i0, j0]
    for _ in range(n_select - 2):
        nxt = torch.argmax(torch.where(sel, -torch.inf, mind))
        _mark(sel, nxt)
        mind = torch.minimum(mind, _dist_to(Zs, sqs, nxt))
        picks.append(nxt)
    return torch.stack(picks).cpu().numpy()


def _check_n(n_select: int, N: int) -> None:
    if not (2 <= n_select <= N):
        raise ValueError(f"need 2 <= n_select <= N, got {n_select} / {N}")


def kennard_stone(X, n_select: int, *, device=None) -> np.ndarray:
    """Kennard–Stone max-min selection: (n_select,) indices in pick order
    (the first two are the farthest pair)."""
    X = as_data(X, device)
    _check_n(n_select, X.shape[0])
    Zs, sqs = _prep_blocks(X)
    i0, j0 = _farthest_pair(Zs, sqs)
    return _maxmin_core(Zs, sqs, n_select, i0, j0)


def spxy(X, Y, n_select: int, *, device=None) -> np.ndarray:
    """SPXY selection: Kennard–Stone under the joint normalised Euclidean
    distance d = dX/max(dX) + dY/max(dY).  A block whose rows are all
    equal (max distance 0) is zeroed, which leaves KS on the other.
    Returns (n_select,) indices in pick order."""
    X = as_data(X, device)
    Y = as_data(Y, X.device).to(X.dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if Y.shape[0] != N:
        raise ValueError(f"X has {N} rows but Y has {Y.shape[0]}")
    _check_n(n_select, N)

    def _norm(Z):
        (Zc,), (sq,) = _prep_blocks(Z)
        i, j = _farthest_pair((Zc,), (sq,))
        dmax2 = ((Zc[i] - Zc[j]) ** 2).sum()
        scale = torch.where(dmax2 > 0, torch.rsqrt(torch.clamp(dmax2, min=1e-30)), 0.0)
        return Zc * scale

    Zs, sqs = _prep_blocks(_norm(X), _norm(Y))
    i0, j0 = _farthest_pair(Zs, sqs)
    return _maxmin_core(Zs, sqs, n_select, i0, j0)


def _duplex_schedule(n_cal: int, N: int) -> list[bool]:
    """Cal/val alternation while both still need points, then whichever
    set has room takes the leftovers (True: calibration)."""
    n_more_cal, n_more_val = n_cal - 2, N - n_cal - 2
    sched = []
    while n_more_cal or n_more_val:
        if n_more_cal and (len(sched) % 2 == 0 or not n_more_val):
            sched.append(True)
            n_more_cal -= 1
        else:
            sched.append(False)
            n_more_val -= 1
    return sched


def duplex(X, n_cal: int, *, device=None) -> tuple[np.ndarray, np.ndarray]:
    """Duplex split: the farthest pair seeds the calibration set, the
    farthest remaining pair the validation set, then max-min additions
    alternate (calibration first; once one set is full the other takes
    the leftovers).  Returns (cal_idx (n_cal,), val_idx (N − n_cal,))."""
    X = as_data(X, device)
    N = X.shape[0]
    if not (2 <= n_cal <= N - 2):
        raise ValueError(f"need 2 <= n_cal <= N-2, got {n_cal} / N={N}")
    Zs, sqs = _prep_blocks(X)
    i0, j0 = _farthest_pair(Zs, sqs)
    assigned = torch.zeros(N, dtype=torch.bool, device=X.device)
    _mark(assigned, i0, j0)
    i1, j1 = _farthest_pair(Zs, sqs, assigned.clone())
    _mark(assigned, i1, j1)
    mind = {True: torch.minimum(_dist_to(Zs, sqs, i0), _dist_to(Zs, sqs, j0)),
            False: torch.minimum(_dist_to(Zs, sqs, i1), _dist_to(Zs, sqs, j1))}
    sched = _duplex_schedule(n_cal, N)
    picks = []
    for to_cal in sched:
        nxt = torch.argmax(torch.where(assigned, -torch.inf, mind[to_cal]))
        _mark(assigned, nxt)
        mind[to_cal] = torch.minimum(mind[to_cal], _dist_to(Zs, sqs, nxt))
        picks.append(nxt)
    seeds = torch.stack([i0, j0, i1, j1]).cpu().numpy()
    picks = torch.stack(picks).cpu().numpy() if picks else np.zeros(0, np.int64)
    was_cal = np.asarray(sched, bool)
    cal = np.concatenate([seeds[:2], picks[was_cal]])
    val = np.concatenate([seeds[2:], picks[~was_cal]])
    return cal, val


def ks_train_test_split(
    X, Y=None, *, train_size: int, method: str = "kennard-stone", device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic coverage-based train/test split.  method:
    "kennard-stone" (X only), "spxy" (needs Y), or "duplex".  Returns
    (train_idx, test_idx); test is the complement in original order for
    KS/SPXY, the duplex validation set for "duplex"."""
    if method == "kennard-stone":
        train = kennard_stone(X, train_size, device=device)
    elif method == "spxy":
        if Y is None:
            raise ValueError("spxy needs Y")
        train = spxy(X, Y, train_size, device=device)
    elif method == "duplex":
        return duplex(X, train_size, device=device)
    else:
        raise ValueError(f"unknown method {method!r}")
    N = X.shape[0] if hasattr(X, "shape") else len(X)
    return train, np.setdiff1d(np.arange(N), train)
