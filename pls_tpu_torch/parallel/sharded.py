"""Sharded PLS on torch.distributed: row- and column-sharded fits, and
fold-sharded cross-validation.

Counterpart of `pls_tpu/parallel/sharded.py`.  Each rank is one process on
one device (`PLSMesh.device`) and passes what it holds:
  - the row-sharded calls (`fit_sharded`, `fit_rowsharded_shardmap`,
    `cv_lso_rowsharded`, `train_step`) take this rank's block of the rows
    of X and Y, `shard_rows(X, mesh)`: the JAX package's
    NamedSharding(P('rows', None));
  - `fit_colsharded` takes this rank's block of the columns of X,
    `shard_cols(X, mesh)`, and all of Y;
  - the fold-sharded CV (`cv_lso_sharded`, `cv_loo_sharded`) takes all of
    X and Y, replicated as in the JAX package, and runs this rank's share
    of the trials or folds.
`partitions` is always the whole (trials, N) matrix of global row indices.
Every output is replicated: the same tensors on every rank.

Every fit here runs the one-device component loop
(`models.kernel_pls._components`, under its `pls.fit` spans).  The
row-sharded fits enter it through `_fit_kernel` with its over-rows hook
set to the 'rows' psum: XᵀY (and XᵀX for type 2) once, and for type 1
the fused [p; tt] of each component, one all-reduce of K+1 values after
the local pass.  That pass is `ops.deflate.deflate_pass` on this rank's
rows: K1 (K2 for x_storage="bf16") on the card, the plain twin on the
CPU, where the JAX package runs `_deflate_pass_pallas` on each shard
(`sharded.py:176-189`).  Where the JAX package gathers an output sharded
over an axis (T, the fold-sharded errors, the column-sharded state), each
rank writes its block into zeros and the blocks are summed.

Every rank issues the same collectives in the same order: each branch
(M == 1, type 1 or 2, the batches of trials) depends only on arguments
and replicated values, and batch sizes are equal over a group.

The fits take the kernel methods, the row-sharded ones with every
precision mode, the column-sharded one without the float64 modes
("compensated", "dd"); the JAX package's GSPMD fits also partition those
and NIPALS and SIMPLS, which here raise.
"""

from __future__ import annotations

import torch

from pls_tpu_torch.cv.loo import make_loo_fold_fn
from pls_tpu_torch.cv.lso import lso_errors
from pls_tpu_torch.models.kernel_pls import (
    F64_PRECISIONS,
    KERNEL_METHODS,
    _check_method,
    _components,
    _fit_kernel,
    _fit_method,
    _prec_ctx,
    _state_dtype,
)
from pls_tpu_torch.models.predict import residuals_all_components
from pls_tpu_torch.parallel.mesh import PLSMesh
from pls_tpu_torch.types import METHOD, PLSFit, Residual
from pls_tpu_torch.utils.batching import chunked_map


# ---------- blocks of an axis ----------
def _block(n: int, mesh: PLSMesh, axis: str) -> slice:
    """The items of n that this rank holds along `axis`: ceil-sized blocks
    in rank order, as NamedSharding lays them out (the last may be short
    or empty)."""
    b = -(-n // mesh.shape[axis])
    i = mesh.index(axis)
    return slice(min(i * b, n), min((i + 1) * b, n))


def shard_rows(X, mesh: PLSMesh, axis: str = "rows"):
    """This rank's block of the rows of X (`_block`)."""
    return X[_block(X.shape[0], mesh, axis)]


def shard_cols(X, mesh: PLSMesh, axis: str = "rows"):
    """This rank's block of the columns of X (`_block`)."""
    return X[:, _block(X.shape[1], mesh, axis)]


def _extent(n_local: int, mesh: PLSMesh, axis: str) -> tuple[int, int]:
    """(start, total): where this rank's n_local items begin along `axis`,
    and the total over its group; one all-reduce of the group's counts."""
    counts = torch.zeros(mesh.shape[axis], dtype=torch.int64, device=mesh.device)
    counts[mesh.index(axis)] = n_local
    counts = mesh.psum(counts, axis).tolist()
    return sum(counts[: mesh.index(axis)]), sum(counts)


def _gather(local: torch.Tensor, start: int, total: int, mesh: PLSMesh, axis: str,
            dim: int = 0) -> torch.Tensor:
    """The tensor of `total` along `dim` whose block [start, start + len)
    is each rank's `local`: a sum of zero-padded blocks over `axis`."""
    shape = list(local.shape)
    shape[dim] = total
    full = local.new_zeros(shape)
    full.narrow(dim, start, local.shape[dim]).copy_(local)
    return mesh.psum(full, axis)


def _on(X, mesh: PLSMesh) -> torch.Tensor:
    """X on this rank's device (a tensor keeps its dtype, an array numpy's)."""
    return torch.as_tensor(X, device=mesh.device)


def _indices(partitions, mesh: PLSMesh) -> torch.Tensor:
    return torch.as_tensor(partitions, device=mesh.device).long()


def _2d(Y: torch.Tensor) -> torch.Tensor:
    return Y[:, None] if Y.ndim == 1 else Y


def _rows_sum(mesh: PLSMesh, axis: str):
    return lambda t: mesh.psum(t, axis)


def _fit_rows(X, Y, A, method, reduce, *, masks=None, power_iters=None, precision="highest",
              x_storage=None) -> PLSFit:
    """`kernel_pls.fit` (masks None) or `fit_folds` (masks (F, n), a batch
    of folds) on this rank's rows of X and Y (n, M), with the component
    loop's over-rows hook `reduce`: the same checks, masking and bf16
    rounding, then the same loop."""
    _check_method(method, x_storage, precision)
    if not 0 < A <= X.shape[1]:
        raise ValueError(f"A={A} must satisfy 0 < A <= K={X.shape[1]}")
    if masks is not None:
        m = masks.to(X.dtype)[:, :, None]
        X, Y = X[None] * m, Y[None] * m
    if x_storage is not None:
        X = X.to(torch.bfloat16)
    return _fit_method(X.contiguous(), Y, A, method, power_iters, precision, reduce)


def _no_scores(f: PLSFit, A: int) -> PLSFit:
    """f with T dropped, (0, A), as the JAX package's replicated fits."""
    return PLSFit(W=f.W, P=f.P, Q=f.Q, R=f.R, T=f.W.new_zeros((0, A)), method=f.method)


def _trial_share(partitions: torch.Tensor, mesh: PLSMesh, what: str) -> tuple[int, torch.Tensor]:
    """(first trial, this rank's trials): the trials split evenly over
    'folds'; the JAX package's error when they do not divide."""
    num_trials, F = partitions.shape[0], mesh.shape["folds"]
    if num_trials % F:
        raise ValueError(
            f"{what}: num_trials={num_trials} must divide evenly "
            f"over the 'folds' mesh axis (size {F})"
        )
    n = num_trials // F
    start = mesh.index("folds") * n
    return start, partitions[start : start + n]


def _owned_rows(Z: torch.Tensor, idx: torch.Tensor, start: int) -> torch.Tensor:
    """Z's rows at the global indices idx (any shape) that this rank holds
    (Z is its block, from row `start`), and zero rows for the others."""
    local = idx - start
    mine = (local >= 0) & (local < Z.shape[0])
    out = Z.new_zeros((*idx.shape, Z.shape[-1]))
    out[mine] = Z[local[mine]]
    return out


def _rowsharded_trials(X, Y, A, method, train_size, start, mesh, axis, precision, x_storage):
    """The errors (F, test, A, M) of a batch of trials (F, N) whose masked
    fits are row-sharded: each rank fits on its rows, residuals the
    held-out rows it holds (zeros for the others: a zero row of X and of Y
    has a zero residual) with the replicated fit, and the blocks are summed
    over `axis`, so each error is one rank's."""
    n = X.shape[0]
    reduce = _rows_sum(mesh, axis)

    def trials(perms: torch.Tensor) -> torch.Tensor:
        masks = torch.zeros(perms.shape, dtype=X.dtype, device=X.device)
        masks.scatter_(1, perms[:, :train_size], 1.0)
        f = _fit_rows(X, Y, A, method, reduce, masks=masks[:, start : start + n],
                      precision=precision, x_storage=x_storage)
        test = perms[:, train_size:]
        res = residuals_all_components(f, _owned_rows(X, test, start), _owned_rows(Y, test, start))
        return mesh.psum(res, axis)

    return trials


# ---------- fits ----------
def fit_sharded(
    X,
    Y,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: PLSMesh,
    precision: str | None = "highest",
    power_iters: int | None = None,
    x_storage: str | None = None,
) -> PLSFit:
    """Row-sharded fit on this rank's rows of X and Y; outputs replicated,
    T dropped to (0, A) (`pls_tpu/parallel/sharded.py:42-72`).

    x_storage="bf16" streams each rank's rows in bf16 (K2 on the card);
    the summed partials and all model state stay f32."""
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    f = _fit_rows(X, Y, A, method, _rows_sum(mesh, "rows"), power_iters=power_iters,
                  precision=precision, x_storage=x_storage)
    return _no_scores(f, A)


def fit_rowsharded_shardmap(
    X,
    Y,
    A: int,
    type1: bool = True,
    *,
    mesh: PLSMesh,
    axis: str = "rows",
    power_iters: int | None = None,
    use_kernel: bool = False,
) -> PLSFit:
    """The explicit collective schedule of the kernel algorithms
    (`pls_tpu/parallel/sharded.py:113-211`), over `axis`: one all-reduce
    for XY = XᵀY (and XX = XᵀX for type 2), then for type 1 one fused
    all-reduce of [Xᵀt; tᵀt] per component; type 2's component loop has
    no communication.  T is gathered to the full (N, A) for type 1.

    use_kernel=True (type 1): each rank's pass over its rows is
    `deflate_pass`, K1 on the card (the twin on the CPU); False: the JAX
    code's plain branch, t = X r, then Xᵀt and tᵀt, as two products (the
    loop's batched form, here a batch of one).  Products run in PyTorch's
    current precision settings (the JAX code sets none)."""
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    reduce = _rows_sum(mesh, axis)
    if use_kernel or not type1:
        f = _fit_kernel(X.contiguous(), Y, A, type1, power_iters, None, reduce)
    else:
        b = _fit_kernel(X[None], Y[None], A, type1, power_iters, None, reduce)
        f = PLSFit(W=b.W[0], P=b.P[0], Q=b.Q[0], R=b.R[0], T=b.T[0], method=b.method)
    if not type1:
        return f
    start, N = _extent(X.shape[0], mesh, axis)
    return PLSFit(W=f.W, P=f.P, Q=f.Q, R=f.R, T=_gather(f.T, start, N, mesh, axis),
                  method=f.method)


def fit_colsharded(
    X,
    Y,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: PLSMesh,
    axis: str = "rows",
    precision: str | None = "highest",
    power_iters: int | None = None,
    x_storage: str | None = None,
) -> PLSFit:
    """COLUMN-sharded fit (`pls_tpu/parallel/sharded.py:75-110`): X is this
    rank's block of columns (`shard_cols` over `axis`), Y all of Y.

    It runs the one-device component loop (`models.kernel_pls._components`,
    with its spans), in which every K-sized object (XY, w, r, p, the
    Gram-Schmidt buffers) stays in blocks.  The sums over K are
    all-reduces over `axis`: the loop's over-K hook `ksum` sums w·w,
    XYᵀXY (M×M), P w (A) and XYᵀr (M) per component, and the projection
    sums t = X r (an N-vector); p = Xᵀt and the deflation of XY stay
    local.  The fused pass cannot serve here, as t needs its cross-rank
    sum before p: two torch products with the all-reduce between them, as
    XLA's partitioner runs the JAX package's fit.  Type 2's XX r is
    Xᵀ(X r) here, so both types take this projection, type 2 keeping no
    T.  W, P and R are gathered to replicated (K, A); type 1's T (N, A) is
    replicated as computed."""
    if method not in KERNEL_METHODS:
        raise ValueError(f"a column-sharded fit takes the kernel methods, not {method}")
    _check_method(method, x_storage, precision)
    if precision in F64_PRECISIONS:
        raise ValueError(f"precision={precision!r} is not column-sharded")
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    k0, K = _extent(X.shape[1], mesh, axis)
    if not 0 < A <= K:
        raise ValueError(f"A={A} must satisfy 0 < A <= K={K}")
    if x_storage is not None:
        X = X.to(torch.bfloat16)
    acc = _state_dtype(X.dtype)
    Xa, Ya = X.to(acc), Y.to(X.dtype).to(acc)
    type1 = method == METHOD.KERNEL_TYPE1

    def psum(t):
        return mesh.psum(t, axis)

    def project(r):
        t = psum(Xa @ r)
        return Xa.mT @ t, t @ t, t if type1 else None

    with _prec_ctx(precision):
        XY = Xa.mT @ Ya  # (K_local, M): every row is here, no sum
    f = _components(XY, A, project, power_iters=power_iters, precision=precision, ksum=psum)
    W, P, R = (_gather(B, k0, K, mesh, axis) for B in (f.W, f.P, f.R))
    return PLSFit(W=W, P=P, Q=f.Q, R=R, T=f.T, method=method)


# ---------- cross-validation ----------
def cv_lso_sharded(
    X,
    Y,
    A: int,
    partitions,
    train_size: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: PLSMesh,
    precision: str | None = "highest",
) -> Residual:
    """Monte-Carlo CV with the trials split over 'folds'
    (`pls_tpu/parallel/sharded.py:214-264`): X and Y whole on every rank,
    each rank's trials a batched fit (`cv.lso.lso_errors`), the errors
    gathered in trial-major order, (M, trials·test, A).  The number of
    trials must divide over 'folds'."""
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    partitions = _indices(partitions, mesh)
    first, mine = _trial_share(partitions, mesh, "cv_lso_sharded")
    test = X.shape[0] - train_size
    errs = lso_errors(X, Y, A, mine, train_size, method, precision=precision)
    return Residual(errors=_gather(errs, first * test, partitions.shape[0] * test, mesh,
                                   "folds", dim=1), method="LSO")


def cv_lso_rowsharded(
    X,
    Y,
    A: int,
    partitions,
    train_size: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: PLSMesh,
    axis: str = "rows",
    trial_batch: int = 1,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV with X and Y ROW-SHARDED, never replicated
    (`pls_tpu/parallel/sharded.py:267-340`): the trials run in groups of
    `trial_batch`, each trial's masked fit row-sharded through the
    over-rows hook; each rank residuals the held-out rows it holds with
    the replicated fit, and the (test, A, M) blocks are summed over
    `axis`.  Same layout as `cv_lso`, (M, trials·test, A)."""
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    partitions = _indices(partitions, mesh)
    start, N = _extent(X.shape[0], mesh, axis)
    num_trials = partitions.shape[0]
    trials = _rowsharded_trials(X, Y, A, method, train_size, start, mesh, axis, precision,
                                x_storage)
    errs = chunked_map(trials, partitions, trial_batch)  # (trials, test, A, M)
    return Residual(errors=errs.permute(3, 0, 1, 2).reshape(
        Y.shape[1], num_trials * (N - train_size), A), method="LSO")


def cv_loo_sharded(
    X,
    Y,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: PLSMesh,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """LOO CV with the folds split over 'folds'
    (`pls_tpu/parallel/sharded.py:343-393`): X and Y whole on every rank,
    each rank's N/D folds through the shared fold body
    (`cv.loo.make_loo_fold_fn`) in batches of `batch_size` (default
    min(N/D, 64)), the errors gathered, (M, N, A).  N must divide over
    'folds'."""
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    N, D = X.shape[0], mesh.shape["folds"]
    if N % D:
        raise ValueError(
            f"cv_loo_sharded: N={N} must divide evenly over the 'folds' "
            f"mesh axis (size {D}); pad the data or use cv_loo"
        )
    n = N // D
    first = mesh.index("folds") * n
    folds = make_loo_fold_fn(X, Y, A, method, power_iters=power_iters, precision=precision)
    idx = torch.arange(first, first + n, device=X.device)
    errs = chunked_map(folds, idx, batch_size or min(n, 64))  # (N/D, A, M)
    return Residual(errors=_gather(errs, first, N, mesh, "folds").permute(2, 0, 1),
                    method="LOO")


def train_step(
    X,
    Y,
    A: int,
    partitions,
    train_size: int,
    *,
    mesh: PLSMesh,
    method: METHOD = METHOD.KERNEL_TYPE1,
    precision: str | None = "highest",
):
    """The full multi-rank step over both axes
    (`pls_tpu/parallel/sharded.py:396-448`), on this rank's rows of X and
    Y (over 'rows'): a row-sharded global fit (K1 on the card), then the
    CV trials split over 'folds', each a row-sharded masked fit (a rank's
    trials are one batch, as the JAX package vmaps them), and PRESS (M, A)
    summed over 'folds'.  Returns (the fit with T of (0, A), press)."""
    X, Y = _on(X, mesh), _2d(_on(Y, mesh))
    partitions = _indices(partitions, mesh)
    f = _no_scores(_fit_rows(X, Y, A, method, _rows_sum(mesh, "rows"), precision=precision), A)
    start, _ = _extent(X.shape[0], mesh, "rows")
    _, mine = _trial_share(partitions, mesh, "train_step")
    trials = _rowsharded_trials(X, Y, A, method, train_size, start, mesh, "rows", precision, None)
    errs = trials(mine)  # (trials, test, A, M)
    press = mesh.psum((errs * errs).sum((0, 1)).mT, "folds")  # (M, A)
    return f, press
