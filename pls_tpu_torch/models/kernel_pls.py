"""Dayal–MacGregor "improved kernel" PLS (types 1 and 2).

Counterpart of `pls_tpu/models/kernel_pls.py:80-382` (reference
`Model::plsr`, pls.cpp:390-437).  Only the K×M cross-product XY = XᵀY is
deflated per component; X itself is never deflated.

The JAX `lax.scan` over components is a Python loop here, and the port
has one: `_components`, which owns the per-component sequence (the
dominant eigenvector, w and its norm, Gram-Schmidt, the projection, p/tt
and q, the rank-1 deflation of XY) and the `pls.fit` /
`pls.fit.component` spans.  It serves one fit and a batch of CV folds:
with a leading fold axis, XY, Pb and Rb carry it too and every product is
batched.  Its callers differ only in the two hooks they pass:
  - `project(r)` -> (p, tt, t): `_fit_kernel` type 1 on X (the pass
    below, its [p; tt] summed by `reduce` in a row-sharded fit); type 2
    on X and every statistics fit, through `_kernel2_loop`, a matvec
    with the Gram matrix (p = XX r, tt = rᵀ p, no t): `fit_from_stats*`
    (streaming fits, downdated LOO/LSO/k-fold) and
    `cv.kfold.cv_kfold_onepass`; `parallel.sharded.fit_colsharded`,
    X r summed over the ranks' column blocks, then Xᵀt;
  - `ksum`, the sum over K of the column-sharded fit (the identity
    elsewhere).
`fit` is the one-model entry point; `fit_folds` refits one model per row
mask, which is how the cross-validators batch their folds.

`method` NIPALS and SIMPLS route to models/nipals.py and models/simpls.py,
as `pls_tpu/models/kernel_pls.py:214-221` does.

The precision modes "compensated" and "dd" run the component loop in
float64 (`F64_PRECISIONS`), where the JAX package carries float32 pairs
(`pls_tpu/ops/twofloat.py`, which exists only because the TPU has no
float64): "compensated" on X as given, "dd" on X and Y rounded to float32
first, as `pls_tpu/models/kernel_dd.py` takes them; `_fit_kernel`'s entry
decides that widening for both.  The state comes back in the fit's own
dtype.  No kernel takes float64 X, so the passes of such a fit are torch
products.
"""

from __future__ import annotations

import contextlib

import torch

from pls_tpu_torch.ops.deflate import deflate_pass
from pls_tpu_torch.ops.eigen import dominant_eigenvector
from pls_tpu_torch.types import METHOD, PLSFit
from pls_tpu_torch.utils import debug
from pls_tpu_torch.utils.profiling import span

KERNEL_METHODS = (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2)
# the precision modes whose component loop runs in float64
F64_PRECISIONS = ("compensated", "dd")


# The JAX package hands `precision` to `jax.default_matmul_precision`
# (`pls_tpu/models/kernel_pls.py:225-234`), which takes these names.  For
# float32 products on a GPU they mean: HIGHEST full float32; HIGH and
# DEFAULT TF32 (10-bit mantissa inputs, float32 sums).  Value: whether
# TF32 is allowed.
_PRECISION_TF32 = {
    "highest": False, "float32": False,
    "high": True, "tensorfloat32": True,
    "default": True, "bfloat16": True,
}


@contextlib.contextmanager
def _prec_ctx(precision: str | None):
    """Set PyTorch's float32 product precision for the duration, then
    restore it.  The names are JAX's (`jax.default_matmul_precision`):
    "highest"/"float32" -> full float32 (TF32 off); "high"/"tensorfloat32"
    and "default"/"bfloat16" -> TF32, what XLA runs for HIGH and DEFAULT
    float32 products on a GPU.  None leaves the settings as they are.
    Float64 products and the CPU ignore the setting.  A name JAX refuses
    ("fastest", "HIGHEST") raises ValueError; so do JAX's dot-algorithm
    preset names, which the port does not map.  "compensated" and "dd"
    (`F64_PRECISIONS`) set what "highest" sets."""
    if precision is None:
        yield
        return
    if precision in F64_PRECISIONS:
        precision = "highest"  # their products are float64, or full float32
    if precision not in _PRECISION_TF32:
        raise ValueError(f"unknown precision {precision!r} (use one of "
                         f"{sorted(_PRECISION_TF32)} or None)")
    tf32 = _PRECISION_TF32[precision]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _check_method(method: METHOD, x_storage: str | None, precision: str | None) -> None:
    """The JAX package's refusals (`pls_tpu/models/kernel_pls.py:164-184`),
    with its messages."""
    if method not in (*KERNEL_METHODS, METHOD.NIPALS, METHOD.SIMPLS):
        raise ValueError(f"unknown method {method}")
    if x_storage is not None:
        if x_storage not in ("bf16", "bfloat16"):
            raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")
        if method not in KERNEL_METHODS:
            raise ValueError(
                "x_storage='bf16' requires a kernel method (type 1/2); "
                f"{method} does not implement the f32-accumulation policy"
            )
        if precision == "dd":
            raise ValueError(
                "precision='dd' carries full pair precision; x_storage='bf16' would defeat it"
            )
    if precision == "dd" and method not in KERNEL_METHODS:
        # JAX hands "dd" to jax.default_matmul_precision there, which refuses it
        raise ValueError(f"precision='dd' is for the kernel methods, not {method}")


def _cast(fit: PLSFit, dtype: torch.dtype) -> PLSFit:
    """The fit's state in `dtype` (the fit itself where it already is)."""
    if fit.W.dtype == dtype:
        return fit
    return PLSFit(
        W=fit.W.to(dtype), P=fit.P.to(dtype), Q=fit.Q.to(dtype), R=fit.R.to(dtype),
        T=fit.T.to(dtype), method=fit.method,
    )


def _state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a fit's state for X in `dtype`: float32 for bf16 X."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _fit_method(X, Y, A, method, power_iters, precision, reduce=None) -> PLSFit:
    """One fit, or a batch on a leading fold axis, of masked and weighted
    X/Y (X possibly bf16) by `method`; `reduce` as in `_fit_kernel`
    (parallel/sharded.py's row-sharded fits pass it, kernel methods only)."""
    if reduce is not None and method not in KERNEL_METHODS:
        raise ValueError(f"a row-sharded fit takes the kernel methods, not {method}")
    if method == METHOD.NIPALS:
        from pls_tpu_torch.models.nipals import fit_nipals

        return fit_nipals(X, Y, A, precision=precision)
    if method == METHOD.SIMPLS:
        from pls_tpu_torch.models.simpls import fit_simpls

        return fit_simpls(X, Y, A, power_iters=power_iters, precision=precision)
    return _fit_kernel(X, Y, A, method == METHOD.KERNEL_TYPE1, power_iters, precision, reduce)


def _checked(f: PLSFit) -> PLSFit:
    """f, checked finite inside `utils.debug.debug_nans()`."""
    if debug.state["check_fits"]:
        debug.assert_finite(f, "fit")
    return f


def fit(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int | None = None,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    row_mask: torch.Tensor | None = None,
    sample_weight: torch.Tensor | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> PLSFit:
    """Fit a PLS model of `A` components (default K).

    Args:
      X: (N, K) predictors, centred/z-scored by the caller.
      Y: (N, M) or (N,) responses.
      method: KERNEL_TYPE1 | KERNEL_TYPE2 | NIPALS | SIMPLS.
      row_mask: optional (N,) {0,1} mask; masked-out rows are excluded
        exactly (they become zero rows of X and Y).
      sample_weight: optional (N,) non-negative weights; rows are scaled by
        √w, so the fit sees XᵀWY / XᵀWX.
      power_iters: fixed power-method iterations instead of `eigh` for the
        M > 1 dominant eigenvector.
      precision: a JAX precision name (`_prec_ctx`): "highest" (float32
        products without TF32), "high"/"default" and their aliases (TF32),
        or None (PyTorch's current settings); or, for the kernel methods,
        "compensated" and "dd" (`F64_PRECISIONS`: a float64 component loop,
        "dd" on X and Y rounded to float32).  NIPALS and SIMPLS read
        "compensated" as "highest" and refuse "dd", as the JAX package does.
      x_storage: "bf16" stores X in bfloat16 after masking and weighting;
        every contraction accumulates in float32 and the model state is
        float32.  Y is rounded to bf16 in XᵀY, as in the JAX package.  Kernel
        methods only, and not with "dd".
    """
    _check_method(method, x_storage, precision)
    X = X.contiguous()  # rows must be contiguous for the kernel (a no-op if they are)
    if Y.ndim == 1:
        Y = Y[:, None]
    N, K = X.shape
    A = K if A is None else A
    if not (0 < A <= K):
        raise ValueError(f"A={A} must satisfy 0 < A <= K={K}")
    if Y.shape[0] != N:
        raise ValueError(f"X has {N} rows but Y has {Y.shape[0]}")
    if row_mask is not None:
        m = row_mask.to(X.dtype)[:, None]
        X = X * m
        Y = Y * m
    if sample_weight is not None:
        w = torch.sqrt(torch.as_tensor(sample_weight, dtype=X.dtype, device=X.device))[:, None]
        X = X * w
        Y = Y * w
    if x_storage is not None:
        X = X.to(torch.bfloat16)
    return _checked(_fit_method(X, Y, A, method, power_iters, precision))


def fit_folds(
    X: torch.Tensor,
    Y: torch.Tensor,
    row_masks: torch.Tensor,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> PLSFit:
    """One fit per row of `row_masks` (F, N), batched on a leading fold
    axis: the returned tensors are (F, K, A), (F, M, A), ...  Fold f equals
    `fit(X, Y, A, method, row_mask=row_masks[f], ...)` up to summation
    order.  X (F, N, K) and Y (F, N, M) may carry the fold axis already:
    each fold's own copy (tune.py's per-fold z-scoring) whose rows outside
    its mask the caller has zeroed, used as it is, without a masked copy.
    A row of `row_masks` may also hold row weights, which multiply X and Y
    as a mask does (the bootstrap's √counts).  With x_storage="bf16" the masked
    X is rounded to bf16 and the batched products run on its float32
    widening."""
    _check_method(method, x_storage, precision)
    if Y.ndim == 1:
        Y = Y[:, None]
    m = row_masks.to(X.dtype)[:, :, None]
    Xf = X if X.ndim == 3 else X[None] * m
    if x_storage is not None:
        Xf = Xf.to(torch.bfloat16)
    return _checked(_fit_method(Xf, Y if Y.ndim == 3 else Y[None] * m, A, method, power_iters,
                                precision))


def fit_masks(
    X: torch.Tensor,
    Y: torch.Tensor,
    row_masks: torch.Tensor,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """`fit_folds` over the masks (F, N), but one mask (F = 1) is an
    un-batched `fit` of X (N, K), whose passes launch K1 on the card for
    float32 X; its state gains the fold axis of one.  The callers that
    cut their folds into batches by `utils.batching.fold_batch_size`
    (conformal, inference, select) fit each batch through this."""
    if row_masks.shape[0] > 1:
        return fit_folds(X, Y, row_masks, A, method, power_iters=power_iters,
                         precision=precision)
    f = fit(X, Y, A, method, row_mask=row_masks[0], power_iters=power_iters,
            precision=precision)
    return PLSFit(W=f.W[None], P=f.P[None], Q=f.Q[None], R=f.R[None], T=f.T[None],
                  method=f.method)


def _components(XY: torch.Tensor, A: int, project, *, power_iters: int | None,
                precision: str | None, ksum=None) -> PLSFit:
    """The Dayal–MacGregor component loop (reference pls.cpp:400-435), the
    one every kernel-PLS fit of the port runs:
      M==1:  w = XY                     else: q₀ = dom.eigvec(XYᵀXY), w = XY q₀
      w /= ‖w‖ ;  r = w − Σ_{j<a}(pⱼᵀw) rⱼ ;  (p, tt, t) = project(r)
      p /= tt ;  q = XYᵀ r / tt ;  XY ← XY − (p qᵀ) tt
    XY is (K, M) or (F, K, M), in the loop's dtype.  `project(r)` gives
    p = Xᵀ(X r) (= XX r), tt = rᵀ XX r and t = X r, or None for t where the
    fit keeps no scores (type 2, the statistics fits): so a fit of type 1
    returns T and one of type 2 a (0, A) T.

    `ksum` is the sum over K of the column-sharded fit
    (parallel/sharded.py: each rank holds a block of K), applied to every
    product that contracts K: XYᵀXY, w·w, Pb w and XYᵀr.  None: all of K
    is here."""
    ksum = ksum or (lambda v: v)
    batch = XY.shape[:-2]
    K, M = XY.shape[-2:]
    with span("pls.fit"), _prec_ctx(precision):
        Pb = XY.new_zeros((*batch, A, K))
        Rb = torch.zeros_like(Pb)
        Ws, Qs, Ts = [], [], []
        for a in range(A):
            with span("pls.fit.component"):
                if M == 1:
                    w = XY[..., 0]
                else:
                    q0 = dominant_eigenvector(ksum(XY.mT @ XY), power_iters)
                    w = (XY @ q0[..., None])[..., 0]
                w = w / torch.sqrt(ksum(w[..., None, :] @ w[..., :, None]))[..., 0]
                # Gram-Schmidt against the previous components over the whole
                # zero-initialised buffers, as the JAX package does.  Slicing to
                # the first a rows changes the sums' order enough to move one
                # borderline 6th digit of nir's f64 state dump off the reference
                r = w - (Rb.mT @ ksum(Pb @ w[..., None]))[..., 0]
                p, tt, t = project(r)
                p = p / tt[..., None]
                q = ksum(XY.mT @ r[..., None])[..., 0] / tt[..., None]
                Pb[..., a, :] = p
                Rb[..., a, :] = r
                Ws.append(w)
                Qs.append(q)
                Ts.append(t)
                XY = XY - p[..., :, None] * q[..., None, :] * tt[..., None, None]
        type1 = Ts[0] is not None
        return PLSFit(
            W=torch.stack(Ws, -1),
            P=Pb.mT,
            Q=torch.stack(Qs, -1),
            R=Rb.mT,
            T=torch.stack(Ts, -1) if type1 else XY.new_zeros((*batch, 0, A)),
            method=METHOD.KERNEL_TYPE1 if type1 else METHOD.KERNEL_TYPE2,
        )


def _fit_kernel(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    type1: bool,
    power_iters: int | None,
    precision: str | None,
    reduce=None,
) -> PLSFit:
    """Kernel algorithms #1/#2 on X (N, K) or (F, N, K) and Y (N, M) or
    (F, N, M): XᵀY (and XᵀX for type 2), then `_components` with
      type1: t = X r, tt = tᵀt, p = Xᵀt      type2: p = XX r, tt = rᵀ p
    One type-1 fit takes its pass from `ops.deflate.deflate_pass`; a batch
    of folds from batched products on Xa, X's widening to the state dtype.
    The precision modes of `F64_PRECISIONS` run on X and Y widened to
    float64: "dd" on both rounded to float32 first, as the JAX package's
    `kernel_dd` takes them, "compensated" on X as given and Y rounded to
    X's dtype, as XᵀY rounds it.  The state comes back in X's state dtype.

    `reduce` is the over-rows hook of the row-sharded fits
    (parallel/sharded.py, the JAX package's psums in `sharded.py:159-189`):
    given, it sums XᵀY (and XᵀX for type 2) once, and for type 1 the fused
    [p; tt] of each component's local pass, one all-reduce of K+1 values;
    type 2's loop needs no other sum.  None: every row is here."""
    out = _state_dtype(X.dtype)
    if precision in F64_PRECISIONS:
        src = torch.float32 if precision == "dd" else X.dtype
        X, Y = _wide(precision, X.to(src), Y.to(src))
    acc = _state_dtype(X.dtype)
    K = X.shape[-1]
    with _prec_ctx(precision):
        Xa = X.to(acc)  # widened copy only for bf16 X
        XY = Xa.mT @ Y.to(X.dtype).to(acc)
        XX = None if type1 else Xa.mT @ Xa
    if reduce is not None:
        XY = reduce(XY)
        XX = None if type1 else reduce(XX)
    if X.ndim == 2 or not type1:
        Xa = None  # read no more: the widened copy of bf16 X goes before the loop
    if not type1:
        return _cast(_kernel2_loop(lambda r: (XX @ r[..., None])[..., 0], XY, A, power_iters,
                                   precision), out)

    def project(r):
        if X.ndim == 2:  # one fit streams X itself, bf16 too
            t, tt, p = deflate_pass(X, r)
        else:
            t = (Xa @ r[..., None])[..., 0]
            p = (Xa.mT @ t[..., None])[..., 0]
            tt = (t * t).sum(-1)
        if reduce is not None:
            stats = reduce(torch.cat([p, tt[..., None]], -1))
            p, tt = stats[..., :K], stats[..., K]
        return p, tt, t

    return _cast(_components(XY, A, project, power_iters=power_iters, precision=precision), out)


# ---------- fits from the statistics XᵀX / XᵀY ----------
def _kernel2_loop(matvec, XY: torch.Tensor, A: int, power_iters, precision) -> PLSFit:
    """Kernel algorithm #2 with the Gram matrix given only through
    `matvec(r) = XX·r`, no scores kept: counterpart of `_kernel2_scan`
    (`pls_tpu/models/kernel_pls.py:385-437`).  XY is (K, M) or (F, K, M);
    with a leading fold axis r is (F, K) and one matvec serves the F folds
    (one (F, K)×(K, K) product against a shared XX).  Type 2 on X and
    every statistics fit enter `_components` here."""

    def project(r):
        v = matvec(r)
        return v, (r * v).sum(-1), None

    return _components(XY, A, project, power_iters=power_iters, precision=precision)


def _gram_matvec(XX: torch.Tensor):
    """r (..., K) → XX·r (..., K): for a batch of r, one product with XX."""
    return lambda r: r @ XX.mT


def _wide(precision: str | None, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors in the component loop's dtype: float64 under the
    precision modes of `F64_PRECISIONS`, else as they are."""
    if precision in F64_PRECISIONS:
        return [t.to(torch.float64) for t in tensors]
    return list(tensors)


def fit_from_stats(
    XX: torch.Tensor,
    XY: torch.Tensor,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """Kernel algorithm #2 fit from XX = XᵀX (K, K) and XY = XᵀY (K, M),
    never touching X: counterpart of `pls_tpu/models/kernel_pls.py:445-472`.
    XX and XY may carry a leading fold axis (F, K, K) / (F, K, M).
    precision="dd" is `kernel_dd.fit_from_stats_dd` (pass the statistics'
    lo parts there); "compensated" runs the loop in float64."""
    if precision == "dd":
        from pls_tpu_torch.models.kernel_dd import fit_from_stats_dd

        return fit_from_stats_dd(XX, XY, A, power_iters=power_iters)
    out = XX.dtype
    XX, XY = _wide(precision, XX, XY)
    if XX.ndim == 2:
        fit = _kernel2_loop(_gram_matvec(XX), XY, A, power_iters, precision)
    else:
        fit = _kernel2_loop(lambda r: (XX @ r[..., None])[..., 0], XY, A, power_iters, precision)
    return _cast(fit, out)


def fit_from_stats_downdated(
    XX: torch.Tensor,
    XY: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """`fit_from_stats(XX − xxᵀ, XY − xyᵀ, A)` with the rank-1 downdate
    inside the matvec, XX r − x (xᵀr): counterpart of
    `pls_tpu/models/kernel_pls.py:553-572`.  x (K,) / y (M,), or (F, K) /
    (F, M) for F LOO folds at once against the one shared XX.  Both modes
    of `F64_PRECISIONS` run the loop in float64."""
    if y.ndim == x.ndim - 1:
        y = y[..., None]
    out = XX.dtype
    XX, XY, x, y = _wide(precision, XX, XY, x, y)
    XYi = XY - x[..., :, None] * y[..., None, :]
    gram = _gram_matvec(XX)
    return _cast(_kernel2_loop(
        lambda r: gram(r) - x * (x * r).sum(-1, keepdim=True), XYi, A, power_iters, precision
    ), out)


def fit_from_stats_blockdowndated(
    XX: torch.Tensor,
    XY: torch.Tensor,
    Xf: torch.Tensor,
    Yf: torch.Tensor,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """`fit_from_stats(XX − XfᵀXf, XY − XfᵀYf, A)` with the block downdate
    inside the matvec, XX r − Xfᵀ(Xf r): counterpart of
    `pls_tpu/models/kernel_pls.py:489-550`.  Xf (Nf, K) / Yf (Nf, M), or
    (F, Nf, K) / (F, Nf, M) for F folds at once; zero rows of Xf are exact
    padding.  A bfloat16 Xf multiplies in float32 after r, Yf and Xf r are
    rounded to bfloat16, as the JAX package's bf16 operands with float32
    accumulation (a bf16 product is exact in float32).  Both modes of
    `F64_PRECISIONS` run the loop, and these products, in float64."""
    out = XX.dtype
    XX, XY, Yf = _wide(precision, XX, XY, Yf)
    acc = XX.dtype
    if Yf.ndim == Xf.ndim - 1:
        Yf = Yf[..., None]
    gram = _gram_matvec(XX)
    narrow = Xf.dtype == torch.bfloat16 and acc != torch.bfloat16

    def rnd(v):
        return v.to(torch.bfloat16).to(acc) if narrow else v

    Xa = Xf.to(acc)
    with _prec_ctx(precision):
        XYf = XY - Xa.mT @ rnd(Yf.to(acc))

    def matvec(r):
        tr = (Xa @ rnd(r)[..., None])[..., 0]
        return gram(r) - (Xa.mT @ rnd(tr)[..., None])[..., 0]

    return _cast(_kernel2_loop(matvec, XYf, A, power_iters, precision), out)
