"""Dayal–MacGregor "improved kernel" PLS (types 1 and 2).

Counterpart of `pls_tpu/models/kernel_pls.py:80-382` (reference
`Model::plsr`, pls.cpp:390-437).  Only the K×M cross-product XY = XᵀY is
deflated per component; X itself is never deflated.

The JAX `lax.scan` over components is a Python loop here.  The same loop
serves one fit and a batch of CV folds: with a leading fold axis on X
(F, N, K), XY, Pb and Rb carry it too and every product is batched.
`fit` is the one-model entry point; `fit_folds` refits one model per row
mask, which is how the cross-validators batch their folds.

Where the per-component (t, tt, p) pass runs:
  - one type-1 fit: `ops.deflate.deflate_pass`, which launches the CUDA
    kernel for float32/bfloat16 X on CUDA and takes the plain two-product
    form for a CPU tensor or float64 X;
  - batched folds: batched products (`X @ r`), which the JAX package also
    leaves to XLA outside any kernel (traced fits never reach Pallas).
"""

from __future__ import annotations

import contextlib

import torch

from pls_tpu_torch.ops.deflate import deflate_pass
from pls_tpu_torch.ops.eigen import dominant_eigenvector
from pls_tpu_torch.types import METHOD, PLSFit

_NOT_PORTED_PRECISION = (
    "precision={!r} is not ported yet (ROADMAP queue 1 item 9: "
    "precision modes on native f64)"
)
_NOT_PORTED_METHOD = (
    "{} is not ported yet (ROADMAP queue 1 item 11: public API and extensions)"
)


@contextlib.contextmanager
def _prec_ctx(precision: str | None):
    """"highest": full float32 products (TF32 off) for the duration;
    None: leave PyTorch's settings as they are."""
    if precision is None:
        yield
        return
    if precision in ("compensated", "dd"):
        raise NotImplementedError(_NOT_PORTED_PRECISION.format(precision))
    if precision != "highest":
        raise ValueError(f"unknown precision {precision!r} (use 'highest' or None)")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _check_method(method: METHOD, x_storage: str | None) -> None:
    if method in (METHOD.NIPALS, METHOD.SIMPLS):
        raise NotImplementedError(_NOT_PORTED_METHOD.format(method))
    if method not in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
        raise ValueError(f"unknown method {method}")
    if x_storage is not None and x_storage not in ("bf16", "bfloat16"):
        raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")


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
      row_mask: optional (N,) {0,1} mask; masked-out rows are excluded
        exactly (they become zero rows of X and Y).
      sample_weight: optional (N,) non-negative weights; rows are scaled by
        √w, so the fit sees XᵀWY / XᵀWX.
      power_iters: fixed power-method iterations instead of `eigh` for the
        M > 1 dominant eigenvector.
      precision: "highest" (float32 products without TF32) or None
        (PyTorch's current settings).
      x_storage: "bf16" stores X in bfloat16 after masking and weighting;
        every contraction accumulates in float32 and the model state is
        float32.  Y is rounded to bf16 in XᵀY, as in the JAX package.
    """
    _check_method(method, x_storage)
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
    return _fit_kernel(
        X, Y, A, type1=(method == METHOD.KERNEL_TYPE1),
        power_iters=power_iters, precision=precision,
    )


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
    order.  With x_storage="bf16" the masked X is rounded to bf16 and the
    batched products run on its float32 widening."""
    _check_method(method, x_storage)
    if Y.ndim == 1:
        Y = Y[:, None]
    m = row_masks.to(X.dtype)[:, :, None]
    Xf = X[None] * m
    if x_storage is not None:
        Xf = Xf.to(torch.bfloat16)
    return _fit_kernel(
        Xf, Y[None] * m, A, type1=(method == METHOD.KERNEL_TYPE1),
        power_iters=power_iters, precision=precision,
    )


def _t_tt_p(X: torch.Tensor, Xa: torch.Tensor, r: torch.Tensor):
    """(t, tt, p) for one component.  X is the stored X, Xa its widening to
    the accumulation dtype (the same tensor unless X is bf16)."""
    if X.ndim == 2:
        return deflate_pass(X, r)
    t = (Xa @ r[..., None])[..., 0]
    p = (Xa.mT @ t[..., None])[..., 0]
    return t, (t * t).sum(-1), p


def _fit_kernel(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    type1: bool,
    power_iters: int | None,
    precision: str | None,
) -> PLSFit:
    """Kernel algorithms #1/#2 (reference pls.cpp:400-435), per component:
      M==1:  w = XY                     else: q₀ = dom.eigvec(XYᵀXY), w = XY q₀
      w /= ‖w‖ ;  r = w − Σ_{j<a}(pⱼᵀw) rⱼ
      type1: t = X r, tt = tᵀt, p = Xᵀt      type2: tt = rᵀ XX r, p = XX r
      p /= tt ;  q = XYᵀ r / tt ;  XY ← XY − (p qᵀ) tt
    X is (N, K) or (F, N, K); Y is (N, M) or (F, N, M)."""
    acc = torch.float32 if X.dtype == torch.bfloat16 else X.dtype
    batch = X.shape[:-2]
    K = X.shape[-1]
    M = Y.shape[-1]
    with _prec_ctx(precision):
        Xa = X.to(acc)  # widened copy only for bf16 X
        XY = Xa.mT @ Y.to(X.dtype).to(acc)
        XX = None if type1 else Xa.mT @ Xa
        if X.ndim == 2 and X.dtype != acc:
            Xa = None  # one fit of bf16 X streams X itself from here on
        Pb = X.new_zeros((*batch, A, K), dtype=acc)
        Rb = torch.zeros_like(Pb)
        Ws, Qs, Ts = [], [], []
        for a in range(A):
            if M == 1:
                w = XY[..., 0]
            else:
                q0 = dominant_eigenvector(XY.mT @ XY, power_iters)
                w = (XY @ q0[..., None])[..., 0]
            w = w / torch.sqrt(w[..., None, :] @ w[..., :, None])[..., 0]
            # Gram-Schmidt against the previous components over the whole
            # zero-initialised buffers, as the JAX package does.  Slicing to
            # the first a rows changes the sums' order enough to move one
            # borderline 6th digit of nir's f64 state dump off the reference
            r = w - (Rb.mT @ (Pb @ w[..., None]))[..., 0]
            if type1:
                t, tt, p = _t_tt_p(X, Xa, r)
                Ts.append(t)
            else:
                p = (XX @ r[..., None])[..., 0]
                tt = (r * p).sum(-1)
            p = p / tt[..., None]
            q = (XY.mT @ r[..., None])[..., 0] / tt[..., None]
            Pb[..., a, :] = p
            Rb[..., a, :] = r
            Ws.append(w)
            Qs.append(q)
            XY = XY - p[..., :, None] * q[..., None, :] * tt[..., None, None]
    T = torch.stack(Ts, -1) if type1 else X.new_zeros((*batch, 0, A), dtype=acc)
    return PLSFit(
        W=torch.stack(Ws, -1),
        P=Pb.mT,
        Q=torch.stack(Qs, -1),
        R=Rb.mT,
        T=T,
        method=METHOD.KERNEL_TYPE1 if type1 else METHOD.KERNEL_TYPE2,
    )
