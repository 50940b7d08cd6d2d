"""Classical NIPALS PLS2 with X- and Y-deflation.

Counterpart of `pls_tpu/models/nipals.py` (not in the reference, whose
algorithms are the kernel ones, pls.cpp:387-437).  Per component, on the
deflated Xd/Yd:

    u ← first column of Yd
    repeat:  w = Xdᵀu/‖Xdᵀu‖ ;  t = Xd w ;  qn = Ydᵀt/‖Ydᵀt‖ ;  u = Yd qn
    until ‖w − w_prev‖ ≤ tol, or max_iter iterations
    t = Xd w ;  p = Xdᵀt/tᵀt ;  q = Ydᵀt/tᵀt
    Xd ← Xd − t pᵀ ;  Yd ← Yd − t qᵀ

and then R = W (PᵀW)⁻¹ maps the original X to the scores (T = X R), so
`models/predict.py` serves these fits unchanged.

The pair after the inner loop, t = Xd w and p = Xdᵀt / tᵀt, is the
deflation pass of kernel type 1 on Xd with r = w.  For one fit it goes
through `ops.deflate.deflate_pass`: the CUDA kernel K1 for float32 Xd on
the card (counted in `deflate.launches["deflate_f32"]`; K2 for bfloat16
Xd, whose state stays bfloat16 as in the JAX package), the plain form for
a CPU tensor or float64.  The inner iterations are two torch
matrix-vector products each, as the JAX package leaves them to XLA.

X and Y may carry a leading fold axis (F, N, K) / (F, N, M), as
`kernel_pls.fit_folds` gives them.  The JAX package runs the inner loop as
a `lax.while_loop` under `vmap`: it iterates while any fold is
unconverged, and a converged fold keeps its state.  The batched loop here
does the same with a per-fold `active` mask and `torch.where`, so each
fold gets exactly its unbatched iterates.  Whether to go on is one host
read per inner iteration (`counts["host_reads"]`); the iterations each
component took are in `last_iterations` (per fold for a batch).
"""

from __future__ import annotations

import torch

from pls_tpu_torch.types import METHOD, PLSFit

# host reads of the convergence test, over all fits since the last reset
counts = {"host_reads": 0}
# inner iterations of each component of the last fit: ints for one fit, a
# list of per-fold ints for a batch
last_iterations: list = []


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A v on the trailing axes, batched over leading ones."""
    return (A @ v[..., None])[..., 0]


def _tp(Xd: torch.Tensor, w: torch.Tensor):
    """(t, tt, Xdᵀt) for w: the kernel pass for one fit, products for a batch."""
    if Xd.ndim == 2:
        from pls_tpu_torch.ops.deflate import deflate_pass_narrow

        return deflate_pass_narrow(Xd, w)
    t = _mv(Xd, w)
    return t, (t * t).sum(-1), _mv(Xd.mT, t)


def _deflate(D: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> None:
    """D ← D − t vᵀ in place, with no temporary of D's size."""
    if D.ndim == 2:
        D.addr_(t, v, alpha=-1)
    else:
        D.baddbmm_(t[..., :, None], v[..., None, :], alpha=-1)


def fit_nipals(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    *,
    tol: float = 1e-12,
    max_iter: int = 500,
    precision: str | None = "highest",
) -> PLSFit:
    """NIPALS fit of A components on X (..., N, K), Y (..., N, M).
    `precision` as `kernel_pls._prec_ctx` reads it ("compensated" is
    "highest"; "dd" is refused by `kernel_pls.fit`)."""
    from pls_tpu_torch.models.kernel_pls import _prec_ctx

    if Y.ndim == X.ndim - 1:
        Y = Y[..., None]
    batch = X.shape[:-2]
    K = X.shape[-1]
    Y = Y.to(X.dtype)
    last_iterations.clear()
    with _prec_ctx(precision):
        Xd = X.clone()
        Yd = Y.clone()
        Ws, Ps, Qs, Ts = [], [], [], []
        for _ in range(A):
            u = Yd[..., 0].clone()
            w = X.new_zeros((*batch, K))
            delta = torch.full(batch, float("inf"), dtype=X.dtype, device=X.device)
            it = torch.zeros(batch, dtype=torch.int64, device=X.device)
            while True:
                active = (it < max_iter) & (delta > tol)
                counts["host_reads"] += 1
                if not bool(active.any()):
                    break
                w_new = _unit(_mv(Xd.mT, u))
                t = _mv(Xd, w_new)
                qn = _unit(_mv(Yd.mT, t))
                u_new = _mv(Yd, qn)
                d_new = torch.sqrt(((w_new - w) ** 2).sum(-1))
                a = active[..., None]
                w = torch.where(a, w_new, w)
                u = torch.where(a, u_new, u)
                delta = torch.where(active, d_new, delta)
                it = it + active.to(it.dtype)
            last_iterations.append(it.tolist())
            t, tt, p = _tp(Xd, w)
            p = p / tt[..., None]
            q = _mv(Yd.mT, t) / tt[..., None]
            _deflate(Xd, t, p)
            _deflate(Yd, t, q)
            Ws.append(w)
            Ps.append(p)
            Qs.append(q)
            Ts.append(t)
        del Xd, Yd
        W = torch.stack(Ws, -1)  # (..., K, A)
        P = torch.stack(Ps, -1)
        # R maps the original X to the scores: T = X R with R = W (PᵀW)⁻¹,
        # PᵀW upper triangular with a unit diagonal
        PtW = P.mT @ W
        # in float32 for bf16 X, whose triangular solve torch lacks
        wide = torch.promote_types(W.dtype, torch.float32)
        R = torch.linalg.solve_triangular(PtW.mT.to(wide), W.mT.to(wide), upper=False)
        R = R.mT.to(W.dtype)
    return PLSFit(W=W, P=P, Q=torch.stack(Qs, -1), R=R, T=torch.stack(Ts, -1), method=METHOD.NIPALS)
