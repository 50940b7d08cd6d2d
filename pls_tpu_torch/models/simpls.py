"""SIMPLS (de Jong 1993, Chemometrics Intell. Lab. Syst. 18:251-263).

Counterpart of `pls_tpu/models/simpls.py` (not in the reference).  SIMPLS
deflates the K×M covariance S = XᵀY against an orthonormal basis V of the
X-loading space, so its weights apply to the original X:

    per component:  r = S (M == 1) or S q₀, q₀ = dom.eigvec(SᵀS)
                    t = X r ;  tnorm = ‖t‖ ;  t, r ← t/tnorm, r/tnorm
                    p = Xᵀt ;  q = Yᵀt
                    v = p − V(Vᵀp), normalised ;  S ← S − v (vᵀS)

The X pass, (t, tᵀt, Xᵀt) for r, is kernel type 1's deflation pass, so a
single fit takes it from `ops.deflate.deflate_pass` (the CUDA kernel K1
for float32 X on the card, counted in `deflate.launches["deflate_f32"]`;
K2 for bfloat16 X, whose state stays bfloat16 as in the JAX package)
and divides t, r and p by √(tᵀt) after it.  A batch of CV folds (a
leading fold axis, from `kernel_pls.fit_folds`) takes batched products.
The basis is JAX's zero-initialised (A, K) buffer, and the Gram-Schmidt
runs over all of it: slicing it to the first rows would change the sums'
order (the same finding as `kernel_pls._fit_kernel`'s Rb/Pb).
"""

from __future__ import annotations

import torch

from pls_tpu_torch.ops.eigen import dominant_eigenvector
from pls_tpu_torch.types import METHOD, PLSFit


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def fit_simpls(
    X: torch.Tensor,
    Y: torch.Tensor,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """SIMPLS fit of A components on X (..., N, K), Y (..., N, M); W = R."""
    from pls_tpu_torch.models.kernel_pls import _prec_ctx
    from pls_tpu_torch.ops.deflate import deflate_pass_narrow

    if Y.ndim == X.ndim - 1:
        Y = Y[..., None]
    batch = X.shape[:-2]
    K, M = X.shape[-1], Y.shape[-1]
    Y = Y.to(X.dtype)
    with _prec_ctx(precision):
        S = X.mT @ Y
        Vb = X.new_zeros((*batch, A, K))
        Rs, Ps, Qs, Ts = [], [], [], []
        for a in range(A):
            if M == 1:
                r = S[..., 0]
            else:
                r = _mv(S, dominant_eigenvector(S.mT @ S, power_iters))
            if X.ndim == 2:
                t, tt, p = deflate_pass_narrow(X, r.contiguous())
            else:
                t = _mv(X, r)
                tt, p = (t * t).sum(-1), _mv(X.mT, t)
            tnorm = torch.sqrt(tt)[..., None]
            t = t / tnorm
            r = r / tnorm
            p = p / tnorm
            q = _mv(Y.mT, t)
            v = p - _mv(Vb.mT, _mv(Vb, p))
            v = v / torch.sqrt((v * v).sum(-1, keepdim=True))
            S = S - v[..., :, None] * (v[..., None, :] @ S)
            Vb[..., a, :] = v
            Rs.append(r)
            Ps.append(p)
            Qs.append(q)
            Ts.append(t)
    R = torch.stack(Rs, -1)
    return PLSFit(W=R, P=torch.stack(Ps, -1), Q=torch.stack(Qs, -1), R=R, T=torch.stack(Ts, -1),
                  method=METHOD.SIMPLS)
