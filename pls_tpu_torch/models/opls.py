"""OPLS: Orthogonal Projections to Latent Structures (Trygg & Wold 2002).

Counterpart of `pls_tpu/models/opls.py`.  Per orthogonal component, on
the current X:

    w   = predictive weight (Xᵀy; M > 1: XY times the dominant
          eigenvector of XYᵀXY), normalised
    t   = X w ;  p = Xᵀt / tᵀt
    w_o = p − (wᵀp) w, normalised ;  t_o = X w_o ;  p_o = Xᵀt_o / t_oᵀt_o
    X  ← X − t_o p_oᵀ

then an ordinary PLS fit (`kernel_pls.fit`: K1 on float32 X on the card
for kernel type 1) on the filtered X.  New data goes through the same
filter, component by component, before the predictive model.  The JAX
package's two `lax.scan`s (the filter, `correct`) are Python loops.

Spans (`utils.profiling`): `pls.opls.filter` around the filter of a fit,
`pls.opls.filter.component` around one orthogonal component (its
eigenvector's `pls.fit.eigh` and the rank-1 update of X included),
`pls.opls.correct` around the filter applied to given data.

`x_elements` counts, by operation ("filter": `_ortho_filter_fit`;
"correct": `correct`), the elements of the X-shaped (N, K) tensors that
each step reads or writes, from the shapes alone (no read of the device):
- a product with X or Xᵀ (XᵀY, X w, Xᵀt, X w_o, Xᵀt_o; `correct`'s
  X w_o): one read of X;
- `torch.outer(t_o, p_o)`: one write of an X-sized temporary;
- `Xc - outer`: two reads (Xc and the temporary) and one write (the new
  Xc);
- `ssx_total = (X * X).sum()`: three (X read, its square written, then
  read by the sum).
So a filter of n_ortho components counts (9 n_ortho + 3)·N·K, and
`correct` of n rows 5 n_ortho·n·K.  A change that fuses or removes a pass
keeps this tally true.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.models.kernel_pls import _prec_ctx, fit
from pls_tpu_torch.models.predict import _promote, fitted_values
from pls_tpu_torch.ops.eigen import dominant_eigenvector
from pls_tpu_torch.types import METHOD, PLSFit
from pls_tpu_torch.utils.profiling import span

x_elements = {"filter": 0, "correct": 0}


@dataclass(frozen=True)
class OPLSFit:
    """OPLS state: W_o, P_o (K, n_ortho) orthogonal weights/loadings; T_o
    (N, n_ortho) training orthogonal scores; r2x_o (n_ortho,) the share of
    X's total sum of squares each orthogonal component removed; `pls` the
    predictive fit on the filtered X."""

    W_o: torch.Tensor
    P_o: torch.Tensor
    T_o: torch.Tensor
    r2x_o: torch.Tensor
    pls: PLSFit

    @property
    def n_ortho(self) -> int:
        return self.W_o.shape[-1]


def _predictive_weight(X, Y, power_iters, M):
    XY = X.T @ Y
    w = XY[:, 0] if M == 1 else XY @ dominant_eigenvector(XY.T @ XY, power_iters)
    return w / torch.sqrt(w @ w)


def _remove(Xc, t_o, p_o, op):
    """Xc − t_o p_oᵀ, tallied under `op` in `x_elements`: the outer
    product's write, then the subtraction's two reads and one write."""
    x_elements[op] += 4 * Xc.numel()
    return Xc - torch.outer(t_o, p_o)


def _ortho_filter_fit(X, Y, n_ortho, power_iters, precision):
    N, K = X.shape
    M = Y.shape[1]
    with span("pls.opls.filter"):
        x_elements["filter"] += 3 * X.numel()
        ssx_total = (X * X).sum()
        Ws, Ps, Ts, r2x = [], [], [], []
        with _prec_ctx(precision):
            Xc = X
            for _ in range(n_ortho):
                with span("pls.opls.filter.component"):
                    x_elements["filter"] += 5 * Xc.numel()  # the five products below
                    w = _predictive_weight(Xc, Y, power_iters, M)
                    t = Xc @ w
                    p = (Xc.T @ t) / (t @ t)
                    w_o = p - (w @ p) * w
                    w_o = w_o / torch.sqrt(w_o @ w_o)
                    t_o = Xc @ w_o
                    p_o = (Xc.T @ t_o) / (t_o @ t_o)
                    Xc = _remove(Xc, t_o, p_o, "filter")
                    Ws.append(w_o)
                    Ps.append(p_o)
                    Ts.append(t_o)
                    r2x.append((t_o @ t_o) * (p_o @ p_o) / ssx_total)

    def stack(vs, n):
        return torch.stack(vs, 1) if vs else X.new_zeros((n, 0))

    r2 = torch.stack(r2x) if r2x else X.new_zeros(0)
    return Xc, stack(Ws, K), stack(Ps, K), stack(Ts, N), r2


def fit_opls(
    X: torch.Tensor,
    Y: torch.Tensor,
    n_ortho: int,
    A: int = 1,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> OPLSFit:
    """`n_ortho` Y-orthogonal components stripped from centred X, then an
    A-component predictive PLS fit by `method` on the filtered X."""
    if Y.ndim == 1:
        Y = Y[:, None]
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but Y has {Y.shape[0]}")
    if n_ortho < 0:
        raise ValueError(f"n_ortho={n_ortho} must be >= 0")
    Xf, W_o, P_o, T_o, r2x = _ortho_filter_fit(X, Y.to(X.dtype), n_ortho, power_iters, precision)
    pfit = fit(Xf, Y, A, method, power_iters=power_iters, precision=precision)
    return OPLSFit(W_o=W_o, P_o=P_o, T_o=T_o, r2x_o=r2x, pls=pfit)


def correct(ofit: OPLSFit, X_new: torch.Tensor):
    """The orthogonal filter on new data, in component order: returns
    (X_filtered, T_o_new (n, n_ortho))."""
    with span("pls.opls.correct"):
        Xc, W_o, P_o = _promote(X_new, ofit.W_o, ofit.P_o)
        Ts = []
        for j in range(W_o.shape[1]):
            x_elements["correct"] += Xc.numel()  # the product X w_o
            t_o = Xc @ W_o[:, j]
            Xc = _remove(Xc, t_o, P_o[:, j], "correct")
            Ts.append(t_o)
        return Xc, torch.stack(Ts, 1) if Ts else Xc.new_zeros((Xc.shape[0], 0))


def predict(ofit: OPLSFit, X_new: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Predicted Y for new X: the orthogonal filter, then the predictive
    model."""
    Xf, _ = correct(ofit, X_new)
    return fitted_values(ofit.pls, Xf, comp)
