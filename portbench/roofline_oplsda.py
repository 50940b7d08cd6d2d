"""The least work of the OPLS-DA job (`jobs/oplsda.py`) on one NVIDIA H100,
from shapes, on `roofline.py`'s peaks.

One job trains a classifier of A predictive and n_o orthogonal components
on X (N, K) float32 with M classes and scores a held-out batch of Nh
spectra: `job_bytes` and `job_flops` give its (bytes, flops), whose
larger share of the peaks is its least time (`roofline.least_seconds`).
As in `roofline.py`, each count is taken from the shapes and the
algorithm, never from what an implementation happens to do: each input
byte is read once a use the algorithm needs, each output byte written
once.

- The z-scoring costs no read of its own (`roofline_plsda`: the moments
  come from the read that forms XᵀY, and a product with z-scored X is one
  with X and the moments folded into the vectors).
- The filter reads X twice an orthogonal component, in two row-streamed
  passes as `roofline.pass_bytes` counts a deflation pass: t = X w with
  p = Xᵀt, then t_o = X w_o with p_o = Xᵀt_o (each row of t is done
  before that row's share of p).  XᵀY needs no read after the first (the
  fit's, below): the filtered X's is XᵀY − p_o (t_oᵀY), a K×M update.
  The filter writes no X: the filtered X is X − T_o P_oᵀ, which every
  later product applies implicitly (X_f v = X v − T_o (P_oᵀ v), X_fᵀ u =
  Xᵀu − P_o (T_oᵀ u), inside the same passes), and ‖X‖² for the shares of
  the sum of squares is (N − 1) K from the z-scoring.
- The predictive fit is `roofline_plsda`'s: X read A + 1 times (XᵀY, the
  filter's first, then a pass a component), the held-out batch read once
  and its decision values written once.  The held-out batch's filter is
  its one read too: Xh W_o beside Xh B.
- The S-plot needs no read: its covariances are the first predictive
  pass's X_fᵀt, and its spreads follow from z-scored X's unit variances
  and the filter's t_o and p_o.
"""

from __future__ import annotations

from portbench import roofline_plsda
from portbench.roofline import F32


def filter_bytes(N: int, K: int, n_o: int) -> int:
    """The filter: X read twice a component (the passes for t and p, and
    for t_o and p_o), and a component's w, p, w_o, p_o (K) and t, t_o (N)
    written once (float32)."""
    return n_o * (2 * N * K * F32 + F32 * (4 * K + 2 * N))


def filter_flops(N: int, K: int, M: int, n_o: int) -> int:
    """The filter, a component: X w with Xᵀt and X w_o with Xᵀt_o (4·N·K
    each pass), tᵀt and t_oᵀt_o (4·N); XYᵀXY and XY q (2·K·M² + 2·K·M);
    the norms, wᵀp and the removal of p's share of w (9·K); XY's update,
    t_oᵀY and p_o times it (2·N·M + 2·K·M); and the earlier j components
    applied implicitly to each of the four products, 2·j·(N + K) each
    (none for the first).  The first XᵀY is the fit's
    (`roofline_plsda.job_flops`)."""
    return sum(8 * N * K + 4 * N + 2 * K * M * M + 2 * K * M + 9 * K
               + 2 * N * M + 2 * K * M + 4 * 2 * j * (N + K) for j in range(n_o))


def job_bytes(N: int, K: int, M: int, A: int, n_o: int, Nh: int) -> int:
    """The filter (`filter_bytes`), then `roofline_plsda.job_bytes`: the
    predictive fit, the held-out batch read once and its decision values
    written once."""
    return filter_bytes(N, K, n_o) + roofline_plsda.job_bytes(N, K, M, A, Nh)


def job_flops(N: int, K: int, M: int, A: int, n_o: int, Nh: int) -> int:
    """The filter (`filter_flops`), then `roofline_plsda.job_flops` (the
    moments, the fit, the held-out batch z-scored and times B), plus the
    filter applied implicitly: to the predictive fit's A passes (2·n_o·(N
    + K) each for X_f r and X_fᵀt; its XᵀY is the filter's last update);
    to the held-out batch, Xh W_o (2·Nh·K·n_o) and T_o,h P_oᵀB (2·Nh·n_o·M
    + 2·n_o·K·M)."""
    implicit = 4 * n_o * (N + K) * A
    held = 2 * Nh * K * n_o + 2 * Nh * n_o * M + 2 * n_o * K * M
    return (filter_flops(N, K, M, n_o) + roofline_plsda.job_flops(N, K, M, A, Nh)
            + implicit + held)

