"""The least work of the PLS-DA job (`jobs/plsda.py`) on one NVIDIA H100,
from shapes, on `roofline.py`'s peaks.

One job trains a classifier of A components on X (N, K) float32 with M
classes and identifies a held-out batch of Nh spectra: `job_bytes` and
`job_flops` give its (bytes, flops), whose larger share of the peaks is
its least time (`roofline.least_seconds`).  As in `roofline.py`, each
count is taken from the shapes and the algorithm, never from what an
implementation happens to do: each input byte is read once a use the
algorithm needs, each output byte written once.

The z-scoring of X costs no read of its own and no copy of X.  The
column sums and sums of squares come from the read that forms XᵀY, since
with centred indicators (1ᵀYc = 0) the z-scored cross-product is
Xzᵀ Yc = D⁻¹ Xᵀ Yc.  A pass over z-scored X is a pass over X with the
moments folded into the vectors (Xz r = X D⁻¹ r − 1 μᵀD⁻¹ r).  So the
fit is `roofline.fit_bytes`'s: X read A + 1 times.
"""

from __future__ import annotations

from portbench import roofline
from portbench.roofline import F32


def job_bytes(N: int, K: int, M: int, A: int, Nh: int) -> int:
    """A kernel-#1 fit (`roofline.fit_bytes`: X read A + 1 times, the
    moments taken in XᵀY's read), then the held-out batch (Nh·K) read
    once and its decision values (Nh·M) written once, all float32."""
    return roofline.fit_bytes(N, K, M, A, F32) + F32 * (Nh * K + Nh * M)


def job_flops(N: int, K: int, M: int, A: int, Nh: int) -> int:
    """The column moments, 3·N·K (a sum, and a square and a sum), then the
    fit (`roofline.fit_flops`), then the held-out batch z-scored
    (2·Nh·K), times B (2·Nh·K·M) and the priors added (Nh·M)."""
    return (3 * N * K + roofline.fit_flops(N, K, M, A)
            + 2 * Nh * K + 2 * Nh * K * M + Nh * M)
