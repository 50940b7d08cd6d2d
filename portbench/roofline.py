"""The least time of the benchmark's jobs on one NVIDIA H100, from shapes.

Every count here is taken from the shapes of a job and the algorithm it
states, never from what an implementation happens to do.  Each input byte
is read once and each output byte written once; a job's least time is the
larger of its bytes over the peak bandwidth and its flops over the peak
rate (`least_seconds`).  A share of that bound above 100 % means the count
is wrong, or the time leaves out part of the work.

Peaks: NVIDIA's data sheet for the H100 SXM5 80GB HBM3 at its 700 W power
limit: 3.35 TB/s of device memory and 67 TFLOP/s of float32 outside the
tensor cores (the jobs run float32 products with TF32 off).  A card set
below 700 W reaches less; the benchmark records the card's power limit
beside every share.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4  # bytes of a float32 value


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time of work moving `nbytes` and computing `flops`."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def pass_bytes(N: int, K: int, itemsize: int) -> int:
    """One deflation pass (t = X r, tt = tᵀt, p = Xᵀt): X read once at its
    storage width, r read once, t, p and tt written once (float32)."""
    return N * K * itemsize + F32 * (K + N + K + 1)


def pass_flops(N: int, K: int) -> int:
    """One deflation pass: X r and Xᵀt, 2·N·K each, and tᵀt, 2·N."""
    return 4 * N * K + 2 * N


def _component_flops(K: int, M: int, a: int) -> int:
    """The small products of component a (0-based) of the kernel algorithms
    besides the pass over X: the dominant eigenvector's XYᵀXY (2·K·M², none
    for M = 1) and w = XY q (2·K·M), Gram-Schmidt against the a earlier
    components (4·a·K), q = XYᵀr (2·K·M) and the rank-1 deflation of XY
    (3·K·M)."""
    eig = 2 * K * M * M + 2 * K * M if M > 1 else 0
    return eig + 4 * a * K + 2 * K * M + 3 * K * M


def fit_bytes(N: int, K: int, M: int, A: int, itemsize: int) -> int:
    """A kernel-#1 fit of A components: X read A + 1 times at its storage
    width (XᵀY, then one pass a component), Y read once, and each
    component's r, t, p and tt read or written once (float32)."""
    return (A + 1) * N * K * itemsize + F32 * (N * M + A * (K + N + K + 1))


def fit_flops(N: int, K: int, M: int, A: int) -> int:
    """A kernel-#1 fit of A components: XᵀY (2·N·K·M), then per component
    its pass over X and the small products of `_component_flops`."""
    return 2 * N * K * M + sum(pass_flops(N, K) + _component_flops(K, M, a) for a in range(A))


def kfold_bytes(N: int, K: int, M: int, A: int, k: int, itemsize: int) -> int:
    """A k-fold CV from the statistics: X and Y read once, XᵀX (K·K) and
    XᵀY written once, and the errors (M·N·A) written once."""
    return N * K * itemsize + F32 * (N * M + K * K + K * M + M * N * A)


def kfold_flops(N: int, K: int, M: int, A: int, k: int) -> int:
    """A k-fold CV by block downdates (kernel algorithm #2): XᵀX counted as
    its unique half, N·K·(K+1); XᵀY, 2·N·K·M; then fold f (Nf rows, N split
    as evenly as the folds allow) downdates XY by XfᵀYf (2·Nf·K·M) and per
    component takes XX r (2·K²), Xf r and Xfᵀ(Xf r) (4·Nf·K), rᵀp (2·K)
    and the small products; its errors at every truncation are Xf R
    (2·Nf·K·A) and the prefix sums over components (2·Nf·A·M)."""
    total = N * K * (K + 1) + 2 * N * K * M
    for f in range(k):
        nf = N // k + (1 if f < N % k else 0)
        total += 2 * nf * K * M + 2 * nf * K * A + 2 * nf * A * M
        total += sum(2 * K * K + 4 * nf * K + 2 * K + _component_flops(K, M, a) for a in range(A))
    return total
