"""Dominant eigenvector of the M×M cross-product XYᵀXY.

Counterpart of `pls_tpu/ops/eigen.py:26-63`.  XYᵀXY is symmetric positive
semi-definite, so its eigenpairs are real.  Every path takes a leading
batch axis, which is how the CV folds' refits run together.

`dominant_eigenvector` picks the path from its input alone:

- `power_iters` given: a fixed-iteration power method ("power");
- float32 or float64 C on CUDA with 1 ≤ M ≤ 32: the hand-written Jacobi
  kernel of `csrc/eigen.cu` ("kernel"), which reads nothing back to the
  host.  `torch.linalg.eigh` on CUDA reads cuSOLVER's `info` back, so each
  call drained the stream once a component;
- anything else, the CPU among it: `torch.linalg.eigh` ("eigh"; ascending
  eigenvalues, dominant last).  On CUDA it solves C widened to float64, as
  the kernel does, and rounds the vector to C's dtype: at M = 33 in the
  pan-cancer PLS-DA cell (10 267 × 20 531, A = 32) cuSOLVER's float32
  solve left the vector 1.7-2.7e-6 from float64's, which late components,
  whose XYᵀXY is deflated far below its first size, carried into B; in
  float64 the call is also the faster (0.23 against 0.32 ms on an H100).
  The CPU solves in C's own dtype.

`path_calls` counts the calls of each path; the kernel's, its launches
(in `jacobi_dominant_cuda`, once a launch returned without error).

The kernel runs cyclic Jacobi in float64 to convergence (the off-diagonal
sum of squares at most (2⁻⁵²)² of ‖C‖²_F), not an approximation.
`jacobi_dominant_plain` is its plain twin: the same ordering, stop rule and
rules below, operation for operation, so the two agree bit for bit; the
tests hold the kernel to it and it to LAPACK's `eigh`.

An eigenvector's sign is arbitrary, and `eigh` here may pick the other
sign than JAX's: every PLS quantity except the per-column signs of
W/P/Q/R/T is invariant to it.  The kernel fixes it: the entry of largest
magnitude is positive (the lowest index wins a tie), and the largest
eigenvalue's vector is taken (the lowest index wins a tie of eigenvalues).
A C with a non-finite entry gives a NaN vector, as the power method does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pls_tpu_torch.utils.profiling import span

KERNEL_DTYPES = (torch.float32, torch.float64)
_CODES = {torch.float32: 0, torch.float64: 1}
KERNEL_MAX_M = 32
MAX_SWEEPS = 20  # kMaxSweeps in csrc/eigen.cu
path_calls = {"kernel": 0, "eigh": 0, "power": 0}


def dominant_eigenvector(C: torch.Tensor, power_iters: int | None = None) -> torch.Tensor:
    """Dominant eigenvector of symmetric PSD C (..., M, M) -> (..., M).

    power_iters=None selects the exact eigenvector: the Jacobi kernel for
    float32/float64 C on CUDA with M ≤ 32, `eigh` otherwise (in float64 on
    CUDA); an integer selects that many power-method iterations from a
    deterministic start vector: the column of C with the largest diagonal,
    plus 1e-30 so a zero column cannot stall."""
    with span("pls.fit.eigh"):
        if power_iters is None:
            if C.is_cuda and C.dtype in KERNEL_DTYPES and 1 <= C.shape[-1] <= KERNEL_MAX_M:
                return jacobi_dominant_cuda(C.contiguous())
            path_calls["eigh"] += 1
            if C.is_cuda:
                return torch.linalg.eigh(C.double()).eigenvectors[..., -1].to(C.dtype)
            return torch.linalg.eigh(C).eigenvectors[..., -1]
        path_calls["power"] += 1
        j = torch.diagonal(C, dim1=-2, dim2=-1).argmax(-1)
        idx = j[..., None, None].expand(*C.shape[:-1], 1)
        v = torch.take_along_dim(C, idx, dim=-1)[..., 0] + 1e-30
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        for _ in range(power_iters):
            w = (C @ v[..., None])[..., 0]
            v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        return v


# ---------- the plain twin of csrc/eigen.cu ----------
def _pairs(r: int, m: int) -> tuple[list[int], list[int]]:
    """Round r's m/2 pairs (p < q) of the round-robin ordering."""
    ps, qs = [], []
    for k in range(m // 2):
        a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
        ps.append(min(a, b))
        qs.append(max(a, b))
    return ps, qs


def _sum_squares(A: torch.Tensor, M: int, off: bool) -> torch.Tensor:
    """Σ a_ij² of the (B, M, M) corner of A (off: i ≠ j only) in the
    kernel's order: lane l adds entries l, l + 32, … of the row-major
    matrix, then a butterfly over the 32 lanes."""
    x = A[:, :M, :M]
    sq = x * x
    if off:
        sq = sq.masked_fill(torch.eye(M, dtype=torch.bool), 0.0)
    sq = sq.reshape(len(A), M * M)
    sq = torch.nn.functional.pad(sq, (0, -(M * M) % 32)).reshape(len(A), -1, 32)
    s = torch.zeros(len(A), 32, dtype=A.dtype)
    for k in range(sq.shape[1]):
        s = s + sq[:, k]
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return s[:, 0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of the kernel's `__dsqrt_rn`:
    numpy's; `torch.sqrt` of float64 on the CPU is off by an ulp in about
    1 % of cases."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def _rotate(x: torch.Tensor, y: torch.Tensor, s: torch.Tensor, tau: torch.Tensor):
    """The kernel's `rotate`: x − s(y + τx), y + s(x − τy)."""
    return x - s * (y + tau * x), y + s * (x - tau * y)


def _round(A: torch.Tensor, V: torch.Tensor, r: int) -> None:
    """One round of the kernel on A (B, m, m) and V (B, M, m), in place."""
    m = A.shape[-1]
    ps, qs = _pairs(r, m)
    p, q = torch.tensor(ps), torch.tensor(qs)
    app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
    theta = (aqq - app) / (2.0 * apq)
    t = 1.0 / (theta.abs() + _sqrt(theta * theta + 1.0))
    t = torch.where(apq == 0.0, 0.0, torch.where(theta < 0.0, -t, t))
    u = _sqrt(t * t + 1.0)  # 1/c
    s = t / u
    tau = t / (u + 1.0)
    tapq = t * apq
    # rows by each pair's rotation, then columns, over the whole matrix;
    # the kernel computes the blocks above the diagonal (by pair) and
    # mirrors them, and writes each pair's own block from the angle
    R = A.clone()
    R[:, p, :], R[:, q, :] = _rotate(A[:, p, :], A[:, q, :], s[..., None], tau[..., None])
    Y = R.clone()
    Y[:, :, p], Y[:, :, q] = _rotate(R[:, :, p], R[:, :, q], s[:, None], tau[:, None])
    pair = torch.empty(m, dtype=torch.long)
    pair[p] = pair[q] = torch.arange(m // 2)
    A[:] = torch.where(pair[:, None] < pair[None, :], Y, Y.mT)
    A[:, p, p], A[:, q, q] = app - tapq, aqq + tapq
    A[:, p, q] = A[:, q, p] = 0.0
    V[:, :, p], V[:, :, q] = _rotate(V[:, :, p], V[:, :, q], s[:, None], tau[:, None])


def _jacobi(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`jacobi_dominant_plain` of C (..., M, M), and the sweeps each
    matrix took (...,)."""
    *batch, M, _ = C.shape
    m = M + M % 2
    A = torch.zeros(C[..., 0, 0].numel(), m, m, dtype=torch.float64)
    A[:, :M, :M] = C.reshape(-1, M, M).to(torch.float64)
    bad = ~torch.isfinite(A).all(-1).all(-1)
    A[bad] = 0.0
    amax = A.abs().amax((-2, -1))
    ex = torch.frexp(amax).exponent.clamp(-1023, 1022)
    scale = torch.where(amax > 0.0, torch.ldexp(torch.ones_like(amax), -ex), 1.0)
    A = torch.where(amax[:, None, None] > 0.0, A * scale[:, None, None], A)
    V = torch.eye(M, m, dtype=torch.float64).repeat(len(A), 1, 1)
    tol = _sum_squares(A, M, off=False) * 2.0**-104
    sweeps = torch.zeros(len(A), dtype=torch.long)
    for _ in range(MAX_SWEEPS):
        active = (_sum_squares(A, M, off=True) > tol).nonzero()[:, 0]
        if len(active) == 0:
            break
        Aa, Va = A[active], V[active]
        for r in range(m - 1):
            _round(Aa, Va, r)
        A[active], V[active] = Aa, Va
        sweeps[active] += 1
    j = torch.diagonal(A, dim1=-2, dim2=-1)[:, :M].argmax(-1)
    v = torch.take_along_dim(V, j[:, None, None], dim=-1)[..., 0]
    big = v.abs().argmax(-1)
    flip = torch.take_along_dim(v, big[:, None], dim=-1) < 0.0
    v = torch.where(flip, -v, v)
    v[bad] = torch.nan
    return v.to(C.dtype).reshape(*batch, M), sweeps.reshape(batch)


def jacobi_dominant_plain(C: torch.Tensor) -> torch.Tensor:
    """The Jacobi kernel's result for C (..., M, M), in plain PyTorch on the
    CPU: float64 throughout, returned in C's dtype."""
    return _jacobi(C.cpu())[0]


# ---------- the CUDA kernel ----------
@functools.cache
def _library() -> ctypes.CDLL:
    from pls_tpu_torch.utils.nvcc import load_library

    lib = load_library("eigen.cu")
    lib.pls_eigen_prepare.argtypes = []
    lib.pls_eigen_prepare.restype = ctypes.c_int
    lib.pls_eigen_dominant.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.pls_eigen_dominant.restype = ctypes.c_int
    lib.pls_eigen_error_string.argtypes = [ctypes.c_int]
    lib.pls_eigen_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_library().pls_eigen_error_string(err).decode()}")


@functools.lru_cache(maxsize=16)
def _prepare(device_index: int) -> None:
    """Raise the kernel's shared memory limit on the device, once."""
    with torch.cuda.device(device_index):
        _check(_library().pls_eigen_prepare(), "eigenvector kernel set-up")


def jacobi_dominant_cuda(C: torch.Tensor) -> torch.Tensor:
    """Launch the Jacobi kernel on the current stream for C (..., M, M),
    float32 or float64, contiguous, on CUDA, 1 ≤ M ≤ 32.  Raises on a
    tensor the kernel does not take, and if the launch fails."""
    if C.dtype not in KERNEL_DTYPES:
        raise ValueError(f"eigenvector kernel takes float32/float64 C, got {C.dtype}")
    if C.ndim < 2 or C.shape[-1] != C.shape[-2]:
        raise ValueError(f"C must be (..., M, M), got shape {tuple(C.shape)}")
    M = C.shape[-1]
    if not 1 <= M <= KERNEL_MAX_M:
        raise ValueError(f"eigenvector kernel takes 1 <= M <= {KERNEL_MAX_M}, got M = {M}")
    if not C.is_contiguous():
        raise ValueError("C must be contiguous")
    if not C.is_cuda:
        raise ValueError(f"C ({C.device}) must be on a CUDA device")
    out = torch.empty(C.shape[:-1], dtype=C.dtype, device=C.device)
    B = out.numel() // M
    if B == 0:
        return out
    _prepare(C.device.index)
    with torch.cuda.device(C.device):
        err = _library().pls_eigen_dominant(_CODES[C.dtype], C.data_ptr(), out.data_ptr(), B, M,
                                            torch.cuda.current_stream().cuda_stream)
    _check(err, "eigenvector kernel launch")
    path_calls["kernel"] += 1
    return out
