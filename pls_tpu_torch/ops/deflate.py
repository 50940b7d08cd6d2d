"""Fused deflation pass of kernel-PLS type 1: (t = X r, tt = tᵀt, p = Xᵀt).

Replaces `pls_tpu/ops/deflate.py::_deflate_pass_pallas` (the TPU kernel,
lines 83-192: body `_kernel_f32` for float32 X, `_kernel_bf16` for
bfloat16 X).  Same contract: X (N, K) float32 or bfloat16, r (K,) float32
-> t (N,), tt (), p (K,), all float32; bf16 X is widened in registers so
that t stays float32 between the two contractions.

What bounds it on the H100: bytes.  One pass moves N·K·itemsize bytes of X
for about 4·N·K flops, far below the card's ridge point.  The two-product
form (`deflate_pass_plain`) reads X twice; the CUDA kernels read it once.
`choose_plan` picks one of four paths per shape (plain Python, so that the
CPU tests reach it); `staged_plan` is the row-staged design's choice
alone, which comparisons launch beside the cols path through `_launch`:

- "cols" (K2 on bf16 X with K % 8 == 0, X 16-byte aligned, K ≤ 10 240):
  the column-owning design of `csrc/deflate_common.cuh`; one block per
  SM, a producer warp keeps a ring of TMA bulk copies of row tiles in
  flight, 16 consumer warps own fixed column chunks (r and p in
  registers), one named barrier per tile;
- "staged" (K1; bf16 X too wide for "cols"): `csrc/deflate.cu`'s
  row-staged design, one block per SM streaming tiles of R rows into
  shared memory with 16-byte cp.async copies (double-buffered), tᵢ of each
  staged row, then xᵢtᵢ into a p accumulator in shared memory;
- "scalar": the same with plain loads, where K is not a multiple of the
  vector width or X or r is not 16-byte aligned;
- "wide": K too wide for one staged row and the accumulator in shared
  memory, a two-pass form (t by rows, then p by column strips).

The cross-block sum of p is two-stage on every path (each block owns a row
of a (G, K) partial buffer; a second kernel sums the rows in fixed order)
and not float atomics, so results are bit-identical from run to run.

`deflate_pass` is the one dispatcher.  A CPU tensor, or float64 X (the
kernel is float32/bfloat16, as on the TPU), takes the plain version;
float32 or bfloat16 X on CUDA launches the kernel or raises.  The TPU
kernel's row-tile policy (`_row_tile`, `pad_rows_to_tile`,
`pallas_supported`) has no counterpart: the CUDA kernels mask the ragged
last tile themselves and need no padding copy.

`launches` counts, per kernel, the calls that launched it;
`path_launches` counts them per path.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable
from dataclasses import dataclass

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_CODES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}  # (dtype code, vector width)
PATHS = ("cols", "staged", "scalar", "wide")
launches = {"deflate_f32": 0, "deflate_bf16": 0}
path_launches = dict.fromkeys(PATHS, 0)

# the column-owning design (csrc/deflate_common.cuh): rows of a tile each
# thread reduces, most 4-column chunks a thread owns, row groups S, ring
# slots; and the shipped configuration (csrc/deflate.cu): consumer warps,
# blocks per SM, ring slots asked for
COLS_ROWS, COLS_CHUNKS, COLS_GROUPS, COLS_MAX_STAGES = 2, 5, (1, 2, 4, 8), 8
COLS_WARPS, COLS_BLOCKS, COLS_STAGES = 16, 1, 4
STAGED_ROWS = (8, 4, 2, 1)  # rows per staged tile, largest that fits first
STAGED_THREADS = 256  # threads of a row-staged block: a wide-K strip's chunks


@dataclass(frozen=True)
class Limits:
    """One device's limits for one kernel configuration: `staged`, the
    dynamic shared memory the row-staged kernel may take; `cols`, the bytes
    the column-owning kernel's ring may take (0 where it does not apply);
    `sms`, the SM count."""

    staged: int
    cols: int
    sms: int


@dataclass(frozen=True)
class Plan:
    """One pass's launch: `path` (one of PATHS), `vec` (the row-staged
    kernels' vector width, 1 for scalar loads), `G` (blocks, the rows of
    the partial buffer), `R` (rows per tile; 0 on the wide path), and on
    the cols path `S` (row groups) and `stages` (ring slots)."""

    path: str
    vec: int
    G: int
    R: int
    S: int = 0
    stages: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cols_plan(N: int, K: int, warps: int, blocks: int, ring_budget: int, sms: int, stages: int,
              min_stages: int = 2) -> Plan | None:
    """The column-owning design's plan, or None where it cannot run (K not
    a multiple of 8, or too wide for the columns a thread holds).

    The 32·warps consumer threads form S row groups (S in 1, 2, 4, 8); a
    tile has R = 2·S rows, two per group.  S is the one whose groups
    spread the K/4 chunks most evenly over their threads (at most 5 each),
    the larger S on a tie (a larger tile); the ring takes `stages` slots of
    R rows, or as many as fit `ring_budget` bytes, and at least
    `min_stages`; `blocks` blocks per SM, or one per tile when there are
    fewer tiles."""
    if K < 8 or K % 8:
        return None
    chunks, threads = K // 4, 32 * warps
    best = None
    for S in COLS_GROUPS:
        group = threads // S
        if threads % S or group % 32:
            continue
        per_thread = _cdiv(chunks, group)
        R = COLS_ROWS * S
        fit = min(stages, COLS_MAX_STAGES, ring_budget // (R * K * 2))
        if per_thread > COLS_CHUNKS or fit < min_stages:
            continue
        spread = chunks / (per_thread * group)
        if best is None or spread >= best[0]:
            best = (spread, S, R, fit)
    if best is None:
        return None
    _, S, R, fit = best
    return Plan("cols", 8, min(blocks * sms, _cdiv(N, R)), R, S, fit)


def cols_max_k(warps: int) -> int:
    """The widest K the column-owning design takes at `warps` consumer
    warps: every thread of one row group holding at most COLS_CHUNKS
    4-column chunks."""
    return 32 * warps * COLS_CHUNKS * 4


def staged_smem(K: int, R: int, itemsize: int) -> int:
    """Dynamic shared memory of the row-staged kernel: the p accumulator,
    then two buffers of R rows."""
    return _cdiv(4 * K, 16) * 16 + 2 * R * K * itemsize


def choose_plan(dtype: torch.dtype, N: int, K: int, x_aligned: bool, r_aligned: bool,
                limits: Callable[[int], Limits]) -> Plan:
    """The pass's plan for X (N, K) of `dtype`: "cols" where the
    column-owning design takes the shape (bf16, K % 8 == 0, X 16-byte
    aligned, K not too wide), else `staged_plan`'s.  `limits(vec)` gives
    the device's limits for that vector width."""
    if dtype == torch.bfloat16 and x_aligned:
        lim = limits(8)
        plan = cols_plan(N, K, COLS_WARPS, COLS_BLOCKS, lim.cols, lim.sms, COLS_STAGES)
        if plan is not None:
            return plan
    return staged_plan(dtype, N, K, x_aligned, r_aligned, limits)


def staged_plan(dtype: torch.dtype, N: int, K: int, x_aligned: bool, r_aligned: bool,
                limits: Callable[[int], Limits]) -> Plan:
    """The row-staged design's plan (K1's; K2's before the column-owning
    design, and still its own where that does not take the shape):
    "staged" with 16-byte loads (K a multiple of 4 f32 / 8 bf16, X and r
    16-byte aligned) or "scalar", with R the largest of 8, 4, 2, 1 rows
    whose buffers fit, else "wide"."""
    full = _CODES[dtype][1]
    vec = full if K % full == 0 and x_aligned and r_aligned else 1
    lim = limits(vec)
    itemsize = 4 if dtype == torch.float32 else 2
    R = next((R for R in STAGED_ROWS if staged_smem(K, R, itemsize) <= lim.staged), 0)
    if R:
        return Plan("staged" if vec > 1 else "scalar", vec, min(lim.sms, _cdiv(N, R)), R)
    strips = _cdiv(K // vec, STAGED_THREADS)  # about 4 blocks per SM over strips × row ranges
    return Plan("wide", vec, min(_cdiv(4 * lim.sms, strips), N), 0)


def kernel_name(dtype: torch.dtype) -> str:
    return "deflate_f32" if dtype == torch.float32 else "deflate_bf16"


def deflate_pass_plain(X: torch.Tensor, r: torch.Tensor):
    """The two-product form, in plain PyTorch: t = X r, p = Xᵀt, tt = r·p.

    bf16 X is widened to float32 first, so t stays float32: the semantics
    of the bf16 kernel, not of `deflate_pass_xla`'s bf16 branch, which
    rounds t back to bf16."""
    if X.dtype == torch.bfloat16:
        X = X.float()
    t = X @ r
    p = X.T @ t
    return t, r @ p, p


@functools.cache
def _library() -> ctypes.CDLL:
    from pls_tpu_torch.utils.nvcc import load_library

    lib = load_library("deflate.cu")
    lib.pls_deflate_limits.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.pls_deflate_limits.restype = ctypes.c_int
    lib.pls_deflate_pass.argtypes = [
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 6,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pls_deflate_pass.restype = ctypes.c_int
    lib.pls_deflate_cols_pass.argtypes = [
        *[ctypes.c_void_p] * 6, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pls_deflate_cols_pass.restype = ctypes.c_int
    lib.pls_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pls_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load the cached build of) the CUDA kernel."""
    _library()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_library().pls_cuda_error_string(err).decode()}")


@functools.lru_cache(maxsize=16)
def _limits(device_index: int, code: int, vec: int) -> Limits:
    """The device's limits for one (dtype, vector width); also raises the
    kernels' shared memory limits there."""
    staged, cols, sms = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_library().pls_deflate_limits(code, vec, ctypes.byref(staged), ctypes.byref(cols),
                                             ctypes.byref(sms)),
               "deflation kernel limits")
    return Limits(staged.value, cols.value, sms.value)


@functools.lru_cache(maxsize=64)
def _plan(planner: Callable[..., Plan], device_index: int, dtype: torch.dtype, N: int, K: int,
          x_aligned: bool, r_aligned: bool) -> Plan:
    code = _CODES[dtype][0]
    return planner(dtype, N, K, x_aligned, r_aligned,
                   lambda vec: _limits(device_index, code, vec))


def _shape(X: torch.Tensor, r: torch.Tensor) -> tuple:
    N, K = X.shape
    return X.device.index, X.dtype, N, K, X.data_ptr() % 16 == 0, r.data_ptr() % 16 == 0


def plan_for(X: torch.Tensor, r: torch.Tensor) -> Plan:
    """The plan `deflate_pass_cuda` launches for these CUDA tensors."""
    return _plan(choose_plan, *_shape(X, r))


def staged_plan_for(X: torch.Tensor, r: torch.Tensor) -> Plan:
    """The row-staged design's plan for these CUDA tensors: what K2 ran
    before the column-owning design, for comparisons (`_launch`)."""
    return _plan(staged_plan, *_shape(X, r))


def deflate_pass_cuda(X: torch.Tensor, r: torch.Tensor):
    """Launch the CUDA kernel on the current stream, on `choose_plan`'s
    path.  Raises on a tensor the kernel does not take, and if the launch
    fails."""
    return _launch(X, r, plan_for)


def _check_operands(X: torch.Tensor, r: torch.Tensor) -> None:
    if not X.is_cuda or X.device != r.device:
        raise ValueError(f"X ({X.device}) and r ({r.device}) must be on one CUDA device")
    if X.dtype not in KERNEL_DTYPES:
        raise ValueError(f"deflation kernel takes float32/bfloat16 X, got {X.dtype}")
    if X.ndim != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D tensor, got shape {tuple(X.shape)}")
    N, K = X.shape
    if N == 0 or K == 0:
        raise ValueError(f"X is empty: shape {(N, K)}")
    if r.dtype != torch.float32 or r.shape != (K,) or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous float32 ({K},) tensor")


def _launch(X: torch.Tensor, r: torch.Tensor, planner: Callable[..., Plan]):
    """Check the operands and launch `planner`'s plan for them: `plan_for`,
    or `staged_plan_for` to time the earlier design; count the launch."""
    _check_operands(X, r)
    plan = planner(X, r)
    N, K = X.shape
    t = torch.empty(N, dtype=torch.float32, device=X.device)
    p = torch.empty(K, dtype=torch.float32, device=X.device)
    tt = torch.empty((), dtype=torch.float32, device=X.device)
    partial = torch.empty((plan.G, K), dtype=torch.float32, device=X.device)
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (X.data_ptr(), r.data_ptr(), t.data_ptr(), p.data_ptr(), tt.data_ptr(),
                partial.data_ptr())
        if plan.path == "cols":
            err = lib.pls_deflate_cols_pass(*ptrs, N, K, plan.G, plan.S, plan.stages, stream)
        else:
            err = lib.pls_deflate_pass(_CODES[X.dtype][0], plan.vec, *ptrs, N, K, plan.G, plan.R,
                                       stream)
    _check(err, f"deflation kernel launch ({plan.path} path)")
    launches[kernel_name(X.dtype)] += 1
    path_launches[plan.path] += 1
    return t, tt, p


def deflate_pass(X: torch.Tensor, r: torch.Tensor):
    """(t, tt, p) of one component: the plain version for a CPU tensor or
    float64 X, the CUDA kernel for float32/bfloat16 X on CUDA."""
    if X.device.type == "cpu" or X.dtype == torch.float64:
        return deflate_pass_plain(X, r)
    return deflate_pass_cuda(X, r)
