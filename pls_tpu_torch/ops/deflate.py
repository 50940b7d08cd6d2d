"""Fused deflation pass of kernel-PLS type 1: (t = X r, tt = tᵀt, p = Xᵀt).

Replaces `pls_tpu/ops/deflate.py::_deflate_pass_pallas` (the TPU kernel,
lines 83-192: body `_kernel_f32` for float32 X, `_kernel_bf16` for
bfloat16 X).  Same contract: X (N, K) float32 or bfloat16, r (K,) float32
-> t (N,), tt (), p (K,), all float32; bf16 X is widened in registers so
that t stays float32 between the two contractions.

What bounds it on the H100: bytes.  One pass moves N·K·itemsize bytes of X
for about 4·N·K flops, far below the card's ridge point.  The two-product
form (`deflate_pass_plain`) reads X twice; the CUDA kernels read it once.
`choose_plan` picks one of five paths per shape (plain Python, so that the
CPU tests reach it); `staged_plan` is the row-staged design's choice
alone, which comparisons launch beside the cols and cluster paths through
`_launch`:

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
- "cluster" (K1/K2 at wide K: past one staged row and the accumulator in
  shared memory, up to K = 262 144 in f32 and bf16, which holds the TPU
  kernel's whole one-pass range, K ≤ 131 072 f32 / 262 144 bf16):
  `csrc/deflate.cu`'s cluster design, one pass over X.  A thread-block
  cluster of C CTAs (2, 4, 8 or 16, the smallest whose threads can hold a
  column slice's r and p in registers) shares every row, each CTA one
  column slice streamed by TMA bulk copies (X 16-byte aligned, K a
  multiple of the vector width; otherwise, vec 1, each row slice's
  16-byte-aligned body by one bulk copy and the few 4-byte words at its
  two edges by cp.async, `cluster_row_pieces`); tᵢ is summed across the
  cluster through distributed shared memory;
- "wide": where the cluster kernel cannot take the shape (K past
  16 CTAs × 512 threads × 32 columns = 262 144, or a cluster size the
  device cannot launch), a two-pass form (t by rows, then p by column
  strips).

The cross-block sum of p is two-stage on every path (each block owns a row
of a (G, K) partial buffer; a second kernel sums the rows in fixed order)
and not float atomics, so results are bit-identical from run to run.

`deflate_pass` is the one dispatcher.  A CPU tensor, float64 X (the
kernel is float32/bfloat16, as on the TPU) or X of no rows takes the
plain version;
float32 or bfloat16 X on CUDA launches the kernel or raises.  The TPU
kernel's row-tile policy (`_row_tile`, `pad_rows_to_tile`,
`pallas_supported`) has no counterpart: the CUDA kernels mask the ragged
last tile themselves and need no padding copy.

`launches` counts, per kernel, the calls that launched it; `path_calls`
counts the passes per path: each kernel launch under its plan's path, and
"plain" for the two-product form the dispatcher takes (the CPU twin);
`staging_calls` counts the cluster passes by how their rows were staged:
"bulk" (vec > 1), "split" (vec 1, at least one row slice's body by bulk
copy) and "words" (vec 1, every slice too short for a body).
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable, Iterator
from dataclasses import dataclass

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_CODES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}  # (dtype code, vector width)
PATHS = ("cols", "staged", "scalar", "cluster", "wide")
launches = {"deflate_f32": 0, "deflate_bf16": 0, "deflate_f32_cluster": 0,
            "deflate_bf16_cluster": 0}
path_calls = dict.fromkeys((*PATHS, "plain"), 0)
staging_calls = {"bulk": 0, "split": 0, "words": 0}

# the column-owning design (csrc/deflate_common.cuh): rows of a tile each
# thread reduces, most 4-column chunks a thread owns, row groups S, ring
# slots; and the shipped configuration (csrc/deflate.cu): consumer warps,
# blocks per SM, ring slots asked for
COLS_ROWS, COLS_CHUNKS, COLS_GROUPS, COLS_MAX_STAGES = 2, 5, (1, 2, 4, 8), 8
COLS_WARPS, COLS_BLOCKS, COLS_STAGES = 16, 1, 4
STAGED_ROWS = (8, 4, 2, 1)  # rows per staged tile, largest that fits first
STAGED_THREADS = 256  # threads of a row-staged block: a wide-K strip's chunks
# the cluster design (csrc/deflate.cu): CTAs a cluster, threads a CTA, most
# columns of a slice a thread holds, rows per tile (largest that fits
# first), ring slots
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_THREADS = 512
CLUSTER_COLS = 32
CLUSTER_ROWS = (4, 2, 1)
CLUSTER_MIN_STAGES, CLUSTER_MAX_STAGES = 3, 8
CLUSTER_ROW_WORDS = 8  # most 4-byte words of a row slice with vec 1: a lane each


@dataclass(frozen=True)
class Limits:
    """One device's limits for one kernel configuration: `staged`, the
    dynamic shared memory the row-staged kernel may take; `cols`, the bytes
    the column-owning kernel's ring may take (0 where it does not apply);
    `sms`, the SM count; `cluster`, the dynamic shared memory a CTA of the
    cluster kernel may take; `clusters`, the most resident clusters of each
    of CLUSTER_SIZES CTAs (0 where that size cannot launch)."""

    staged: int
    cols: int
    sms: int
    cluster: int
    clusters: tuple[int, ...]


@dataclass(frozen=True)
class Plan:
    """One pass's launch: `path` (one of PATHS), `vec` (the vector width,
    1 for scalar loads), `G` (blocks, or clusters on the cluster path: the
    rows of the partial buffer), `R` (rows per tile; 0 on the wide path),
    `S` (the cols path's row groups), `stages` (ring slots, cols and
    cluster paths) and `C` (CTAs a cluster)."""

    path: str
    vec: int
    G: int
    R: int
    S: int = 0
    stages: int = 0
    C: int = 0


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


def cluster_row_bytes(K: int, C: int, vec: int, itemsize: int) -> int:
    """Shared memory of one staged row slice in the cluster kernel: the
    slice's chunks, 16-byte aligned, and with scalar staging 16 bytes more
    for the slice's shift from the 16-byte boundary its row is staged from
    (`cluster_row_pieces`; `cluster_row_bytes` in csrc/deflate.cu)."""
    return _cdiv(_cdiv(K // vec, C) * vec * itemsize, 16) * 16 + (16 if vec == 1 else 0)


@dataclass(frozen=True)
class RowPieces:
    """How the cluster kernel with vec 1 stages one row slice: `head` 4-byte
    words from `align_down(addr, 4)`, the body of `body_bytes` (a multiple
    of 16, 0 for none) from `body` (16-byte aligned) by one bulk copy, then
    `tail` words from its end.  The slot's row starts at
    `align_down(addr, 16)`, so every piece keeps its offset from there and
    the slice's first element lies `shift` elements in."""

    head: int
    body: int
    body_bytes: int
    tail: int
    shift: int


def cluster_row_pieces(addr: int, length: int, itemsize: int) -> RowPieces:
    """The pieces of the row slice of `length` bytes at `addr` (the plain
    twin of `row_pieces` in csrc/deflate.cu): the body from
    `align_up(addr, 16)` to `align_down(addr + length, 16)`, and the words
    on each side of it; a slice with no such body (or none of it) takes its
    words alone, all as `head`.  No words for an empty slice."""
    end = addr + length
    w0, w1 = addr & ~3, (end + 3) & ~3
    b0, b1 = (addr + 15) & ~15, end & ~15
    shift = (addr & 15) // itemsize
    if length == 0:
        return RowPieces(0, b0, 0, 0, shift)
    if b1 <= b0:
        return RowPieces((w1 - w0) // 4, b0, 0, 0, shift)
    return RowPieces((b0 - w0) // 4, b0, b1 - b0, (w1 - b1) // 4, shift)


@functools.lru_cache(maxsize=64)
def _staging(residue: int, rows: int, K: int, C: int, itemsize: int) -> str:
    sc_full = _cdiv(K, C)
    for rank in range(C):
        length = max(0, min(sc_full, K - rank * sc_full)) * itemsize
        for i in range(rows):
            addr = residue + (i * K + rank * sc_full) * itemsize
            if cluster_row_pieces(addr, length, itemsize).body_bytes:
                return "split"
    return "words"


def cluster_staging(addr: int, N: int, K: int, C: int, vec: int, itemsize: int) -> str:
    """How a cluster pass over X (N, K) at `addr` in clusters of C stages
    its rows: "bulk" with vec > 1; with vec 1 "split" where some row slice
    has a body for one bulk copy (`cluster_row_pieces`), else "words".  A
    row's address mod 16 repeats within 8 rows, so 8 rows tell."""
    if vec > 1:
        return "bulk"
    return _staging(addr % 16, min(N, 8), K, C, itemsize)


def cluster_plans(dtype: torch.dtype, N: int, K: int, x_aligned: bool,
                  limits: Callable[[int], Limits],
                  min_stages: int = CLUSTER_MIN_STAGES) -> Iterator[Plan]:
    """Every plan the cluster kernel can run for X (N, K), in the order the
    planner prefers them: 16-byte
    staging where K is a multiple of the vector width and X 16-byte aligned,
    else 4-byte copies (vec 1); r is read once, by scalars, so its alignment
    does not matter.  Each C of CLUSTER_SIZES the device launches whose
    slice every thread can hold (at most CLUSTER_COLS columns each),
    smallest first; within it each R of CLUSTER_ROWS, largest first, whose
    ring takes at least `min_stages` slots, with as many slots
    (≤ CLUSTER_MAX_STAGES) as fit; G, the clusters, at most the resident
    ones, and no more than the tiles.  No plan past 16 CTAs' columns
    (K > 262 144 = 16 · CLUSTER_THREADS · CLUSTER_COLS)."""
    itemsize = 4 if dtype == torch.float32 else 2
    full = _CODES[dtype][1]
    vec = full if K % full == 0 and x_aligned else 1
    lim = limits(vec)
    for C, resident in zip(CLUSTER_SIZES, lim.clusters):
        if (resident < 1 or K // vec < C
                or _cdiv(_cdiv(K // vec, C), CLUSTER_THREADS) * vec > CLUSTER_COLS):
            continue
        row = cluster_row_bytes(K, C, vec, itemsize)
        for R in CLUSTER_ROWS:
            stages = min(CLUSTER_MAX_STAGES, lim.cluster // (R * row))
            if stages >= min_stages:
                yield Plan("cluster", vec, min(resident, _cdiv(N, R)), R, 0, stages, C)


def cluster_plan(dtype: torch.dtype, N: int, K: int, x_aligned: bool,
                 limits: Callable[[int], Limits]) -> Plan | None:
    """The cluster design's plan, the first of `cluster_plans`: the
    smallest C that holds the slice with CLUSTER_MIN_STAGES slots of one
    row, then the largest R with as many; or None where the cluster kernel
    cannot take the shape."""
    return next(cluster_plans(dtype, N, K, x_aligned, limits), None)


def choose_plan(dtype: torch.dtype, N: int, K: int, x_aligned: bool, r_aligned: bool,
                limits: Callable[[int], Limits]) -> Plan:
    """The pass's plan for X (N, K) of `dtype`: "cols" where the
    column-owning design takes the shape (bf16, K % 8 == 0, X 16-byte
    aligned, K not too wide); else `staged_plan`'s, unless that is "wide"
    and `cluster_plan` takes the shape.  `limits(vec)` gives the device's
    limits for that vector width."""
    if dtype == torch.bfloat16 and x_aligned:
        lim = limits(8)
        plan = cols_plan(N, K, COLS_WARPS, COLS_BLOCKS, lim.cols, lim.sms, COLS_STAGES)
        if plan is not None:
            return plan
    plan = staged_plan(dtype, N, K, x_aligned, r_aligned, limits)
    if plan.path == "wide":
        return cluster_plan(dtype, N, K, x_aligned, limits) or plan
    return plan


def staged_plan(dtype: torch.dtype, N: int, K: int, x_aligned: bool, r_aligned: bool,
                limits: Callable[[int], Limits]) -> Plan:
    """The row-staged design's plan (K1's; K2's before the column-owning
    design, and still its own where that does not take the shape):
    "staged" with 16-byte loads (K a multiple of 4 f32 / 8 bf16, X and r
    16-byte aligned) or "scalar", with R the largest of 8, 4, 2, 1 rows
    whose buffers fit, else "wide" (the dispatcher's "cluster" takes most
    of those shapes; comparisons launch this plan beside it)."""
    full = _CODES[dtype][1]
    vec = full if K % full == 0 and x_aligned and r_aligned else 1
    lim = limits(vec)
    itemsize = 4 if dtype == torch.float32 else 2
    R = next((R for R in STAGED_ROWS if staged_smem(K, R, itemsize) <= lim.staged), 0)
    if R:
        return Plan("staged" if vec > 1 else "scalar", vec, min(lim.sms, _cdiv(N, R)), R)
    strips = _cdiv(K // vec, STAGED_THREADS)  # about 4 blocks per SM over strips × row ranges
    return Plan("wide", vec, min(_cdiv(4 * lim.sms, strips), N), 0)


def kernel_name(dtype: torch.dtype, path: str = "staged") -> str:
    """The kernel a launch on `path` counts in `launches`."""
    name = "deflate_f32" if dtype == torch.float32 else "deflate_bf16"
    return name + "_cluster" if path == "cluster" else name


def deflate_pass_plain(X: torch.Tensor, r: torch.Tensor):
    """The two-product form, in plain PyTorch: t = X r, p = Xᵀt, tt = r·p.

    bf16 X (and r) is widened to float32 first, so t stays float32: the
    semantics of the bf16 kernel, not of `deflate_pass_xla`'s bf16 branch,
    which rounds t back to bf16."""
    if X.dtype == torch.bfloat16:
        X, r = X.float(), r.float()
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
    lib.pls_deflate_cluster_limits.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_int)]
    lib.pls_deflate_cluster_limits.restype = ctypes.c_int
    lib.pls_deflate_cluster_pass.argtypes = [
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 6,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pls_deflate_cluster_pass.restype = ctypes.c_int
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
    staged, cols, sms, cluster = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    clusters = (ctypes.c_int * len(CLUSTER_SIZES))()
    with torch.cuda.device(device_index):
        _check(_library().pls_deflate_limits(code, vec, ctypes.byref(staged), ctypes.byref(cols),
                                             ctypes.byref(sms)),
               "deflation kernel limits")
        _check(_library().pls_deflate_cluster_limits(code, vec, ctypes.byref(cluster), clusters),
               "cluster kernel limits")
    return Limits(staged.value, cols.value, sms.value, cluster.value, tuple(clusters))


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
    before the column-owning design, and the two-pass "wide" form where
    the dispatcher plans "cluster", for comparisons (`_launch`)."""
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
        elif plan.path == "cluster":
            err = lib.pls_deflate_cluster_pass(_CODES[X.dtype][0], plan.vec, *ptrs, N, K, plan.G,
                                               plan.C, plan.R, plan.stages, stream)
        else:
            err = lib.pls_deflate_pass(_CODES[X.dtype][0], plan.vec, *ptrs, N, K, plan.G, plan.R,
                                       stream)
    _check(err, f"deflation kernel launch ({plan.path} path)")
    launches[kernel_name(X.dtype, plan.path)] += 1
    path_calls[plan.path] += 1
    if plan.path == "cluster":
        staging_calls[cluster_staging(X.data_ptr(), N, K, plan.C, plan.vec,
                                      X.element_size())] += 1
    return t, tt, p


def deflate_pass(X: torch.Tensor, r: torch.Tensor):
    """(t, tt, p) of one component: the plain version for a CPU tensor or
    float64 X, the CUDA kernel for float32/bfloat16 X on CUDA.  X of no
    rows (a row-sharded fit's empty last shard) launches nothing: p and tt
    are zeros."""
    if X.device.type == "cpu" or X.dtype == torch.float64 or X.shape[0] == 0:
        path_calls["plain"] += 1
        return deflate_pass_plain(X, r)
    return deflate_pass_cuda(X, r)


def deflate_pass_narrow(X: torch.Tensor, r: torch.Tensor):
    """`deflate_pass` for fits whose state has X's dtype, as NIPALS and
    SIMPLS keep it in the JAX package: for bf16 X, r goes in widened to
    float32 (the kernel's contract) and t, tt, p come back rounded to
    bf16.  Other dtypes pass through."""
    if X.dtype != torch.bfloat16:
        return deflate_pass(X, r)
    return tuple(v.to(X.dtype) for v in deflate_pass(X, r.float()))
