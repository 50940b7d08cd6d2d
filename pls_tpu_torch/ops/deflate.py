"""Fused deflation pass of kernel-PLS type 1: (t = X r, tt = tᵀt, p = Xᵀt).

Replaces `pls_tpu/ops/deflate.py::_deflate_pass_pallas` (the TPU kernel,
lines 83-192: body `_kernel_f32` for float32 X, `_kernel_bf16` for
bfloat16 X).  Same contract: X (N, K) float32 or bfloat16, r (K,) float32
-> t (N,), tt (), p (K,), all float32; bf16 X is widened in registers so
that t stays float32 between the two contractions.

What bounds it on the H100: bytes.  One pass moves N·K·itemsize bytes of X
for about 4·N·K flops, far below the card's ridge point.  The two-product
form (`deflate_pass_plain`) reads X twice; the CUDA kernel
(`csrc/deflate.cu`) reads it once: one block per SM streams tiles of rows
into shared memory with asynchronous copies (double-buffered), computes
tᵢ of each staged row, then adds xᵢtᵢ into a p accumulator in shared
memory.  K too wide for one row and the accumulator in shared memory
takes a two-pass form of the same kernel file (t by rows, then p by
column strips).  The cross-block sum of p is two-stage (each block owns a
row of a (G, K) partial buffer; a second kernel sums the rows in fixed
order) and not float atomics, so results are bit-identical from run to
run.

`deflate_pass` is the one dispatcher.  A CPU tensor, or float64 X (the
kernel is float32/bfloat16, as on the TPU), takes the plain version;
float32 or bfloat16 X on CUDA launches the kernel or raises.  The TPU
kernel's row-tile policy (`_row_tile`, `pad_rows_to_tile`,
`pallas_supported`) has no counterpart: the CUDA kernel masks the ragged
last tile itself and needs no padding copy.

`launches` counts, per kernel, the `deflate_pass` calls that launched it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_CODES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}  # (dtype code, vector width)
launches = {"deflate_f32": 0, "deflate_bf16": 0}


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
    lib.pls_deflate_plan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
    ]
    lib.pls_deflate_plan.restype = ctypes.c_int
    lib.pls_deflate_pass.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pls_deflate_pass.restype = ctypes.c_int
    lib.pls_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pls_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load the cached build of) the CUDA kernel."""
    _library()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_library().pls_cuda_error_string(err).decode()}")


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, code: int, vec: int, N: int, K: int) -> tuple[int, int]:
    """(G, R) for this shape: the rows of the partial buffer, and the rows
    per staged tile (0: the two-pass wide-K form).  Planned once per shape
    and device, which also raises the kernel's shared memory limit there."""
    G, R = ctypes.c_int64(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_library().pls_deflate_plan(code, vec, N, K, ctypes.byref(G), ctypes.byref(R)),
               "deflation kernel plan")
    return G.value, R.value


def deflate_pass_cuda(X: torch.Tensor, r: torch.Tensor):
    """Launch the CUDA kernel on the current stream.  Raises on a tensor
    the kernel does not take, and if the launch fails."""
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
    code, vec = _CODES[X.dtype]
    if K % vec or X.data_ptr() % 16 or r.data_ptr() % 16:
        vec = 1  # scalar loads: rows of X, or r, are not all 16-byte aligned
    G, R = _plan(X.device.index, code, vec, N, K)
    t = torch.empty(N, dtype=torch.float32, device=X.device)
    p = torch.empty(K, dtype=torch.float32, device=X.device)
    tt = torch.empty((), dtype=torch.float32, device=X.device)
    partial = torch.empty((G, K), dtype=torch.float32, device=X.device)
    lib = _library()
    with torch.cuda.device(X.device):
        err = lib.pls_deflate_pass(
            code, vec, X.data_ptr(), r.data_ptr(), t.data_ptr(), p.data_ptr(),
            tt.data_ptr(), partial.data_ptr(), N, K, G, R,
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "deflation kernel launch")
    launches[kernel_name(X.dtype)] += 1
    return t, tt, p


def deflate_pass(X: torch.Tensor, r: torch.Tensor):
    """(t, tt, p) of one component: the plain version for a CPU tensor or
    float64 X, the CUDA kernel for float32/bfloat16 X on CUDA."""
    if X.device.type == "cpu" or X.dtype == torch.float64:
        return deflate_pass_plain(X, r)
    return deflate_pass_cuda(X, r)
