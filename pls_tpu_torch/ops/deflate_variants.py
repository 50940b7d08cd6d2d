"""Kernel variants of the fused deflation pass: the sweep's kernels K3-K5.

Replaces the TPU kernels of `tools/kernel_variants.py`, the design sweep
that chose the JAX package's shipped kernel:

- K3 `make_vpu_1k(tn, tt_inside, vmem_mb)` (lines 72-151): the VPU form on
  float32 X, tt inside the kernel or as r·p outside it;
- K4 `make_mxu(tn, prec)` (lines 153-206): t and p as matrix-unit matvecs
  at DEFAULT (1 bf16 pass), HIGH (3) or HIGHEST (6), tt = t·t outside;
  on 16-byte-aligned X with K % 4 == 0 the ring kernel `mxu_ring` (a
  producer warp keeps `stages` slots of 8 rows in flight with TMA bulk
  copies, `mxu_plan`), else the row-staged `mxu_rows` with R = tn rows;
- K5 `make_vpu_bf16(tn, vmem_mb)` (lines 208-272): K3's form on bfloat16
  X widened in registers, tt = r·p; beside it `make_cols_bf16(warps,
  stages, blocks)`, the same function in the column-owning design that is
  K2's on the shipped path (`csrc/deflate_common.cuh`): 16 or 8 consumer
  warps own fixed column chunks, a producer warp keeps a ring of 2-8 TMA
  slots, one block per SM (two at 8 warps).

Each factory keeps the JAX name and returns a `Variant` (a `ColsVariant`
for the column-owning design), a callable `fn(X, r) -> (t, tt, p)` in
float32.  The kernels are in
`csrc/deflate_variants.cu` (CUDA C++ for sm_90a; K4 on bf16 `mma.sync`
tensor-core instructions); its header says how the TPU's knobs map onto
the card's: `tn` becomes R, the rows per staged shared-memory tile (≤ 8
VPU, ≤ 16 mma, lowered to the largest power of two that fits); `vmem_mb`
becomes `smem_kb`, the shared memory each block reserves (and so the
blocks per SM); Pallas's double buffering becomes `stages` (1 or 2; for
K4 the ring's slots, 1-4, of which the row-staged path takes at most 2).

Beside each kernel, its plain PyTorch version: `vpu_f32_plain`,
`vpu_bf16_plain` (also the cols rows') and `mxu_plain`, the two-product
form on the operands the kernel sees (bf16-rounded or split for the mma form, t rounded to bf16 at
DEFAULT as the TPU's matrix unit does).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises, with no fallback.

`launches` counts, per kernel, the calls that launched it;
`mxu_path_launches` counts K4's per path ("ring" or "staged").
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import ClassVar

import torch

from pls_tpu_torch.ops.deflate import COLS_MAX_STAGES, Plan, cols_max_k, cols_plan

# the kernel file's row-staged kinds, and each one's X dtype and 16-byte
# vector width (cols_bf16, `ColsVariant`, has its own entry points)
_KINDS = {"vpu_f32": (0, torch.float32, 4), "vpu_bf16": (1, torch.bfloat16, 8),
          "mxu_f32": (2, torch.float32, 4)}
PRECISIONS = {"DEFAULT": 1, "HIGH": 3, "HIGHEST": 6}  # bf16 mma passes
_SPLITS = {1: 1, 3: 2, 6: 3}  # bf16 parts each operand is split into
# the products of split parts (X part, r or t part), smallest first; P
# passes take the last P, in the kernel's order
_TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
VPU_MAX_ROWS, MMA_MAX_ROWS = 8, 16
# K4's ring (csrc/deflate_variants.cu, `mxu_ring`): rows of a slot (the
# n = 8 of mma.m16n8k16) and most slots
MXU_ROWS, MXU_MAX_STAGES = 8, 4
# the column-owning kernel's instantiations (csrc/deflate_variants.cu):
# (consumer warps, blocks per SM)
COLS_CONFIGS = ((16, 1), (8, 2))
launches = {"vpu_f32": 0, "mxu_f32": 0, "vpu_bf16": 0, "cols_bf16": 0}
mxu_path_launches = {"ring": 0, "staged": 0}


# ---------- plain versions ----------
def vpu_f32_plain(X: torch.Tensor, r: torch.Tensor, tt_inside: bool = False):
    """t = X r, p = Xᵀt; tt = t·t when `tt_inside` (the kernel sums tᵢ²),
    else r·p."""
    t = X @ r
    p = X.T @ t
    return t, (t @ t if tt_inside else r @ p), p


def vpu_bf16_plain(X: torch.Tensor, r: torch.Tensor):
    """K5's form: bf16 X widened to float32, t = X r, p = Xᵀt, tt = r·p."""
    return vpu_f32_plain(X.float(), r)


def bf16_split(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x ≈ s₀ + … + s_{n−1}, each part rounded to bf16 to nearest even and
    held in float32: s₀ = bf16(x), s₁ = bf16(x − s₀), s₂ = bf16(x − s₀ − s₁)."""
    parts, rest = [], x
    for _ in range(n):
        s = rest.to(torch.bfloat16).float()
        parts.append(s)
        rest = rest - s
    return parts


def _split_products(A: list[torch.Tensor], b: list[torch.Tensor], passes: int) -> torch.Tensor:
    out = None
    for i, j in _TERMS[6 - passes:]:
        term = A[i] @ b[j]
        out = term if out is None else out + term
    return out


def mxu_plain(X: torch.Tensor, r: torch.Tensor, prec: str = "DEFAULT"):
    """K4's arithmetic in plain PyTorch: X and r split into 1, 2 or 3 bf16
    parts (DEFAULT, HIGH, HIGHEST), t = Σ of the pass products in float32;
    t split the same way (at DEFAULT: rounded to bf16) for p = Xᵀt; tt = t·t
    of the float32 t.  Products of bf16 values are exact in float32, so only
    the order of the float32 sums differs from the kernel's."""
    passes = PRECISIONS[prec]
    n = _SPLITS[passes]
    xs = bf16_split(X.float(), n)
    t = _split_products(xs, bf16_split(r, n), passes)
    return t, t @ t, mxu_plain_p(X, t, prec, xs)


def mxu_plain_p(X: torch.Tensor, t: torch.Tensor, prec: str = "DEFAULT",
                xs: list[torch.Tensor] | None = None) -> torch.Tensor:
    """K4's second product alone, p = Xᵀt on a given float32 t, split (at
    DEFAULT: rounded to bf16) as the kernel splits its own t.  Holding a
    kernel's p against this on the kernel's t checks the second product at
    the float32 bound: on the plain t instead, a last-bit difference in tᵢ
    can round it to the neighbouring bf16 value.  `xs`: X's split parts,
    when the caller has them."""
    passes = PRECISIONS[prec]
    n = _SPLITS[passes]
    if xs is None:
        xs = bf16_split(X.float(), n)
    return _split_products([x.T for x in xs], bf16_split(t, n), passes)


# ---------- K4's ring: the plan ----------
def mxu_pitch(K: int) -> int:
    """Floats between two rows of K4's staged tiles: K rounded up to whole
    16-column chunks, then to ≡ 8 (mod 32), so that neither phase's
    fragment loads meet in one shared-memory bank more than twice
    (`csrc/deflate_variants.cu`, `mxu_pitch`)."""
    k16 = -(-K // 16) * 16
    return k16 + (8 if k16 % 32 == 0 else 24)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclass(frozen=True)
class MxuPlan:
    """One launch of `mxu_ring`: G blocks (one per SM, at most one per
    tile), `stages` ring slots of `slot_bytes` (MXU_ROWS rows of `pitch`
    floats), `smem` dynamic shared memory in all (the p accumulator, r's
    bf16 parts and the ring)."""

    G: int
    stages: int
    pitch: int
    slot_bytes: int
    smem: int


def mxu_plan(N: int, K: int, passes: int, stages: int, budget: int, sms: int) -> MxuPlan | None:
    """The ring's plan for X (N, K) at `passes` bf16 products: `stages`
    slots, or as many as fit `budget` bytes beside the p accumulator and
    the split parts of r, at least one; None where K % 4 != 0 (the bulk
    copies move whole 16-byte rows) or not one slot fits."""
    if K % 4:
        return None
    pitch = mxu_pitch(K)
    fixed = _align16(4 * K) + _align16(2 * pitch * _SPLITS[passes])
    slot = MXU_ROWS * pitch * 4
    fit = min(stages, MXU_MAX_STAGES, (budget - fixed) // slot)
    if fit < 1:
        return None
    return MxuPlan(min(sms, -(-N // MXU_ROWS)), fit, pitch, slot, fixed + fit * slot)


# ---------- the CUDA library ----------
@functools.cache
def _library() -> ctypes.CDLL:
    from pls_tpu_torch.utils.nvcc import load_library

    lib = load_library("deflate_variants.cu")
    lib.kv_plan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.kv_plan.restype = ctypes.c_int
    lib.kv_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 7,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.kv_launch.restype = ctypes.c_int
    lib.kv_mxu_limits.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.kv_mxu_limits.restype = ctypes.c_int
    lib.kv_cols_limits.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.kv_cols_limits.restype = ctypes.c_int
    lib.kv_cols_launch.argtypes = [
        *[ctypes.c_int] * 2, *[ctypes.c_void_p] * 6, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.kv_cols_launch.restype = ctypes.c_int
    lib.kv_error_string.argtypes = [ctypes.c_int]
    lib.kv_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load the cached build of) csrc/deflate_variants.cu."""
    _library()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_library().kv_error_string(err).decode()}")


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, code: int, vec: int, N: int, K: int, rows: int, stages: int,
          smem_kb: int, passes: int) -> tuple[int, int, int]:
    G, R, per_sm = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_library().kv_plan(code, vec, N, K, rows, stages, smem_kb, passes, ctypes.byref(G),
                                  ctypes.byref(R), ctypes.byref(per_sm)),
               "kernel variant plan")
    return G.value, R.value, per_sm.value


@functools.lru_cache(maxsize=64)
def _mxu_plan(device_index: int, N: int, K: int, passes: int, stages: int) -> MxuPlan | None:
    """`mxu_plan` with the device's budget and SM count."""
    budget, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_library().kv_mxu_limits(passes, ctypes.byref(budget), ctypes.byref(sms)),
               "mxu_ring limits")
    return mxu_plan(N, K, passes, stages, budget.value, sms.value)


@functools.lru_cache(maxsize=64)
def _cols_plan(device_index: int, N: int, K: int, warps: int, blocks: int,
               stages: int) -> Plan | None:
    """The plan of one configuration of the column-owning kernel for X
    (N, K) on the device (`ops.deflate.cols_plan` with its ring budget and
    SM count), None where it does not take K."""
    budget, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_library().kv_cols_limits(warps, blocks, ctypes.byref(budget),
                                         ctypes.byref(sms)),
               "cols_bf16 limits")
    return cols_plan(N, K, warps, blocks, budget.value, sms.value, stages, stages)


def _check_operands(name: str, dtype: torch.dtype, X: torch.Tensor, r: torch.Tensor) -> None:
    if not X.is_cuda or X.device != r.device:
        raise ValueError(f"X ({X.device}) and r ({r.device}) must be on one CUDA device")
    if X.dtype != dtype:
        raise ValueError(f"{name} takes {dtype} X, got {X.dtype}")
    if X.ndim != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D tensor, got shape {tuple(X.shape)}")
    N, K = X.shape
    if N == 0 or K == 0:
        raise ValueError(f"X is empty: shape {(N, K)}")
    if r.dtype != torch.float32 or r.shape != (K,) or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous float32 ({K},) tensor")


def _outputs(X: torch.Tensor, G: int):
    """t (N,), tt (), p (K,) and the (G, K) partial buffer, float32 on X's device."""
    N, K = X.shape
    return (torch.empty(N, dtype=torch.float32, device=X.device),
            torch.empty((), dtype=torch.float32, device=X.device),
            torch.empty(K, dtype=torch.float32, device=X.device),
            torch.empty((G, K), dtype=torch.float32, device=X.device))


@dataclass(frozen=True)
class Variant:
    """One row-staged kernel variant: `fn(X, r) -> (t, tt, p)`, float32.

    kind: "vpu_f32" (K3), "mxu_f32" (K4) or "vpu_bf16" (K5); tn: the rows
    per staged tile asked for; stages: 1 or 2 staging buffers (K4: 1-4
    ring slots, of which the row-staged path takes at most 2); smem_kb:
    the shared memory a block reserves (None: the device's maximum, one
    block per SM; not K4's ring, which takes the device's maximum);
    tt_inside (K3): the kernel sums tᵢ² itself; prec (K4)."""

    kind: str
    tn: int
    stages: int = 2
    smem_kb: int | None = None
    tt_inside: bool = False
    prec: str | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown kernel kind {self.kind!r}")
        max_rows = MMA_MAX_ROWS if self.kind == "mxu_f32" else VPU_MAX_ROWS
        if not 1 <= self.tn <= max_rows:
            raise ValueError(f"{self.kind}: tn must be in 1..{max_rows}, got {self.tn}")
        most = MXU_MAX_STAGES if self.kind == "mxu_f32" else 2
        if not 1 <= self.stages <= most:
            raise ValueError(f"{self.kind}: stages must be in 1..{most}, got {self.stages}")
        if self.smem_kb is not None and self.smem_kb < 1:
            raise ValueError(f"smem_kb must be positive, got {self.smem_kb}")
        if (self.prec is not None) != (self.kind == "mxu_f32"):
            raise ValueError("prec is given for the mma form (mxu_f32) and only for it")
        if self.prec is not None and self.prec not in PRECISIONS:
            raise ValueError(f"prec must be one of {list(PRECISIONS)}, got {self.prec!r}")
        if self.tt_inside and self.kind != "vpu_f32":
            raise ValueError("tt_inside is a knob of the f32 VPU form only")

    @property
    def name(self) -> str:
        if self.kind == "mxu_f32":
            head = f"mxu_{self.prec}"
        else:
            head = "vpu_1k" if self.kind == "vpu_f32" else "vpu_bf16"
        kb = f"_k{self.smem_kb}" if self.smem_kb else ""
        return f"{head}_r{self.tn}_s{self.stages}{kb}" + ("_tt" if self.tt_inside else "")

    @property
    def dtype(self) -> torch.dtype:
        return _KINDS[self.kind][1]

    def plain(self, X: torch.Tensor, r: torch.Tensor):
        if self.kind == "mxu_f32":
            return mxu_plain(X, r, self.prec)
        if self.kind == "vpu_bf16":
            return vpu_bf16_plain(X, r)
        return vpu_f32_plain(X, r, self.tt_inside)

    def _vec(self, X: torch.Tensor, r: torch.Tensor) -> int:
        vec = _KINDS[self.kind][2]
        if X.shape[1] % vec or X.data_ptr() % 16 or r.data_ptr() % 16:
            return 1  # scalar loads: rows of X, or r, are not all 16-byte aligned
        return vec

    def takes(self, X: torch.Tensor) -> bool:
        """Whether the kernel runs on X (every shape and alignment)."""
        return True

    @property
    def _passes(self) -> int:
        return PRECISIONS[self.prec] if self.prec else 1

    def _launch_plan(self, X: torch.Tensor, r: torch.Tensor):
        """(vec, G, R, stages, blocks per SM, ring) of the launch for X: K4's
        ring where it takes X, else the row-staged plan (K4's with scalar
        staging, in at most 2 buffers)."""
        N, K = X.shape
        vec = self._vec(X, r)
        if self.kind == "mxu_f32":
            ring = _mxu_plan(X.device.index, N, K, self._passes, self.stages) if vec > 1 else None
            if ring is not None:
                return vec, ring.G, MXU_ROWS, ring.stages, 1, True
            vec = 1  # K4 stages rows in 16-byte units only in its ring
        stages = min(self.stages, 2)
        G, R, per_sm = _plan(X.device.index, _KINDS[self.kind][0], vec, N, K, self.tn, stages,
                             self.smem_kb or 0, self._passes)
        if R == 0:
            raise ValueError(f"{self.name}: not one row of K={K} and the p accumulator fit "
                             f"{stages} staging buffer(s) in the block's shared memory")
        return vec, G, R, stages, per_sm, False

    def plan(self, X: torch.Tensor, r: torch.Tensor) -> tuple[int, int, int]:
        """(G, R, blocks per SM) of this variant for X on its device."""
        _, G, R, _, per_sm, _ = self._launch_plan(X, r)
        return G, R, per_sm

    def cuda(self, X: torch.Tensor, r: torch.Tensor):
        """Launch the kernel on the current stream.  Raises on a tensor the
        kernel does not take, and if the launch fails."""
        _check_operands(self.name, self.dtype, X, r)
        N, K = X.shape
        vec, G, R, stages, _, ring = self._launch_plan(X, r)
        t, tt, p, partial = _outputs(X, G)
        tt_part = torch.empty(G, dtype=torch.float32, device=X.device) if self.tt_inside else None
        with torch.cuda.device(X.device):
            err = _library().kv_launch(
                _KINDS[self.kind][0], vec, X.data_ptr(), r.data_ptr(),
                t.data_ptr(), p.data_ptr(), tt.data_ptr(), partial.data_ptr(),
                tt_part.data_ptr() if tt_part is not None else None,
                N, K, G, R, stages, int(self.tt_inside), self._passes,
                torch.cuda.current_stream().cuda_stream,
            )
        _check(err, f"{self.name} launch")
        launches[self.kind] += 1
        if self.kind == "mxu_f32":
            mxu_path_launches["ring" if ring else "staged"] += 1
        return t, tt, p

    def __call__(self, X: torch.Tensor, r: torch.Tensor):
        """The plain version for a CPU tensor, the kernel for a CUDA one."""
        if X.device.type == "cpu":
            return self.plain(X, r)
        return self.cuda(X, r)


def make_vpu_1k(tn: int, tt_inside: bool, smem_kb: int | None = None,
                stages: int = 2) -> Variant:
    """K3: the VPU form on float32 X."""
    return Variant("vpu_f32", tn, stages, smem_kb, tt_inside=tt_inside)


def make_mxu(tn: int, prec: str, stages: int = 2) -> Variant:
    """K4: t and p as bf16 tensor-core matvecs at `prec`; `stages` ring
    slots (1-4) of 8 rows on 16-byte-aligned X with K % 4 == 0, else tn
    rows per staged tile in min(stages, 2) buffers."""
    return Variant("mxu_f32", tn, stages, prec=prec)


def make_vpu_bf16(tn: int, smem_kb: int | None = None) -> Variant:
    """K5: the VPU form on bfloat16 X, widened in registers, two stages."""
    return Variant("vpu_bf16", tn, 2, smem_kb)


@dataclass(frozen=True)
class ColsVariant:
    """K5 in the column-owning design (K2's on the shipped path), with
    `Variant`'s interface: `warps` consumer warps and `blocks` blocks per
    SM (one of COLS_CONFIGS), a ring of `stages` TMA slots (2-8); the plan
    picks the rows per tile from K."""

    warps: int
    stages: int
    blocks: int = 1
    kind: ClassVar[str] = "cols_bf16"
    dtype: ClassVar[torch.dtype] = torch.bfloat16

    def __post_init__(self):
        if (self.warps, self.blocks) not in COLS_CONFIGS:
            raise ValueError(f"cols_bf16: (warps, blocks) must be one of {COLS_CONFIGS}, "
                             f"got {(self.warps, self.blocks)}")
        if not 2 <= self.stages <= COLS_MAX_STAGES:
            raise ValueError(f"cols_bf16: stages must be in 2..{COLS_MAX_STAGES}, "
                             f"got {self.stages}")

    @property
    def name(self) -> str:
        blocks = f"x{self.blocks}" if self.blocks > 1 else ""
        return f"cols_bf16_w{self.warps}{blocks}_s{self.stages}"

    def plain(self, X: torch.Tensor, r: torch.Tensor):
        return vpu_bf16_plain(X, r)

    def takes(self, X: torch.Tensor) -> bool:
        """Whether the kernel runs on X: K % 8 == 0, X 16-byte aligned, K
        within the columns its threads hold."""
        K = X.shape[1]
        return K % 8 == 0 and K <= cols_max_k(self.warps) and X.data_ptr() % 16 == 0

    def _plan(self, X: torch.Tensor) -> Plan:
        N, K = X.shape
        plan = _cols_plan(X.device.index, N, K, self.warps, self.blocks, self.stages)
        if plan is None or X.data_ptr() % 16:
            raise ValueError(f"{self.name}: takes K % 8 == 0 with at most "
                             f"{cols_max_k(self.warps)} columns, X 16-byte aligned, and "
                             f"{self.stages} ring slots of its tile; got K={K}")
        return plan

    def plan(self, X: torch.Tensor, r: torch.Tensor) -> tuple[int, int, int]:
        """(G, R, blocks per SM) of this variant for X on its device."""
        plan = self._plan(X)
        return plan.G, plan.R, self.blocks

    def cuda(self, X: torch.Tensor, r: torch.Tensor):
        """Launch the kernel on the current stream.  Raises on a tensor the
        kernel does not take, and if the launch fails."""
        _check_operands(self.name, self.dtype, X, r)
        N, K = X.shape
        plan = self._plan(X)
        t, tt, p, partial = _outputs(X, plan.G)
        with torch.cuda.device(X.device):
            err = _library().kv_cols_launch(
                self.warps, self.blocks, X.data_ptr(), r.data_ptr(), t.data_ptr(), p.data_ptr(),
                tt.data_ptr(), partial.data_ptr(), N, K, plan.G, plan.S, plan.stages,
                torch.cuda.current_stream().cuda_stream,
            )
        _check(err, f"{self.name} launch")
        launches[self.kind] += 1
        return t, tt, p

    def __call__(self, X: torch.Tensor, r: torch.Tensor):
        """The plain version for a CPU tensor, the kernel for a CUDA one."""
        if X.device.type == "cpu":
            return self.plain(X, r)
        return self.cuda(X, r)


def make_cols_bf16(warps: int, stages: int, blocks: int = 1) -> ColsVariant:
    """K5 in the column-owning design: `warps` consumer warps and `blocks`
    blocks per SM (one of COLS_CONFIGS), a ring of `stages` TMA slots (2-8)."""
    return ColsVariant(warps, stages, blocks)
