"""The port's deflation pass (pls_tpu_torch.ops.deflate) against the JAX package.

`deflate_pass_plain` is the CUDA kernel's plain twin.  It is held against
the TPU kernel itself, `pls_tpu.ops.deflate._deflate_pass_pallas`, run in
interpret mode on the CPU as tests/test_pallas.py runs it, for float32 and
bfloat16 X; in float64 against `deflate_pass_xla`.  Inputs come from numpy
with a seed and go to both packages as the same arrays.

Tolerances: in float32 and bf16 both sides accumulate in float32 in
another order, so t, p and tt agree to 1e-5 relative to their largest
entry (the TPU kernel's own contract against f64, tools/tpu_smoke.py:67).
The bf16 inputs are bit-identical (both packages round to nearest even).
In float64 the two products agree to 1e-12.

The wrapper's choice of path (`choose_plan`: cols / staged / scalar /
cluster / wide) is plain Python and is checked here with the H100's
limits (132 SMs, 227 KB of shared memory a block, the resident clusters
of each size): K % 8 != 0, misaligned X or r, K too wide for the
column-owning design or for the staged form, the cluster size at wide K
(and every plan of the cluster kernel the timing sweep launches), K past
the cluster kernel's 262 144 columns, and a ragged last tile; so is the
row-staged design's own plan (`staged_plan`), which comparisons launch
beside the cols and cluster paths.  So are the pieces the cluster kernel
stages a vec-1 row slice in (`cluster_row_pieces`: the words at its two
edges and its 16-byte-aligned body) at every start mod 16, f32 and bf16,
and the staging each pass is counted under (`cluster_staging`).  The
plain twin is held to the TPU kernel at wide K too (up to 131 072
columns), and a float64 fit at a wide K to the JAX package's fit.  So is
the rule that the port runs on the card unless asked for the CPU: without
a card `default_device()` raises, and the CLI and the `.npy` entry points
refuse to run unless given the CPU.

The CUDA kernel itself runs only on a card: those cases are marked `gpu`
and skip here.  On the card they hold the kernel against the plain version
on the same inputs (1e-5 relative) at the CPU shapes, at K too wide for
the staged form, and with an r that is not 16-byte aligned; K2's
column-owning path against the plain version and float64 of the
bf16-rounded X at 4096×5000, 65536×2048, a ragged 4099×5000 and K = 8
(1e-5 relative, bit-identical relaunches); the cluster path against
the plain version and the two-pass form at wide K (1e-5 relative,
bit-identical relaunches, counted on the cluster path); and its vec-1
staging against float64 at ragged K, in bf16, from X one and two elements
into its storage, at one row and in forced plans whose slices are too
short for a body (1e-5 relative, bit-identical relaunches, counted by
`staging_calls`).
"""

import contextlib
import io
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.models import kernel_pls as jax_kernel_pls
from pls_tpu.ops.deflate import _TILE_BUDGET, _deflate_pass_pallas, deflate_pass_xla
from pls_tpu_torch import config
from pls_tpu_torch.models import kernel_pls
from pls_tpu_torch.ops import deflate
from pls_tpu_torch.types import METHOD
from pls_tpu_torch.utils import binio, nvcc

SHAPES = [(256, 128), (300, 200), (64, 640), (130, 128), (60, 401)]


def _operands(N, K, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, K)), rng.normal(size=K)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,K", SHAPES)
def test_plain_matches_pallas_kernel(N, K, dtype):
    _plain_vs_pallas(N, K, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,K", [(40, 20_000), (24, 65_536), (16, 131_072)])
def test_plain_matches_pallas_kernel_wide_k(N, K, dtype):
    # the K of the cluster path, up to the TPU kernel's one-pass limit in f32
    _plain_vs_pallas(N, K, dtype)


def _plain_vs_pallas(N, K, dtype):
    X, r = _operands(N, K)
    X32, r32 = X.astype(np.float32), r.astype(np.float32)
    Xj = jnp.asarray(X32).astype(dtype)
    t, tt, p = _deflate_pass_pallas(Xj, jnp.asarray(r32), interpret=True)
    Xt = torch.from_numpy(X32).to(getattr(torch, dtype))
    np.testing.assert_array_equal(Xt.float().numpy(), np.asarray(Xj.astype(jnp.float32)))
    t2, tt2, p2 = deflate.deflate_pass_plain(Xt, torch.from_numpy(r32))
    assert t2.dtype == tt2.dtype == p2.dtype == torch.float32
    assert t2.shape == (N,) and p2.shape == (K,) and tt2.shape == ()
    assert _rel(t2, t) < 1e-5
    assert _rel(p2, p) < 1e-5
    assert abs(float(tt2) - float(tt)) / float(tt) < 1e-5


@pytest.mark.parametrize("N,K", [(256, 128), (60, 401)])
def test_plain_matches_xla_in_float64(N, K):
    X, r = _operands(N, K, seed=1)
    t, tt, p = deflate_pass_xla(jnp.asarray(X), jnp.asarray(r))
    t2, tt2, p2 = deflate.deflate_pass_plain(torch.from_numpy(X), torch.from_numpy(r))
    assert t2.dtype == torch.float64
    np.testing.assert_allclose(t2.numpy(), np.asarray(t), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(p2.numpy(), np.asarray(p), rtol=1e-12, atol=1e-10)
    assert abs(float(tt2) - float(tt)) / float(tt) < 1e-12


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    X, r = _operands(64, 32, seed=2)
    Xt, rt = torch.from_numpy(X).float(), torch.from_numpy(r).float()
    before = dict(deflate.launches)
    out = deflate.deflate_pass(Xt, rt)
    for a, b in zip(out, deflate.deflate_pass_plain(Xt, rt)):
        assert torch.equal(a, b)
    assert deflate.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_path_calls_count_the_plain_form(dtype):
    # the dispatcher's two-product form counts as "plain", and no kernel path moves
    X, r = _operands(20, 12, seed=4)
    Xt = torch.from_numpy(X).to(dtype)
    rt = torch.from_numpy(r).to(torch.float64 if dtype == torch.float64 else torch.float32)
    before = dict(deflate.path_calls)
    deflate.deflate_pass(Xt, rt)
    deflate.deflate_pass_narrow(Xt, rt)
    assert deflate.path_calls == {**before, "plain": before["plain"] + 2}
    assert set(deflate.path_calls) == {*deflate.PATHS, "plain"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_dispatcher_takes_plain_version_off_the_kernel(dtype):
    # a CPU tensor of any dtype, like float64 X on a card, never reaches the kernel
    X, r = _operands(48, 24, seed=5)
    Xt = torch.from_numpy(X).to(dtype)
    rt = torch.from_numpy(r).to(torch.float64 if dtype == torch.float64 else torch.float32)
    before = dict(deflate.launches)
    out = deflate.deflate_pass(Xt, rt)
    for a, b in zip(out, deflate.deflate_pass_plain(Xt, rt)):
        assert torch.equal(a, b)
    assert deflate.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    X, r = _operands(16, 8, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        deflate.deflate_pass_cuda(torch.from_numpy(X).float(), torch.from_numpy(r).float())


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.nvcc_path()


def test_library_name_follows_source():
    path = nvcc.library_path("deflate.cu")
    assert path.parent == nvcc.BUILD_DIR
    assert path.name.startswith("deflate-") and path.suffix == ".so"
    assert path == nvcc.library_path("deflate.cu")


def test_library_name_follows_included_header(tmp_path, monkeypatch):
    shutil.copytree(nvcc.PACKAGE_DIR / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(nvcc, "PACKAGE_DIR", tmp_path)
    names = [f.name for f in nvcc.source_files("deflate.cu")]
    assert names == ["deflate.cu", "deflate_common.cuh"]
    assert [f.name for f in nvcc.source_files("deflate_variants.cu")] == [
        "deflate_variants.cu", "deflate_common.cuh"]
    before = {src: nvcc.library_path(src) for src in ("deflate.cu", "deflate_variants.cu")}
    header = tmp_path / "csrc" / "deflate_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for src, path in before.items():
        after = nvcc.library_path(src)
        assert after != path and after.name.startswith(src.split(".")[0] + "-")
    (tmp_path / "csrc" / "unrelated.cuh").write_text("// not included\n")
    assert nvcc.library_path("deflate.cu") == nvcc.library_path("deflate.cu")


# ---------- the wrapper's choice of path, with the H100's limits ----------
# the cluster kernel's budget and resident clusters of 2, 4, 8, 16 CTAs as the
# H100 80GB HBM3 reports them (`pls_deflate_cluster_limits`)
CLUSTER_LIMITS = dict(cluster=231_552, clusters=(66, 30, 15, 7))
H100 = {4: deflate.Limits(232_416, 0, 132, **CLUSTER_LIMITS),
        8: deflate.Limits(232_416, 230_272, 132, **CLUSTER_LIMITS),
        1: deflate.Limits(232_416, 0, 132, **CLUSTER_LIMITS)}


def _choose(dtype, N, K, x_aligned=True, r_aligned=True, planner=deflate.choose_plan):
    return planner(dtype, N, K, x_aligned, r_aligned, H100.__getitem__)


@pytest.mark.parametrize("N,K,S,R", [(100_000, 5000, 2, 4), (65_536, 2048, 4, 8),
                                     (4096, 5000, 2, 4), (1000, 8, 8, 16), (64, 10_240, 1, 2)])
def test_bf16_takes_the_cols_path(N, K, S, R):
    plan = _choose(torch.bfloat16, N, K)
    assert (plan.path, plan.S, plan.R, plan.stages) == ("cols", S, R, 4)
    assert plan.G == min(132, -(-N // R))
    # every thread of a group owns at most COLS_CHUNKS 4-column chunks
    group = 32 * deflate.COLS_WARPS // S
    assert -(-K // 4 // group) <= deflate.COLS_CHUNKS
    assert plan.stages * R * K * 2 <= H100[8].cols


def test_cols_spreads_the_chunks_over_the_threads():
    # K = 5000: 1250 chunks; S = 2 fills 97.7 % of the 256 × 5 slots, S = 1 only 81 %
    assert _choose(torch.bfloat16, 100_000, 5000).S == 2
    # K = 2048: 512 chunks fill every slot at S = 1, 2 and 4; the larger tile wins
    assert _choose(torch.bfloat16, 65_536, 2048).S == 4


def test_ragged_last_tile_is_planned_not_padded():
    plan = _choose(torch.bfloat16, 4099, 5000)
    tiles = -(-4099 // plan.R)
    assert plan.path == "cols" and plan.G == 132 and 4099 - (tiles - 1) * plan.R == 3
    small = _choose(torch.bfloat16, 3, 5000)  # fewer rows than one tile: one block
    assert (small.path, small.G) == ("cols", 1)


@pytest.mark.parametrize("dtype,N,K,x_aligned,r_aligned,path,vec,R", [
    (torch.bfloat16, 60, 401, True, True, "scalar", 1, 8),      # K % 8 != 0 (nir)
    (torch.bfloat16, 300, 5004, True, True, "scalar", 1, 8),    # K % 4 == 0 but not % 8
    (torch.bfloat16, 100, 5000, False, True, "scalar", 1, 8),   # X not 16-byte aligned
    (torch.bfloat16, 100, 5000, True, False, "cols", 8, 4),     # cols reads r by scalars
    (torch.bfloat16, 1000, 10_248, True, True, "staged", 8, 4),  # past cols' registers
    (torch.bfloat16, 1000, 16_384, True, True, "staged", 8, 2),
    (torch.bfloat16, 2048, 30_000, True, True, "cluster", 8, 2),  # past the staged form
    (torch.float32, 100_000, 5000, True, True, "staged", 4, 4),  # K1
    (torch.float32, 300, 5004, True, False, "scalar", 1, 4),
    (torch.float32, 2048, 30_000, True, True, "cluster", 4, 1),
])
def test_path_choice(dtype, N, K, x_aligned, r_aligned, path, vec, R):
    plan = _choose(dtype, N, K, x_aligned, r_aligned)
    assert (plan.path, plan.vec, plan.R) == (path, vec, R)
    if path == "wide":
        strips = -(-(K // vec) // deflate.STAGED_THREADS)
        assert plan.G == min(-(-4 * 132 // strips), N)
    elif path == "cluster":
        assert plan.G == min(CLUSTER_LIMITS["clusters"][0], -(-N // plan.R)) and plan.C == 2
    else:
        assert plan.G == min(132, -(-N // plan.R))


def test_forced_paths():
    # the row-staged design's own plan (`staged_plan`): K2's earlier design
    # at the main path's shape, for the timing beside cols, and the shapes
    # where it is the dispatcher's plan too
    def staged(*args):
        return _choose(*args, planner=deflate.staged_plan)

    old = staged(torch.bfloat16, 100_000, 5000)
    assert (old.path, old.vec, old.R, old.G) == ("staged", 8, 8, 132)
    assert staged(torch.bfloat16, 100_000, 5000, False).path == "scalar"
    assert staged(torch.bfloat16, 100, 40_000).path == "wide"
    for args in [(torch.bfloat16, 60, 401), (torch.bfloat16, 1000, 16_384),
                 (torch.float32, 100_000, 5000)]:
        assert staged(*args) == _choose(*args)
    # at wide K the dispatcher takes the cluster path; the two-pass form
    # stays the row-staged design's plan, for the timing beside it
    assert staged(torch.float32, 2048, 30_000).path == "wide"
    assert _choose(torch.float32, 2048, 30_000).path == "cluster"


def test_one_pass_range_is_the_tpu_kernels():
    # the cluster path reads X once across the TPU kernel's whole one-pass
    # range (a 16-row tile within its VMEM budget), and in f32 past it up to
    # the cluster kernel's own 16 CTAs × 512 threads × 32 columns
    widest = 16 * deflate.CLUSTER_THREADS * deflate.CLUSTER_COLS
    assert widest == 262_144
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        tpu = _TILE_BUDGET // (16 * itemsize)
        assert tpu <= widest
        assert _choose(dtype, 64, tpu).path == "cluster"
        assert _choose(dtype, 64, widest).path == "cluster"
        assert _choose(dtype, 64, widest + 8).path == "wide"


@pytest.mark.parametrize("dtype,N,K,vec,C,R,stages", [
    (torch.float32, 2048, 30_000, 4, 2, 1, 3),     # 15 000 columns a CTA, 60 KB a row
    (torch.float32, 512, 65_536, 4, 4, 1, 3),
    (torch.float32, 256, 131_072, 4, 8, 1, 3),     # the TPU kernel's widest f32 K
    (torch.float32, 64, 140_000, 4, 16, 2, 3),     # past it: clusters of 16
    (torch.float32, 128, 262_144, 4, 16, 1, 3),    # the cluster kernel's widest K
    (torch.float32, 100, 20_000, 4, 2, 1, 5),      # just past the staged form: 40 KB a row
    (torch.bfloat16, 2048, 30_000, 8, 2, 2, 3),
    (torch.bfloat16, 512, 65_536, 8, 4, 2, 3),
    (torch.bfloat16, 256, 131_072, 8, 8, 2, 3),
    (torch.bfloat16, 128, 262_144, 8, 16, 2, 3),   # the widest bf16 K: clusters of 16
    (torch.float32, 1024, 30_001, 1, 2, 1, 3),     # ragged K: 4-byte staging
    (torch.float32, 10_267, 20_531, 1, 2, 1, 5),   # TCGA's 20 531 genes (7² · 419): 4-byte
    (torch.bfloat16, 1024, 30_001, 1, 2, 2, 3),
])
def test_cluster_plan(dtype, N, K, vec, C, R, stages):
    plan = _choose(dtype, N, K)
    assert (plan.path, plan.vec, plan.C, plan.R, plan.stages) == ("cluster", vec, C, R, stages)
    i = deflate.CLUSTER_SIZES.index(C)
    assert plan.G == min(CLUSTER_LIMITS["clusters"][i], -(-N // R))
    # each thread holds at most CLUSTER_COLS columns of its CTA's slice ...
    slice_cols = -(-(K // vec) // C) * vec
    assert -(-slice_cols // vec // deflate.CLUSTER_THREADS) * vec <= deflate.CLUSTER_COLS
    # ... and the ring fits the CTA's shared memory, which one cluster size less could not hold
    row = deflate.cluster_row_bytes(K, C, vec, 4 if dtype == torch.float32 else 2)
    assert stages * R * row <= CLUSTER_LIMITS["cluster"]
    if C > 2:
        half = -(-(K // vec) // (C // 2)) * vec
        assert -(-half // vec // deflate.CLUSTER_THREADS) * vec > deflate.CLUSTER_COLS


def test_cluster_plan_edges():
    # X not 16-byte aligned: 4-byte staging, the same cluster; r's alignment does not matter
    plan = _choose(torch.float32, 2048, 30_000, x_aligned=False)
    assert (plan.path, plan.vec, plan.C) == ("cluster", 1, 2)
    assert _choose(torch.float32, 2048, 30_000, r_aligned=False) == _choose(
        torch.float32, 2048, 30_000)
    # fewer rows than resident clusters: one cluster a tile
    assert _choose(torch.float32, 3, 30_000).G == 3
    assert _choose(torch.bfloat16, 5, 30_000).G == 3  # 2-row tiles
    # past the cluster kernel's 262 144 columns (also ragged): the two-pass form
    for dtype, K in ((torch.float32, 262_148), (torch.float32, 262_145),
                     (torch.float32, 300_000), (torch.bfloat16, 262_152)):
        assert _choose(dtype, 64, K).path == "wide"
    # a device that cannot launch clusters of 16: past 131 072 columns is two-pass
    no16 = {v: deflate.Limits(232_416, lim.cols, 132, 231_552, (66, 30, 15, 0))
            for v, lim in H100.items()}
    for dtype in (torch.float32, torch.bfloat16):
        plan = deflate.choose_plan(dtype, 128, 262_144, True, True, no16.__getitem__)
        assert plan.path == "wide"
    # a shared memory budget too small for three one-row slots at C = 2 takes C = 4
    small = {v: deflate.Limits(232_416, lim.cols, 132, 150_000, (66, 30, 15, 7))
             for v, lim in H100.items()}
    assert deflate.choose_plan(torch.float32, 2048, 30_000, True, True,
                               small.__getitem__).C == 4


@pytest.mark.parametrize("dtype,N,K,x_aligned,sizes", [
    (torch.float32, 20_000, 30_000, True, (2, 4, 8, 16)),
    (torch.bfloat16, 20_000, 30_000, True, (2, 4, 8, 16)),
    (torch.float32, 8192, 65_536, True, (4, 8, 16)),
    (torch.float32, 8192, 131_072, True, (8, 16)),
    (torch.bfloat16, 4096, 262_144, True, (16,)),
    (torch.float32, 1024, 30_001, True, (2, 4, 8, 16)),  # ragged K: 4-byte staging
    (torch.float32, 64, 262_152, True, ()),              # past the kernel's columns
])
def test_cluster_plans_enumerate_what_the_kernel_holds(dtype, N, K, x_aligned, sizes):
    # the timing sweep's plans (tools/kernel_variants.py): every (C, R) with
    # at least `min_stages` ring slots; the first at 3 slots is the planner's
    plans = list(deflate.cluster_plans(dtype, N, K, x_aligned, H100.__getitem__, 2))
    assert tuple(sorted({p.C for p in plans})) == sizes
    itemsize = 4 if dtype == torch.float32 else 2
    for p in plans:
        i = deflate.CLUSTER_SIZES.index(p.C)
        row = deflate.cluster_row_bytes(K, p.C, p.vec, itemsize)
        assert 2 <= p.stages <= deflate.CLUSTER_MAX_STAGES
        assert p.stages * p.R * row <= CLUSTER_LIMITS["cluster"]
        assert (p.stages + 1) * p.R * row > CLUSTER_LIMITS["cluster"] or (
            p.stages == deflate.CLUSTER_MAX_STAGES)
        assert -(-(K // p.vec) // p.C // deflate.CLUSTER_THREADS) * p.vec <= deflate.CLUSTER_COLS
        assert p.G == min(CLUSTER_LIMITS["clusters"][i], -(-N // p.R))
    # in the planner's order: C ascending, R descending within it
    assert [(p.C, -p.R) for p in plans] == sorted((p.C, -p.R) for p in plans)
    first = next((p for p in plans if p.stages >= deflate.CLUSTER_MIN_STAGES), None)
    assert deflate.cluster_plan(dtype, N, K, x_aligned, H100.__getitem__) == first


# the cluster kernel's 4-byte staging (vec 1): every start of a row slice mod
# 16 (f32 rows start 4-byte aligned, bf16 2-byte), lengths 0-40 bytes and
# the pan-cancer cell's rank-1 slice (10 266 genes of 20 531, f32)
ROW_PIECES = [(itemsize, residue, length) for itemsize in (4, 2)
              for residue in range(0, 16, itemsize)
              for length in (*range(0, 41, itemsize), 41_064)]


@pytest.mark.parametrize("itemsize,residue,length", ROW_PIECES)
def test_cluster_row_pieces(itemsize, residue, length):
    addr = 0x7F00_0000_0000 + residue
    pc = deflate.cluster_row_pieces(addr, length, itemsize)
    base = addr & ~15
    # the pieces cover exactly the words of [addr, addr + length), each once
    words = [(addr & ~3) + 4 * k for k in range(pc.head)]
    words += range(pc.body, pc.body + pc.body_bytes, 4)
    words += [pc.body + pc.body_bytes + 4 * k for k in range(pc.tail)]
    end = (addr + length + 3) & ~3
    assert words == list(range(addr & ~3, end if length else addr & ~3, 4))
    # the body: 16-byte aligned in device memory, in the slot's row, in size
    assert pc.body % 16 == 0 and (pc.body - base) % 16 == 0 and pc.body_bytes % 16 == 0
    if pc.body_bytes:
        assert pc.body == (addr + 15) & ~15 and pc.body + pc.body_bytes == (addr + length) & ~15
        assert pc.head <= 16 // 4 - (itemsize == 4) and pc.tail <= 16 // 4 - (itemsize == 4)
    else:
        assert pc.tail == 0 and (addr + length) & ~15 <= (addr + 15) & ~15 or length == 0
    assert pc.head + pc.tail <= deflate.CLUSTER_ROW_WORDS
    # the slot's row starts at the 16-byte boundary: the shift and every
    # copied byte fit the row slice's shared memory (2n columns in clusters of 2)
    assert pc.shift * itemsize == addr - base
    n = length // itemsize
    assert end - base <= deflate.cluster_row_bytes(2 * n, 2, 1, itemsize)


def test_cluster_staging_by_what_the_rows_hold():
    # the pan-cancer pass: K odd, vec 1, every rank's slice takes a body
    assert deflate.cluster_staging(0, 10_267, 20_531, 2, 1, 4) == "split"
    assert deflate.cluster_staging(4, 300, 30_000, 2, 1, 4) == "split"  # one element in
    assert deflate.cluster_staging(2, 1024, 30_001, 2, 1, 2) == "split"
    assert deflate.cluster_staging(0, 2048, 30_000, 2, 4, 4) == "bulk"
    # slices of 3 f32 (12 bytes) or 6 bf16 never hold an aligned 16 bytes
    for addr in range(0, 16, 4):
        assert deflate.cluster_staging(addr, 64, 40, 16, 1, 4) == "words"
    assert deflate.cluster_staging(2, 64, 41, 8, 1, 2) == "words"
    # 7 f32 (28 bytes) hold one on some rows only
    assert deflate.cluster_staging(0, 1, 14, 2, 1, 4) == "split"
    assert set(deflate.staging_calls) == {"bulk", "split", "words"}


def test_kernel_names_per_path():
    assert deflate.kernel_name(torch.float32) == "deflate_f32"
    assert deflate.kernel_name(torch.bfloat16, "cols") == "deflate_bf16"
    assert deflate.kernel_name(torch.float32, "cluster") == "deflate_f32_cluster"
    assert deflate.kernel_name(torch.bfloat16, "cluster") == "deflate_bf16_cluster"
    assert set(deflate.launches) == {deflate.kernel_name(d, p) for d in deflate.KERNEL_DTYPES
                                     for p in ("staged", "cluster")}
    assert "cluster" in deflate.PATHS


@pytest.mark.parametrize("M", [1, 3])
def test_wide_k_fit_matches_jax_in_float64(M):
    # a fit at a K past the staged form (the cluster path's on the card) and
    # N < K, in float64 on the CPU: the plain pass, held to the JAX package
    rng = np.random.default_rng(11)
    N, K, A = 48, 20_001, 5
    L = rng.normal(size=(N, 4))
    X = L @ rng.normal(size=(4, K)) + 0.1 * rng.normal(size=(N, K))
    Y = L @ rng.normal(size=(4, M)) + 0.1 * rng.normal(size=(N, M))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    f_jax = jax_kernel_pls.fit(jnp.asarray(X), jnp.asarray(Y), A, pt.METHOD.KERNEL_TYPE1)
    f = kernel_pls.fit(torch.from_numpy(X), torch.from_numpy(Y), A, METHOD.KERNEL_TYPE1)
    B, Bj = f.R.numpy() @ f.Q.numpy().T, np.asarray(f_jax.R) @ np.asarray(f_jax.Q).T
    np.testing.assert_allclose(B, Bj, rtol=0, atol=1e-10 * np.abs(Bj).max())
    s = np.sign(np.sum(f.W.numpy() * np.asarray(f_jax.W), axis=0))
    for name in ("W", "P", "R", "Q", "T"):
        mine, ref = getattr(f, name).numpy(), np.asarray(getattr(f_jax, name))
        assert mine.shape == ref.shape, name
        if mine.size:
            np.testing.assert_allclose(mine * s, ref, atol=1e-10, err_msg=name)


def test_cols_plan_refuses_what_it_cannot_hold():
    def plan(K, budget, stages=4, min_stages=2, warps=16, blocks=1, N=100):
        return deflate.cols_plan(N, K, warps, blocks, budget, 132, stages, min_stages)

    assert plan(5004, 230_272) is None  # K % 8 != 0
    assert plan(10_248, 230_272) is None  # more than 5 chunks a thread
    assert plan(5000, 30_000) is None  # not 2 slots of even a 2-row tile (20 KB)
    two = plan(5000, 100_000)  # 2 slots of 4-row tiles (40 KB)
    assert (two.S, two.stages) == (2, 2)
    # 3 slots at least: only 2-row tiles (S = 1, 20 KB) take that many
    three = plan(5000, 100_000, min_stages=3)
    assert (three.S, three.R, three.stages) == (1, 2, 4)
    # 12 warps: 384 threads, 1250 chunks spread best at S = 1 (4 each)
    assert plan(5000, 230_272, stages=3, warps=12).S == 1
    # 8 warps, two blocks per SM: 256 threads, 5 chunks each at S = 1
    eight = plan(5000, 111_000, warps=8, blocks=2, N=100_000)
    assert (eight.S, eight.R, eight.G, eight.stages) == (1, 2, 264, 4)


# ---------- the port runs on the card unless asked for the CPU ----------
@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="--device cpu"):
        config.default_device()


def test_cli_without_device_cpu_exits_1_without_a_card(no_card):
    from pls_tpu_torch.cli import main

    data = nvcc.PACKAGE_DIR.parent / "pls_tpu" / "data"
    argv = [str(data / "toyX.csv"), str(data / "toyY.csv"), "2", "--cv", "none"]
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        assert main(argv) == 1
    assert err.getvalue().startswith("Error: no CUDA device") and out.getvalue() == ""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        assert main(argv + ["--device", "cpu"]) == 0
    assert "components explained variance" in err.getvalue()


def test_npy_entry_points_need_the_cpu_asked_for(no_card, tmp_path):
    rng = np.random.default_rng(9)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, rng.normal(size=(64, 6)).astype(np.float32))
    np.save(yp, rng.normal(size=(64, 2)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binio.stats_from_npy(xp, yp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binio.fit_streaming_npy(xp, yp, 2)
    assert binio.stats_from_npy(xp, yp, device="cpu").n == 64


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", SHAPES + [(4096, 5000)])
def test_cuda_kernel_matches_plain(N, K, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=4)
    _kernel_vs_plain(torch.from_numpy(X).float().cuda().to(dtype),
                     torch.from_numpy(r).float().cuda())


def _kernel_vs_plain(Xc, rc):
    name = deflate.kernel_name(Xc.dtype, deflate.plan_for(Xc, rc).path)
    before = deflate.launches[name]
    t, tt, p = deflate.deflate_pass(Xc, rc)
    t2, tt2, p2 = deflate.deflate_pass(Xc, rc)
    torch.cuda.synchronize()
    assert deflate.launches[name] == before + 2
    assert torch.equal(t, t2) and torch.equal(p, p2) and torch.equal(tt, tt2)
    tp, ttp, pp = deflate.deflate_pass_plain(Xc, rc)
    assert _rel(t.cpu(), tp.cpu()) < 1e-5
    assert _rel(p.cpu(), pp.cpu()) < 1e-5
    assert abs(float(tt) - float(ttp)) / float(ttp) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", [(64, 20000), (300, 30000), (33, 30001)])
def test_cuda_kernel_wide_k(N, K, dtype):
    # K at the staged form's limit (bf16 K=20000: one row per tile) and above
    # it (one row and the p accumulator do not fit in shared memory)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=6)
    _kernel_vs_plain(torch.from_numpy(X).float().cuda().to(dtype),
                     torch.from_numpy(r).float().cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_unaligned_r(dtype):
    # r a contiguous slice 4 bytes into its storage: not 16-byte aligned
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(256, 640, seed=7)
    buf = torch.from_numpy(np.concatenate([[0.0], r])).float().cuda()
    rc = buf[1:]
    assert rc.is_contiguous() and rc.data_ptr() % 16
    _kernel_vs_plain(torch.from_numpy(X).float().cuda().to(dtype), rc)


@pytest.mark.gpu
@pytest.mark.parametrize("N,K", [(4096, 5000), (65_536, 2048), (4099, 5000), (1000, 8)])
def test_cuda_cols_path_matches_plain_and_f64(N, K):
    # K2's column-owning design: against the plain version (the same f32
    # arithmetic in another order) and float64 of the bf16-rounded X
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=8)
    Xc = torch.from_numpy(X).float().cuda().to(torch.bfloat16)
    rc = torch.from_numpy(r).float().cuda()
    assert deflate.plan_for(Xc, rc).path == "cols"
    before = deflate.path_calls["cols"]
    _kernel_vs_plain(Xc, rc)
    assert deflate.path_calls["cols"] == before + 2
    t, tt, p = deflate.deflate_pass(Xc, rc)
    Xd, rd = Xc.double(), rc.double()
    td = Xd @ rd
    pd = Xd.T @ td
    assert _rel(t.cpu(), td.cpu()) < 1e-5 and _rel(p.cpu(), pd.cpu()) < 1e-5
    assert abs(float(tt) - float(td @ td)) / float(td @ td) < 1e-5


CLUSTER_SHAPES = [(torch.float32, 2048, 30_000), (torch.bfloat16, 2048, 30_000),
                  (torch.float32, 1024, 30_001), (torch.bfloat16, 1024, 30_001),
                  (torch.float32, 512, 65_536), (torch.bfloat16, 512, 65_536),
                  (torch.float32, 256, 131_072), (torch.bfloat16, 256, 131_072),
                  (torch.bfloat16, 128, 262_144), (torch.float32, 64, 140_000),
                  (torch.float32, 128, 262_144)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,N,K", CLUSTER_SHAPES)
def test_cuda_cluster_path_matches_plain_and_two_pass(dtype, N, K):
    # the one-pass cluster kernel at wide K: against the plain version and
    # the two-pass form it replaces (both 1e-5), relaunches bit-identical,
    # each launch counted on the cluster path
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=10)
    Xc = torch.from_numpy(X).float().cuda().to(dtype)
    rc = torch.from_numpy(r).float().cuda()
    assert deflate.plan_for(Xc, rc).path == "cluster"
    assert deflate.staged_plan_for(Xc, rc).path == "wide"
    before = deflate.path_calls["cluster"]
    _kernel_vs_plain(Xc, rc)
    assert deflate.path_calls["cluster"] == before + 2
    t, tt, p = deflate.deflate_pass(Xc, rc)
    tw, ttw, pw = deflate._launch(Xc, rc, deflate.staged_plan_for)
    tp, ttp, pp = deflate.deflate_pass_plain(Xc, rc)
    for a, b in ((t, tp), (p, pp), (tw, tp), (pw, pp)):
        assert _rel(a.cpu(), b.cpu()) < 1e-5
    assert abs(float(ttw) - float(ttp)) / float(ttp) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cluster_path_unaligned_x(dtype):
    # X a contiguous view one element into its storage: not 16-byte
    # aligned, so the cluster kernel stages 4-byte words
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    N, K = 300, 30_000
    X, r = _operands(N, K, seed=12)
    buf = torch.zeros(N * K + 1, dtype=dtype, device="cuda")
    buf[1:] = torch.from_numpy(X).float().cuda().to(dtype).reshape(-1)
    Xc = buf[1:].view(N, K)
    assert Xc.is_contiguous() and Xc.data_ptr() % 16
    rc = torch.from_numpy(r).float().cuda()
    plan = deflate.plan_for(Xc, rc)
    assert (plan.path, plan.vec) == ("cluster", 1)
    _kernel_vs_plain(Xc, rc)


@pytest.mark.gpu
def test_cuda_cluster_path_vec1_at_the_pancan_shape():
    # the pan-cancer cell's pass (10 267 tumours × 20 531 genes, f32): K is
    # odd, so the cluster kernel stages 4-byte words in clusters of 2; held
    # to float64 of the same X, relaunches bit-identical, counted as "cluster"
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    g = torch.Generator("cuda").manual_seed(14)
    Xc = torch.randn((10_267, 20_531), generator=g, device="cuda")
    rc = torch.randn(20_531, generator=g, device="cuda")
    plan = deflate.plan_for(Xc, rc)
    assert (plan.path, plan.vec, plan.C, plan.R) == ("cluster", 1, 2, 1)
    before = deflate.path_calls["cluster"]
    t, tt, p = deflate.deflate_pass(Xc, rc)
    t2, tt2, p2 = deflate.deflate_pass(Xc, rc)
    torch.cuda.synchronize()
    assert deflate.path_calls["cluster"] == before + 2
    assert torch.equal(t, t2) and torch.equal(p, p2) and torch.equal(tt, tt2)
    td, ttd, pd = deflate.deflate_pass_plain(Xc.double(), rc.double())
    assert _rel(t.cpu(), td.cpu()) < 1e-5 and _rel(p.cpu(), pd.cpu()) < 1e-5
    assert abs(float(tt) - float(ttd)) / float(ttd) < 1e-5


# the cluster kernel's vec-1 staging on the card: (dtype, N, K, elements
# X lies into its storage, the forced plan's (C, R) or None for the
# planner's, the staging counted)
VEC1_STAGING = [
    (torch.float32, 1024, 30_001, 0, None, "split"),    # ragged K
    (torch.float32, 2000, 20_531, 0, None, "split"),    # the pan-cancer cell's K
    (torch.bfloat16, 1024, 30_001, 0, None, "split"),   # bf16, K % 8 != 0
    (torch.bfloat16, 700, 30_004, 0, None, "split"),    # bf16, K % 8 == 4
    (torch.float32, 300, 30_000, 1, None, "split"),     # X one element in
    (torch.float32, 300, 30_000, 2, None, "split"),     # ... and two
    (torch.bfloat16, 300, 30_000, 1, None, "split"),
    (torch.bfloat16, 300, 30_000, 2, None, "split"),
    (torch.float32, 1, 30_001, 0, None, "split"),       # one row
    (torch.float32, 1, 131_073, 0, None, "split"),      # clusters of 16, one row
    (torch.float32, 37, 45, 0, (2, 4), "split"),        # 4-row tiles, the last ragged
    (torch.float32, 64, 40, 0, (16, 1), "words"),       # 3, 1 and 0 columns a CTA
    (torch.float32, 1, 40, 1, (16, 1), "words"),
    (torch.bfloat16, 50, 41, 0, (8, 2), "words"),       # 6 bf16 (12 bytes) a CTA
    (torch.float32, 33, 14, 0, (2, 4), "split"),        # 28 bytes: a body on some rows
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,N,K,offset,forced,staging", VEC1_STAGING)
def test_cuda_cluster_path_vec1_staging(dtype, N, K, offset, forced, staging):
    # held to float64 of the same (bf16-rounded) X at 1e-5, relaunches
    # bit-identical, each launch counted on the cluster path by its staging
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=15)
    buf = torch.zeros(N * K + offset, dtype=dtype, device="cuda")
    buf[offset:] = torch.from_numpy(X).float().cuda().to(dtype).reshape(-1)
    Xc, rc = buf[offset:].view(N, K), torch.from_numpy(r).float().cuda()
    planner = deflate.plan_for
    if forced is not None:
        C, R = forced
        lim = deflate._limits(Xc.device.index, deflate._CODES[dtype][0], 1)
        resident = lim.clusters[deflate.CLUSTER_SIZES.index(C)]
        assert resident > 0
        plan = deflate.Plan("cluster", 1, min(resident, -(-N // R)), R, 0, 3, C)
        planner = lambda X, r: plan  # noqa: E731
    plan = planner(Xc, rc)
    assert (plan.path, plan.vec) == ("cluster", 1)
    assert deflate.cluster_staging(Xc.data_ptr(), N, K, plan.C, 1, Xc.element_size()) == staging
    calls, stagings = deflate.path_calls["cluster"], dict(deflate.staging_calls)
    t, tt, p = deflate._launch(Xc, rc, planner)
    t2, tt2, p2 = deflate._launch(Xc, rc, planner)
    torch.cuda.synchronize()
    assert deflate.path_calls["cluster"] == calls + 2
    assert deflate.staging_calls == {**stagings, staging: stagings[staging] + 2}
    assert torch.equal(t, t2) and torch.equal(p, p2) and torch.equal(tt, tt2)
    td, ttd, pd = deflate.deflate_pass_plain(Xc.double(), rc.double())
    assert _rel(t.cpu(), td.cpu()) < 1e-5 and _rel(p.cpu(), pd.cpu()) < 1e-5
    assert abs(float(tt) - float(ttd)) / float(ttd) < 1e-5


@pytest.mark.gpu
def test_cuda_past_one_pass_range_is_two_pass():
    # past the cluster kernel's 262 144 columns: the two-pass form
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(64, 262_152, seed=13)
    Xc, rc = torch.from_numpy(X).float().cuda(), torch.from_numpy(r).float().cuda()
    assert deflate.plan_for(Xc, rc).path == "wide"
    before = deflate.path_calls["wide"]
    _kernel_vs_plain(Xc, rc)
    assert deflate.path_calls["wide"] == before + 2
