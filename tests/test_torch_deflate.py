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
wide) is plain Python and is checked here with the H100's limits (132
SMs, 227 KB of shared memory a block): K % 8 != 0, misaligned X or r,
K too wide for the column-owning design or for the staged form, and a
ragged last tile; so is the row-staged design's own plan (`staged_plan`),
which comparisons launch beside the cols path.  So is the rule that the port runs on the card unless
asked for the CPU: without a card `default_device()` raises, and the CLI
and the `.npy` entry points refuse to run unless given the CPU.

The CUDA kernel itself runs only on a card: those cases are marked `gpu`
and skip here.  On the card they hold the kernel against the plain version
on the same inputs (1e-5 relative) at the CPU shapes, at K too wide for
the staged form (the two-pass wide-K form), and with an r that is not
16-byte aligned; and K2's column-owning path against the plain version
and float64 of the bf16-rounded X at 4096×5000, 65536×2048, a ragged
4099×5000 and K = 8 (1e-5 relative, bit-identical relaunches).
"""

import contextlib
import io
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pls_tpu.ops.deflate import _deflate_pass_pallas, deflate_pass_xla
from pls_tpu_torch import config
from pls_tpu_torch.ops import deflate
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
H100 = {4: deflate.Limits(232_416, 0, 132), 8: deflate.Limits(232_416, 230_272, 132),
        1: deflate.Limits(232_416, 0, 132)}


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
    (torch.bfloat16, 2048, 30_000, True, True, "wide", 8, 0),   # past the staged form
    (torch.float32, 100_000, 5000, True, True, "staged", 4, 4),  # K1
    (torch.float32, 300, 5004, True, False, "scalar", 1, 4),
    (torch.float32, 2048, 30_000, True, True, "wide", 4, 0),
])
def test_path_choice(dtype, N, K, x_aligned, r_aligned, path, vec, R):
    plan = _choose(dtype, N, K, x_aligned, r_aligned)
    assert (plan.path, plan.vec, plan.R) == (path, vec, R)
    if path == "wide":
        strips = -(-(K // vec) // deflate.STAGED_THREADS)
        assert plan.G == min(-(-4 * 132 // strips), N)
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
                 (torch.float32, 100_000, 5000), (torch.float32, 2048, 30_000)]:
        assert staged(*args) == _choose(*args)


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
    name = deflate.kernel_name(Xc.dtype)
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
    before = deflate.path_launches["cols"]
    _kernel_vs_plain(Xc, rc)
    assert deflate.path_launches["cols"] == before + 2
    t, tt, p = deflate.deflate_pass(Xc, rc)
    Xd, rd = Xc.double(), rc.double()
    td = Xd @ rd
    pd = Xd.T @ td
    assert _rel(t.cpu(), td.cpu()) < 1e-5 and _rel(p.cpu(), pd.cpu()) < 1e-5
    assert abs(float(tt) - float(td @ td)) / float(td @ td) < 1e-5
