#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. device: the card, torch/CUDA versions, TF32 off; build the two CUDA
     sources, csrc/deflate.cu (K1/K2) and csrc/deflate_variants.cu
     (K3-K5), with one nvcc each started together; print their ptxas
     register and spill lines and the build time;
  2. kernel vs plain: the f32 (K1) and bf16 (K2) kernels against
     `deflate_pass_plain` on the same inputs and against f64 truth on the
     card, at every shape the main path gives them (toy 10×15, nir 60×401,
     100000×5000) and at (130, 96), (300, 401), (4096, 5000), (65536,
     2048), a ragged (4099, 5000), K = 8 (1000, 8), a bf16 K too wide for
     the column-owning path (1024, 16384) and a K too wide for the staged
     form (2048, 30000), printing each launch's path (cols / staged /
     scalar / wide); relative error of t, p and tt ≤ 1e-5 against both,
     and two launches bit-identical; then every
     variant of the kernel-variant sweep's default lists (K3, K4 at
     DEFAULT/HIGH/HIGHEST, K5 in both designs) against its plain version
     and f64 at 10×15, 130×96, 300×401 (scalar staging), 4096×5000 and
     65536×2048 (a cols_bf16 variant must refuse K % 8 != 0), two
     launches bit-identical: K3, K5 and K4-HIGHEST ≤ 1e-5 against
     both; K4 DEFAULT/HIGH ≤ 1e-5 in t and tt against plain, p ≤ 1e-5
     against the plain second product on the kernel's own t (and at
     HIGH against the whole plain chain), and within 10× the plain
     emulation's own error against f64; at DEFAULT a control, p with t
     left unrounded, must fall outside 1e-5;
  3. main path on real data: the port's CLI on nir/octane (A=10) and toy
     (A=2) in float32, tables against tests/golden, optimal component
     counts equal, and exactly A kernel launches per fit;
  4. main path at real size: PLSModel on 100000×5000 X, 10 Y, 20
     components (the repo's single-chip configuration, BASELINE.json),
     made on the card from --seed; f32 against the same fit in f64, and
     x_storage="bf16" against f32 within the bf16 budget, all 20 of its
     K2 launches on the cols path; the f32 and bf16 fit walls, warm, in
     turns (f32, bf16, bf16, f32, f32, bf16);
  5. timing with CUDA events (median of 25 after warm-up, one call per
     event pair; and back to back, 10 calls per pair, 5 pairs) at
     100000×5000: K1; K2 in its column-owning design beside its earlier
     row-staged design (`ops.deflate.staged_plan_for`), in turns (cols,
     staged, staged, cols); the plain
     two-product form in f32 and in bf16-upcast; the library yardsticks
     (two f32 `torch.matmul` products; two bf16 cuBLAS products with r
     and t rounded to bf16, a looser function); the card's
     device-to-device copy ceiling; and the wide-K form of K1 and K2
     against the plain form at 20000×30000;
  6. the sweep path: `pls_tpu_torch.tools.kernel_variants.sweep` at its
     default 65536×2048 and at 100000×5000, in f32 and in bf16, printing
     its tables (every variant beside the shipped kernel, the plain form
     and the copy ceiling), each row's err_p and err_tt against f64
     within its bound (SWEEP_RTOL); each of K3-K5 must launch;
  7. the statistics path at the north star's width: raw 50000×10000 X and
     10 Y (rank-30 latent data, column offsets of 0.5-3 σ) made on the
     card from --seed and written as .npy into a temporary directory
     under build/ (removed at exit); `stats_from_npy` (XᵀX, XᵀY held to
     f64 on the card, relative Frobenius ≤ 1e-4), `fit_streaming_npy`
     (A=20, zscore; coefficients against the f64 statistics' fit),
     `cv_kfold_npy` (k=10, A=20, zscore, residual pass; one-pass PRESS
     against Σ errors² at tests/test_binio.py's tolerances),
     `cv_loo_from_stats` over 1000 held-out rows (4 folds against explicit
     f64 downdated fits, 5e-3 of Y's scale) and `optimal_num_components`
     on the device-resident errors; prints the disk→card rate beside the
     file's read rate and the pinned host→device copy rate, the k-fold
     wall, LOO folds per second and the peak device memory.  This path
     runs none of K1-K5.

The K1/K2 launch counts are set to 0 just before phase 3 and read just
after phase 4; the K3-K5 counts just before and after phase 6; all of
them just before and after phase 7, where they stay 0.  The last
two lines of stdout are the kernels' JSON record (K1-K5; ms is the
back-to-back time per call, K1/K2 at 100000×5000, K3-K5 of the best
variant at 65536×2048 by the sweep's chain slope, timed again back to
back; K5's the faster of its two designs' best, timed in turns; each
with bound_ms, the larger of its bytes over 3.35 TB/s and its flops over
67 TFLOP/s f32, and library_ms) and {"ok": true, "device": {...}};
the card's nvidia-smi line is printed in phase 1.  Without a CUDA device,
or outside a checkout of the repo, the script exits non-zero and prints
neither.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
DATA = ROOT / "pls_tpu" / "data"

# float32 tolerances against the f64 goldens.  Coefficients and explained
# variance: the JAX package's f32 contract on its accelerator
# (tests/test_tpu_hw.py:155,162).  RMSE tables: 1e-3 relative, 50× the
# float32 deviation the port's own CPU float32 run shows on nir (2e-5).
COEF_RTOL = 5e-3
EV_ATOL = 1e-3
RMSE_RTOL = 1e-3
# phase 2: the TPU kernel's contract (tools/tpu_smoke.py:67)
KERNEL_RTOL = 1e-5
# phase 4: f32 vs f64 of the same fit; bf16 vs f32 (tests/test_bf16.py:59,67)
FIT_COEF_RTOL = 1e-3
FIT_EV_ATOL = 1e-4
BF16_COEF_RTOL = 2e-2
BF16_EV_ATOL = 2e-3

BIG = (100_000, 5_000)
# every (N, K) the main path hands the kernel: toy, nir, the real-size fit
MAIN_PATH_SHAPES = [(10, 15), (60, 401), BIG]
# K2's column-owning path: the sweep's shape, a ragged last tile, K = 8;
# then a bf16 K past it (row-staged) and a K past the staged form (wide)
KERNEL_SHAPES = [(130, 96), (300, 401), (4096, 5000), (65_536, 2_048), (4099, 5000), (1000, 8),
                 (1024, 16_384), (2048, 30_000)]
WIDE = (20_000, 30_000)  # K past the staged form: the two-pass wide-K form
# the published H100 SXM peaks the bound is taken against (700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# phase 6: the kernel-variant sweep's path
SWEEP = (65_536, 2_048)  # the sweep's default size
SWEEP_ITERS = 10
# (300, 401): K % 4 != 0, the scalar staging path
VARIANT_SHAPES = [(10, 15), (130, 96), (300, 401), (4096, 5000), SWEEP]
# the sweep's err_p and err_tt, against f64 of the float32 X: 1e-5 for the
# exact-f32 rows; K4 HIGH drops the lo·lo term, 2⁻¹⁶ of each product;
# DEFAULT rounds X, r and t to bf16, 2⁻⁹ each; with KV_BF16 every row sees
# X rounded to bf16.
SWEEP_RTOL = {"mxu_HIGH": 1e-4, "mxu_DEFAULT": 1e-2}
SWEEP_BF16_RTOL = 2.0 ** -8

# phase 7: the statistics path (BASELINE.json's 1M×10k north star, N cut to
# 50000), k-fold CV and 1000 LOO folds at A = 20
STATS = (50_000, 10_000, 10)
STATS_K, STATS_A, LOO_FOLDS, LOO_CHECKED = 10, 20, 1000, 4
STATS_CHUNK = 8192  # rows per chunk when writing the files
STATS_RTOL = 1e-4  # XᵀX, XᵀY: relative Frobenius error against f64
LOO_ATOL = 5e-3  # held-out errors, relative to Y's scale (σ = 1 after z-scoring)

# (kernel name, its source in pls_tpu_torch/csrc, the TPU kernel it
# replaces, the launch counters that are its launches)
KERNELS = [
    ("deflate_f32", "deflate.cu", "pls_tpu/ops/deflate.py:83", ("deflate_f32",)),
    ("deflate_bf16", "deflate.cu", "pls_tpu/ops/deflate.py:102", ("deflate_bf16",)),
    ("vpu_f32", "deflate_variants.cu", "tools/kernel_variants.py:72", ("vpu_f32",)),
    ("mxu_f32", "deflate_variants.cu", "tools/kernel_variants.py:153", ("mxu_f32",)),
    ("vpu_bf16", "deflate_variants.cu", "tools/kernel_variants.py:208",
     ("vpu_bf16", "cols_bf16")),
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


# ---------- reading the CLI's report ----------
def _matrix_after(lines: list[str], start: int) -> np.ndarray:
    rows = []
    for ln in lines[start:]:
        vals = ln.replace("(", " ").replace(",0)", " ").split()
        try:
            row = [float(v) for v in vals]
        except ValueError:
            break
        if not row:
            break
        rows.append(row)
    return np.asarray(rows)


def parse_report(text: str) -> dict:
    """The CLI's stderr report as arrays: state matrices, explained
    variance and SSE (A, M), and per CV method its RMSE (M, A) and optimal
    component counts (M,)."""
    lines = text.split("\n")
    out: dict = {}
    for label in ("P", "W", "R", "Q", "T", "coefficients"):
        out[label] = _matrix_after(lines, lines.index(f"{label}:") + 1)
    ev_pat = re.compile(r"^\s*\d+ components explained variance: (.*?)  - SSE: (.*)$")
    ev = [ev_pat.match(ln) for ln in lines]
    out["ev"] = np.asarray([[float(v) for v in m.group(1).split()] for m in ev if m])
    out["sse"] = np.asarray([[float(v) for v in m.group(2).split()] for m in ev if m])
    for method in ("LOO", "LSO"):
        if f"{method} Validation:" not in lines:
            continue
        i = lines.index(f"{method} Validation:") + 2
        rmse = _matrix_after(lines, i)
        j = i + len(rmse)
        first = lines[j].split("\t")[1]
        opt = [int(first)] + [int(v) for v in lines[j + 1 : j + len(rmse)]]
        out[method.lower() + "_rmse"] = rmse
        out[method.lower() + "_opt"] = np.asarray(opt)
    return out


def golden(name: str) -> np.ndarray:
    return np.loadtxt(GOLDEN / f"{name}.csv", delimiter=",", ndmin=2)


def golden_errors(report: dict, name: str) -> dict:
    """Errors of a parsed report against the reference's goldens."""
    B, Bg = report["coefficients"], golden(f"{name}_B")
    errs = {
        "coef_rel": float(np.abs(B - Bg).max() / np.abs(Bg).max()),
        "ev_abs": float(np.abs(report["ev"] - golden(f"{name}_ev")).max()),
    }
    for m in ("loo", "lso"):
        ref = golden(f"{name}_{m}_rmse")
        errs[f"{m}_rmse_rel"] = float(np.abs(report[f"{m}_rmse"] - ref).max() / np.abs(ref).max())
        errs[f"{m}_opt_equal"] = bool(
            np.array_equal(report[f"{m}_opt"], golden(f"{name}_{m}_opt").ravel().astype(int))
        )
    return errs


# ---------- phases ----------
def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_device(deflate, variants) -> None:
    print(nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    from pls_tpu_torch.utils.nvcc import library_path

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        for fut in [pool.submit(deflate.build), pool.submit(variants.build)]:
            fut.result()
    print(f"kernels build+load {time.perf_counter() - t0:.2f} s")
    for source in ("deflate.cu", "deflate_variants.cu"):
        print(f"  {library_path(source).name}")
        log = library_path(source).with_suffix(".log")
        if log.exists():
            for ln in log.read_text().splitlines():
                if "entry function" in ln or "registers" in ln or "spill" in ln:
                    print("  ptxas:", ln.strip())


def phase_kernel(deflate, dev, seed: int) -> dict:
    """Returns {kernel name: max |kernel - plain| of t and p over the shapes}."""
    abs_err = {"deflate_f32": 0.0, "deflate_bf16": 0.0}
    g = torch.Generator(dev).manual_seed(seed)
    for N, K in MAIN_PATH_SHAPES + KERNEL_SHAPES:
        X32 = torch.randn((N, K), generator=g, device=dev)
        r = torch.randn(K, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            X = X32.to(dtype)
            name = deflate.kernel_name(dtype)
            before = dict(deflate.path_launches)
            t, tt, p = deflate.deflate_pass_cuda(X, r)
            t2, tt2, p2 = deflate.deflate_pass_cuda(X, r)
            torch.cuda.synchronize()
            path = [k for k, v in deflate.path_launches.items() if v != before[k]]
            check(path == [deflate.plan_for(X, r).path], f"{name} {N}x{K}: launched {path}")
            check(torch.equal(t, t2) and torch.equal(p, p2) and torch.equal(tt, tt2),
                  f"{name} {N}x{K}: two launches differ")
            tp, ttp, pp = deflate.deflate_pass_plain(X, r)
            Xd, rd = X.double(), r.double()  # f64 truth of the stored (rounded) X
            td = Xd @ rd
            pd = Xd.T @ td
            ttd = td @ td
            del Xd
            e_p, e_t = rel_err(p, pd), rel_err(t, td)
            e_tt = abs(float(tt) - float(ttd)) / float(ttd)
            q_p, q_t = rel_err(p, pp), rel_err(t, tp)
            q_tt = abs(float(tt) - float(ttp)) / float(ttp)
            print(f"{name} {N}x{K} {path[0]} {deflate.plan_for(X, r)}: "
                  f"vs f64 rel p {e_p:.3e} tt {e_tt:.3e} t {e_t:.3e}; "
                  f"vs plain rel p {q_p:.3e} tt {q_tt:.3e} t {q_t:.3e}; "
                  f"bit-identical relaunch")
            check(tuple(t.shape) == (N,) and tuple(p.shape) == (K,) and tt.dim() == 0,
                  f"{name}: output shapes")
            check(max(e_p, e_tt, e_t) <= KERNEL_RTOL,
                  f"{name} {N}x{K}: vs f64 rel err p {e_p:.2e} tt {e_tt:.2e} t {e_t:.2e} "
                  f"> {KERNEL_RTOL}")
            check(max(q_p, q_tt, q_t) <= KERNEL_RTOL,
                  f"{name} {N}x{K}: vs plain rel err p {q_p:.2e} tt {q_tt:.2e} t {q_t:.2e} "
                  f"> {KERNEL_RTOL}")
            abs_err[name] = max(abs_err[name],
                                float(max((p - pp).abs().max(), (t - tp).abs().max())))
        del X32
    torch.cuda.empty_cache()
    return abs_err


def run_cli(args: list[str]) -> str:
    from pls_tpu_torch.cli import main as cli_main

    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli_main(args)
    check(rc == 0, f"CLI {args} exited {rc}:\n{err.getvalue()[-2000:]}")
    check(out.getvalue() == "", "CLI wrote to stdout")
    return err.getvalue()


def phase_cli(deflate) -> dict:
    walls = {}
    for name, xf, yf, A in [
        ("nir", "nir.csv", "octane.csv", 10),
        ("toy", "toyX.csv", "toyY.csv", 2),
    ]:
        before = dict(deflate.launches)
        t0 = time.perf_counter()
        text = run_cli([str(DATA / xf), str(DATA / yf), str(A)])
        walls[name] = time.perf_counter() - t0
        d32 = deflate.launches["deflate_f32"] - before["deflate_f32"]
        d16 = deflate.launches["deflate_bf16"] - before["deflate_bf16"]
        errs = golden_errors(parse_report(text), name)
        print(f"cli {name} A={A}: wall {walls[name]:.3f} s, launches f32 {d32} bf16 {d16}, "
              f"vs golden {json.dumps(errs)}")
        check(d32 == A and d16 == 0, f"cli {name}: {d32} f32 launches, expected {A}")
        check(errs["coef_rel"] <= COEF_RTOL, f"cli {name}: coefficients {errs['coef_rel']:.2e}")
        check(errs["ev_abs"] <= EV_ATOL, f"cli {name}: explained variance {errs['ev_abs']:.2e}")
        for m in ("loo", "lso"):
            check(errs[f"{m}_rmse_rel"] <= RMSE_RTOL,
                  f"cli {name}: {m} RMSE {errs[f'{m}_rmse_rel']:.2e}")
            check(errs[f"{m}_opt_equal"], f"cli {name}: {m} optimal components differ")
    return walls


def make_big(dev, seed: int):
    """100000×5000 X, 10 Y: a rank-30 latent model plus noise, z-scored."""
    from pls_tpu_torch.ops.stats import colwise_z_scores

    N, K = BIG
    g = torch.Generator(dev).manual_seed(seed)
    lat = torch.randn((N, 30), generator=g, device=dev)
    X = lat @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = lat @ torch.randn((30, 10), generator=g, device=dev)
    Y += 0.1 * torch.randn((N, 10), generator=g, device=dev)
    return colwise_z_scores(X), colwise_z_scores(Y)


def fit_big(X, Y, **kw):
    from pls_tpu_torch.model import PLSModel

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = PLSModel(X, Y, max_components=20, **kw)
    B, ev = m.coefficients(), m.explained_variance()
    torch.cuda.synchronize()
    return m, B, ev, time.perf_counter() - t0


def phase_big(deflate, dev, seed: int) -> float:
    X, Y = make_big(dev, seed)
    before = dict(deflate.launches)
    m32, B32, ev32, wall = fit_big(X, Y)
    d32 = deflate.launches["deflate_f32"] - before["deflate_f32"]
    check(d32 == 20, f"100k×5k f32 fit: {d32} launches, expected 20")
    check(tuple(B32.shape) == (5000, 10) and bool(torch.isfinite(B32).all())
          and tuple(m32.T.shape) == (100_000, 20), "100k×5k f32 fit: shapes / non-finite")
    _, B64, ev64, wall64 = fit_big(X.double(), Y.double())
    check(deflate.launches["deflate_f32"] - before["deflate_f32"] == 20,
          "f64 fit launched the kernel")
    e_b, e_ev = rel_err(B32, B64), float((ev32.double() - ev64).abs().max())
    print(f"100k×5k×10 A=20 f32: wall {wall:.3f} s (first fit), launches {d32}; "
          f"vs f64 (plain path, wall {wall64:.3f} s): coef rel {e_b:.3e}, ev abs {e_ev:.3e}")
    check(e_b <= FIT_COEF_RTOL and e_ev <= FIT_EV_ATOL, "100k×5k f32 fit disagrees with f64")
    del B64, ev64
    before, cols_before = dict(deflate.launches), deflate.path_launches["cols"]
    _, B16, ev16, wall16 = fit_big(X, Y, x_storage="bf16")
    d16 = deflate.launches["deflate_bf16"] - before["deflate_bf16"]
    d_cols = deflate.path_launches["cols"] - cols_before
    e_b16, e_ev16 = rel_err(B16, B32), float((ev16 - ev32).abs().max())
    print(f"100k×5k×10 A=20 bf16 storage: wall {wall16:.3f} s, launches {d16} ({d_cols} on the "
          f"cols path); vs f32: coef rel {e_b16:.3e}, ev abs {e_ev16:.3e}")
    check(d16 == 20 and d_cols == 20, f"bf16 fit: {d16} launches, {d_cols} cols, expected 20")
    check(e_b16 <= BF16_COEF_RTOL and e_ev16 <= BF16_EV_ATOL, "bf16 fit outside its budget")
    walls = {"f32": [], "bf16": []}
    for storage in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):  # in turns
        walls[storage].append(fit_big(X, Y, **({"x_storage": "bf16"} if storage == "bf16"
                                              else {}))[3])
    fit_walls = {k: statistics.median(v) for k, v in walls.items()}
    for k, v in walls.items():
        print(f"100k×5k×10 A=20 {k} fit wall, warm: median {fit_walls[k]:.4f} s "
              f"of {[round(w, 4) for w in v]}")
    return fit_walls


def times_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 1) -> list[float]:
    """CUDA-event times of `inner` calls of fn back to back, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return times


def median_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 1) -> float:
    return statistics.median(times_ms(fn, reps, warmup, inner))


def bound(N: int, K: int, itemsize: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one pass on the
    published H100 SXM peaks, X and r read once, t, p and tt written once,
    against 4·N·K + 2·K f32 flops."""
    byte_ms = (N * K * itemsize + 4 * (2 * K + N + 1)) / HBM_BYTES_PER_S * 1e3
    flop_ms = (4 * N * K + 2 * K) / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def library_pass(X: torch.Tensor, r: torch.Tensor):
    """The two library products of the pass: t = X r, p = Xᵀt; on bf16 X
    with r and t rounded to bf16 (cuBLAS has no bf16 × f32 product)."""
    rr = r.to(X.dtype)
    t = X @ rr
    return t, X.T @ t


def phase_timing(deflate, dev, seed: int) -> dict:
    """{kernel name: (ms, plain ms, library ms, bound ms, bound_by)} of K1
    and K2 at 100000×5000."""
    N, K = BIG
    g = torch.Generator(dev).manual_seed(seed + 1)
    X = torch.randn((N, K), generator=g, device=dev)
    Xb = X.to(torch.bfloat16)
    r = torch.randn(K, generator=g, device=dev)
    check(deflate.plan_for(Xb, r).path == "cols" and deflate.staged_plan_for(Xb, r).path
          == "staged", f"K2 {N}x{K}: the two designs are not planned")
    designs = {"K1": lambda: deflate.deflate_pass_cuda(X, r),
               "K2 cols": lambda: deflate.deflate_pass_cuda(Xb, r),
               "K2 staged": lambda: deflate._launch(Xb, r, deflate.staged_plan_for)}
    one, b2b = {k: [] for k in designs}, {k: [] for k in designs}
    # K2's two designs in turns: cols, staged, staged, cols
    for key in ("K1", "K2 cols", "K2 staged", "K2 staged", "K2 cols"):
        one[key] += times_ms(designs[key])
        b2b[key] += times_ms(designs[key], reps=5, inner=10)
    out = {}
    for name, XX, key in (("deflate_f32", X, "K1"), ("deflate_bf16", Xb, "K2 cols")):
        plain_ms = median_ms(lambda: deflate.deflate_pass_plain(XX, r))
        lib_ms = median_ms(lambda: library_pass(XX, r))
        b_ms, b_by = bound(N, K, XX.element_size())
        out[name] = (statistics.median(b2b[key]), plain_ms, lib_ms, b_ms, b_by)
        print(f"{name} {N}x{K} {deflate.plan_for(XX, r)}: bound {b_ms:.4f} ms ({b_by}); plain "
              f"{plain_ms:.4f} ms; library (two {'bf16' if XX.element_size() == 2 else 'f32'} "
              f"products) {lib_ms:.4f} ms")
    for key in designs:
        XX = X if key == "K1" else Xb
        b_ms = bound(N, K, XX.element_size())[0]
        ms, ms2 = statistics.median(one[key]), statistics.median(b2b[key])
        gbs = N * K * XX.element_size() / ms2 / 1e6
        print(f"{key} {N}x{K}: one call {ms:.4f} ms (spread {min(one[key]):.4f}-"
              f"{max(one[key]):.4f}), back to back {ms2:.4f} ms per call (spread "
              f"{min(b2b[key]):.4f}-{max(b2b[key]):.4f}) = {gbs:.1f} GB/s one-pass; "
              f"{b_ms / ms:.3f} / {b_ms / ms2:.3f} of the bound")
    gain = [statistics.median(d["K2 staged"]) / statistics.median(d["K2 cols"]) for d in (one, b2b)]
    print(f"K2 cols vs staged at {N}x{K}: {gain[0]:.3f}x (one call), {gain[1]:.3f}x (back to "
          f"back) faster")
    dst = torch.empty_like(X)
    copy_ms = median_ms(lambda: dst.copy_(X))
    print(f"device-to-device copy of {4 * N * K} B: {copy_ms:.4f} ms = "
          f"{2 * 4 * N * K / copy_ms / 1e6:.1f} GB/s (read + write)")
    del X, Xb, dst
    torch.cuda.empty_cache()
    N, K = WIDE
    X = torch.randn((N, K), generator=g, device=dev)
    r = torch.randn(K, generator=g, device=dev)
    for Xw in (X, X.to(torch.bfloat16)):
        ms = median_ms(lambda: deflate.deflate_pass_cuda(Xw, r))
        plain_ms = median_ms(lambda: deflate.deflate_pass_plain(Xw, r))
        nbytes = N * K * Xw.element_size()
        print(f"{deflate.kernel_name(Xw.dtype)} wide-K {N}x{K}: kernel {ms:.4f} ms = "
              f"{nbytes / ms / 1e6:.1f} GB/s one-pass; plain {plain_ms:.4f} ms = "
              f"{nbytes / plain_ms / 1e6:.1f} GB/s one-pass")
    return out


def _fmt(errs) -> str:
    return "/".join(f"{e:.2e}" for e in errs)


def _rel3(out, ref) -> tuple[float, float, float]:
    """Relative errors of (t, p, tt) against a reference triple."""
    (t, tt, p), (tr, ttr, pr) = out, ref
    return rel_err(t, tr), rel_err(p, pr), abs(float(tt) - float(ttr)) / abs(float(ttr))


def phase_variants(dv, kv, dev, seed: int) -> dict:
    """Every variant of the sweep's default lists against its plain version
    and f64 truth, with a bit-identical relaunch.  Returns {kernel name:
    max |kernel - plain| of t and p}."""
    abs_err = {name: 0.0 for name in dv.launches}
    variants = kv.default_variants(False) + kv.default_variants(True)
    g = torch.Generator(dev).manual_seed(seed + 2)
    for N, K in VARIANT_SHAPES:
        X32 = torch.randn((N, K), generator=g, device=dev)
        r = torch.randn(K, generator=g, device=dev)
        truth = {}
        for dtype in (torch.float32, torch.bfloat16):
            Xd = X32.to(dtype).double()  # f64 truth of the stored (rounded) X
            td = Xd @ r.double()
            truth[dtype] = (td, td @ td, Xd.T @ td)
            del Xd
        worst = [0.0] * 6  # VPU forms: t, p, tt vs plain, then vs f64
        for v in variants:
            prec = getattr(v, "prec", None)  # K4's; the column-owning rows have none
            X = X32.to(v.dtype)
            if not v.takes(X):  # cols_bf16 at K % 8 != 0: refuses, never falls back
                try:
                    v.cuda(X, r)
                except ValueError:
                    continue
                raise SmokeFailure(f"{v.name} {N}x{K}: ran a shape it does not take")
            out = v.cuda(X, r)
            again = v.cuda(X, r)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"{v.name} {N}x{K}: two launches differ")
            check(tuple(out[0].shape) == (N,) and tuple(out[2].shape) == (K,)
                  and out[1].dim() == 0 and all(o.dtype == torch.float32 for o in out),
                  f"{v.name} {N}x{K}: output shapes / dtypes")
            plain = v.plain(X, r)
            q = _rel3(out, plain)
            e = _rel3(out, truth[v.dtype])
            budget = KERNEL_RTOL
            if prec in ("DEFAULT", "HIGH"):
                # against f64: within 10× the error of the plain emulation itself
                budget = 10 * max(_rel3(plain, truth[v.dtype]))
            if prec:
                # K4's p against the plain second product on the kernel's own t
                # (see mxu_plain_p); at DEFAULT the whole chain's p is printed
                # only, as a last-bit flip of tᵢ can move its bf16 rounding
                p_own = dv.mxu_plain_p(X, out[0], prec)
                q_own = rel_err(out[2], p_own)
                check(max(q[0], q_own, q[2]) <= KERNEL_RTOL,
                      f"{v.name} {N}x{K}: vs plain rel err t {q[0]:.2e} p (own t) "
                      f"{q_own:.2e} tt {q[2]:.2e} > {KERNEL_RTOL}")
                line = f"p on own t {q_own:.2e}"
                if prec == "DEFAULT":
                    # the check's power: p with t left unrounded (a kernel that
                    # skips t's bf16 re-rounding) must fall outside the bound
                    ctrl = rel_err(X.to(torch.bfloat16).float().T @ out[0], p_own)
                    check(ctrl > KERNEL_RTOL, f"{v.name} {N}x{K}: control {ctrl:.2e} "
                          f"within {KERNEL_RTOL}: the p check cannot see t's rounding")
                    line += f", control (t not re-rounded) {ctrl:.2e}"
                else:
                    check(q[1] <= KERNEL_RTOL,
                          f"{v.name} {N}x{K}: vs plain rel err p {q[1]:.2e} > {KERNEL_RTOL}")
                print(f"  {v.name} {N}x{K}: rel err t/p/tt vs plain {_fmt(q)}, {line}, "
                      f"vs f64 {_fmt(e)} (budget {budget:.3e})")
                del p_own
            else:
                check(max(q) <= KERNEL_RTOL,
                      f"{v.name} {N}x{K}: vs plain rel err t/p/tt {_fmt(q)} > {KERNEL_RTOL}")
                worst = [max(w, a) for w, a in zip(worst, q + e)]
            check(max(e) <= budget,
                  f"{v.name} {N}x{K}: vs f64 rel err t/p/tt {_fmt(e)} > {budget:.3e}")
            abs_err[v.kind] = max(abs_err[v.kind], float(max(
                (out[0] - plain[0]).abs().max(), (out[2] - plain[2]).abs().max())))
            del X, out, again, plain
        print(f"variants {N}x{K}: {len(variants)} variants, bit-identical relaunches; "
              f"VPU forms' largest rel err t/p/tt vs plain {_fmt(worst[:3])}, "
              f"vs f64 {_fmt(worst[3:])}")
        del X32, truth
        torch.cuda.empty_cache()
    return abs_err


def phase_sweep(kv, seed: int) -> dict:
    """The sweep at its default size in f32 and bf16 and at the repo's full
    size; returns {(n, k, bf16): rows}."""
    tables = {}
    for (n, k), bf16 in [(SWEEP, False), (SWEEP, True), (BIG, False), (BIG, True)]:
        rows = kv.sweep(n, k, SWEEP_ITERS, bf16, seed)
        failed = [row["name"] for row in rows if "error" in row]
        check(not failed, f"sweep {n}x{k} bf16={bf16}: {failed} failed")
        for row in rows[1:]:  # all but the copy: err_p, err_tt against f64 of the f32 X
            tol = SWEEP_BF16_RTOL if bf16 else SWEEP_RTOL.get(row["name"].split("_r")[0],
                                                              KERNEL_RTOL)
            check(max(row["err_p"], row["err_tt"]) <= tol,
                  f"sweep {n}x{k} {row['name']}: err_p {row['err_p']:.2e} "
                  f"err_tt {row['err_tt']:.2e} > {tol}")
        tables[(n, k, bf16)] = rows
        torch.cuda.empty_cache()
    return tables


def best_variant_times(dv, kv, tables: dict, dev, seed: int) -> dict:
    """{kernel name: (ms, its plain version's ms, the library products' ms,
    bound ms, bound_by)} at the sweep's default size.  Each kernel's best
    variant by the sweep's chain slope is timed again back to back (10
    calls per event pair): the chain slope carries the host's time per
    chained step.  K5's best row-staged and best column-owning variants
    are timed in turns, and its ms is the faster one's."""
    out = {}
    n, k = SWEEP
    g = torch.Generator(dev).manual_seed(seed + 3)
    X32 = torch.randn((n, k), generator=g, device=dev)
    r = torch.randn(k, generator=g, device=dev)
    for name, prefixes in (("vpu_f32", ("vpu_1k_",)), ("mxu_f32", ("mxu_",)),
                           ("vpu_bf16", ("vpu_bf16_", "cols_bf16_"))):
        bf16 = name == "vpu_bf16"
        variants = {v.name: v for v in kv.default_variants(bf16)}
        best = {}
        for prefix in prefixes:
            rows = [row for row in tables[(n, k, bf16)] if row["name"].startswith(prefix)]
            row = min(rows, key=lambda row: row["ms"])
            best[row["name"]] = (variants[row["name"]], row["ms"])
        X = X32.to(torch.bfloat16 if bf16 else torch.float32)
        times = {v_name: [] for v_name in best}
        order = list(best) + list(best)[::-1]  # in turns: a, b, b, a
        for v_name in order:
            v = best[v_name][0]
            times[v_name] += times_ms(lambda: v.cuda(X, r), reps=5, inner=10)
        ms = {v_name: statistics.median(t) for v_name, t in times.items()}
        b_ms, b_by = bound(n, k, X.element_size())
        for v_name, t in times.items():
            print(f"{name}: {v_name} at {n}x{k}: back to back {ms[v_name]:.4f} ms per call "
                  f"(spread {min(t):.4f}-{max(t):.4f}; chain slope {best[v_name][1]:.4f}), "
                  f"{b_ms / ms[v_name]:.3f} of the {b_ms:.4f} ms bound ({b_by})")
        fastest = min(ms, key=ms.get)
        v = best[fastest][0]
        out[name] = (ms[fastest], median_ms(lambda: v.plain(X, r)),
                     median_ms(lambda: library_pass(X, r)), b_ms, b_by)
        print(f"{name}: best variant at {n}x{k} {fastest} {ms[fastest]:.4f} ms; its plain "
              f"version {out[name][1]:.4f} ms; library (two {'bf16' if bf16 else 'f32'} "
              f"products) {out[name][2]:.4f} ms")
    return out


def make_stats_data(dev, seed: int):
    """Raw 50000×10000 X and 10 Y on the card: make_big's rank-30 latent
    model plus noise, with column offsets of 0.5-3 column σ."""
    N, K, M = STATS
    g = torch.Generator(dev).manual_seed(seed + 7)
    lat = torch.randn((N, 30), generator=g, device=dev)
    X = lat @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = lat @ torch.randn((30, M), generator=g, device=dev)
    Y += 0.1 * torch.randn((N, M), generator=g, device=dev)
    for T in (X, Y):
        T += (0.5 + 2.5 * torch.rand(T.shape[1], generator=g, device=dev)) * T.std(0)
    return X, Y


def f64_stats(X, Y, chunk: int = 4096):
    """XᵀX, XᵀY, YᵀY and the column sums in float64 on the card, in chunks."""
    K, M = X.shape[1], Y.shape[1]
    XX = torch.zeros((K, K), dtype=torch.float64, device=X.device)
    XY = torch.zeros((K, M), dtype=torch.float64, device=X.device)
    YY = torch.zeros((M, M), dtype=torch.float64, device=X.device)
    sx = torch.zeros(K, dtype=torch.float64, device=X.device)
    sy = torch.zeros(M, dtype=torch.float64, device=X.device)
    for i in range(0, X.shape[0], chunk):
        x, y = X[i : i + chunk].double(), Y[i : i + chunk].double()
        XX.addmm_(x.T, x)
        XY.addmm_(x.T, y)
        YY.addmm_(y.T, y)
        sx += x.sum(0)
        sy += y.sum(0)
    return XX, XY, YY, sx, sy


def fro_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))


def synced_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fsync(path: str) -> None:
    """Flush a written file to the disk, so that a later read does not
    wait on its write-back."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def direct_io_ok(path: str) -> bool:
    try:
        os.close(os.open(path, os.O_RDONLY | os.O_DIRECT))
        return True
    except OSError:
        return False


def phase_stats(dev, seed: int) -> dict:
    """The statistics path on the card (phase 7).  Returns its measurements."""
    from pls_tpu_torch.cv.kfold import kfold_assignments
    from pls_tpu_torch.cv.loo import cv_loo_from_stats
    from pls_tpu_torch.cv.validation import optimal_num_components
    from pls_tpu_torch.models.kernel_pls import fit_from_stats
    from pls_tpu_torch.models.predict import coefficients, residuals_all_components
    from pls_tpu_torch.models.streaming import zscore_stats
    from pls_tpu_torch.utils import binio

    N, K, M = STATS
    A = STATS_A
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    X, Y = make_stats_data(dev, seed)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stats_", dir=ROOT / "build"))
    try:
        xp, yp = str(tmp / "X.npy"), str(tmp / "Y.npy")
        _, wall_w = synced_wall(lambda: (
            binio.write_npy_chunked(xp, (X[i : i + STATS_CHUNK] for i in range(0, N, STATS_CHUNK))),
            binio.write_npy_chunked(yp, [Y]), fsync(xp), fsync(yp)))
        xbytes = os.path.getsize(xp)
        direct = direct_io_ok(xp)
        chunk_rows = binio.auto_chunk_rows(torch.float32)
        # the file's read rate (pooled pinned reader, no copies) and the
        # pinned host→device copy rate of one chunk
        t0 = time.perf_counter()
        for _ in binio.stream_npy(xp, chunk_rows, reuse_buffers=True, pin_memory=True):
            pass
        read_gbs = xbytes / (time.perf_counter() - t0) / 1e9
        host = torch.empty((chunk_rows, K), pin_memory=True)
        devbuf = torch.empty((chunk_rows, K), device=dev)
        h2d_ms = median_ms(lambda: devbuf.copy_(host, non_blocking=True), reps=9, warmup=2)
        h2d_gbs = host.numel() * 4 / h2d_ms / 1e6
        del host, devbuf
        print(f"stats data {N}x{K}x{M} f32: X file {xbytes} B written and synced in {wall_w:.3f} s "
              f"(O_DIRECT {'yes' if direct else 'no, buffered'}); read rate "
              f"{read_gbs:.3f} GB/s; pinned host->device {h2d_gbs:.3f} GB/s "
              f"({h2d_ms:.4f} ms per {chunk_rows}-row chunk)")

        # the stats pass, held to f64 on the card
        acc, wall_s = synced_wall(lambda: binio.stats_from_npy(
            xp, yp, device=dev, stats_precision="highest"))
        XX64, XY64, YY64, sx64, sy64 = f64_stats(X, Y)
        e_xx, e_xy = fro_rel(acc.XX, XX64), fro_rel(acc.XY, XY64)
        stats_gbs = (xbytes + os.path.getsize(yp)) / wall_s / 1e9
        print(f"stats_from_npy: {wall_s:.3f} s = {stats_gbs:.3f} GB/s disk->card; XX rel Frobenius "
              f"{e_xx:.3e}, XY {e_xy:.3e} vs f64 on the card (bound {STATS_RTOL})")
        check(acc.n == N and e_xx <= STATS_RTOL and e_xy <= STATS_RTOL,
              f"stats pass: n {acc.n}, XX {e_xx:.2e}, XY {e_xy:.2e} > {STATS_RTOL}")
        devices = {acc.XX.device.type, acc.XY.device.type}
        del acc

        # the streamed fit (A = 20, z-scored in closed form) against the fit
        # from the f64 statistics
        Z64 = zscore_stats(XX64, XY64, sx64, sy64, N, YY=YY64)
        del XX64, XY64
        fit, wall_f = synced_wall(lambda: binio.fit_streaming_npy(
            xp, yp, A, device=dev, zscore=True))
        B32 = coefficients(fit)
        B64 = coefficients(fit_from_stats(Z64[0], Z64[1], A))
        e_b = rel_err(B32, B64)
        print(f"fit_streaming_npy A={A} zscore: wall {wall_f:.3f} s; coef rel {e_b:.3e} vs the f64 "
              f"statistics' fit (bound {FIT_COEF_RTOL})")
        check(tuple(B32.shape) == (K, M) and bool(torch.isfinite(B32).all()),
              "streamed fit: shape / non-finite")
        check(e_b <= FIT_COEF_RTOL, f"streamed fit: coef rel {e_b:.2e} > {FIT_COEF_RTOL}")
        devices.add(B32.device.type)
        del fit, B32, B64

        # k-fold CV from the files: two passes, errors kept on the card
        assign = kfold_assignments(N, STATS_K, seed)
        (summary, res), wall_k = synced_wall(lambda: binio.cv_kfold_npy(
            xp, yp, A, k=STATS_K, assignments=assign, zscore=True, residual_pass=True,
            device=dev))
        check(tuple(res.errors.shape) == (M, N, A) and bool(torch.isfinite(res.errors).all()),
              "k-fold: errors shape / non-finite")
        press_res = (res.errors.double() ** 2).sum(1).cpu().numpy()
        energy = float(N - 1)  # Σ y² of a z-scored column
        gap = np.abs(summary.press - press_res)
        worst = float((gap / (2e-4 * np.abs(press_res) + 1e-5 * energy)).max())
        opt, wall_o = synced_wall(lambda: optimal_num_components(res))
        print(f"cv_kfold_npy k={STATS_K} A={A} zscore: wall {wall_k:.3f} s (stats pass, closed "
              f"form, residual pass); PRESS one-pass vs Σ errors² max gap {float(gap.max()):.4e} "
              f"({worst:.3f} of the bound); RMSE at A=1/{A} "
              f"{summary.rmse[:, 0].round(4).tolist()} / {summary.rmse[:, -1].round(4).tolist()}; "
              f"optimal components {opt.tolist()} ({wall_o:.3f} s on the device errors)")
        check(worst <= 1.0, "k-fold: one-pass PRESS disagrees with the residual pass")
        check(bool(((opt >= 1) & (opt <= A)).all()), "k-fold: optimal components out of range")
        devices |= {summary.B.device.type, res.errors.device.type, opt.device.type}
        del summary, res

        # LOO over 1000 held-out rows from the (z-scored) statistics
        acc = binio.stats_from_npy(xp, yp, device=dev, stats_precision="highest")
        XXz, XYz, _, mx, sdx, my, sdy = acc.zscored()
        del acc
        rows = torch.arange(LOO_FOLDS, device=dev)
        fx, fy = (X[rows] - mx) / sdx, (Y[rows] - my) / sdy
        loo, wall_l = synced_wall(lambda: cv_loo_from_stats(XXz, XYz, fx, fy, A))
        del XXz, XYz
        check(tuple(loo.errors.shape) == (M, LOO_FOLDS, A) and bool(torch.isfinite(loo.errors).all()),
              "LOO: errors shape / non-finite")
        mx64, sdx64, my64, sdy64 = Z64[3:]
        worst_loo = 0.0
        for i in range(LOO_CHECKED):
            x = (X[i].double() - mx64) / sdx64
            y = (Y[i].double() - my64) / sdy64
            f64 = fit_from_stats(Z64[0] - torch.outer(x, x), Z64[1] - torch.outer(x, y), A)
            ref = residuals_all_components(f64, x[None], y[None])[0]  # (A, M)
            worst_loo = max(worst_loo, float((loo.errors[:, i, :].T.double() - ref).abs().max()))
        print(f"cv_loo_from_stats {LOO_FOLDS} folds A={A}: wall {wall_l:.3f} s = "
              f"{LOO_FOLDS / wall_l:.1f} folds/s; {LOO_CHECKED} folds vs explicit f64 downdated "
              f"fits: max |err| {worst_loo:.3e} (bound {LOO_ATOL})")
        check(worst_loo <= LOO_ATOL, f"LOO: {worst_loo:.2e} > {LOO_ATOL} against f64")
        devices.add(loo.errors.device.type)
        check(devices == {"cuda"}, f"phase 7 tensors on {devices}")
        peak = torch.cuda.max_memory_allocated()
        print(f"phase 7 peak device memory {peak} B ({peak / 2**30:.2f} GiB); {nvidia_smi()}")
        return {"write_s": wall_w, "read_gbs": read_gbs, "h2d_gbs": h2d_gbs, "stats_s": wall_s,
                "stats_gbs": stats_gbs, "kfold_s": wall_k, "loo_per_s": LOO_FOLDS / wall_l,
                "peak_bytes": peak}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del X, Y
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import pls_tpu_torch
    from pls_tpu_torch.ops import deflate, deflate_variants as dv
    from pls_tpu_torch.tools import kernel_variants as kv

    check(Path(pls_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"pls_tpu_torch imported from {pls_tpu_torch.__file__}, not this checkout")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_device(deflate, dv)
    abs_err = phase_kernel(deflate, dev, args.seed)
    abs_err.update(phase_variants(dv, kv, dev, args.seed))

    for counts in (deflate.launches, deflate.path_launches):  # the main path's run starts here
        for k in counts:
            counts[k] = 0
    cli_walls = phase_cli(deflate)
    fit_walls = phase_big(deflate, dev, args.seed)
    launches = dict(deflate.launches)  # ... and ends here
    print(f"main path launches: {launches}, by path {deflate.path_launches}; cli walls "
          f"{cli_walls}; 20-component fit walls {fit_walls}")
    check(all(v > 0 for v in launches.values()), "a kernel of the path never launched")

    times = phase_timing(deflate, dev, args.seed)

    for k in dv.launches:  # the sweep path's run starts here
        dv.launches[k] = 0
    tables = phase_sweep(kv, args.seed)
    sweep_launches = dict(dv.launches)  # ... and ends here
    print(f"sweep path launches: {sweep_launches}")
    check(all(v > 0 for v in sweep_launches.values()), "a kernel of the sweep never launched")
    launches.update(sweep_launches)
    times.update(best_variant_times(dv, kv, tables, dev, args.seed))

    for counts in (deflate.launches, dv.launches):  # the stats path's run starts here
        for k in counts:
            counts[k] = 0
    stats = phase_stats(dev, args.seed)
    stats_launches = {**deflate.launches, **dv.launches}  # ... and ends here
    print(f"stats path launches: {stats_launches} (the path runs none of K1-K5); "
          f"{json.dumps(stats)}")

    check("jax" not in sys.modules and "pls_tpu" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"pls_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": sum(launches[c] for c in counters),
         "max_abs_err": max(abs_err[c] for c in counters), "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][3], "bound_by": times[name][4],
         "library_ms": times[name][2]}
        for name, source, replaces, counters in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
