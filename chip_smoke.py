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
     100000×5000) and at (130, 96), (300, 401), (4096, 5000) and a K too
     wide for the staged form (2048, 30000); relative error of t, p and
     tt ≤ 1e-5 against both, and two launches bit-identical; then every
     variant of the kernel-variant sweep's default lists (K3, K4 at
     DEFAULT/HIGH/HIGHEST, K5) against its plain version and f64 at
     10×15, 130×96, 300×401 (scalar staging), 4096×5000 and 65536×2048,
     two launches bit-identical: K3, K5 and K4-HIGHEST ≤ 1e-5 against
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
     x_storage="bf16" against f32 within the bf16 budget;
  5. timing with CUDA events (median of 25 after warm-up) at 100000×5000:
     K1, K2, the plain two-product form in f32 and in bf16-upcast, the
     card's device-to-device copy ceiling, and the 20-component fit; and
     the wide-K form of K1 and K2 against the plain form at 20000×30000;
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
two lines of stdout are the kernels' JSON record (K1-K5; K3-K5's ms is
the best variant's at 65536×2048) and {"ok": true, "device": {...}};
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
WIDE = (20_000, 30_000)  # K past the staged form: the two-pass wide-K form
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

# (kernel name, its source in pls_tpu_torch/csrc, the TPU kernel it replaces)
KERNELS = [
    ("deflate_f32", "deflate.cu", "pls_tpu/ops/deflate.py:83"),
    ("deflate_bf16", "deflate.cu", "pls_tpu/ops/deflate.py:102"),
    ("vpu_f32", "deflate_variants.cu", "tools/kernel_variants.py:72"),
    ("mxu_f32", "deflate_variants.cu", "tools/kernel_variants.py:153"),
    ("vpu_bf16", "deflate_variants.cu", "tools/kernel_variants.py:208"),
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
    for N, K in MAIN_PATH_SHAPES + [(130, 96), (300, 401), (4096, 5000), (2048, 30_000)]:
        X32 = torch.randn((N, K), generator=g, device=dev)
        r = torch.randn(K, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            X = X32.to(dtype)
            name = deflate.kernel_name(dtype)
            t, tt, p = deflate.deflate_pass_cuda(X, r)
            t2, tt2, p2 = deflate.deflate_pass_cuda(X, r)
            torch.cuda.synchronize()
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
            print(f"{name} {N}x{K}: vs f64 rel p {e_p:.3e} tt {e_tt:.3e} t {e_t:.3e}; "
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
    before = dict(deflate.launches)
    _, B16, ev16, wall16 = fit_big(X, Y, x_storage="bf16")
    d16 = deflate.launches["deflate_bf16"] - before["deflate_bf16"]
    e_b16, e_ev16 = rel_err(B16, B32), float((ev16 - ev32).abs().max())
    print(f"100k×5k×10 A=20 bf16 storage: wall {wall16:.3f} s, launches {d16}; "
          f"vs f32: coef rel {e_b16:.3e}, ev abs {e_ev16:.3e}")
    check(d16 == 20, f"bf16 fit: {d16} launches, expected 20")
    check(e_b16 <= BF16_COEF_RTOL and e_ev16 <= BF16_EV_ATOL, "bf16 fit outside its budget")
    walls = [fit_big(X, Y)[3] for _ in range(3)]
    print(f"100k×5k×10 A=20 f32 fit wall, warm: median {statistics.median(walls):.4f} s "
          f"of {[round(w, 4) for w in walls]}")
    return statistics.median(walls)


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_timing(deflate, dev, seed: int) -> dict:
    N, K = BIG
    g = torch.Generator(dev).manual_seed(seed + 1)
    X = torch.randn((N, K), generator=g, device=dev)
    Xb = X.to(torch.bfloat16)
    r = torch.randn(K, generator=g, device=dev)
    out = {
        "deflate_f32": (median_ms(lambda: deflate.deflate_pass_cuda(X, r)),
                        median_ms(lambda: deflate.deflate_pass_plain(X, r))),
        "deflate_bf16": (median_ms(lambda: deflate.deflate_pass_cuda(Xb, r)),
                         median_ms(lambda: deflate.deflate_pass_plain(Xb, r))),
    }
    for name, (ms, plain_ms) in out.items():
        nbytes = N * K * (4 if name == "deflate_f32" else 2)
        print(f"{name} {N}x{K}: kernel {ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s one-pass; "
              f"plain {plain_ms:.4f} ms = {nbytes / plain_ms / 1e6:.1f} GB/s one-pass")
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
            X = X32.to(v.dtype)
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
            if v.prec in ("DEFAULT", "HIGH"):
                # against f64: within 10× the error of the plain emulation itself
                budget = 10 * max(_rel3(plain, truth[v.dtype]))
            if v.prec:
                # K4's p against the plain second product on the kernel's own t
                # (see mxu_plain_p); at DEFAULT the whole chain's p is printed
                # only, as a last-bit flip of tᵢ can move its bf16 rounding
                p_own = dv.mxu_plain_p(X, out[0], v.prec)
                q_own = rel_err(out[2], p_own)
                check(max(q[0], q_own, q[2]) <= KERNEL_RTOL,
                      f"{v.name} {N}x{K}: vs plain rel err t {q[0]:.2e} p (own t) "
                      f"{q_own:.2e} tt {q[2]:.2e} > {KERNEL_RTOL}")
                line = f"p on own t {q_own:.2e}"
                if v.prec == "DEFAULT":
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
    """{kernel name: (ms of its best variant at the sweep's default size,
    ms of that variant's plain version on the same shape)}."""
    out = {}
    n, k = SWEEP
    g = torch.Generator(dev).manual_seed(seed + 3)
    X32 = torch.randn((n, k), generator=g, device=dev)
    r = torch.randn(k, generator=g, device=dev)
    for kind in dv.launches:
        bf16 = kind == "vpu_bf16"
        prefix = {"vpu_f32": "vpu_1k_", "mxu_f32": "mxu_", "vpu_bf16": "vpu_bf16_"}[kind]
        rows = [row for row in tables[(n, k, bf16)] if row["name"].startswith(prefix)]
        best = min(rows, key=lambda row: row["ms"])
        v = next(v for v in kv.default_variants(bf16) if v.name == best["name"])
        X = X32.to(v.dtype)
        out[kind] = (best["ms"], median_ms(lambda: v.plain(X, r)))
        print(f"{kind}: best variant at {n}x{k} {best['name']} {best['ms']:.4f} ms; "
              f"its plain version {out[kind][1]:.4f} ms")
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

    for k in deflate.launches:  # the main path's run starts here
        deflate.launches[k] = 0
    cli_walls = phase_cli(deflate)
    fit_wall = phase_big(deflate, dev, args.seed)
    launches = dict(deflate.launches)  # ... and ends here
    print(f"main path launches: {launches}; cli walls {cli_walls}; "
          f"20-component fit wall {fit_wall:.4f} s")
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
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": abs_err[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name, source, replaces in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
