#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. device: the card, torch/CUDA versions, TF32 off; build the CUDA
     deflation kernel from csrc/deflate.cu and time the build;
  2. kernel vs plain: the f32 (K1) and bf16 (K2) kernels against
     `deflate_pass_plain` on the same inputs and against f64 truth on the
     card, at every shape the main path gives them (toy 10×15, nir 60×401,
     100000×5000) and at (130, 96), (300, 401), (4096, 5000) and a K too
     wide for the staged form (2048, 30000); relative error of t, p and
     tt ≤ 1e-5 against both, and two launches bit-identical;
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
     the wide-K form of K1 and K2 against the plain form at 20000×30000.

The kernel launch counts are set to 0 just before phase 3 and read just
after phase 4.  The last two lines of stdout are the kernels' JSON record
and {"ok": true, "device": {...}}; without a CUDA device, or outside a
checkout of the repo, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
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


def phase_device(deflate) -> str:
    smi = nvidia_smi()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    from pls_tpu_torch.utils.nvcc import library_path

    t0 = time.perf_counter()
    deflate.build()
    print(f"kernel build+load {time.perf_counter() - t0:.2f} s "
          f"({library_path('deflate.cu').name})")
    log = library_path("deflate.cu").with_suffix(".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())
    return smi


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import pls_tpu_torch
    from pls_tpu_torch.ops import deflate

    check(Path(pls_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"pls_tpu_torch imported from {pls_tpu_torch.__file__}, not this checkout")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = phase_device(deflate)
    abs_err = phase_kernel(deflate, dev, args.seed)

    for k in deflate.launches:  # the main path's run starts here
        deflate.launches[k] = 0
    cli_walls = phase_cli(deflate)
    fit_wall = phase_big(deflate, dev, args.seed)
    launches = dict(deflate.launches)  # ... and ends here
    print(f"main path launches: {launches}; cli walls {cli_walls}; "
          f"20-component fit wall {fit_wall:.4f} s")
    check(all(v > 0 for v in launches.values()), "a kernel of the path never launched")

    times = phase_timing(deflate, dev, args.seed)
    check("jax" not in sys.modules and "pls_tpu" not in sys.modules, "jax was imported")
    replaces = {"deflate_f32": "pls_tpu/ops/deflate.py:83", "deflate_bf16": "pls_tpu/ops/deflate.py:102"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "pls_tpu_torch/csrc/deflate.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": abs_err[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("deflate_f32", "deflate_bf16")
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
