"""The port's CLI (`python -m pls_tpu_torch`) against the reference's goldens.

Runs the CLI in a subprocess with `--device cpu` (float64, the CPU
default; without it the CLI runs on the card or exits 1) on the
toy and nir data vendored in pls_tpu/data/, and checks exit codes 100 and
1, an empty stdout, and the state, explained-variance and validation
tables against the captured reference stderr (tests/golden/*_cli_stderr.txt)
with tests/test_cli.py's tolerance (2e-5 relative on 6-digit prints, per
column sign alignment of the state).  The nir state block printed with
--format eigen-complex must equal the reference's byte for byte (M = 1:
no eigenvector sign), as tests/test_cli.py:212-236 checks for pls_tpu.
The report tables are read with chip_smoke.py's parser, which the card
run uses on the same output.  `--cv kfold --kfold-k 5`, `--cv all` and
`--cv lso --rng jax --seed 3`, `--method nipals`, `--method simpls`,
`--preprocess savgol:11:2:1,snv` and `--preprocess msc,detrend:2` print,
on toy and nir in float64, the same stderr bytes as
`pls_tpu.config.run_pipeline` (both run in process), but for two values of
nir's SIMPLS state on a rounding boundary of their sixth digit
(`BORDERLINE`).
With `--x-storage bf16 --cv all` the main fit stores X in bf16 but every
CV refit runs in X's own precision, as in the JAX package: the LOO, LSO
and k-fold blocks equal `pls_tpu`'s byte for byte, and those of the run
without the flag.
`--dtype bfloat16` (X and Y read and z-scored in bf16, float32 fit state)
cannot equal anything byte for byte: its parity is a bound measured from
the JAX package's own bf16 run (`D_JAX`), and a tight one
(`SAME_ARITH_RTOL`) against that run with its main fit on the JAX
package's Pallas kernel in interpret mode, whose arithmetic the port's
follows.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import golden_errors, parse_report

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
DATA = REPO / "pls_tpu" / "data"


def run_cli(*args, timeout=600):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "pls_tpu_torch", *map(str, args), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout,
    )


@pytest.fixture(scope="module")
def toy_run():
    r = run_cli(DATA / "toyX.csv", DATA / "toyY.csv", 2)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


@pytest.fixture(scope="module")
def nir_run():
    r = run_cli(DATA / "nir.csv", DATA / "octane.csv", 10, "--format", "eigen-complex")
    assert r.returncode == 0, r.stderr[-2000:]
    return r


@pytest.mark.parametrize("name", ["toy", "nir"])
def test_tables_match_reference(name, toy_run, nir_run):
    run = toy_run if name == "toy" else nir_run
    assert run.stdout == ""
    mine = parse_report(run.stderr)
    ref = parse_report((GOLDEN / f"{name}_cli_stderr.txt").read_text())
    for label in ("P", "W", "R", "Q", "T", "coefficients"):
        assert mine[label].shape == ref[label].shape, label
        s = np.sign(np.sum(mine[label] * ref[label], axis=0))
        s[s == 0] = 1
        np.testing.assert_allclose(mine[label] * s, ref[label], rtol=2e-5, atol=1e-5, err_msg=label)
    for key in ("ev", "sse", "loo_rmse", "lso_rmse"):
        np.testing.assert_allclose(mine[key], ref[key], rtol=2e-5, err_msg=key)
    for key in ("loo_opt", "lso_opt"):
        np.testing.assert_array_equal(mine[key], ref[key])
    errs = golden_errors(mine, name)
    assert errs["loo_opt_equal"] and errs["lso_opt_equal"]
    assert errs["coef_rel"] < 2e-5 and errs["ev_abs"] < 1e-5


def test_eigen_complex_state_block_byte_parity_nir(nir_run):
    def state_block(text):
        lines = text.split("\n")
        start = lines.index("P:")
        end = next(i for i, ln in enumerate(lines) if "components explained" in ln)
        return lines[start:end]

    assert state_block(nir_run.stderr) == state_block((GOLDEN / "nir_cli_stderr.txt").read_text())


def test_bad_argc_exits_100():
    r = run_cli("only_one_arg", timeout=120)
    assert r.returncode == 100
    assert "Usage: ./pls X_data.csv Y_data.csv num_components" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize(
    "extra,needle",
    [
        ((), "Error: row 1 has 2 columns, but previous row(s) have 3 columns."),
        (("--cv", "kfold"), "Error: row 1 has 2 columns, but previous row(s) have 3 columns."),
        (("--cv", "all"), "Error: row 1 has 2 columns, but previous row(s) have 3 columns."),
        (("--preprocess", "snv"), "Error: row 1 has 2 columns, but previous row(s) have 3 columns."),
        (("--dtype", "bfloat16"), "Error: row 1 has 2 columns, but previous row(s) have 3 columns."),
    ],
)
def test_bad_input_exits_1(tmp_path, extra, needle):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n4,5\n")
    y = tmp_path / "y.csv"
    y.write_text("1\n2\n")
    r = run_cli(bad, y, 1, *extra, timeout=120)
    assert r.returncode == 1
    assert needle in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("chain,needle", [("fft", "unknown preprocessing step 'fft'"),
                                          ("savgol:11", "savgol needs window:polyorder")])
def test_bad_preprocess_chain_exits_1(chain, needle):
    r = run_cli(DATA / "toyX.csv", DATA / "toyY.csv", 2, "--preprocess", chain, timeout=120)
    assert r.returncode == 1 and r.stdout == ""
    assert r.stderr.startswith("Error: ") and needle in r.stderr


def test_missing_file_exits_1(tmp_path):
    r = run_cli(tmp_path / "nope.csv", tmp_path / "nope2.csv", 1, timeout=120)
    assert r.returncode == 1
    assert r.stderr.startswith("Error: ")


def test_json_report_and_flags(tmp_path):
    out = tmp_path / "report.json"
    r = run_cli(DATA / "toyX.csv", DATA / "toyY.csv", 2, "--cv", "loo", "--json", out)
    assert r.returncode == 0, r.stderr[-1500:]
    assert "LSO Validation:" not in r.stderr
    rep = json.loads(out.read_text())
    assert rep["num_components"] == 2 and rep["dtype"] == "float64" and rep["device"] == "cpu"
    assert rep["loo_optimal_components"] == [2, 1]
    assert abs(rep["loo_rmse"][0][0] - 0.791811) < 1e-4
    assert "lso_rmse" not in rep
    r = run_cli(
        DATA / "toyX.csv", DATA / "toyY.csv", 2, "--cv", "lso", "--rng", "torch",
        "--seed", "3", "--lso-trials", "20", "--alpha", "1e-9", "--method", "kernel2",
        "--dtype", "float32", "--json", out,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    rep = json.loads(out.read_text())
    assert rep["dtype"] == "float32" and rep["method"] == "kernel2"
    assert np.asarray(rep["lso_rmse"]).shape == (2, 2)
    assert rep["lso_optimal_components"] == [1, 1]  # α = 1e-9: every smaller model passes
    assert "LOO Validation:" not in r.stderr


def test_bf16_x_storage_within_budget(tmp_path):
    r = run_cli(DATA / "nir.csv", DATA / "octane.csv", 10, "--cv", "none", "--x-storage", "bf16")
    assert r.returncode == 0, r.stderr[-1500:]
    rep = parse_report(r.stderr)
    gold = np.loadtxt(GOLDEN / "nir_ev.csv", delimiter=",", ndmin=2)
    np.testing.assert_allclose(rep["ev"], gold, atol=2e-3)


# ---------- stderr bytes against the JAX package's pipeline ----------
PARITY_ARGS = {
    "kfold5": ["--cv", "kfold", "--kfold-k", "5"],
    "all": ["--cv", "all"],
    "lso_jax": ["--cv", "lso", "--rng", "jax", "--seed", "3"],
    "all_bf16": ["--x-storage", "bf16", "--cv", "all"],
    "nipals": ["--method", "nipals"],
    "simpls": ["--method", "simpls"],
    "savgol_snv": ["--preprocess", "savgol:11:2:1,snv"],
    "msc_detrend": ["--preprocess", "msc,detrend:2"],
}
# nir's SIMPLS state (A = 10) sits within 1.2e-11 of pls_tpu's, relative to
# its scale (tests/test_torch_nipals_simpls.py holds it at 1e-10); two of
# its printed values sit on a rounding boundary of the sixth digit and
# print one unit apart: P row 51, column 10 (0.000574387 against
# pls_tpu's 0.000574386) and coefficient 264 (0.000499365 against
# 0.000499364)
BORDERLINE = {("nir", "simpls"): 2}
PARITY_DATA = {"toy": ("toyX.csv", "toyY.csv", 2), "nir": ("nir.csv", "octane.csv", 10)}


def _parity_argv(data, case):
    xf, yf, A = PARITY_DATA[data]
    return [str(DATA / xf), str(DATA / yf), str(A), *PARITY_ARGS[case]]


def _stderr_of(main, argv):
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    assert out.getvalue() == ""
    return err.getvalue()


def _assert_borderline_digits(mine: str, ref: str, n_lines: int):
    """Equal bytes except `n_lines` lines of the state dump, whose values
    differ by at most one unit in the sixth significant digit."""
    a, b = mine.split("\n"), ref.split("\n")
    assert len(a) == len(b)
    state_end = next(i for i, ln in enumerate(b) if "components explained" in ln)
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    assert len(diff) == n_lines and all(i < state_end for i in diff), diff
    for i in diff:
        x, y = np.array(a[i].split(), float), np.array(b[i].split(), float)
        unit = 10.0 ** (np.floor(np.log10(np.abs(y))) - 5)  # of the sixth significant digit
        assert np.all(np.abs(x - y) <= 1.001 * unit), (a[i], b[i])


def _cv_blocks(text: str) -> str:
    """The report from its first validation block to the end."""
    return text[text.index("LOO Validation:"):]


@pytest.fixture(scope="module")
def jax_stderr():
    """The JAX package's CLI (in process, float64 on the CPU) for every
    parity case, run once for the module."""
    from pls_tpu.cli import main as jax_main

    return {(d, c): _stderr_of(jax_main, _parity_argv(d, c)) for d in PARITY_DATA for c in PARITY_ARGS}


@pytest.mark.parametrize("case", sorted(PARITY_ARGS))
@pytest.mark.parametrize("data", sorted(PARITY_DATA))
def test_cv_stderr_bytes_match_jax(data, case, jax_stderr):
    from pls_tpu_torch.cli import main

    mine = _stderr_of(main, _parity_argv(data, case) + ["--device", "cpu"])
    if case == "all_bf16":
        # the main fit's tables differ within the bf16 budget (the JAX
        # package's XLA pass rounds t to bf16, the port keeps it float32);
        # the CV blocks are full-precision refits in both
        blocks = _cv_blocks(mine)
        assert blocks == _cv_blocks(jax_stderr[(data, case)])
        assert blocks == _cv_blocks(jax_stderr[(data, "all")])
        assert blocks.count("Validation:") == 3
        return
    if (data, case) in BORDERLINE:
        _assert_borderline_digits(mine, jax_stderr[(data, case)], BORDERLINE[(data, case)])
        return
    assert mine == jax_stderr[(data, case)]
    if case in ("nipals", "simpls", "savgol_snv", "msc_detrend"):
        assert "LOO Validation:" in mine and "LSO Validation:" in mine
    elif case != "lso_jax":
        k = 5 if case == "kfold5" else 10
        assert f"{k}-FOLD Validation:" in mine


@pytest.mark.parametrize("data", sorted(PARITY_DATA))
def test_cli_reads_through_the_native_loader(data, jax_stderr):
    """The CLI's loader (config.run_pipeline) parses X and Y with the
    port's host runtime, whose counter says so, and prints pls_tpu's bytes."""
    from pls_tpu_torch.cli import main
    from pls_tpu_torch.utils import io as tio

    before = dict(tio.native_reads)
    mine = _stderr_of(main, _parity_argv(data, "kfold5") + ["--device", "cpu"])
    assert tio.native_reads == {**before, "read_matrix": before["read_matrix"] + 2}
    assert mine == jax_stderr[(data, "kfold5")]


def _rc_stderr(main, argv):
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, err.getvalue(), out.getvalue()


@pytest.mark.parametrize("text", ["1,2,3\n4,5\n", "1,2\n3,x\n", "1,2\n\n3,4\n", "1,2,\n"],
                         ids=["ragged", "non_numeric", "empty_line", "trailing_separator"])
def test_cli_bad_csv_exits_as_jax_native(tmp_path, text):
    """Bad CSV input: the reference's ragged-row message and exit 1, and the
    native loader's other messages (which the plain parser words otherwise),
    byte for byte as pls_tpu's CLI on its native path."""
    from pls_tpu.cli import main as jax_main
    from pls_tpu_torch.cli import main

    bad, y = tmp_path / "bad.csv", tmp_path / "y.csv"
    bad.write_text(text)
    y.write_text("1\n2\n")
    argv = [str(bad), str(y), "1"]
    mine = _rc_stderr(main, argv + ["--device", "cpu"])
    assert mine == _rc_stderr(jax_main, argv)
    assert mine[0] == 1 and mine[2] == "" and mine[1].count("\n") == 1
    if text.startswith("1,2,3"):
        assert mine[1] == "Error: row 1 has 2 columns, but previous row(s) have 3 columns.\n"


def test_kfold_json_report(tmp_path):
    from pls_tpu_torch.config import PLSRunConfig, run_pipeline

    out = tmp_path / "r.json"
    cfg = PLSRunConfig(str(DATA / "toyX.csv"), str(DATA / "toyY.csv"), 2, cv=("kfold",),
                       kfold_k=5, json_out=str(out))
    rep = run_pipeline(cfg, file=io.StringIO(), device="cpu")
    assert json.loads(out.read_text()) == rep
    assert rep["kfold_k"] == 5 and np.asarray(rep["kfold_rmse"]).shape == (2, 2)
    assert list(rep)[-3:] == ["kfold_k", "kfold_rmse", "kfold_optimal_components"]


# ---------- --dtype bfloat16 against the JAX package's bf16 run ----------
# d_jax: the JAX package's `--dtype bfloat16` run against float64 (the
# reference goldens, which its float64 run meets within 2e-5), per table:
# max |bf16 − f64| / max |f64|, state columns sign-aligned.  Measured on the
# CPU (pls_tpu.cli in process, x64 on).  The port's bf16 run must lie within
# d_jax of JAX's bf16 run and within 2·d_jax of float64.  Beside each: the
# port's measured distances (to JAX bf16, to f64).
D_JAX = {
    ("toy", "W"): 0.05674,  # port 0.00078, 0.05674
    ("toy", "P"): 0.05936,  # port 0.00096, 0.05899
    ("toy", "Q"): 0.01362,  # port 0.00152, 0.01399
    ("toy", "R"): 0.06734,  # port 0.00024, 0.06739
    ("toy", "coefficients"): 0.06660,  # port 0.00123, 0.06734
    ("toy", "ev"): 0.01648,  # port 1.4e-5, 0.01648
    ("toy", "loo_rmse"): 0.01452,  # port 0.00013, 0.01465
    ("toy", "lso_rmse"): 0.01966,  # port 8.2e-5, 0.01975
    ("nir", "W"): 0.8960,  # port 0.0757, 0.8594
    ("nir", "P"): 0.9069,  # port 0.0585, 0.8920
    ("nir", "Q"): 0.7100,  # port 0.0309, 0.7040
    ("nir", "R"): 0.6181,  # port 0.0414, 0.6230
    ("nir", "coefficients"): 0.6566,  # port 0.0233, 0.6330
    ("nir", "ev"): 0.02149,  # port 7.2e-5, 0.02152
    ("nir", "loo_rmse"): 0.08941,  # port 0.00251, 0.08778
    ("nir", "lso_rmse"): 0.06341,  # port 0.00065, 0.06340
}
# What is left of the port's distance to JAX's bf16 run is one rounding:
# the port's deflation pass keeps t = Xr in float32, as the JAX package's
# Pallas kernel does (pls_tpu/ops/deflate.py:102), where its XLA pass, which
# the CPU takes, rounds t to bf16 before p = Xᵀt.  Against the JAX fit with
# its Pallas kernel in interpret mode, the same arithmetic, the main fit's
# tables agree to SAME_ARITH_RTOL in every component, noise included (max
# |Δ| / max |table| measured: toy 4.1e-6 in the coefficients, nir 7.6e-5
# in W).  The CV
# tables are refits that JAX runs on its XLA pass either way; D_JAX holds
# them.
SAME_ARITH_RTOL = 1e-3
BF16_TABLES = ("W", "P", "Q", "R", "coefficients", "ev", "loo_rmse", "lso_rmse")
MAIN_FIT_TABLES = ("W", "P", "Q", "R", "coefficients", "ev")


def _table_dist(a: np.ndarray, b: np.ndarray, state: bool) -> float:
    if state:
        s = np.sign(np.sum(a * b, axis=0))
        s[s == 0] = 1
        a = a * s
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def bf16_runs():
    """The parsed reports: the JAX package's bf16 CLI, the port's bf16 CLI
    on the CPU, the float64 golden, and the JAX package's bf16 CLI with its
    main fit on the Pallas kernel in interpret mode, for toy and nir."""
    import functools

    import pls_tpu.models.kernel_pls as jax_kernel_pls
    import pls_tpu.ops.deflate as jax_deflate
    from pls_tpu.cli import main as jax_main
    from pls_tpu_torch.cli import main

    out = {}
    for data, (xf, yf, A) in PARITY_DATA.items():
        argv = [str(DATA / xf), str(DATA / yf), str(A), "--dtype", "bfloat16"]
        with pytest.MonkeyPatch.context() as mp:
            # the fit's un-traced call takes the kernel; the vmapped CV
            # refits stay on the XLA pass
            mp.setattr(jax_kernel_pls, "auto_pallas_mode", lambda *a, **k: "unroll")
            mp.setattr(jax_deflate, "deflate_pass",
                       functools.partial(jax_deflate.deflate_pass, interpret=True))
            kernel = parse_report(_stderr_of(jax_main, argv))
        out[data] = (parse_report(_stderr_of(jax_main, argv)),
                     parse_report(_stderr_of(main, argv + ["--device", "cpu"])),
                     parse_report((GOLDEN / f"{data}_cli_stderr.txt").read_text()),
                     kernel)
    return out


@pytest.mark.parametrize("table", BF16_TABLES)
@pytest.mark.parametrize("data", sorted(PARITY_DATA))
def test_bf16_cli_within_jax_bf16_bound(data, table, bf16_runs):
    jax16, port16, f64, _ = (r[table] for r in bf16_runs[data])
    state = table in ("W", "P", "Q", "R", "coefficients")
    d_jax = _table_dist(jax16, f64, state)
    bound = D_JAX[(data, table)]
    assert abs(d_jax - bound) <= 0.05 * bound, (d_jax, bound)  # the recorded measurement
    to_f64 = _table_dist(port16, f64, state)
    to_jax = _table_dist(port16, jax16, state)
    assert to_f64 <= 2 * bound, (to_f64, bound)
    assert to_jax <= bound, (to_jax, bound)


@pytest.mark.parametrize("table", MAIN_FIT_TABLES)
@pytest.mark.parametrize("data", sorted(PARITY_DATA))
def test_bf16_cli_same_arithmetic_as_jax_kernel(data, table, bf16_runs):
    _, port16, _, kernel = (r[table] for r in bf16_runs[data])
    d = _table_dist(port16, kernel, table in ("W", "P", "Q", "R"))
    assert d <= SAME_ARITH_RTOL, (d, SAME_ARITH_RTOL)


def test_chip_smoke_holds_the_card_to_these_bounds():
    from chip_smoke import BF16_D_JAX, BF16_SAME_ARITH_RTOL

    assert BF16_D_JAX == D_JAX and BF16_SAME_ARITH_RTOL == SAME_ARITH_RTOL


@pytest.mark.parametrize("data", sorted(PARITY_DATA))
def test_bf16_cli_component_choices(data, bf16_runs):
    # equal to JAX's bf16 run; nir's move from float64's (LOO 3 → 6, LSO
    # 5 → 7) in both packages
    jax16, port16, _, _ = bf16_runs[data]
    for key in ("loo_opt", "lso_opt"):
        np.testing.assert_array_equal(port16[key], jax16[key])


def test_bf16_cli_json_reports_float32(tmp_path):
    out = tmp_path / "r.json"
    r = run_cli(DATA / "toyX.csv", DATA / "toyY.csv", 2, "--dtype", "bfloat16", "--json", out)
    assert r.returncode == 0 and r.stdout == "", r.stderr[-1500:]
    rep = json.loads(out.read_text())
    assert rep["dtype"] == "bfloat16"
    # the RMSE and explained variance are float32 numbers (bf16 data meets
    # the float32 state), as in the JAX package's report
    v = rep["loo_rmse"][0][1]
    assert float(np.float32(v)) == v and abs(v - 0.4256) < 1e-3
