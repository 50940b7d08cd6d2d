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
`--cv lso --rng jax --seed 3` print, on toy and nir in float64, the same
stderr bytes as `pls_tpu.config.run_pipeline` (both run in process).
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
        (("--preprocess", "snv"), "ROADMAP queue 1 item 11"),
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
}
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
    assert mine == jax_stderr[(data, case)]
    if case != "lso_jax":
        k = 5 if case == "kfold5" else 10
        assert f"{k}-FOLD Validation:" in mine


def test_kfold_json_report(tmp_path):
    from pls_tpu_torch.config import PLSRunConfig, run_pipeline

    out = tmp_path / "r.json"
    cfg = PLSRunConfig(str(DATA / "toyX.csv"), str(DATA / "toyY.csv"), 2, cv=("kfold",),
                       kfold_k=5, json_out=str(out))
    rep = run_pipeline(cfg, file=io.StringIO(), device="cpu")
    assert json.loads(out.read_text()) == rep
    assert rep["kfold_k"] == 5 and np.asarray(rep["kfold_rmse"]).shape == (2, 2)
    assert list(rep)[-3:] == ["kfold_k", "kfold_rmse", "kfold_optimal_components"]
