"""The OPLS-DA cell's and the regressor cell's own pieces on the CPU: the
urine NMR generator (`portbench/nmr.py`) and its grid, the OPLS-DA job's
least work (`portbench/roofline_oplsda.py`) on shapes worked by hand, the
regressor job (`portbench/jobs/regressor.py`) at its configuration's cut,
and both cells joining the benchmark by new files and list appends alone,
as `test_portbench_add_cell.py` adds one."""

from __future__ import annotations

import copy
import json
import shutil

import pytest
import torch

from pls_tpu_torch.estimator import PLSRegressor
from portbench import harness, nmr, roofline, roofline_oplsda, roofline_plsda
from portbench.tests import contract, tiny
from portbench.tests.test_portbench_add_cell import (  # noqa: F401 (untouched: a fixture)
    _assert_appends_only, _write_json, untouched)

ROOT = harness.ROOT
CONFIG_NAME = "intermap-nmr-oplsda-9k-26k-4"
CONFIG = json.loads((ROOT / f"portbench/configs/{CONFIG_NAME}.json").read_text())
SMALL = {**CONFIG, "N": 96, "K": 1537}
CELLS = ("intermap.oplsda-f32", "synth100k.regressor")
METRICS = ("ortho_x_passes",)
# what the two cells brought, beside their entries in BENCHMARK.json
FILES = (f"configs/{CONFIG_NAME}.json", f"tests/cuts/{CONFIG_NAME}.json",
         "traffic/oplsda-nmr.json", "traffic/regressor.json",
         "limits/intermap.oplsda-f32.json", "limits/synth100k.regressor.json",
         "jobs/oplsda.py", "jobs/regressor.py", "metrics/ortho_x_passes.py")
MIRRORED = ("configs", "traffic", "limits", "metrics", "jobs", "tests/cuts")


def test_the_grid_keeps_25887_points_of_0_2_to_10_ppm_less_water():
    a = CONFIG["assumed"]
    assert a["spectral_points"] / a["spectral_width_ppm"] == pytest.approx(3276.8)
    # 9.80 ppm kept less 1.90 of water and urea: 7.90 ppm of 64K points over 20 ppm
    assert round(7.90 * 65536 / 20) == 25887
    assert nmr.grid_points(CONFIG) == CONFIG["K"] == 25887
    ppm = nmr.axis(CONFIG)
    assert ppm.shape == (25887,) and ppm.dtype == torch.float64
    assert bool((ppm[1:] > ppm[:-1]).all())
    assert 0.20 < float(ppm[0]) < 0.2002 and 9.9998 < float(ppm[-1]) < 10.00
    assert not bool(((ppm > 4.50) & (ppm < 6.40)).any())
    step = torch.diff(ppm)
    inside = step < 0.1  # every step but the jump over the water
    assert int((~inside).sum()) == 1
    assert torch.allclose(step[inside], torch.full_like(step[inside], 1 / 3276.8), rtol=1e-4)


def test_participants_take_the_enrolment_s_shares():
    counts = nmr.shares(4630, CONFIG["enrolment"])
    assert sum(counts) == 4630
    enrolled = list(CONFIG["enrolment"].values())  # China, Japan, UK, USA
    assert all(abs(c - 4630 * e / sum(enrolled)) <= 1 for c, e in zip(counts, enrolled))
    assert nmr.shares(4, CONFIG["enrolment"]) == [1, 1, 1, 1]
    with pytest.raises(ValueError):
        nmr.shares(3, CONFIG["enrolment"])


def test_the_cohort_is_the_seed_s():
    X, y, Xn, yn = nmr.cohort(SMALL, 32, 11, "cpu")
    X2, y2, Xn2, yn2 = nmr.cohort(SMALL, 32, 11, "cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2) and torch.equal(Xn, Xn2)
    assert torch.equal(yn, yn2)
    assert not torch.equal(X, nmr.cohort(SMALL, 32, 12, "cpu")[0])
    assert X.shape == (96, 1537) and Xn.shape == (32, 1537) and X.dtype == torch.float32
    # two collections a participant in consecutive rows, of one country
    assert torch.equal(y[0::2], y[1::2]) and torch.equal(yn[0::2], yn[1::2])
    assert torch.bincount(y[0::2], minlength=4).tolist() == nmr.shares(48, CONFIG["enrolment"])
    assert not torch.equal(X[0::2], X[1::2])  # the day's variation and dilution differ
    # the held-out batch is a second draw: no row of it is a training row
    assert float(torch.cdist(Xn, X).min()) > 0.1
    with pytest.raises(ValueError):
        nmr.cohort({**SMALL, "N": 95}, 32, 11, "cpu")


def test_lines_are_lorentzians_and_only_ph_sensitive_ones_move():
    lib = nmr.library(SMALL, torch.Generator().manual_seed(3), "cpu")
    a = CONFIG["assumed"]
    # 1 Hz full width at 600 MHz: a half width of 1/1200 ppm
    assert lib.gamma == pytest.approx(0.5 / 600)
    assert lib.n_compounds == a["metabolites"] + a["drugs"]
    assert bool((lib.alpha[lib.owner >= a["metabolites"]] == 0).all())  # drugs hold their place
    assert bool((lib.alpha != 0).any())
    fixed = lib.bank(0.0, sensitive=False)
    assert torch.equal(fixed, lib.bank(float(lib.levels[-1]), sensitive=False))
    moved = lib.bank(float(lib.levels[-1]), sensitive=True)
    assert not torch.equal(moved, lib.bank(0.0, sensitive=True))
    # each fixed line a Lorentzian of half width gamma about its position,
    # summed into its compound's row
    keep = lib.alpha == 0
    d = (lib.axis[None, :] - lib.pos[keep][:, None]) / lib.gamma
    want = torch.zeros(lib.n_compounds, lib.axis.shape[0], dtype=torch.float64)
    want.index_add_(0, lib.owner[keep], lib.weight[keep][:, None] / (1 + d * d))
    assert torch.allclose(fixed.double(), want, rtol=1e-6, atol=1e-6)


def test_the_job_s_work_by_hand():
    N, K, M, A, n_o, Nh = 10, 6, 3, 2, 4, 5
    per_comp = 2 * N * K + 4 * K + 2 * N
    assert roofline_oplsda.filter_bytes(N, K, n_o) == 4 * n_o * per_comp
    assert roofline_oplsda.job_bytes(N, K, M, A, n_o, Nh) == (
        4 * n_o * per_comp + roofline_plsda.job_bytes(N, K, M, A, Nh))
    # two passes a component, each 2·N·K twice; tᵀt and t_oᵀt_o; XYᵀXY and
    # XY q; the norms and wᵀp; XY's rank-1 update; no second XᵀY
    comp = 8 * N * K + 4 * N + 2 * K * M * M + 2 * K * M + 9 * K + 2 * N * M + 2 * K * M
    filt = sum(comp + 8 * j * (N + K) for j in range(n_o))
    assert roofline_oplsda.filter_flops(N, K, M, n_o) == filt
    implicit = 4 * n_o * (N + K) * A
    held = 2 * Nh * K * n_o + 2 * Nh * n_o * M + 2 * n_o * K * M
    assert roofline_oplsda.job_flops(N, K, M, A, n_o, Nh) == (
        filt + roofline_plsda.job_flops(N, K, M, A, Nh) + implicit + held)


def test_the_oplsda_cell_is_bound_by_bytes_at_about_5_8_ms():
    N, K, M, A, n_o, Nh = 9260, 25887, 4, 3, 8, 2000
    b = roofline_oplsda.job_bytes(N, K, M, A, n_o, Nh)
    f = roofline_oplsda.job_flops(N, K, M, A, n_o, Nh)
    assert roofline.least_seconds(b, f) == pytest.approx(b / 3.35e12)
    # X read twice an orthogonal component (the t/p and t_o/p_o passes, as
    # a deflation pass reads it once) and A + 1 times by the fit, the
    # held-out batch once
    x_reads = (2 * n_o + A + 1) * N * K + Nh * K
    assert roofline.least_seconds(b, f) == pytest.approx(4 * x_reads / 3.35e12, rel=1e-3)
    assert roofline.least_seconds(b, f) == pytest.approx(5.79e-3, rel=1e-3)
    # a pass of the filter is what the deflation kernel's roofline counts
    assert roofline_oplsda.filter_bytes(N, K, 1) == pytest.approx(
        2 * roofline.pass_bytes(N, K, 4), rel=1e-4)


def test_the_regressor_job_at_its_cut():
    c = tiny.cell("synth100k.regressor")
    job = harness.load_module(harness.BENCH / "jobs" / "regressor.py")
    seed = 2**31 + 41
    j = job.Job(c.config, c.mix, seed, torch.device("cpu"))
    N, K, M = c.config["N"], c.config["K"], c.config["M"]
    Nh = c.mix["predict_rows"]
    assert j.X.shape == (N, K) and j.Y.shape == (N, M) and j.X_new.shape == (Nh, K)
    # the same seed draws the same rows; the new rows come from a stream of their own
    X, Y, Xn = job.draw(c.config, Nh, seed, "cpu")
    assert torch.equal(X, j.X) and torch.equal(Y, j.Y) and torch.equal(Xn, j.X_new)
    X3, Y3, _ = job.draw(c.config, Nh + 3, seed, "cpu")
    assert torch.equal(X3, X) and torch.equal(Y3, Y)
    assert float(torch.cdist(Xn[:50], X).min()) > 0.1
    assert j.work == (roofline_plsda.job_bytes(N, K, M, c.config["A"], Nh),
                      roofline_plsda.job_flops(N, K, M, c.config["A"], Nh))
    # the reference z-scores as the estimator does
    reg = PLSRegressor(n_components=c.config["A"], device="cpu").fit(X, Y)
    mean, sd = job._moments(X.double())
    assert torch.allclose(reg._x_scaler.mean.double(), mean, atol=1e-6)
    assert torch.allclose(reg._x_scaler.stdev.double(), sd, rtol=1e-5)
    answer = j.run(0)
    j.keep(answer)
    (got,) = j.check(c.limits)
    limits = {k: v for k, v in c.limits.items() if k != "margins"}
    assert all(got[k] <= v for k, v in limits.items()), got
    low = j.control(c.limits)
    assert any(low[k] > v for k, v in limits.items()), low


def _stripped(bench: dict) -> dict:
    """BENCHMARK.json without the two cells, their configuration and their
    metrics."""
    out = copy.deepcopy(bench)
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG_NAME]
    out["workloads"] = [w for w in out["workloads"] if w["name"] not in CELLS]
    out["per_layer"] = [m for m in out["per_layer"] if m["name"] not in METRICS]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in CELLS]
    return out


def test_both_cells_join_by_new_files_and_list_appends(tmp_path, monkeypatch, untouched):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _stripped(bench)
    _assert_appends_only(before, bench)
    root = tmp_path / "checkout"
    for sub in MIRRORED:
        shutil.copytree(ROOT / "portbench" / sub, root / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__", *{f.split("/")[-1]
                                                                       for f in FILES}))
    for f in FILES:
        assert not (root / "portbench" / f).exists(), f
    _write_json(root / "BENCHMARK.json", before)
    # the parent's benchmark resolves without the new files
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "portbench")
    contract.check(before, root)
    for f in FILES:
        (root / "portbench" / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / "portbench" / f, root / "portbench" / f)
    after = copy.deepcopy(before)
    after["configs"] += [c for c in bench["configs"] if c["name"] == CONFIG_NAME]
    after["workloads"] += [w for w in bench["workloads"] if w["name"] in CELLS]
    after["per_layer"] += [m for m in bench["per_layer"] if m["name"] in METRICS]
    for m, real in zip(after["end_to_end"] + after["per_layer"],
                       bench["end_to_end"] + bench["per_layer"]):
        if "workloads" in m:
            m["workloads"] += [w for w in real["workloads"] if w in CELLS]
    assert after == bench
    _write_json(root / "BENCHMARK.json", after)
    contract.check(after, root)
    for cell in CELLS:
        c = harness.Cell.load(cell)
        assert c.chips == 1
        assert {m["name"] for m in c.end_to_end} == {"fit_ms", "setup_s"}
        r, m, (correct, rows, failed) = tiny.run(cell, tmp_path)
        assert correct and failed == 0, rows
        assert set(m) == {"fit_ms", "setup_s"}
    assert {m["name"] for m in harness.Cell.load(CELLS[0]).per_layer} >= set(METRICS)
    assert not set(METRICS) & {m["name"] for m in harness.Cell.load(CELLS[1]).per_layer}
