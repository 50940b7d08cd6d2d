"""BENCHMARK.json against the benchmark's contract, and every cell's run
at a tiny size on the CPU."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    assert len(set(names[: len(BENCH["end_to_end"]) + len(BENCH["per_layer"])])) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert all(UNIT.fullmatch(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in BENCH["end_to_end"] + BENCH["per_layer"])
    text = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
    text += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s for s in text)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_entry_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51 and all(w["chips"] == 1 for w in BENCH["workloads"])


def test_every_file_resolves_by_name_and_every_configuration_has_a_cell():
    for w in CELLS:
        c = harness.Cell.load(w)
        assert (harness.BENCH / "jobs" / f"{c.mix['job']}.py").exists()
        for m in c.end_to_end + c.per_layer:
            assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert any(m["name"] != "setup_s" for m in c.end_to_end) and c.per_layer
        assert {m["moves"] for m in c.per_layer} <= {m["name"] for m in c.end_to_end}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests import tiny\n"
        "from portbench import harness, control\n"
        "for w in %r: tiny.run(w, __import__('pathlib').Path(%r), trace=True, seconds=0.05)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), CELLS, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "pls_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: run.py would measure")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_at_a_tiny_size_and_is_correct(workload, tmp_path):
    r, m, (correct, rows, failed) = tiny.run(workload, tmp_path)
    assert correct and failed == 0, rows
    assert r.jobs >= 1 and r.setup_s > 0
    assert set(m) == {s["name"] for s in r.cell.end_to_end}
    assert all(v["value"] > 0 for v in m.values())


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_traced_at_a_tiny_size(workload, tmp_path):
    r, m, (correct, _, _) = tiny.run(workload, tmp_path, trace=True)
    assert correct
    assert r.trace is not None and r.trace.jobs == r.job.traced and r.trace.window_s > 0
    # no device on the CPU: the device's readers find nothing and report nothing
    assert all(name in ("fit_mfu", "cv_mfu") for name in m)
    assert r.trace.breakdown()["device_ops"] == []
    assert not list(tmp_path.glob("portbench-*.json"))  # the trace file is removed
