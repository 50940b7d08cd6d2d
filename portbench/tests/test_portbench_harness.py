"""BENCHMARK.json against the benchmark's contract, and every cell's run
at a tiny size on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import contract, tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_use_the_allowed_characters():
    contract.names_and_units(BENCH, ROOT)


def test_every_entry_has_the_contract_keys():
    contract.keys(BENCH)


def test_every_file_resolves_by_name_and_every_configuration_has_a_cell():
    contract.files(BENCH, ROOT)


def _with_chips(*chips: int) -> dict:
    """BENCHMARK.json with as many cells as `chips`, copies of the first,
    each on its count of chips."""
    first = BENCH["workloads"][0]
    cells = [{**first, "name": f"cell{i}", "chips": n} for i, n in enumerate(chips)]
    return {**BENCH, "workloads": cells}


@pytest.mark.parametrize("chips", [(1,), (4,), (4, 1, 1), (4, 1, 1, 1), (4, 4, 1, 1, 1, 1, 1, 1),
                                   (1,) * 23 + (4,)], ids=str)
def test_a_cell_may_take_one_chip_or_four(chips):
    contract.keys(_with_chips(*chips))


@pytest.mark.parametrize("chips", [(2,), (0,), (8,), (1.0,), (4, 4), (4, 4, 1, 1, 1, 1, 1),
                                   (4, 4, 4, 1, 1, 1, 1, 1, 1, 1, 1)], ids=str)
def test_more_four_chip_cells_than_a_quarter_or_other_counts_are_refused(chips):
    with pytest.raises(AssertionError):
        contract.keys(_with_chips(*chips))


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
