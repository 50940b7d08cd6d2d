"""A configuration and its cell join the benchmark by new files and appends
to BENCHMARK.json's lists alone, as a later change adds one: on a mirror
of the checkout's benchmark files in a temporary directory, with the
harness pointed at it.  The added cell passes the contract, resolves
every file, runs correct at a tiny size untraced and traced, and comes
out not correct under each planted fault and under the control; no file
of the real checkout changes.  Also the CPU cuts' own rules."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from portbench import control, harness
from portbench.tests import contract, tiny
from portbench.tests.test_portbench_faults import answer, half, state

ROOT = harness.ROOT
MIRRORED = ("configs", "traffic", "limits", "metrics", "jobs", "tests/cuts")
CONFIG = "widek-mirror"  # the synthetic configuration at a wide K
CELL = "widek-mirror.fit-f32"
TWIN = "synth100k.fit-f32"  # the cell on the same mix whose lists the new cell joins
CUT = {"config": {"N": 64, "K": 1024, "M": 3, "A": 5}, "mix": {}}


def _hashes() -> dict[str, str]:
    """The SHA-256 of BENCHMARK.json and of every file of portbench/ but
    bytecode caches, by path."""
    paths = [ROOT / "BENCHMARK.json"]
    paths += [p for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts]
    return {str(p.relative_to(ROOT)): hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}


def _write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")


def _add_cell(root: Path, cut: dict | None) -> dict:
    """Add the configuration, its cut (unless None) and its cell to the
    mirror at `root` by new files and list appends; returns the new
    BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    twin = next(w for w in bench["workloads"] if w["name"] == TWIN)
    base_cfg = next(c for c in bench["configs"] if c["name"] == twin["config"])
    sizes = json.loads((root / base_cfg["file"]).read_text())
    sizes.update(name=CONFIG, N=20000, K=30000, M=10, A=20)
    cfg_file = f"portbench/configs/{CONFIG}.json"
    for path in (root / cfg_file, root / f"portbench/limits/{CELL}.json"):
        assert not path.exists()
    _write_json(root / cfg_file, sizes)
    if cut is not None:
        _write_json(root / f"portbench/tests/cuts/{CONFIG}.json", cut)
    limits = json.loads((root / f"portbench/limits/{TWIN}.json").read_text())
    _write_json(root / f"portbench/limits/{CELL}.json", limits)
    bench["configs"].append({**base_cfg, "name": CONFIG, "file": cfg_file,
                             "why": "wide spectra: 20 000 x 30 000 x 10, A = 20, f32"})
    bench["workloads"].append({**twin, "name": CELL, "config": CONFIG,
                               "why": "back-to-back fits at K = 30 000: every pass on the "
                                      "cluster path"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if TWIN in m.get("workloads", []):
            m["workloads"].append(CELL)
    _write_json(root / "BENCHMARK.json", bench)
    return bench


def _mirror(tmp: Path, monkeypatch, cut: dict | None = CUT) -> dict:
    root = tmp / "checkout"
    (root / "portbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in MIRRORED:
        shutil.copytree(ROOT / "portbench" / sub, root / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    before = json.loads((root / "BENCHMARK.json").read_text())
    bench = _add_cell(root, cut)
    _assert_appends_only(before, bench)
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "portbench")
    return bench


def _assert_appends_only(before: dict, after: dict) -> None:
    """`after` is `before` with entries appended to its lists and nothing
    else changed."""
    if isinstance(before, dict):
        assert before.keys() == after.keys()
        for k in before:
            _assert_appends_only(before[k], after[k])
    elif isinstance(before, list):
        assert len(after) >= len(before)
        for b, a in zip(before, after):
            _assert_appends_only(b, a)
    else:
        assert before == after


@pytest.fixture
def untouched():
    """The real checkout's benchmark files are the same after the test."""
    before = _hashes()
    yield
    assert _hashes() == before


@pytest.fixture
def mirror(tmp_path, monkeypatch, untouched) -> dict:
    return _mirror(tmp_path, monkeypatch)


def test_the_added_cell_passes_the_contract_and_resolves_every_file(mirror):
    contract.check(mirror, harness.ROOT)
    c = harness.Cell.load(CELL)
    assert (c.config["name"], c.config["K"], c.chips) == (CONFIG, 30000, 1)
    assert c.mix == json.loads((harness.BENCH / "traffic" / "fit.json").read_text())
    assert c.limits == json.loads((ROOT / "portbench" / "limits" / f"{TWIN}.json").read_text())
    twin = harness.Cell.load(TWIN)
    assert [m["name"] for m in c.end_to_end] == [m["name"] for m in twin.end_to_end]
    assert [m["name"] for m in c.per_layer] == [m["name"] for m in twin.per_layer]
    cut = tiny.cell(CELL)
    assert {k: cut.config[k] for k in CUT["config"]} == CUT["config"]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_added_cell_runs_correct_at_a_tiny_size(mirror, tmp_path, trace):
    r, m, (correct, rows, failed) = tiny.run(CELL, tmp_path, trace=trace)
    assert correct and failed == 0, rows
    assert r.cell.name == CELL and r.job.X.shape == (64, 1024) and r.jobs >= 1
    specs = r.cell.per_layer if trace else r.cell.end_to_end
    if trace:  # no device on the CPU: only the readers of the host clock read
        assert set(m) == {"fit_mfu"}
    else:
        assert set(m) == {s["name"] for s in specs}
    assert all(v["value"] > 0 for v in m.values())


@pytest.mark.parametrize("fault", [state, half, answer], ids=lambda f: f.__name__)
def test_a_fault_in_the_added_cell_is_not_correct(mirror, tmp_path, fault):
    with pytest.MonkeyPatch.context() as mp:
        fault(mp)
        _, _, (correct, rows, failed) = tiny.run(CELL, tmp_path)
    assert not correct and failed > 0, rows


def test_the_added_cell_s_control_is_not_correct(mirror):
    c = tiny.cell(CELL)
    got = control.readings(CELL, 2**31 + 9, "cpu", True, c)
    limits = {k: v for k, v in c.limits.items() if k != "margins"}
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got


def test_a_configuration_without_a_cut_names_the_file_to_add(tmp_path, monkeypatch, untouched):
    _mirror(tmp_path, monkeypatch, cut=None)
    with pytest.raises(FileNotFoundError, match=f"add portbench/tests/cuts/{CONFIG}.json"):
        tiny.cell(CELL)
    with pytest.raises(AssertionError, match=CONFIG):
        contract.files(json.loads((harness.ROOT / "BENCHMARK.json").read_text()), harness.ROOT)


@pytest.mark.parametrize("cut", [
    {"config": {**CUT["config"], "latent_rank": 8}, "mix": {}},
    {"config": CUT["config"], "mix": {"lso_trials_per_row": 1}},
    {"config": CUT["config"]},
    {**CUT, "seconds": 1},
], ids=["config-key", "mix-key", "no-mix", "extra-part"])
def test_a_cut_that_brings_a_key_the_run_lacks_is_refused(tmp_path, monkeypatch, untouched, cut):
    _mirror(tmp_path, monkeypatch, cut=copy.deepcopy(cut))
    with pytest.raises(ValueError, match=f"{CONFIG}.json"):
        tiny.cell(CELL)


def test_every_configuration_has_a_cut_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cut = json.loads(tiny.cut_file(c["name"]).read_text())
        assert set(cut) == {"config", "mix"}, c["name"]

