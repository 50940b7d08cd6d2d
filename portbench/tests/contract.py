"""The benchmark's contract, as checks of a BENCHMARK.json dict and the root
of the checkout that holds it: `check(bench, root)` runs them all.  Cells
are loaded by the harness, which has to point at `root` (`harness.ROOT`,
`harness.BENCH`)."""

from __future__ import annotations

import re
from pathlib import Path

from portbench import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def names_and_units(bench: dict, root: Path) -> None:
    cells = [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    names += [c["name"] for c in bench["configs"]] + cells
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(cells)) == len(cells)
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert all(UNIT.fullmatch(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    text = [c["why"] for c in bench["configs"] + bench["workloads"]]
    text += [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s for s in text)
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024


def keys(bench: dict) -> None:
    """Every entry's keys, the bounds, the run's length and the chips: 1 or
    4 a cell, and at most max(1, a quarter of the cells, rounded down) on 4."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    assert 1 <= bench["run_seconds"] <= 51
    chips = [w["chips"] for w in bench["workloads"]]
    assert all(type(n) is int and n in (1, 4) for n in chips), chips
    assert chips.count(4) <= max(1, len(chips) // 4), chips


def files(bench: dict, root: Path) -> None:
    """Every file a cell needs resolves by name under `root`, every cell
    reports `setup_s`, another end-to-end metric and a per-layer one, and
    every configuration has a cell, a file of its own and a CPU cut."""
    assert harness.ROOT == root, "point harness.ROOT and harness.BENCH at root first"
    base = root / "portbench"
    for w in bench["workloads"]:
        c = harness.Cell.load(w["name"], root / "BENCHMARK.json")
        assert (base / "traffic" / f"{w['traffic']}.json").exists()
        assert (base / "limits" / f"{w['name']}.json").exists()
        assert (base / "jobs" / f"{c.mix['job']}.py").exists()
        for m in c.end_to_end + c.per_layer:
            assert (base / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert any(m["name"] != "setup_s" for m in c.end_to_end) and c.per_layer
        assert {m["moves"] for m in c.per_layer} <= {m["name"] for m in c.end_to_end}
    for c in bench["configs"]:
        assert (root / c["file"]).exists() and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    missing = [c["name"] for c in bench["configs"]
               if not (base / "tests" / "cuts" / f"{c['name']}.json").exists()]
    assert not missing, f"no CPU cut in portbench/tests/cuts/ for {missing}"


def check(bench: dict, root: Path) -> None:
    names_and_units(bench, root)
    keys(bench)
    files(bench, root)
