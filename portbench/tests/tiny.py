"""A cell's run at a size the CPU holds, for the tests: the harness's own
steps (set-up, window, traced slice, check) with the configuration and the
mix cut down, on the CPU.  The harness's look for a card is skipped.

Each configuration's cut is its own file, `portbench/tests/cuts/<name>.json`
(`<name>` as `configs[].name` in BENCHMARK.json), of the form
`{"config": {...}, "mix": {...}}`: values that replace the configuration's
and the cell's mix's own.  A cut names only keys they already have, so it
cannot bring in a setting that the run never reads.  The synthetic
configuration is cut to what a test holds; nir is run whole, with 60 LSO
trials instead of 600.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench import harness


def cut_file(config: str) -> Path:
    """The cut of configuration `config`, in the checkout the harness
    points at."""
    return harness.BENCH / "tests" / "cuts" / f"{config}.json"


def cell(workload: str) -> harness.Cell:
    c = harness.Cell.load(workload)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"] if w["name"] == workload)
    path = cut_file(config)
    if not path.exists():
        raise FileNotFoundError(
            f"configuration {config!r} has no CPU cut: add {path.relative_to(harness.ROOT)}, "
            '{"config": {...}, "mix": {...}}')
    cut = json.loads(path.read_text())
    if set(cut) != {"config", "mix"}:
        raise ValueError(f"{path.name}: a cut has the keys 'config' and 'mix', not {sorted(cut)}")
    for part, into in (("config", c.config), ("mix", c.mix)):
        unknown = sorted(set(cut[part]) - set(into))
        if unknown:
            raise ValueError(f"{path.name}: the {part} of {workload} has no {unknown}")
        into.update(cut[part])
    return c


def run(workload: str, tmp: Path, *, trace: bool = False, seconds: float = 0.2,
        seed: int = 2**31 + 77) -> tuple[harness.Run, dict, tuple]:
    """(the run, its metrics, harness.check's (correct, rows, failed))."""
    c = cell(workload)
    r = harness.Run(c, seed, seconds, torch.device("cpu"))
    harness.measure(r, 0.0, trace, tmp)
    m = harness.metrics(r, c.per_layer if trace else c.end_to_end)
    r.job.release()
    return r, m, harness.check(r)
