"""A cell's run at a size the CPU holds, for the tests: the harness's own
steps (set-up, window, traced slice, check) with the configuration and the
mix cut down, on the CPU.  The harness's look for a card is skipped."""

from __future__ import annotations

from pathlib import Path

import torch

from portbench import harness

# the synthetic configuration cut to what a test holds; nir is run whole,
# with 60 LSO trials instead of 600
CUTS = {
    "synth-100k-5k-10": ({"N": 400, "K": 48, "M": 3, "A": 5}, {}),
    "gasoline-nir": ({}, {"lso_trials_per_row": 1}),
}


def cell(workload: str) -> harness.Cell:
    c = harness.Cell.load(workload)
    config, mix = CUTS[c.config["name"]]
    c.config.update(config)
    c.mix.update(mix)
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
