"""Cold-process wall of the reference's flagship workload through the port.

    python -m pls_tpu_torch.tools.flagship_wall [--runs 3] [--out f.json] [--device cuda|cpu]

The port of tools/flagship_wall.py: the whole CLI pipeline

    python -m pls_tpu_torch nir.csv octane.csv 10 --device <device>

(read the CSVs, z-score, fit A = 10, print the state and the explained
variance, LOO's 60 refits, LSO's 600 trials of 30 % held out, the
Wilcoxon choice; reference main.cpp:29-41), timed as a subprocess from
start to exit: process start-up, imports, the kernel libraries' load (and
build, if a run finds none) and all.  Every run's wall is reported;
`cold_sec` is the first, which pays the libraries' load, and
`warm_best_sec` the best.  --device cuda (the default) needs a card and
exits 1 without one; --device cpu runs the float64 CPU path.

Prints each run to stderr and one JSON object on stdout (also written to
--out): {"workload", "device" (nvidia-smi's name and power limit on the
card, "cpu" on the CPU), "walls_sec", "cold_sec", "warm_best_sec"}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
WORKLOAD = "pls nir.csv octane.csv 10 (fit + LOO + 600-trial LSO)"


def run_once(device: str) -> tuple[float, subprocess.CompletedProcess]:
    """(wall seconds, the finished process) of one CLI run."""
    from pls_tpu_torch.datasets import _DATA

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the package of this checkout, from its root
    argv = [sys.executable, "-m", "pls_tpu_torch", str(_DATA / "nir.csv"),
            str(_DATA / "octane.csv"), "10", "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=_REPO)
    return time.perf_counter() - t0, proc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("flagship_wall: no CUDA device (pass --device cpu for the CPU path)",
                  file=sys.stderr)
            return 1
        from pls_tpu_torch.tools.kernel_variants import card

        device = card()
    else:
        device = "cpu"
    walls = []
    for i in range(args.runs):
        wall, proc = run_once(args.device)
        if proc.returncode != 0:
            print(f"flagship_wall: the CLI exited {proc.returncode}:\n{proc.stderr[-2000:]}",
                  file=sys.stderr)
            return 1
        walls.append(wall)
        print(f"[flagship] run {i}: {wall:.3f} s", file=sys.stderr, flush=True)
    out = {"workload": WORKLOAD, "device": device, "walls_sec": walls,
           "cold_sec": walls[0], "warm_best_sec": min(walls)}
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
