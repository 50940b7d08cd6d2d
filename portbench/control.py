"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--no-control]

For each seed: the cell's inputs, as many jobs as a run checks, run as the
window runs them, and their readings against the float64 reference (the
lower readings: what sound runs of the program give); then the control's
readings: the reference one precision down in the program's place (float32
with TF32 products, or float8 X for a bfloat16 cell), which the limits
have to fail (the upper readings).  Prints one JSON line a seed.  The
benchmark's own runs never run this.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def readings(workload: str, seed: int, device, control: bool = True, cell=None) -> dict:
    """{"program": worst reading of each number over the checked jobs,
    "control": the control's readings} for one seed."""
    import torch

    from portbench import harness

    cell = cell or harness.Cell.load(workload)
    job = harness.load_module(harness.BENCH / "jobs" / f"{cell.mix['job']}.py").Job(
        cell.config, cell.mix, seed, torch.device(device))
    for i in range(cell.mix["checked"]):
        job.keep(job.run(i))
    job.release()
    got = job.check(cell.limits)
    out = {"seed": seed, "program": {k: max(r[k] for r in got) for k in got[0]}}
    if control:
        out["control"] = job.control(cell.limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        t = time.perf_counter()
        rec = readings(args.workload, seed, "cuda", not args.no_control)
        rec["s"] = time.perf_counter() - t
        print(json.dumps({"workload": args.workload, **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
