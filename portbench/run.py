"""Run one cell of BENCHMARK.json once on one card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up makes the cell's inputs on the card
from `--seed` and runs one job, which builds the program's kernels into
the checkout's build/ the first time; then jobs run back to back for
`--seconds` (the measured window).  With `--trace 1` a few more jobs run
under torch.profiler, and the line carries the cell's per-layer metrics
instead of its end-to-end ones.  After the window the program's answers
are checked against the plain float64 reference (portbench/reference/);
each number compared is printed beside its limit on standard error and,
under "checks", as the result line's last key.

The last line on standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs) and checks.  Exits 1 with
no result without a CUDA device (or with fewer than the cell's), or if
JAX or the JAX package was loaded; 2 where the program cannot be
imported.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """The process's start on the wall clock (Linux: from /proc)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
sys.path[0] = str(ROOT)  # the checkout, not portbench/, is the import root
# every kernel cache of the run at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        import pls_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not importable here: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    run = harness.Run(cell, args.seed, args.seconds, dev)
    harness.measure(run, PROCESS_START, bool(args.trace),
                    Path(os.environ.get("TMPDIR", "/tmp")))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
              "power_limit_w": harness.power_limit_w()}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
    line = {"metrics": harness.metrics(run, cell.per_layer if args.trace else cell.end_to_end)}
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
        run.trace = None
    run.job.release()
    correct, rows, failed = harness.check(run)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 1
    result = {"correct": correct, "attempted": run.jobs, "failed": failed, **line,
              "device": device,
              "checks": {name: {"value": value, "limit": limit} for name, value, limit in rows}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
