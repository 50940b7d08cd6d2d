"""Scaling report: the row-sharded fit and the fold-sharded CV at 1/2/4/8 ranks.

    python3 -m pls_tpu_torch.tools.scaling_report [--devices 8] [--n 4096] [--k 512]
        [--m 4] [--a 8] [--trials 16] [--device cuda|cpu] [--out report.json]

Counterpart of `tools/scaling_report.py`.  For each world size it starts
that many ranks (`parallel.launch.spawn_ranks`), which time
`fit_sharded` on a 'rows' mesh and `cv_lso_sharded` on a 'folds' mesh
(host clock around calls that end in a synchronise; mean of 5 fits after
one, of 2 CV runs after one), and prints one JSON report.

On the card (the default) the ranks run NCCL, one card each, for the
world sizes the host's cards cover: one on a one-card machine, which
measures no scaling.  The report then gives each world size's seconds and,
past one rank, its efficiency against one rank; it prints the card's name
and power limit first.  Without a card it exits 1.  --device cpu runs
gloo ranks on the CPU in path-validation mode, as the JAX tool's virtual
mode (`tools/scaling_report.py:90-102`): the ranks timeslice one host's
cores, so no efficiency is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

TIMEOUT_SEC = 600  # for each world size's run, and for each collective


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps: int) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def rank_main(args) -> int:
    """One rank: time the two calls and, on rank 0, print their seconds."""
    import torch.distributed as dist

    from pls_tpu_torch.parallel import (cv_lso_sharded, fit_sharded, initialize_distributed,
                                        make_pls_mesh)
    from pls_tpu_torch.parallel.sharded import shard_rows

    device = "cpu" if args.device == "cpu" else None
    initialize_distributed(args.init_method, args.world_size, args.rank, device=device,
                           timeout_sec=TIMEOUT_SEC)
    try:
        rows = make_pls_mesh(rows=args.world_size, folds=1, device=device)
        folds = make_pls_mesh(rows=1, folds=args.world_size, device=device)
        g = torch.Generator().manual_seed(0)
        X = torch.randn((args.n, args.k), generator=g).to(rows.device)
        Y = torch.randn((args.n, args.m), generator=g).to(rows.device)
        parts = torch.stack([torch.randperm(args.n, generator=g) for _ in range(args.trials)])
        train = (3 * args.n) // 4
        Xl, Yl = shard_rows(X, rows), shard_rows(Y, rows)
        fit_s = _timed(lambda: fit_sharded(Xl, Yl, args.a, mesh=rows, precision=None), rows.device, 5)
        cv_s = _timed(lambda: cv_lso_sharded(X, Y, args.a, parts, train, mesh=folds,
                                             precision=None), rows.device, 2)
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        print(json.dumps({"fit_s": fit_s, "cv_s": cv_s}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="the largest world size tried")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--a", type=int, default=8)
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)

    from pls_tpu_torch.parallel.launch import spawn_ranks

    hw = args.device == "cuda"
    if hw and not torch.cuda.is_available():
        print("scaling_report: no CUDA device (--device cpu validates the paths on the CPU)",
              file=sys.stderr)
        return 1
    report = {"backend": "nccl" if hw else "gloo", "mode": "hw" if hw else "path-validation",
              "shape": [args.n, args.k, args.m, args.a], "trials": args.trials,
              "rows_scaling": {}, "folds_scaling": {}}
    cards = args.devices
    if hw:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0])
        cards = torch.cuda.device_count()
        report["device"] = {"kind": torch.cuda.get_device_name(0), "count": cards}
    else:
        report["disclaimer"] = (
            "path-validation only: gloo ranks on the CPU timeslice one host's cores, so "
            "per-rank efficiency cannot be measured and is omitted; measure with one card "
            "per rank (NCCL) for scaling"
        )
    root = Path(__file__).resolve().parents[2]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "pls_tpu_torch.tools.scaling_report", "--n", str(args.n),
           "--k", str(args.k), "--m", str(args.m), "--a", str(args.a),
           "--trials", str(args.trials), "--device", args.device]
    base = None
    for d in (1, 2, 4, 8):
        if d > min(args.devices, cards):
            break
        outs = spawn_ranks(cmd, d, timeout_sec=TIMEOUT_SEC, env=env)
        t = json.loads(outs[0].strip().splitlines()[-1])
        base = base or t
        report["rows_scaling"][d] = {"sec": t["fit_s"]}
        report["folds_scaling"][d] = {"sec": t["cv_s"]}
        if hw and d > 1:
            report["rows_scaling"][d]["efficiency"] = base["fit_s"] / (t["fit_s"] * d)
            report["folds_scaling"][d]["efficiency"] = base["cv_s"] / (t["cv_s"] * d)
        print(f"ranks={d} fit={t['fit_s'] * 1e3:.3f} ms cv={t['cv_s'] * 1e3:.3f} ms",
              file=sys.stderr)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
