"""Accumulation error of the streaming statistics at large N, on the card.

    python -m pls_tpu_torch.tools.precision_at_scale [--n 10000000] [--chunk 16384]
                                                     [--k 64] [--m 4] [--out result.json]

The port of `tools/precision_at_scale.py`.  It streams `n` rows of
standard-normal float32 data, made chunk by chunk from a seeded generator
on the card, through a plain float32 `StatsAccumulator` and a compensated
one (float64 accumulators, read as the JAX package's hi + lo pairs), and
records at about 12 logarithmic checkpoints the largest error of XᵀY and
XᵀX relative to their largest entry, against a float64 accumulation of
the same float32 chunks on the card (so the inputs' own rounding is not
counted).  The plain error grows with the number of chunks; the
compensated one should not.  Prints progress on stderr and one JSON
record on stdout (also written to `--out`), with the card's name and power
limit.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def run(n_total: int, chunk: int, K: int, M: int = 4, seed: int = 0,
        device: torch.device | None = None) -> dict:
    from pls_tpu_torch.models.streaming import StatsAccumulator

    dev = torch.device("cuda", 0) if device is None else device
    g = torch.Generator(dev).manual_seed(seed)
    plain = StatsAccumulator(K, M, torch.float32, precision="highest", device=dev)
    comp = StatsAccumulator(K, M, torch.float32, compensated=True, device=dev)
    XX64 = torch.zeros((K, K), dtype=torch.float64, device=dev)
    XY64 = torch.zeros((K, M), dtype=torch.float64, device=dev)

    def err(hi, lo, truth) -> float:
        got = hi.double() if lo is None else hi.double() + lo.double()
        return float((got - truth).abs().max() / truth.abs().max())

    n_chunks = n_total // chunk
    checks = sorted({max(1, int(round(n_chunks ** (i / 11)))) for i in range(12)})
    curves = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ci in range(1, n_chunks + 1):
        Xc = torch.randn((chunk, K), generator=g, device=dev)
        Yc = torch.randn((chunk, M), generator=g, device=dev)
        Xd, Yd = Xc.double(), Yc.double()
        XX64.addmm_(Xd.T, Xd)
        XY64.addmm_(Xd.T, Yd)
        plain.update(Xc, Yc)
        comp.update(Xc, Yc)
        if ci in checks:
            rec = {
                "n_rows": ci * chunk,
                "n_chunks": ci,
                "xy_err_plain": err(plain.XY, None, XY64),
                "xy_err_comp": err(comp.XY, comp.XYe, XY64),
                "xx_err_plain": err(plain.XX, None, XX64),
                "xx_err_comp": err(comp.XX, comp.XXe, XX64),
            }
            curves.append(rec)
            print(f"n={rec['n_rows']:>10,}  XY err plain={rec['xy_err_plain']:.3e} "
                  f"comp={rec['xy_err_comp']:.3e}   XX err plain={rec['xx_err_plain']:.3e} "
                  f"comp={rec['xx_err_comp']:.3e}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {
        "n_total": n_chunks * chunk, "chunk": chunk, "K": K, "M": M, "seed": seed,
        "device": str(dev),
        "card": _card() if dev.type == "cuda" else "cpu",
        "wall_sec": wall,
        "curves": curves,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("precision_at_scale: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    report = run(args.n, args.chunk, args.k, args.m)
    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
