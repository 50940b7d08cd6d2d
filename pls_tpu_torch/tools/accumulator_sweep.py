"""Chunk-size sweep of the streaming statistics update on one CUDA card.

    python -m pls_tpu_torch.tools.accumulator_sweep [--k 10000] [--m 10]
        [--chunks 4096 8192 16384 32768] [--reps 3]

The port of tools/accumulator_sweep.py, with its CLI: the sweep behind the
default rows per chunk of the `.npy` ingest (`utils/binio.auto_chunk_rows`).
For each chunk size, X (chunk, K) and Y (chunk, M) are drawn on the card
from a seeded generator in float32 and kept there, with bfloat16 copies;
`models.streaming.StatsAccumulator.update` runs on them in float32 and
with x_storage="bf16" on the bf16 chunks (widened to float32 for the
products), full float32 products (TF32 off, as the port runs them).  The
updates of a loop accumulate into one XᵀX, so each waits on the last; a
loop of 3 and one of 13 are timed with CUDA events, each the best of
--reps, and the slope between them (÷ 10) is the time per update, so
launch constants cancel.  FLOPs are counted as 2·chunk·K² + 2·chunk·K·M.
Beside each row the card's own GEMM rate at the chunk's shape,
`torch.matmul(Xᵀ, X)` in float32 with TF32 off, timed the same way in the
same run (`gemm_tflops`; the update's `gemm_share`), and `ms_range`, the
least and most of the --reps per-pair slopes (the run's spread).

Progress goes to stderr; stdout is one JSON object:
{"device": "<name>, <power limit>" (nvidia-smi), "K", "M",
 "sweep": {"f32_<chunk>" | "bf16_<chunk>": {"ms_per_update", "tflops",
 "chunk_gbps", "gemm_tflops", "gemm_share", "ms_range"}}}.
Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

SHORT, LONG = 3, 13


def log(msg: str) -> None:
    print(f"[accsweep {time.strftime('%T')}] {msg}", file=sys.stderr, flush=True)


def loop_seconds(step, iters: int) -> float:
    """CUDA-event seconds of `iters` calls of step, back to back."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        step()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 1e3


def slope(step, reps: int) -> tuple[float, float, float]:
    """(seconds per call from the best loops, least and most per-pair
    slope) of step: loops of LONG and SHORT calls, `reps` of each."""
    step()  # warm-up: cuBLAS's choice, the allocator's blocks
    pairs = [(loop_seconds(step, LONG), loop_seconds(step, SHORT)) for _ in range(reps)]
    per = (min(p[0] for p in pairs) - min(p[1] for p in pairs)) / (LONG - SHORT)
    each = [(lo - sh) / (LONG - SHORT) for lo, sh in pairs]
    return per, min(each), max(each)


def sweep(K: int, M: int, chunks: list[int], reps: int, seed: int = 0) -> dict:
    from pls_tpu_torch.models.streaming import StatsAccumulator

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(seed)
    results = {}
    for chunk in chunks:
        Xc = torch.randn((chunk, K), generator=g, device=dev)
        Yc = torch.randn((chunk, M), generator=g, device=dev)
        Xb, Yb = Xc.to(torch.bfloat16), Yc.to(torch.bfloat16)
        gram = torch.empty((K, K), device=dev)
        gemm, _, _ = slope(lambda: torch.matmul(Xc.mT, Xc, out=gram), reps)
        gemm_tf = 2 * chunk * float(K) * K / gemm / 1e12
        del gram
        flops = 2 * chunk * (float(K) * K + K * M)
        for label, storage, xa, ya in (("f32", None, Xc, Yc), ("bf16", "bf16", Xb, Yb)):
            acc = StatsAccumulator(K, M, x_storage=storage, precision="highest", device=dev)
            per, lo, hi = slope(lambda: acc.update(xa, ya), reps)
            tf = flops / per / 1e12
            gbps = chunk * K * xa.element_size() / per / 1e9
            log(f"chunk={chunk:6d} {label}: {per * 1e3:8.3f} ms/update -> {tf:6.2f} TFLOP/s "
                f"({tf / gemm_tf:.3f} of the GEMM's {gemm_tf:.2f}), {gbps:6.1f} GB/s chunk-stream")
            results[f"{label}_{chunk}"] = {
                "ms_per_update": per * 1e3, "tflops": tf, "chunk_gbps": gbps,
                "gemm_tflops": gemm_tf, "gemm_share": tf / gemm_tf,
                "ms_range": [lo * 1e3, hi * 1e3],
            }
            del acc
        del Xc, Yc, Xb, Yb
        torch.cuda.empty_cache()
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--chunks", type=int, nargs="+", default=[4096, 8192, 16384, 32768])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("accumulator_sweep: no CUDA device; the sweep times the update on the card",
              file=sys.stderr)
        return 1
    from pls_tpu_torch.tools.kernel_variants import card

    torch.backends.cuda.matmul.allow_tf32 = False
    device = card()
    log(f"device={device} K={args.k} M={args.m}")
    results = sweep(args.k, args.m, args.chunks, args.reps)
    print(json.dumps({"device": device, "K": args.k, "M": args.m, "sweep": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
