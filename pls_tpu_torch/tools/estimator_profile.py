"""Where an estimator's fit spends its time on the card, and when the grid
search's fold batches pay.

    python -m pls_tpu_torch.tools.estimator_profile [--seed 0] [--out result.json]

Readings on data made on the card from `--seed` (a rank-30 latent model
plus noise, z-scored; M = 10 responses, A = 20 components), as phase 9 of
chip_smoke.py makes it:

1. `PLSRegressor.fit` at 100000×5000 under torch.profiler: its wall (CUDA
   events), the device time the profiler records, the part of it in the
   deflation kernel's kernels, and the top device ops;
2. the host syncs of `PLSRegressor.fit` and of `RobustPLSRegressor.fit` at
   that size, by their place in the Python code (torch's sync debug mode);
3. `grid_search_cv` over n_components 1..20 with 5 folds at 2000×500,
   10000×1000 and 100000×5000: its wall (the median of 3 calls after one
   warm-up) and peak device memory, with the folds in batches of the
   default policy (`utils.batching.fold_batch_size`), of 1 (one
   un-batched fit a fold, K1) and of 5 (one batched fit).

Prints one JSON record on stdout (also written to `--out`) with the card's
name and power limit.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import warnings
from pathlib import Path

import torch

from pls_tpu_torch.tools.precision_at_scale import _card

BIG = (100_000, 5_000)
GRID_SIZES = [(2_000, 500), (10_000, 1_000), BIG]
A, M, FOLDS = 20, 10, 5
# the deflation kernel's CUDA kernels (csrc/deflate.cu, csrc/deflate_common.cuh)
KERNEL_NAMES = ("deflate_cols", "deflate_rows", "row_dots", "strip_partials", "reduce_partials",
                "tree_sum")


def make_data(dev, seed: int, N: int, K: int):
    """N×K X, 10 Y: a rank-30 latent model plus noise, z-scored."""
    from pls_tpu_torch.ops.stats import colwise_z_scores

    g = torch.Generator(dev).manual_seed(seed)
    lat = torch.randn((N, 30), generator=g, device=dev)
    X = lat @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = lat @ torch.randn((30, M), generator=g, device=dev)
    Y += 0.1 * torch.randn((N, M), generator=g, device=dev)
    return colwise_z_scores(X), colwise_z_scores(Y)


def event_wall(fn):
    """(fn(), seconds between CUDA events recorded around it)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1) / 1e3


def device_breakdown(fn) -> dict:
    """fn's wall (CUDA events), the device time torch.profiler records and
    the part of it in the deflation kernel, and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = event_wall(fn)
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    total = sum(ms for _, ms in rows)
    kern = sum(ms for k, ms in rows if any(n in k for n in KERNEL_NAMES))
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return {"wall_ms": wall * 1e3, "device_ms": total, "kernel_ms": kern,
            "top": [(k[:60], round(ms, 3)) for k, ms in top]}


def count_syncs(fn) -> dict:
    """{"file:line": n}: the host syncs fn made, by where in the Python
    code they happened (torch's sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where: dict = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def grid_batches(dev, seed: int, N: int, K: int) -> dict:
    """grid_search_cv's median wall and peak memory by fold batch size."""
    import pls_tpu_torch as tt
    from pls_tpu_torch.utils.batching import fold_batch_size

    X, Y = make_data(dev, seed, N, K)
    out = {"N": N, "K": K, "policy_batch": fold_batch_size(FOLDS, X)}
    for name, bs in (("policy", None), ("1", 1), (str(FOLDS), FOLDS)):
        def search():
            return tt.grid_search_cv(lambda: tt.PLSRegressor(), {"n_components": list(
                range(1, A + 1))}, X, Y, n_folds=FOLDS, key=seed, batch_size=bs)

        search()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = [event_wall(search)[1] for _ in range(3)]
        out[name] = {"s": statistics.median(walls), "walls_s": walls,
                     "peak_GiB": torch.cuda.max_memory_allocated(dev) / 2**30}
    del X, Y
    torch.cuda.empty_cache()
    return out


def run(seed: int = 0) -> dict:
    import pls_tpu_torch as tt

    dev = torch.device("cuda", 0)
    X, Y = make_data(dev, seed, *BIG)
    tt.PLSRegressor(A).fit(X, Y)  # warm-up
    tt.RobustPLSRegressor(A).fit(X, Y)
    rec = {"card": _card(), "torch": torch.__version__, "shape": [*BIG, M], "A": A}
    rec["PLSRegressor_breakdown"] = device_breakdown(lambda: tt.PLSRegressor(A).fit(X, Y))
    rec["PLSRegressor_syncs"] = count_syncs(lambda: tt.PLSRegressor(A).fit(X, Y))
    rec["RobustPLSRegressor_syncs"] = count_syncs(lambda: tt.RobustPLSRegressor(A).fit(X, Y))
    print(json.dumps(rec), file=sys.stderr)
    del X, Y
    torch.cuda.empty_cache()
    rec["grid_search_cv"] = []
    for N, K in GRID_SIZES:
        rec["grid_search_cv"].append(grid_batches(dev, seed, N, K))
        print(json.dumps(rec["grid_search_cv"][-1]), file=sys.stderr)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("estimator_profile: no CUDA device", file=sys.stderr)
        return 1
    rec = run(args.seed)
    text = json.dumps(rec)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
