"""One rank of tests/test_torch_parallel.py's spawned runs (gloo, CPU).

    python tests/torch_parallel_worker.py DIR --rank R --world-size N --init-method URL

Reads DIR/inputs.npz, calls every function of `pls_tpu_torch.parallel` on
this rank's share of the data over meshes of N ranks, and writes the
replicated outputs to DIR/rank<R>.npz.  Imports no jax: the test holds the
outputs against the JAX package.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pls_tpu_torch import KERNEL_TYPE1, KERNEL_TYPE2, coefficients  # noqa: E402
from pls_tpu_torch.parallel import (  # noqa: E402
    cv_lso_rowsharded,
    cv_lso_sharded,
    cv_loo_sharded,
    fit_colsharded,
    fit_rowsharded_shardmap,
    fit_sharded,
    initialize_distributed,
    make_pls_mesh,
    train_step,
)
from pls_tpu_torch.parallel.sharded import shard_cols, shard_rows  # noqa: E402

TIMEOUT_SEC = 60  # a collective that waits longer fails the rank


def folds_mesh_shape(n: int) -> tuple[int, int]:
    """(rows, folds) of the two-axis mesh at n ranks: (2, 2) at 4."""
    return (n // 2, 2) if n % 2 == 0 else (n, 1)


def run(d: dict, n: int) -> dict:
    X, Y = torch.from_numpy(d["X"]), torch.from_numpy(d["Y"])
    X32, Y32 = X.float(), Y.float()
    A = 4
    out = {}
    rows = make_pls_mesh(rows=n, folds=1, device="cpu")

    def rs(Z):
        return shard_rows(Z, rows)

    f = fit_sharded(rs(X), rs(Y), A, mesh=rows)
    out["fit_sharded"] = coefficients(f)
    out["fit_sharded_T_shape"] = torch.tensor(f.T.shape)
    f = fit_sharded(rs(X32), rs(Y32), A, mesh=rows, x_storage="bf16")
    out["fit_sharded_bf16"] = coefficients(f)
    out["fit_sharded_bf16_dtype_f32"] = torch.tensor(f.W.dtype == torch.float32)
    for type1 in (True, False):
        f = fit_rowsharded_shardmap(rs(X), rs(Y), A, type1=type1, mesh=rows)
        out[f"shardmap_{type1}"] = coefficients(f)
        out[f"shardmap_{type1}_T"] = f.T
    f = fit_rowsharded_shardmap(rs(X32), rs(Y32), 3, mesh=rows, use_kernel=True)
    out["shardmap_kernel_W"], out["shardmap_kernel_T"] = f.W, f.T
    out["shardmap_kernel"] = coefficients(f)
    for method in (KERNEL_TYPE1, KERNEL_TYPE2):
        f = fit_colsharded(shard_cols(X, rows), Y, A, method, mesh=rows)
        out[f"colsharded_{method.value}"] = coefficients(f)
    out["lso_rowsharded"] = cv_lso_rowsharded(
        rs(X), rs(Y), A, d["parts_row"], 48, mesh=rows, trial_batch=2).errors
    # uneven blocks (at 4 ranks: 16, 16, 16, 15 rows)
    out["fit_sharded_uneven"] = coefficients(fit_sharded(rs(X[:63]), rs(Y[:63]), A, mesh=rows))

    folds = make_pls_mesh(rows=1, folds=n, device="cpu")
    out["lso_sharded"] = cv_lso_sharded(X, Y, A, d["parts_lso"], 48, mesh=folds).errors
    out["loo_sharded"] = cv_loo_sharded(X, Y, A, mesh=folds).errors

    r, k = folds_mesh_shape(n)
    both = make_pls_mesh(rows=r, folds=k, device="cpu")
    out["lso_sharded_2axes"] = cv_lso_sharded(X, Y, A, d["parts_lso"], 48, mesh=both).errors
    f, press = train_step(shard_rows(X, both), shard_rows(Y, both), A, d["parts_step"], 48,
                          mesh=both)
    out["train_step"], out["train_step_press"] = coefficients(f), press
    return {k: v.numpy() for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    args = ap.parse_args()
    initialize_distributed(args.init_method, args.world_size, args.rank, device="cpu",
                           timeout_sec=TIMEOUT_SEC)
    try:
        with np.load(Path(args.dir) / "inputs.npz") as z:
            out = run(dict(z), args.world_size)
    finally:
        dist.destroy_process_group()
    np.savez(Path(args.dir) / f"rank{args.rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
