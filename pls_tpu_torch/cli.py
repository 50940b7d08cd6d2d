"""Command-line interface mirroring the reference executable.

Counterpart of `pls_tpu/cli.py` (reference main.cpp:10-44):

    python -m pls_tpu_torch X.csv Y.csv num_components [flags]

- bad argv → the usage block on stderr, exit 100;
- ragged CSV rows → the reference's exact message, exit 1; other bad input
  (missing file, non-numeric field, unported option) → "Error: ...", exit 1;
- z-score X and Y, fit kernel PLS type 1, print the model state, the
  explained variance for 1..A components, LOO validation (RMSE), then LSO
  validation (fraction 0.3, 10·N trials, the reference's default-seeded
  mt19937 partitions); `--cv kfold|all` adds k-fold validation on the JAX
  package's keyed fold labels, `--rng jax` its keyed LSO partitions;
- all output on stderr; stdout stays empty.

The run is on CUDA device 0 (`--device cuda`, the default) or, when asked,
on the CPU (`--device cpu`), the counterpart of the JAX CLI's
`JAX_PLATFORMS` handling.  Without a card and without `--device cpu` it
prints "Error: ..." and exits 1: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys

USAGE = (
    "Usage: ./pls X_data.csv Y_data.csv num_components\n"
    "NB: X and Y csvs must be comma delimited, square numerical data, "
    "with no headers."
)

# a CLI option of the JAX package that waits for a later part of the port
_NOT_PORTED_PREPROCESS = "--preprocess is not ported yet (ROADMAP queue 1 item 11)"


def build_parser() -> argparse.ArgumentParser:
    class _QuietParser(argparse.ArgumentParser):
        # bad argv prints only the usage block and exits 100 (main.cpp:12-16)
        def error(self, message):
            raise SystemExit(2)

    p = _QuietParser(prog="pls", add_help=True, usage=USAGE)
    p.add_argument("x_file")
    p.add_argument("y_file")
    p.add_argument("num_components", type=int)
    p.add_argument("--method", choices=["kernel1", "kernel2"], default="kernel1")
    p.add_argument(
        "--dtype", choices=["float64", "float32"], default=None,
        help="working precision (default: float64 on the CPU, float32 on CUDA)",
    )
    p.add_argument(
        "--cv", choices=["both", "loo", "lso", "kfold", "all", "none"], default="both",
        help="which cross-validations to run (default: both = loo+lso, like "
        "the reference CLI; all = loo+lso+kfold)",
    )
    p.add_argument("--kfold-k", type=int, default=10, help="folds for --cv kfold/all (default 10)")
    p.add_argument("--lso-frac", type=float, default=0.3)
    p.add_argument("--lso-trials", type=int, default=None, help="default: 10 * n_rows")
    p.add_argument(
        "--rng", choices=["gcc", "jax", "torch"], default="gcc",
        help="gcc = the reference's exact std::mt19937 partitions (default); "
        "jax = the JAX package's jax.random partitions; torch = a torch.Generator",
    )
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--alpha", type=float, default=0.1,
        help="Wilcoxon significance level for optimal-component selection",
    )
    p.add_argument("--json", metavar="PATH", default=None,
                   help="also write a structured JSON report")
    p.add_argument(
        "--x-storage", choices=["native", "bf16"], default="native",
        help="'bf16' stores X in bfloat16 with f32 accumulation",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the run goes: CUDA device 0 (default; exit 1 without a card) or the CPU",
    )
    p.add_argument("--preprocess", default=None, metavar="CHAIN")
    p.add_argument(
        "--format", choices=["real", "eigen-complex"], default="real", dest="fmt",
        help="matrix rendering in the state dump: real numbers (default) or the "
        "reference's Eigen complex '(re,0)' tuples for byte diffing",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        if e.code == 0:  # --help
            return 0
        print(USAGE, file=sys.stderr)
        return 100
    if args.preprocess:
        print(f"Error: {_NOT_PORTED_PREPROCESS}", file=sys.stderr)
        return 1

    import torch

    from pls_tpu_torch.config import PLSRunConfig, default_device, run_pipeline
    from pls_tpu_torch.types import METHOD
    from pls_tpu_torch.utils.io import RaggedMatrixError

    try:
        device = torch.device("cpu") if args.device == "cpu" else default_device()
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    cfg = PLSRunConfig(
        x_file=args.x_file,
        y_file=args.y_file,
        num_components=args.num_components,
        method=METHOD(args.method),
        dtype=args.dtype,
        cv={
            "both": ("loo", "lso"), "loo": ("loo",), "lso": ("lso",),
            "kfold": ("kfold",), "all": ("loo", "lso", "kfold"), "none": (),
        }[args.cv],
        lso_fraction=args.lso_frac,
        lso_trials=args.lso_trials,
        kfold_k=args.kfold_k,
        rng=args.rng,
        seed=args.seed,
        alpha=args.alpha,
        json_out=args.json,
        complex_format=(args.fmt == "eigen-complex"),
        x_storage=None if args.x_storage == "native" else args.x_storage,
    )
    try:
        run_pipeline(cfg, device=device)
    except RaggedMatrixError as e:
        print(str(e), file=sys.stderr)
        return e.exit_code
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
