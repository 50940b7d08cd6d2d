"""Run configuration for the reference CLI pipeline.

Counterpart of `pls_tpu/config.py`: every knob of `pls X.csv Y.csv A` in
one dataclass, consumed by the CLI (cli.py) and by programmatic callers.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import torch

from pls_tpu_torch.types import KERNEL_TYPE1, METHOD


@dataclass
class PLSRunConfig:
    x_file: str
    y_file: str
    num_components: int
    method: METHOD = KERNEL_TYPE1
    dtype: str | None = None  # None = float64 on the CPU, float32 on CUDA
    cv: tuple[str, ...] = ("loo", "lso")  # subset of {"loo", "lso", "kfold"}
    lso_fraction: float = 0.3
    lso_trials: int | None = None  # None = 10 * n_rows (reference main.cpp:40)
    kfold_k: int = 10  # folds for "kfold"
    # "gcc" = the reference's exact partitions | "jax" = the JAX package's
    # jax.random partitions | "torch" = a torch.Generator
    rng: str = "gcc"
    seed: int | None = None  # None = 5489 (gcc) / 0 (jax, torch); also keys k-fold
    alpha: float = 0.1  # Wilcoxon selector level (pls.h:152)
    json_out: str | None = None
    complex_format: bool = False  # Eigen '(re,0)' tuples for byte diffing
    x_storage: str | None = None  # "bf16" = X stored narrow, f32 accumulation


def default_device() -> torch.device:
    """CUDA device 0.  The port runs on the card unless a caller asks for
    the CPU, so without a card this raises RuntimeError instead of falling
    back: pass device="cpu" (`--device cpu` on the command line)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: pass device="cpu" (--device cpu on the command line) '
            "to run on the CPU"
        )
    return torch.device("cuda", 0)


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on: `device` when the caller gives
    one, else that of the tensor `like` the caller passed in, else
    `default_device()` (the card, or RuntimeError without one)."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return default_device()


def run_pipeline(cfg: PLSRunConfig, *, file=None, device: torch.device | None = None) -> dict:
    """Run the reference CLI pipeline (reference main.cpp:21-41) under
    `cfg`: read → z-score both → fit → print state + EV → LOO → LSO →
    k-fold (`pls_tpu/config.py:40-129`).  Returns the report dict; raises
    utils.io errors on bad input.  `device` None is `default_device()`:
    the card, or RuntimeError without one."""
    from pls_tpu_torch.cv.validation import optimal_num_components, print_validation, validation
    from pls_tpu_torch.model import PLSModel
    from pls_tpu_torch.ops.stats import colwise_z_scores
    from pls_tpu_torch.types import MSE, default_float_dtype
    from pls_tpu_torch.utils.gcc_rng import GccRng
    from pls_tpu_torch.utils.io import read_matrix_file

    file = sys.stderr if file is None else file
    device = resolve_device(device)
    if device.type == "cuda":
        # full float32 products, as the JAX package's precision="highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg.dtype) if cfg.dtype else default_float_dtype(device)

    def load(path):
        return colwise_z_scores(torch.as_tensor(read_matrix_file(path), dtype=dtype, device=device))

    X = load(cfg.x_file)
    Y = load(cfg.y_file)
    model = PLSModel(X, Y, cfg.method, cfg.num_components, x_storage=cfg.x_storage)
    model.print_state(file=file, complex_format=cfg.complex_format)
    model.print_explained_variance(X, Y, file=file)

    _, ev_profile = model.explained_variance_profile()
    report: dict = {
        "method": cfg.method.value,
        "num_components": model.A,
        "dtype": str(dtype).removeprefix("torch."),
        "device": str(device),
        "alpha": cfg.alpha,
        "explained_variance": {
            str(c): ev_profile[c - 1].tolist() for c in range(1, model.A + 1)
        },
    }

    def record(name, residual):
        print_validation(residual, MSE, file=file, alpha=cfg.alpha)
        report[f"{name}_rmse"] = validation(residual, MSE).sqrt().tolist()
        report[f"{name}_optimal_components"] = optimal_num_components(
            residual, cfg.alpha
        ).tolist()

    if "loo" in cfg.cv:
        record("loo", model.cv_LOO())
    if "lso" in cfg.cv:
        n = X.shape[0]
        trials = cfg.lso_trials if cfg.lso_trials is not None else 10 * n
        seed = cfg.seed if cfg.seed is not None else (5489 if cfg.rng == "gcc" else 0)
        rng = {
            "gcc": lambda: GccRng(seed),
            "jax": lambda: seed,  # an int is a JAX seed to cv_LSO
            "torch": lambda: torch.Generator(device).manual_seed(seed),
        }[cfg.rng]()
        record("lso", model.cv_LSO(cfg.lso_fraction, trials, rng))
    if "kfold" in cfg.cv:
        report["kfold_k"] = cfg.kfold_k
        record("kfold", model.cv_KFOLD(cfg.kfold_k, key=cfg.seed if cfg.seed is not None else 0))

    if cfg.json_out:
        with open(cfg.json_out, "w") as f:
            json.dump(report, f, indent=2)
    return report
