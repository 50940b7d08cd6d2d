"""Run configuration for the reference CLI pipeline.

Counterpart of `pls_tpu/config.py`: every knob of `pls X.csv Y.csv A` in
one dataclass, consumed by the CLI (cli.py) and by programmatic callers.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from pls_tpu_torch.types import KERNEL_TYPE1, METHOD, default_float_dtype


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
    preprocess: str | None = None  # spectral chain for raw X, e.g. "savgol:11:2:1,snv"


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


def as_data(X, device=None) -> torch.Tensor:
    """X as a floating tensor on `device` (None: that of a tensor X, else
    the card): a floating tensor keeps its dtype, other data takes the
    device's default float dtype."""
    device = resolve_device(device, X)
    if isinstance(X, torch.Tensor) and X.is_floating_point():
        return X.to(device)
    return torch.as_tensor(np.asarray(X), dtype=default_float_dtype(device), device=device)


def run_pipeline(cfg: PLSRunConfig, *, file=None, device: torch.device | None = None) -> dict:
    """Run the reference CLI pipeline (reference main.cpp:21-41) under
    `cfg`: read → preprocess X → z-score both → fit → print state + EV →
    LOO → LSO → k-fold (`pls_tpu/config.py:40-129`).  Returns the report dict; raises
    utils.io errors on bad input.  `device` None is `default_device()`:
    the card, or RuntimeError without one."""
    from pls_tpu_torch.cv.validation import optimal_num_components, print_validation, validation
    from pls_tpu_torch.model import PLSModel
    from pls_tpu_torch.ops.stats import colwise_z_scores
    from pls_tpu_torch.types import MSE, default_float_dtype
    from pls_tpu_torch.utils.gcc_rng import GccRng
    from pls_tpu_torch.utils.io import read_matrix_file
    from pls_tpu_torch.utils.profiling import span

    file = sys.stderr if file is None else file
    device = resolve_device(device)
    if device.type == "cuda":
        # full float32 products, as the JAX package's precision="highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg.dtype) if cfg.dtype else default_float_dtype(device)

    def read(path):
        return torch.as_tensor(read_matrix_file(path), dtype=dtype, device=device)

    with span("pls.pipeline"):
        with span("pls.pipeline.read"):
            X_raw = read(cfg.x_file)
            if cfg.preprocess:
                from pls_tpu_torch.spectral import apply_chain

                X_raw = apply_chain(X_raw, cfg.preprocess)
            Y_raw = read(cfg.y_file)
        with span("pls.pipeline.zscore"):
            X = colwise_z_scores(X_raw)
            Y = colwise_z_scores(Y_raw)
        with span("pls.pipeline.fit"):
            model = PLSModel(X, Y, cfg.method, cfg.num_components, x_storage=cfg.x_storage)
        with span("pls.pipeline.report"):
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
            with span("pls.pipeline.select"):
                print_validation(residual, MSE, file=file, alpha=cfg.alpha)
                report[f"{name}_rmse"] = validation(residual, MSE).sqrt().tolist()
                report[f"{name}_optimal_components"] = optimal_num_components(
                    residual, cfg.alpha
                ).tolist()

        if "loo" in cfg.cv:
            with span("pls.pipeline.loo"):
                residual = model.cv_LOO()
            record("loo", residual)
        if "lso" in cfg.cv:
            n = X.shape[0]
            trials = cfg.lso_trials if cfg.lso_trials is not None else 10 * n
            seed = cfg.seed if cfg.seed is not None else (5489 if cfg.rng == "gcc" else 0)
            rng = {
                "gcc": lambda: GccRng(seed),
                "jax": lambda: seed,  # an int is a JAX seed to cv_LSO
                "torch": lambda: torch.Generator(device).manual_seed(seed),
            }[cfg.rng]()
            with span("pls.pipeline.lso"):
                residual = model.cv_LSO(cfg.lso_fraction, trials, rng)
            record("lso", residual)
        if "kfold" in cfg.cv:
            report["kfold_k"] = cfg.kfold_k
            with span("pls.pipeline.kfold"):
                residual = model.cv_KFOLD(cfg.kfold_k, key=cfg.seed if cfg.seed is not None else 0)
            record("kfold", residual)

        if cfg.json_out:
            with open(cfg.json_out, "w") as f:
                json.dump(report, f, indent=2)
    return report
