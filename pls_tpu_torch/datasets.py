"""Bundled datasets, the port's own copy of the JAX package's data files
(`pls_tpu_torch/data/`, package data):

- toy: 10×15 X, 10×2 Y, the reference README's smoke-test pair;
- nir: 60×401 NIR spectra (X) and 60×1 octane ratings (Y), the classic
  gasoline near-infrared calibration set.

Counterpart of `pls_tpu/datasets.py`: raw float64 numpy arrays, as the
JAX package returns them; z-score with `pls_tpu_torch.colwise_z_scores`
to reproduce the reference CLI pipeline.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pls_tpu_torch.utils.io import read_matrix_file

_DATA = Path(__file__).resolve().parent / "data"


def load_toy() -> tuple[np.ndarray, np.ndarray]:
    """(X, Y) = (10×15, 10×2) toy regression pair."""
    return read_matrix_file(str(_DATA / "toyX.csv")), read_matrix_file(str(_DATA / "toyY.csv"))


def load_nir() -> tuple[np.ndarray, np.ndarray]:
    """(X, Y) = (60×401 NIR spectra, 60×1 octane ratings)."""
    return read_matrix_file(str(_DATA / "nir.csv")), read_matrix_file(str(_DATA / "octane.csv"))


def make_synthetic(
    n_rows: int,
    n_predictors: int,
    n_responses: int = 1,
    noise: float = 0.1,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic linear-model data (X ~ N(0,1), Y = X B + noise), numpy's
    draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_predictors))
    B = rng.normal(size=(n_predictors, n_responses)) / np.sqrt(n_predictors)
    Y = X @ B + noise * rng.normal(size=(n_rows, n_responses))
    return X, Y
