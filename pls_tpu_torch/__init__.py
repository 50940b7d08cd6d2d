"""pls_tpu_torch: the PyTorch/CUDA port of pls-tpu.

It sits beside the JAX package `pls_tpu`, keeps its module paths and public
names, and is held against it by the tests (tests/test_torch_*.py).  It
imports torch and numpy, never jax or pls_tpu.

Ported so far is the reference CLI's main path: CSV IO, z-scoring, the
kernel-PLS fit (types 1 and 2) with the per-component deflation pass as a
hand-written CUDA kernel (ops/deflate.py, csrc/deflate.cu), prediction,
LOO / LSO / new-data cross-validation, the Wilcoxon component selector,
the PLSModel façade and the CLI (`python -m pls_tpu_torch X.csv Y.csv A`).
"""

from pls_tpu_torch.types import (
    KERNEL_TYPE1,
    KERNEL_TYPE2,
    METHOD,
    MSE,
    RESS,
    VALIDATION_OUTPUT,
    PLSFit,
    Residual,
    default_float_dtype,
)
from pls_tpu_torch.ops.stats import colwise_stdev, colwise_z_scores, sst, z_scores
from pls_tpu_torch.ops.special import normalcdf
from pls_tpu_torch.ops.wilcoxon import wilcoxon
from pls_tpu_torch.models.kernel_pls import fit, fit_folds
from pls_tpu_torch.models.predict import (
    coefficients,
    coefficients_all_components,
    explained_variance,
    fitted_values,
    loadings_x,
    loadings_y,
    residuals,
    residuals_all_components,
    scores,
    sse,
)
from pls_tpu_torch.cv.loo import cv_loo
from pls_tpu_torch.cv.lso import cv_lso, lso_sizes, random_partitions
from pls_tpu_torch.cv.newdata import cv_new_data
from pls_tpu_torch.cv.validation import optimal_num_components, print_validation, validation
from pls_tpu_torch.model import PLSModel
from pls_tpu_torch.utils.gcc_rng import GccRng

__all__ = [
    "KERNEL_TYPE1", "KERNEL_TYPE2", "METHOD", "MSE", "RESS", "VALIDATION_OUTPUT",
    "PLSFit", "Residual", "default_float_dtype",
    "colwise_stdev", "colwise_z_scores", "sst", "z_scores", "normalcdf", "wilcoxon",
    "fit", "fit_folds",
    "coefficients", "coefficients_all_components", "explained_variance",
    "fitted_values", "loadings_x", "loadings_y", "residuals",
    "residuals_all_components", "scores", "sse",
    "cv_loo", "cv_lso", "lso_sizes", "random_partitions", "cv_new_data",
    "optimal_num_components", "print_validation", "validation",
    "PLSModel", "GccRng",
]
