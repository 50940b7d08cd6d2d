"""pls_tpu_torch: the PyTorch/CUDA port of pls-tpu.

It sits beside the JAX package `pls_tpu`, keeps its module paths and public
names, and is held against it by the tests (tests/test_torch_*.py).  It
imports torch and numpy, never jax or pls_tpu.

Ported so far is the reference CLI's main path: CSV IO, z-scoring, the
kernel-PLS fit (types 1 and 2) with the per-component deflation pass as a
hand-written CUDA kernel (ops/deflate.py, csrc/deflate.cu), prediction,
LOO / LSO / new-data cross-validation, the Wilcoxon component selector,
the PLSModel façade and the CLI (`python -m pls_tpu_torch X.csv Y.csv A`);
the statistics path: streaming XᵀX/XᵀY (models/streaming.py), fits
from the statistics, downdated LOO/LSO/k-fold and the one-pass k-fold CV
(cv/), `.npy` ingest (utils/binio.py), and the JAX package's keyed random
partitions without jax (utils/jax_prng.py); NIPALS and SIMPLS
(models/nipals.py, models/simpls.py), the float64 precision modes
"compensated" and "dd" (models/kernel_dd.py), spectral preprocessing
(spectral.py, `--preprocess`), `ZScorer` (preprocess.py), the VIP /
target-projection / selectivity-ratio diagnostics and the bootstrap
(cv/bootstrap.py); `--dtype bfloat16`; and the scikit-learn entry point:
the estimators (estimator.py, models/plsda.py) over the model families
they front (models/robust.py, sparse.py, opls.py, kpls.py, crossdecomp.py,
plsglm.py), conformal prediction intervals (cv/conformal.py), the T²/SPE
monitor (models/diagnostics.py), the PLSB export for native consumers
(export.py) and hyper-parameter tuning (tune.py); the parallel package on
torch.distributed (parallel/: row-, column- and fold-sharded fits and CV)
and resumable CV sweeps (cv/resumable.py); and the rest of the public
API: checkpointing in the JAX package's `.npz` layout
(utils/checkpoint.py), jackknife and permutation inference
(cv/inference.py), iPLS and UVE (select.py), Kennard-Stone/SPXY/duplex
(sampling.py), DS/PDS/EPO calibration transfer (transfer.py), the model
families multiblock, oplsda, plscox, recursive, missing, npls, o2pls and
plspm (models/), the bundled datasets (datasets.py) and the debug and
profiling utilities (utils/debug.py, utils/profiling.py).
"""

from pls_tpu_torch.types import (
    KERNEL_TYPE1,
    KERNEL_TYPE2,
    METHOD,
    MSE,
    NIPALS,
    RESS,
    SIMPLS,
    SPLS,
    VALIDATION_OUTPUT,
    PLSFit,
    Residual,
    default_float_dtype,
)
from pls_tpu_torch.ops.stats import colwise_stdev, colwise_z_scores, sst, z_scores
from pls_tpu_torch.ops.special import normalcdf
from pls_tpu_torch.ops.wilcoxon import wilcoxon
from pls_tpu_torch.models.kernel_pls import (
    fit,
    fit_folds,
    fit_from_stats,
    fit_from_stats_blockdowndated,
    fit_from_stats_downdated,
)
from pls_tpu_torch.models.kernel_dd import fit_dd, fit_from_stats_dd
from pls_tpu_torch.models.streaming import (
    FoldStatsAccumulator,
    StatsAccumulator,
    collect_moments,
    fit_streaming,
    fit_streaming_csv,
    zscore_fold_stats,
    zscore_stats,
)
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
    selectivity_ratio,
    sse,
    target_projection,
    vip,
)
from pls_tpu_torch.cv.bootstrap import bootstrap_coefficient_intervals, bootstrap_coefficients
from pls_tpu_torch.cv.kfold import (
    KFoldOnePass,
    cv_group,
    cv_kfold,
    cv_kfold_downdate,
    cv_kfold_from_stats,
    cv_kfold_onepass,
    fold_residual_chunk,
    kfold_assignments,
)
from pls_tpu_torch.cv.loo import cv_loo, cv_loo_downdate, cv_loo_from_stats
from pls_tpu_torch.cv.lso import cv_lso, cv_lso_downdate, lso_sizes, random_partitions
from pls_tpu_torch.cv.newdata import cv_new_data
from pls_tpu_torch.cv.validation import (
    compare_models,
    optimal_num_components,
    print_validation,
    q_squared,
    rmsep,
    validation,
)
from pls_tpu_torch.model import PLSModel
from pls_tpu_torch.utils.gcc_rng import GccRng
from pls_tpu_torch.utils.io import read_matrix_file, stream_matrix_file
from pls_tpu_torch.preprocess import ZScorer
from pls_tpu_torch.spectral import (
    SNV,
    Detrend,
    MSCorrection,
    SavitzkyGolay,
    detrend,
    msc,
    normalize,
    savgol,
    savgol_coeffs,
    snv,
)
from pls_tpu_torch.cv.conformal import (
    cv_plus_intervals,
    jackknife_plus_intervals,
    split_conformal_intervals,
)
from pls_tpu_torch.models.diagnostics import (
    MonitorModel,
    fit_monitor,
    hotelling_t2,
    leverage,
    spe,
    spe_contributions,
    spe_limit,
    t2_contributions,
    t2_limit,
    x_residuals,
)
from pls_tpu_torch.export import export_model_c, load_model_c
from pls_tpu_torch.models.robust import fit_robust
from pls_tpu_torch.models.sparse import fit_spls, selected_variables
from pls_tpu_torch.models.opls import OPLSFit, fit_opls
from pls_tpu_torch.models.opls import correct as opls_correct
from pls_tpu_torch.models.opls import predict as opls_predict
from pls_tpu_torch.models.kpls import KPLSFit, fit_kpls, kernel_matrix, predict_kpls
from pls_tpu_torch.models.crossdecomp import (
    CDFit,
    cd_coefficients,
    cd_predict,
    cd_transform,
    fit_cca,
    fit_plscanonical,
    fit_plssvd,
)
from pls_tpu_torch.models.plsglm import PLSGLMFit, fit_plsglm, predict_plsglm
from pls_tpu_torch.models.plsda import PLSDAClassifier
from pls_tpu_torch.estimator import (
    CCA,
    KPLSRegressor,
    OPLSRegressor,
    PLSCanonical,
    PLSGLMClassifier,
    PLSRegressor,
    PLSSVD,
    RobustPLSRegressor,
    SPLSRegressor,
)
from pls_tpu_torch.tune import (
    NestedCVResult,
    grid_search_cv,
    kfold_split,
    nested_cv_components,
    nested_grid_search_cv,
    tune_kpls,
    tune_spls_keepx,
)
from pls_tpu_torch.cv.inference import (
    coefficient_significance,
    jackknife_coefficients,
    permutation_test,
)
from pls_tpu_torch.utils.checkpoint import (
    load_fit,
    load_fit_orbax,
    register_checkpointable,
    save_fit,
    save_fit_orbax,
)
from pls_tpu_torch.select import (
    IPLSResult,
    IPLSSelection,
    UVEResult,
    interval_masks,
    ipls,
    ipls_backward,
    ipls_forward,
    uve_pls,
)
from pls_tpu_torch.sampling import duplex, kennard_stone, ks_train_test_split, spxy
from pls_tpu_torch.transfer import (
    EPOModel,
    TransferModel,
    apply_transfer,
    direct_standardization,
    epo,
    epo_difference_matrix,
    piecewise_ds,
)
from pls_tpu_torch.models.multiblock import (
    MBPLSFit,
    block_importance,
    block_scores,
    block_weights,
    fit_mbpls,
    predict_mbpls,
    super_scores,
)
from pls_tpu_torch.models.oplsda import OPLSDAClassifier, fit_oplsda, s_plot
from pls_tpu_torch.models.plscox import (
    PLSCoxFit,
    concordance_index,
    fit_plscox,
    predict_plscox,
)
from pls_tpu_torch.models.recursive import RecursivePLS
from pls_tpu_torch.models.missing import (
    fit_nipals_missing,
    impute_pls,
    nan_column_stats,
    predict_missing,
    scores_missing,
)
from pls_tpu_torch.models.npls import NPLSFit, fit_npls, predict_npls, scores_npls
from pls_tpu_torch.models.o2pls import O2PLSFit, fit_o2pls
from pls_tpu_torch.models.o2pls import predict_x as o2pls_predict_x
from pls_tpu_torch.models.o2pls import predict_y as o2pls_predict_y
from pls_tpu_torch.models.o2pls import transform as o2pls_transform
from pls_tpu_torch.models.plspm import (
    PLSPMBootstrap,
    PLSPMFit,
    bootstrap_plspm,
    fit_plspm,
    plspm_scores,
)
from pls_tpu_torch.utils.binio import (
    cv_kfold_npy,
    cv_repeated_kfold_npy,
    fit_streaming_npy,
    fold_stats_from_npy,
    npy_chunks,
    stats_from_npy,
    stream_npy,
    write_npy_chunked,
)

__all__ = [
    "KERNEL_TYPE1", "KERNEL_TYPE2", "NIPALS", "SIMPLS", "SPLS", "METHOD", "MSE", "RESS",
    "VALIDATION_OUTPUT",
    "PLSFit", "Residual", "default_float_dtype",
    "colwise_stdev", "colwise_z_scores", "sst", "z_scores", "normalcdf", "wilcoxon",
    "fit", "fit_folds", "fit_from_stats", "fit_from_stats_blockdowndated",
    "fit_from_stats_downdated", "fit_dd", "fit_from_stats_dd",
    "FoldStatsAccumulator", "StatsAccumulator", "collect_moments", "fit_streaming",
    "fit_streaming_csv", "zscore_fold_stats", "zscore_stats",
    "coefficients", "coefficients_all_components", "explained_variance",
    "fitted_values", "loadings_x", "loadings_y", "residuals",
    "residuals_all_components", "scores", "sse", "vip", "target_projection",
    "selectivity_ratio", "bootstrap_coefficients", "bootstrap_coefficient_intervals",
    "KFoldOnePass", "cv_group", "cv_kfold", "cv_kfold_downdate", "cv_kfold_from_stats",
    "cv_kfold_onepass", "fold_residual_chunk", "kfold_assignments",
    "cv_loo", "cv_loo_downdate", "cv_loo_from_stats",
    "cv_lso", "cv_lso_downdate", "lso_sizes", "random_partitions", "cv_new_data",
    "compare_models", "optimal_num_components", "print_validation", "q_squared", "rmsep",
    "validation",
    "PLSModel", "GccRng",
    "read_matrix_file", "stream_matrix_file",
    "cv_kfold_npy", "cv_repeated_kfold_npy", "fit_streaming_npy", "fold_stats_from_npy",
    "npy_chunks", "stats_from_npy", "stream_npy", "write_npy_chunked",
    "ZScorer", "snv", "msc", "MSCorrection", "savgol", "savgol_coeffs", "detrend", "normalize",
    "SNV", "SavitzkyGolay", "Detrend",
    "cv_plus_intervals", "jackknife_plus_intervals", "split_conformal_intervals",
    "MonitorModel", "fit_monitor", "hotelling_t2", "leverage", "spe", "spe_contributions",
    "spe_limit", "t2_contributions", "t2_limit", "x_residuals",
    "export_model_c", "load_model_c",
    "fit_robust", "fit_spls", "selected_variables",
    "OPLSFit", "fit_opls", "opls_correct", "opls_predict",
    "KPLSFit", "fit_kpls", "kernel_matrix", "predict_kpls",
    "CDFit", "cd_coefficients", "cd_predict", "cd_transform", "fit_cca", "fit_plscanonical",
    "fit_plssvd",
    "PLSGLMFit", "fit_plsglm", "predict_plsglm", "PLSDAClassifier",
    "CCA", "KPLSRegressor", "OPLSRegressor", "PLSCanonical", "PLSGLMClassifier", "PLSRegressor",
    "PLSSVD", "RobustPLSRegressor", "SPLSRegressor",
    "NestedCVResult", "grid_search_cv", "kfold_split", "nested_cv_components",
    "nested_grid_search_cv", "tune_kpls", "tune_spls_keepx",
    "jackknife_coefficients", "coefficient_significance", "permutation_test",
    "save_fit", "load_fit", "save_fit_orbax", "load_fit_orbax", "register_checkpointable",
    "ipls", "ipls_forward", "ipls_backward", "interval_masks", "IPLSResult", "IPLSSelection",
    "uve_pls", "UVEResult",
    "kennard_stone", "spxy", "duplex", "ks_train_test_split",
    "TransferModel", "direct_standardization", "piecewise_ds", "apply_transfer", "EPOModel",
    "epo", "epo_difference_matrix",
    "MBPLSFit", "block_importance", "block_scores", "block_weights", "fit_mbpls",
    "predict_mbpls", "super_scores",
    "OPLSDAClassifier", "fit_oplsda", "s_plot",
    "PLSCoxFit", "fit_plscox", "predict_plscox", "concordance_index",
    "RecursivePLS",
    "fit_nipals_missing", "impute_pls", "nan_column_stats", "predict_missing", "scores_missing",
    "NPLSFit", "fit_npls", "predict_npls", "scores_npls",
    "O2PLSFit", "fit_o2pls", "o2pls_predict_y", "o2pls_predict_x", "o2pls_transform",
    "PLSPMFit", "PLSPMBootstrap", "fit_plspm", "plspm_scores", "bootstrap_plspm",
]
