#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. device: the card, torch/CUDA versions, TF32 off; build the three
     CUDA sources, csrc/deflate.cu (K1/K2), csrc/deflate_variants.cu
     (K3-K5) and csrc/eigen.cu (E1, the M×M dominant eigenvector), with
     one nvcc each started together; print their ptxas register and
     spill lines and the build time;
  2. kernel vs plain: the f32 (K1) and bf16 (K2) kernels against
     `deflate_pass_plain` on the same inputs and against f64 truth on the
     card, at every shape the main path gives them (toy 10×15, nir 60×401,
     100000×5000; phase 10's 10000×1000 and each of two ranks' 50000×5000;
     phase 11's 100000×10000, 10000×5000, 1000×5000, 2000×500 and 45×401;
     phase 5's wide fit, 20000×30000) and at (130, 96), (300, 401), (4096,
     5000), (65536, 2048), a ragged (4099, 5000), K = 8 (1000, 8), a bf16 K
     too wide for the column-owning path (1024, 16384) and the K too wide
     for the staged form, which must take the cluster path: (2048, 30000),
     a ragged (1024, 30001), (512, 65536), (256, 131072), (128, 262144)
     in bf16, (64, 140000) in f32 and every shape phase 5 times at wide K
     (8192×65536, 8192×131072, 4096×262144), each also against the
     two-pass form it replaces; and (64, 262152), past the cluster
     kernel's 262144 columns, which must take the two-pass form; printing
     each launch's plan (path:
     cols / staged / scalar / cluster / wide, and the cluster size C);
     relative error of t, p and tt ≤ 1e-5 against both, and two launches
     bit-identical; then every
     variant of the kernel-variant sweep's default lists (K3, K4 at
     DEFAULT/HIGH/HIGHEST, K5 in both designs) against its plain version
     and f64 at 10×15, 130×96, 300×401 (scalar staging), 4096×5000 and
     65536×2048 (a cols_bf16 variant must refuse K % 8 != 0; K4 must take
     its ring of 8-row TMA slots where K % 4 == 0, a ragged last slot at
     130×96, and its scalar-staged tiles at 10×15 and 300×401), two
     launches bit-identical: K3, K5 and K4-HIGHEST ≤ 1e-5 against
     both; K4 DEFAULT/HIGH ≤ 1e-5 in t and tt against plain, p ≤ 1e-5
     against the plain second product on the kernel's own t (and at
     HIGH against the whole plain chain), and within 10× the plain
     emulation's own error against f64; at DEFAULT a control, p with t
     left unrounded, must fall outside 1e-5; then E1
     (`ops.eigen.jacobi_dominant_cuda`) on random PSD C made on the card
     at (B, M, M) = (1, 10, 10), a fit's component, (8, 10, 10), a fold
     batch's, and (600, 10, 10), in float32 and float64: bit-equal to
     its twin `jacobi_dominant_plain`, two launches bit-identical, and
     within 1e-12 (float64 C) or 1e-6 (float32 C) of float64 eigh's
     dominant eigenvector up to sign;
  3. main path on real data: the port's CLI on nir/octane (A=10) and toy
     (A=2) in float32, tables against tests/golden, optimal component
     counts equal, and exactly A kernel launches per fit; E1 launches
     none for nir (one response) and A each for toy's fit, LOO fold batch
     and LSO fold batch;
  4. main path at real size: PLSModel on 100000×5000 X, 10 Y, 20
     components (the repo's single-chip configuration, BASELINE.json),
     made on the card from --seed; f32 against the same fit in f64, and
     x_storage="bf16" against f32 within the bf16 budget, all 20 of its
     K2 launches on the cols path; the f32 and bf16 fit walls, warm, in
     turns (f32, bf16, bf16, f32, f32, bf16); every component's
     eigenvector on E1: `ops.eigen.path_calls`, set to 0 just before
     phase 3, reads after phase 4 toy's 6 kernel launches and 20 for each
     of phase 4's 9 fits, and no eigh;
  5. timing with CUDA events (median of 25 after warm-up, one call per
     event pair; and back to back, 10 calls per pair, 5 pairs) at
     100000×5000: K1; K2 in its column-owning design beside its earlier
     row-staged design (`ops.deflate.staged_plan_for`), in turns (cols,
     staged, staged, cols); the plain
     two-product form in f32 and in bf16-upcast; the library yardsticks
     (two f32 `torch.matmul` products; two bf16 cuBLAS products with r
     and t rounded to bf16, a looser function); the card's
     device-to-device copy ceiling; then at wide K, in f32 and bf16, at
     20000×30000 (clusters of 2), 8192×65536 (4), 8192×131072 (8) and
     4096×262144 (16), the cluster path against the two-pass form in
     turns (cluster, two-pass, two-pass, cluster; back to back), which it
     must beat at every shape, with the plain form, the library's two
     products, each one's share of the bound and the clusters × C against
     the card's SMs; the pan-cancer cell's pass (PANCAN, f32: K odd, so
     vec 1) beside K + 1 (vec 4, the same plan otherwise) and K + 1 from a
     view one element into its storage (vec 1 at an even K), in turns,
     back to back, each within KERNEL_RTOL of the plain form, with its
     staging (`ops.deflate.staging_calls`) and share of the bound; then
     (its launch counts set to 0 just before and read just after)
     `models.kernel_pls.fit` at 20000×30000×10, A = 20, on the
     cluster path: f32 against float64 on the card (FIT_COEF_RTOL), bf16
     storage against f32 (BF16_COEF_RTOL), 80 launches of each cluster
     kernel and none of the others, the warm walls in turns beside 20 ×
     the pass-time gain over the two-pass form; last, E1 at phase 2's
     three shapes in float32 and float64: its device time a call, 10
     launches queued behind a sleep of the stream between each event
     pair (median of 5 pairs), against eigh's time a call as the stream
     sees it (it reads cuSOLVER's info back inside the call; median of
     25), with the twin's sweeps and the time a dependent round;
  6. the sweep path: `pls_tpu_torch.tools.kernel_variants.sweep` at its
     default 65536×2048 and at 100000×5000, in f32 and in bf16, printing
     its tables (every variant beside the shipped kernel, the plain form
     and the copy ceiling), each row's err_p and err_tt against f64
     within its bound (SWEEP_RTOL); each of K3-K5 must launch, K4 on
     its ring;
  7. the statistics path at the north star's width: raw 50000×10000 X and
     10 Y (rank-30 latent data, column offsets of 0.5-3 σ) made on the
     card from --seed and written as .npy into a temporary directory
     under build/ (removed at exit); `stats_from_npy` (XᵀX, XᵀY held to
     f64 on the card, relative Frobenius ≤ 1e-4), `fit_streaming_npy`
     (A=20, zscore; coefficients against the f64 statistics' fit),
     `cv_kfold_npy` (k=10, A=20, zscore, residual pass; one-pass PRESS
     against Σ errors² at tests/test_binio.py's tolerances),
     `cv_loo_from_stats` over 1000 held-out rows (4 folds against explicit
     f64 downdated fits, 5e-3 of Y's scale) and `optimal_num_components`
     on the device-resident errors; prints the disk→card rate beside the
     file's read rate and the pinned host→device copy rate, the k-fold
     wall, LOO folds per second and the peak device memory.  This path
     runs none of K1-K5;
  8. the NIPALS/SIMPLS, precision, preprocessing and bootstrap slice at
     100000×5000×10 (make_big, A = 20; NIPALS at NIPALS_A): SIMPLS and
     NIPALS in float32 against the same method in float64 on the same
     data (5e-3 of the coefficients), each fit launching K1 exactly A
     times, NIPALS's inner iterations per component, the fits' walls by
     CUDA events beside kernel type 1's (SIMPLS's and type 1's from a
     second fit, NIPALS's from its one); precision="dd" types 1 and 2
     against the float64 fit (1e-10 for float64 input, float32 rounding
     for float32 input) and at the deep-A stress of
     tests/test_fit_parity.py:287-293 (256×128×3, A = 50, ≤ 1e-4 against
     float64, plain float32 printed beside it); compensated statistics over
     1M rows × K = 64 (`tools.precision_at_scale.run`, XᵀX within 1.09e-8
     of float64); `apply_chain("savgol:11:2:1,snv")` against float64 (1e-5);
     the CLI on nir with `--method nipals`, `--method simpls` and
     `--preprocess savgol:11:2:1,snv`, in float32 on the card against the
     port's float64 run on the CPU (phase 3's tolerances, but 0.1 for
     SIMPLS's coefficients, SIMPLS_NIR_COEF_RTOL; equal component counts,
     A launches of K1 each); the bootstrap on nir (A = 10, 200
     replicates, int32 draws) against the same call in float64 on the CPU
     (5e-3), with its wall;
  9. `--dtype bfloat16` and the scikit-learn entry point: the CLI in bf16
     on toy and nir (K2 launches, A each), every table within 1e-3 of the
     port's bf16 run on the CPU (BF16_SAME_ARITH_RTOL, below d_jax) with
     the same component choices, and within 2·d_jax of the f64 goldens
     (BF16_D_JAX); at 100000×5000×10, A = 20 (make_big): PLSRegressor
     fit/predict/score (20 K1 launches), with x_storage="bf16" (20 K2),
     build_monitor/check, export_c into build/ and load_model_c,
     predict_interval "cv+" (10 folds, 220 K1) and "split" (20 K1),
     RobustPLSRegressor (220 K1), PLSGLMClassifier on a noisy binary
     response (n_irls = 10, 200 K1), each against the same call in float64
     on the card (1e-3; 5e-3 for the IRLS fits), with CUDA-event walls and
     the phase's parts; grid_search_cv over n_components 1..20, 5 folds,
     at this size (one un-batched fit a fold, K1) and at 2000×500 (one
     batched fit), against un-batched float32 fits on each fold's own
     scaled rows (1e-4);
     then SPLS, OPLS, KPLS, PLSCanonical, CCA and PLSSVD at K = 5000, M =
     10 and the rows of FAMILIES, each against float64 (5e-3);
 10. the parallel slice on torch.distributed.  NCCL at world size 1 on
     this card through `initialize_distributed` (a `file://` store under
     build/, removed at exit): on phase 4's data (100000×5000×10, A = 20)
     `fit_sharded` in f32 (K1 20 times) and with x_storage="bf16" (K2 20
     times, cols path), `fit_rowsharded_shardmap(use_kernel=True)` type 1
     (K1, T gathered to 100000×20) and type 2, and `fit_colsharded`, each
     held to the same fit on one device (1e-5) with the largest
     difference printed; on its first 10000 rows and 1000 columns (A =
     10, 16 trials) `cv_lso_sharded`, `cv_lso_rowsharded(trial_batch=2)`
     and `train_step` (K1 10 times), and on 2000 rows `cv_loo_sharded`,
     held to the port's `cv_lso`/`cv_loo` on the card (2e-5: folds
     batched in other sizes); the sharded fit's wall against the
     one-device fit's, in 10 pairs (PAR_PAIRS), alternating which goes
     first.  Then two gloo ranks share the card (`--rank` runs of this
     script, started by `parallel.launch.spawn_ranks`): `fit_sharded`,
     `fit_rowsharded_shardmap(use_kernel=True)` and `train_step` at
     100000×5000×10, A = 20, each rank launching K1 on its own 50000 rows,
     rank 0 holding them to the one-device fit and press (1e-5, 2e-5).
     One line a call: CUDA-event wall, launches by path, error;
 11. the rest of the public API on phase 4's data (100000×5000×10), each
     call against the same call in float64 on the card (1e-3 closed
     form, 5e-3 iterative), one line a call with the float32 call's
     CUDA-event wall and K1 launches: `fit_mbpls` (5 blocks of 1000, A =
     20, K1 20), `fit_oplsda` (two classes from Y[:, 0]'s sign, n_ortho =
     2, K1 1) and `OPLSDAClassifier`, `fit_plscox` (A = 5, K1 5;
     `concordance_index` on 5000 rows), `permutation_test` (A = 20, 20
     permutations, K1 420, the draws jax_prng's), `ipls` (20 intervals,
     A = 10, k = 5, K1 1050) and `ipls_forward` (10000 rows, 3 intervals
     at most), `uve_pls` (k = 10, A = 10; K1 at K = 10000),
     `coefficient_significance` (1000 rows, A = 10), `kennard_stone`,
     `spxy` (1000 of 100000) and `duplex` (1000 of 5000) held by their
     picks' max-min distances (1e-5), `direct_standardization`,
     `piecewise_ds` and `epo` (1000 paired rows), `fit_npls`
     (100000×50×100, A = 5), `fit_o2pls` (100000×5000 against 500
     columns, both made from the joint and specific latents O2PLS models), `fit_nipals_missing` (5 % NaN; iterations per component)
     and `impute_pls` (2000×500), `fit_plspm` (10 blocks of 500, one in
     mode B, the path scheme, on structural-model data of the same size)
     and `bootstrap_plspm` (200 replicates of 10000×500), `RecursivePLS` (10 chunks, λ = 1 and 0.99); checkpoints
     of each registered type fitted, both formats, bit-equal under build/
     (removed); `fit_health` and `roofline_report` of one K1 pass; then
     nir's example flows (Kennard-Stone split, savgol + SNV, ipls_forward,
     piecewise_ds) in float32 on the card against the port's float64 run
     on the CPU.  The cuts (rows where a call is O(N²) or runs N fits) are
     the constants IPLS_FWD_N through BOOT;
 12. CSV ingest through the port's host runtime (csrc/native_io.cpp, built
     by the host C++ compiler): a NIR-style calibration set, 50000×1000 X
     and 50000×5 Y (rank-30 latent data with column offsets, from --seed),
     written as headerless CSV of float32 values at %.9g (about 0.55 GB;
     numpy digit tables on one thread a core) into a temporary directory
     under build/ (removed at exit); (a) `read_matrix_file` on X through the native
     loader, timed, in MB/s, and the plain parser on its first 5000 rows
     (its MB/s), bit-equal to the native loader's rows; the in-memory fit
     of the z-scored data, A = 10, f32 on the card (K1 10 times) against
     f64 on the card (FIT_COEF_RTOL); (b) `fit_streaming_csv` on the same
     files at its default chunk_rows, f32 on the card, against (a)'s f64
     fit (FIT_COEF_RTOL), with its wall, the wall of one parse-only pass of
     X and Y, and the device-busy share (CUDA events around each chunk's
     device work); (c) the native loader's counters (3 whole-file reads,
     2 × (1 + 2 × passes) chunks) and no reader thread left; (d)
     `pls_tpu_torch.tools.accumulator_sweep` at its defaults and
     `pls_tpu_torch.tools.flagship_wall --runs 3`, each in its own process,
     their JSON lines printed.
 13. the k-fold Gram (`ops.stats.gram`, which `cv.loo.global_stats`
     forms XᵀX with) on phase 4's 100000×5000 X in float32, TF32 off:
     the whole `X.mT @ X` against the upper block triangle and its mirror
     of `gram_plan`, in turns (whole, triangle, triangle, whole), each
     the median of 5 CUDA-event pairs; the sweep of GRAM_WIDTHS' strip
     widths and of recursive halving to GRAM_DEPTHS (2, 4, 8 leaves):
     each plan's time, its flops over the whole product's, its rate on
     its own flops; each within GRAM_RTOL of float64 XᵀX and exactly
     symmetric; the default plan's products alone; at each of GRAM_KS'
     narrower widths of the same rows, the whole product against the
     plan's; the peak device memory of each form, the triangle's at most
     K²·4 bytes above the whole product's.

The K1/K2 launch counts are set to 0 just before phase 3 and read just
after phase 4; those of the cluster kernels just before and after phase
5's fit; the K3-K5 counts just before and after phase 6; all of
them just before and after phase 7, where they stay 0, and just before
and after phases 8 and 9, whose K1 (and phase 9's K2) launches join phase
3-4's in the record; phase 10 sets them to 0 after its one-device
references and reads them after its sharded calls, and its two ranks
report their own counts, all of which join the record; phase 11 sets
them to 0 before its calls and reads them after, and its K1 launches
(not those `roofline_report` times) join the record; so do phase 12's
(its in-memory fit's, A of them; the tools' processes keep their own
counts).  The last
two lines of stdout are the kernels' JSON record (K1-K5, K1/K2's
cluster kernels and E1; ms is the back-to-back time per call, K1/K2 at
100000×5000, their cluster kernels at 20000×30000, K3-K5 of the best
variant at 65536×2048 by the sweep's chain slope, timed again back to
back; K5's the faster of its two designs' best, timed in turns; E1's at
(1, 10, 10) float32, as the f32 fits hand C over, with its launches the
main path's; each with bound_ms, the larger of its bytes over 3.35 TB/s
and its flops over 67 TFLOP/s f32 (E1: its rotations' float64 flops
over 34 TFLOP/s), and library_ms, E1's eigh; E1's plain_ms is null: its
twin runs on the CPU) and {"ok": true, "device": {...}};
the record also gives, under "k1_wide_staging", the pan-cancer pass's
three forms of phase 5 (ms, bound_ms, share, vec, staging);
the card's nvidia-smi line is printed in phase 1 and again just before
the kernels' record.  Without a CUDA device,
or outside a checkout of the repo, the script exits non-zero and prints
neither.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
DATA = ROOT / "pls_tpu_torch" / "data"

# float32 tolerances against the f64 goldens.  Coefficients and explained
# variance: the JAX package's f32 contract on its accelerator
# (tests/test_tpu_hw.py:155,162).  RMSE tables: 1e-3 relative, 50× the
# float32 deviation the port's own CPU float32 run shows on nir (2e-5).
COEF_RTOL = 5e-3
EV_ATOL = 1e-3
RMSE_RTOL = 1e-3
# phase 2: the TPU kernel's contract (tools/tpu_smoke.py:67)
KERNEL_RTOL = 1e-5
# phase 4: f32 vs f64 of the same fit; bf16 vs f32 (tests/test_bf16.py:59,67)
FIT_COEF_RTOL = 1e-3
FIT_EV_ATOL = 1e-4
BF16_COEF_RTOL = 2e-2
BF16_EV_ATOL = 2e-3

BIG = (100_000, 5_000)
WIDE_FIT = (20_000, 30_000, 10)  # N, K, M of the fit on the cluster path, A = 20
WIDE = WIDE_FIT[:2]  # K past the staged form: the cluster path (two-pass form beside it)
# every (N, K) the main path hands the kernel: toy, nir, the real-size fit,
# and phase 10's: train_step's global fit at PAR_CV (world size 1) and each
# of the two gloo ranks' half of BIG's rows
MAIN_PATH_SHAPES = [(10, 15), (60, 401), BIG, (10_000, 1_000), (BIG[0] // 2, BIG[1]),
                    # and phase 11's: UVE's X with its noise columns, ipls_forward's
                    # and the jackknife's full fit, impute_pls's NIPALS, nir's
                    # Kennard-Stone calibration rows
                    (BIG[0], 2 * BIG[1]), (10_000, 5_000), (1_000, 5_000), (2_000, 500),
                    (45, 401),
                    # and phase 5's fit on the cluster path
                    WIDE,
                    # and phase 12's in-memory fit of the CSV calibration set
                    (50_000, 1_000)]
# phase 5's wide-K timing: one shape for each cluster size, 2, 4, 8 and 16
# (8192×131072 the TPU kernel's widest one-pass f32 K), in f32 and bf16
WIDE_TIMED = [WIDE, (8_192, 65_536), (8_192, 131_072), (4_096, 262_144)]
# the pan-cancer cell's pass: 10 267 tumours × 20 531 genes, f32 (K odd: the
# cluster kernel's vec-1 staging, clusters of 2)
PANCAN = (10_267, 20_531)
# K2's column-owning path: the sweep's shape, a ragged last tile, K = 8;
# then a bf16 K past it (row-staged) and the K past the staged form: the
# cluster path up to 262 144 columns (a ragged K on its 4-byte staging;
# clusters of 16 past 131 072) and at phase 5's timed shapes, and a K
# past 262 144, the two-pass form
KERNEL_SHAPES = [(130, 96), (300, 401), (4096, 5000), (65_536, 2_048), (4099, 5000), (1000, 8),
                 (1024, 16_384), (2048, 30_000), (1024, 30_001), (512, 65_536), (256, 131_072),
                 (128, 262_144), (64, 140_000), *WIDE_TIMED[1:], (64, 262_152)]
SHAPE_DTYPES = {(128, 262_144): (torch.bfloat16,), (64, 140_000): (torch.float32,)}
WIDE_PATHS = {**dict.fromkeys([(2048, 30_000), (1024, 30_001), (512, 65_536), (256, 131_072),
                               (128, 262_144), (64, 140_000), *WIDE_TIMED], "cluster"),
              (64, 262_152): "wide"}
# the published H100 SXM peaks the bound is taken against (700 W); FP64
# without tensor cores for E1
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
# E1: (B, M) of a fit's component, a fold batch of 8, and a batch of 600;
# its dominant eigenvector against float64 eigh's, up to sign (float32 C:
# the result rounded to float32 once)
EIGEN_SHAPES = [(1, 10), (8, 10), (600, 10)]
EIGEN_ATOL = {torch.float64: 1e-12, torch.float32: 1e-6}
EIGEN_HOLD_CYCLES = 20_000_000  # a sleep of the stream that E1's timed launches queue behind
# E1's launches on the main path: an eigenvector a component of phase 4's
# fits (f32, f64, bf16, six timed; A = 20) and of the toy CLI's (M = 2, A
# = 2: the fit, LOO's fold batch, LSO's fold batch); nir has M = 1
MAIN_PATH_EIGEN = 9 * 20 + 3 * 2
# phase 6: the kernel-variant sweep's path
SWEEP = (65_536, 2_048)  # the sweep's default size
SWEEP_ITERS = 10
# (300, 401): K % 4 != 0, the scalar staging path
VARIANT_SHAPES = [(10, 15), (130, 96), (300, 401), (4096, 5000), SWEEP]
# the sweep's err_p and err_tt, against f64 of the float32 X: 1e-5 for the
# exact-f32 rows; K4 HIGH drops the lo·lo term, 2⁻¹⁶ of each product;
# DEFAULT rounds X, r and t to bf16, 2⁻⁹ each; with KV_BF16 every row sees
# X rounded to bf16.
SWEEP_RTOL = {"mxu_HIGH": 1e-4, "mxu_DEFAULT": 1e-2}
SWEEP_BF16_RTOL = 2.0 ** -8

# phase 7: the statistics path (BASELINE.json's 1M×10k north star, N cut to
# 50000), k-fold CV and 1000 LOO folds at A = 20
STATS = (50_000, 10_000, 10)
STATS_K, STATS_A, LOO_FOLDS, LOO_CHECKED = 10, 20, 1000, 4
STATS_CHUNK = 8192  # rows per chunk when writing the files
STATS_RTOL = 1e-4  # XᵀX, XᵀY: relative Frobenius error against f64
LOO_ATOL = 5e-3  # held-out errors, relative to Y's scale (σ = 1 after z-scoring)

# phase 8: the NIPALS/SIMPLS, precision, preprocessing and bootstrap slice
SLICE_A = 20
NIPALS_A = 20  # NIPALS's component count at 100k×5k (its 500-iteration cap sets the wall)
METHOD_COEF_RTOL = 5e-3  # float32 against float64 of the same method (COEF_RTOL)
DD_RTOL = 1e-10  # precision="dd" on float64 input against the float64 fit
DD_F32_RTOL = 1e-6  # ... on float32 input: its state rounded to float32
DD_STRESS = (256, 128, 3, 50)  # N, K, M, A of tests/test_fit_parity.py:287-293
DD_STRESS_RTOL = 1e-4
COMP_STATS = (1_000_000, 16_384, 64, 4)  # rows, chunk, K, M
COMP_XX_RTOL = 1.09e-8  # the JAX package's compensated XᵀX at 9 994 240 rows
# SIMPLS's coefficients on nir at A = 10 in float32: its single Gram-Schmidt
# of the loadings loses orthogonality over the collinear spectra, in the
# JAX package too (its float32 fit is 6.2e-2 from float64 on the CPU, the
# port's 1.3e-2 there); explained variance, RMSE and the choice of
# components keep phase 3's tolerances
SIMPLS_NIR_COEF_RTOL = 0.1
CHAIN = "savgol:11:2:1,snv"
CHAIN_RTOL = 1e-5
BOOT_A, BOOT_REPS, BOOT_RTOL = 10, 200, 5e-3

# phase 9: --dtype bfloat16 and the scikit-learn entry point.  The bf16
# CLI's bounds per table: d_jax, the JAX package's own bf16 run against
# float64, measured on the CPU (tests/test_torch_cli.py's D_JAX, which a
# test holds equal to this); the card's run must lie within d_jax of the
# port's bf16 run on the CPU and within 2·d_jax of the f64 goldens.
BF16_D_JAX = {
    ("toy", "W"): 0.05674, ("toy", "P"): 0.05936, ("toy", "Q"): 0.01362, ("toy", "R"): 0.06734,
    ("toy", "coefficients"): 0.06660, ("toy", "ev"): 0.01648, ("toy", "loo_rmse"): 0.01452,
    ("toy", "lso_rmse"): 0.01966,
    ("nir", "W"): 0.8960, ("nir", "P"): 0.9069, ("nir", "Q"): 0.7100, ("nir", "R"): 0.6181,
    ("nir", "coefficients"): 0.6566, ("nir", "ev"): 0.02149, ("nir", "loo_rmse"): 0.08941,
    ("nir", "lso_rmse"): 0.06341,
}
# The card's bf16 run follows the port's CPU bf16 run's arithmetic (bf16
# data, float32 state, t kept float32 in the pass) and differs from it only
# in the order of float32 sums: every table within this of it, in every
# component (the CPU run against the JAX package's Pallas kernel in
# interpret mode: 7.6e-5 at most; tests/test_torch_cli.py's
# SAME_ARITH_RTOL, which a test holds equal to this)
BF16_SAME_ARITH_RTOL = 1e-3
EST_A = 20  # BASELINE.json's "Synthetic 100k×5k X, 10 Y, 20 components"
EST_RTOL = 1e-3  # float32 estimator against the same call in float64 (FIT_COEF_RTOL)
IRLS_RTOL = 5e-3  # the IRLS fits, whose reweightings compound the rounding (METHOD_COEF_RTOL)
N_NEW = 256  # rows the intervals and the monitor's check are asked for
GRID_FOLDS, GRID_RTOL = 5, 1e-4  # grid search against its folds' un-batched fits
GRID_SMALL = (2_000, 500)  # a size whose five folds' copies of X make one batch
# the families whose cost grows past the width, at K = 5000, M = 10: rows
# and components.  KPLS's Gram matrix is N² (1.6 GB in float32 at 20 000);
# CCA takes two pseudo-inverses (an SVD of the N×K block) per component
FAMILIES = {"SPLSRegressor": (100_000, 5), "OPLSRegressor": (100_000, 3),
            "KPLSRegressor": (20_000, 5), "PLSCanonical": (100_000, 3), "CCA": (10_000, 2),
            "PLSSVD": (100_000, 5)}
FAMILY_RTOL = 5e-3  # float32 against float64 of the same call (METHOD_COEF_RTOL)

# phase 10: the parallel slice on torch.distributed.  The fits at BIG, A =
# 20; the fold-sharded CV on the first PAR_CV rows and columns of the same
# data (A = PAR_CV_A, PAR_TRIALS trials, a quarter of the rows held out),
# LOO on its first PAR_LOO_N rows (N folds of N-row masked fits)
PAR_A = 20
PAR_CV, PAR_CV_A, PAR_TRIALS, PAR_LOO_N = (10_000, 1_000), 10, 16, 2_000
PAR_STEP_TRIALS = 2  # train_step's trials at BIG: one batch of masked copies of a shard
PAR_TIMEOUT = 300  # seconds: the collectives' timeout, and the two-rank run's
PAR_PAIRS = 10  # (one-device fit, sharded fit) pairs timed at world size 1
# a sharded call against the same call on one device: float32 sums over
# ranks (two gloo ranks; the column-sharded fit's sums over K in another
# order, 4.5e-7 measured), or, for the CV errors and press, batches of
# another size (the LOO/LSO folds; 2.95e-6 at most measured, PERF.md §6)
PAR_RTOL = 1e-5
PAR_CV_RTOL = 2e-5

# phase 11: the rest of the public API on phase 4's data (make_big).  Each
# call against the same call in float64 on the card: API_RTOL for the
# closed-form fits, API_ITER_RTOL for the iterative ones
API_A = 20  # fit_mbpls, permutation_test, RecursivePLS: BASELINE.json's 20 components
API_RTOL = 1e-3  # FIT_COEF_RTOL
API_ITER_RTOL = 5e-3  # METHOD_COEF_RTOL
PICK_RTOL = 1e-5  # sample selection: each pick's max-min distance against float64's picks'
N_PERM = 20
IPLS = (20, 10, 5)  # intervals, A, folds
# the cuts: rows where a call is O(N²) or runs N fits (PERF.md §4)
IPLS_FWD_N = 10_000  # ipls_forward: every round refits every remaining candidate
JACK_N = 1_000  # the jackknife: N fits
PICKS = 1_000
DUPLEX_N = 5_000  # duplex assigns every row, one pass over X a row
COX_C_N = 5_000  # concordance_index: N² host memory
TRANSFER_N = 1_000  # paired transfer rows (master and slave), 5000 channels
IMPUTE = (2_000, 500)  # impute_pls: n_outer dense NIPALS fits
BOOT = (200, 10_000, 500)  # bootstrap_plspm: replicates, rows, columns (B copies)
NIPALS_TOL = 1e-6  # the missing-data NIPALS and PLS-PM loops: a float32 tolerance
RLS_CHUNKS = 10

# phase 12: CSV ingest through the port's host runtime (csrc/native_io.cpp):
# a NIR-style calibration set of the reference's container, headerless CSV,
# float32 values printed with 9 significant digits (about 0.55 GB)
CSV = (50_000, 1_000, 5)  # N, K, M
CSV_A = 10
CSV_LATENT = 30
CSV_PREFIX = 5_000  # rows the plain parser is held bit-equal on
CSV_BLOCK = 1_000  # rows made and formatted at once
TOOL_TIMEOUT = 600  # seconds: each of the two tools' subprocess runs

# phase 13: the k-fold Gram at BIG in float32.  The sweep: strip widths
# (multiples of the SIMT sgemm's 128-column tiles) and recursive halving
# of the diagonal blocks on the same 128-column grid; the planner's
# threshold by K at BIG's rows
GRAM_WIDTHS = [256, 384, 512, 640, 768, 1024, 1280, 1664, 2560]
GRAM_DEPTHS = [1, 2, 3, 4]
GRAM_GRID = 128
GRAM_KS = [512, 768, 1024, 1536, 2048, 3840]
GRAM_REPS = 5
# relative Frobenius error against float64 XᵀX: float32 dots over 100 000
# rows, the whole product 9.3e-7 from it, the sweep's plans 6.8e-7 to 1.2e-6
# on an H100
GRAM_RTOL = 2e-6

# (kernel name, its source in pls_tpu_torch/csrc, the TPU kernel it
# replaces, the launch counters that are its launches)
KERNELS = [
    ("deflate_f32", "deflate.cu", "pls_tpu/ops/deflate.py:83", ("deflate_f32",)),
    ("deflate_bf16", "deflate.cu", "pls_tpu/ops/deflate.py:102", ("deflate_bf16",)),
    ("deflate_f32_cluster", "deflate.cu", "pls_tpu/ops/deflate.py:83", ("deflate_f32_cluster",)),
    ("deflate_bf16_cluster", "deflate.cu", "pls_tpu/ops/deflate.py:102",
     ("deflate_bf16_cluster",)),
    ("vpu_f32", "deflate_variants.cu", "tools/kernel_variants.py:72", ("vpu_f32",)),
    ("mxu_f32", "deflate_variants.cu", "tools/kernel_variants.py:153", ("mxu_f32",)),
    ("vpu_bf16", "deflate_variants.cu", "tools/kernel_variants.py:208",
     ("vpu_bf16", "cols_bf16")),
    ("jacobi_dominant", "eigen.cu", "pls_tpu/ops/eigen.py:33", ("jacobi_dominant",)),
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def k12_counts(f32: int, bf16: int) -> dict:
    """Launch counts of K1 and K2 on their row paths, none on the cluster path."""
    return {"deflate_f32": f32, "deflate_bf16": bf16, "deflate_f32_cluster": 0,
            "deflate_bf16_cluster": 0}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


# ---------- reading the CLI's report ----------
def _matrix_after(lines: list[str], start: int) -> np.ndarray:
    rows = []
    for ln in lines[start:]:
        vals = ln.replace("(", " ").replace(",0)", " ").split()
        try:
            row = [float(v) for v in vals]
        except ValueError:
            break
        if not row:
            break
        rows.append(row)
    return np.asarray(rows)


def parse_report(text: str) -> dict:
    """The CLI's stderr report as arrays: state matrices, explained
    variance and SSE (A, M), and per CV method its RMSE (M, A) and optimal
    component counts (M,)."""
    lines = text.split("\n")
    out: dict = {}
    for label in ("P", "W", "R", "Q", "T", "coefficients"):
        out[label] = _matrix_after(lines, lines.index(f"{label}:") + 1)
    ev_pat = re.compile(r"^\s*\d+ components explained variance: (.*?)  - SSE: (.*)$")
    ev = [ev_pat.match(ln) for ln in lines]
    out["ev"] = np.asarray([[float(v) for v in m.group(1).split()] for m in ev if m])
    out["sse"] = np.asarray([[float(v) for v in m.group(2).split()] for m in ev if m])
    for method in ("LOO", "LSO"):
        if f"{method} Validation:" not in lines:
            continue
        i = lines.index(f"{method} Validation:") + 2
        rmse = _matrix_after(lines, i)
        j = i + len(rmse)
        first = lines[j].split("\t")[1]
        opt = [int(first)] + [int(v) for v in lines[j + 1 : j + len(rmse)]]
        out[method.lower() + "_rmse"] = rmse
        out[method.lower() + "_opt"] = np.asarray(opt)
    return out


def golden(name: str) -> np.ndarray:
    return np.loadtxt(GOLDEN / f"{name}.csv", delimiter=",", ndmin=2)


def golden_errors(report: dict, name: str) -> dict:
    """Errors of a parsed report against the reference's goldens."""
    B, Bg = report["coefficients"], golden(f"{name}_B")
    errs = {
        "coef_rel": float(np.abs(B - Bg).max() / np.abs(Bg).max()),
        "ev_abs": float(np.abs(report["ev"] - golden(f"{name}_ev")).max()),
    }
    for m in ("loo", "lso"):
        ref = golden(f"{name}_{m}_rmse")
        errs[f"{m}_rmse_rel"] = float(np.abs(report[f"{m}_rmse"] - ref).max() / np.abs(ref).max())
        errs[f"{m}_opt_equal"] = bool(
            np.array_equal(report[f"{m}_opt"], golden(f"{name}_{m}_opt").ravel().astype(int))
        )
    return errs


# ---------- phases ----------
def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_device(deflate, variants, eigen) -> None:
    print(nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    from pls_tpu_torch.utils.nvcc import library_path

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, started together
        for fut in [pool.submit(deflate.build), pool.submit(variants.build),
                    pool.submit(eigen._library)]:
            fut.result()
    print(f"kernels build+load {time.perf_counter() - t0:.2f} s")
    for source in ("deflate.cu", "deflate_variants.cu", "eigen.cu"):
        print(f"  {library_path(source).name}")
        log = library_path(source).with_suffix(".log")
        if log.exists():
            for ln in log.read_text().splitlines():
                if "entry function" in ln or "registers" in ln or "spill" in ln:
                    print("  ptxas:", ln.strip())


def phase_kernel(deflate, dev, seed: int) -> dict:
    """Returns {kernel name: max |kernel - plain| of t and p over the shapes}."""
    abs_err = dict.fromkeys(deflate.launches, 0.0)
    g = torch.Generator(dev).manual_seed(seed)
    for N, K in MAIN_PATH_SHAPES + KERNEL_SHAPES:
        X32 = torch.randn((N, K), generator=g, device=dev)
        r = torch.randn(K, generator=g, device=dev)
        for dtype in SHAPE_DTYPES.get((N, K), (torch.float32, torch.bfloat16)):
            X = X32.to(dtype)
            plan = deflate.plan_for(X, r)
            name = deflate.kernel_name(dtype, plan.path)
            if (N, K) in WIDE_PATHS:
                check(plan.path == WIDE_PATHS[N, K], f"{name} {N}x{K}: planned {plan.path}")
            before = dict(deflate.path_calls)
            t, tt, p = deflate.deflate_pass_cuda(X, r)
            t2, tt2, p2 = deflate.deflate_pass_cuda(X, r)
            torch.cuda.synchronize()
            path = [k for k, v in deflate.path_calls.items() if v != before[k]]
            check(path == [plan.path], f"{name} {N}x{K}: launched {path}")
            check(torch.equal(t, t2) and torch.equal(p, p2) and torch.equal(tt, tt2),
                  f"{name} {N}x{K}: two launches differ")
            tp, ttp, pp = deflate.deflate_pass_plain(X, r)
            Xd, rd = X.double(), r.double()  # f64 truth of the stored (rounded) X
            td = Xd @ rd
            pd = Xd.T @ td
            ttd = td @ td
            del Xd
            e_p, e_t = rel_err(p, pd), rel_err(t, td)
            e_tt = abs(float(tt) - float(ttd)) / float(ttd)
            q_p, q_t = rel_err(p, pp), rel_err(t, tp)
            q_tt = abs(float(tt) - float(ttp)) / float(ttp)
            two = ""
            if plan.path == "cluster":  # the two-pass form on the same inputs, for comparison
                w = deflate._launch(X, r, deflate.staged_plan_for)
                q_w = max(_rel3(w, (tp, ttp, pp)))
                check(q_w <= KERNEL_RTOL, f"{name} {N}x{K}: two-pass vs plain rel err {q_w:.2e}")
                two = f"; two-pass form vs plain {q_w:.3e}"
                del w
            print(f"{name} {N}x{K} {path[0]} {plan}: "
                  f"vs f64 rel p {e_p:.3e} tt {e_tt:.3e} t {e_t:.3e}; "
                  f"vs plain rel p {q_p:.3e} tt {q_tt:.3e} t {q_t:.3e}; "
                  f"bit-identical relaunch{two}")
            check(tuple(t.shape) == (N,) and tuple(p.shape) == (K,) and tt.dim() == 0,
                  f"{name}: output shapes")
            check(max(e_p, e_tt, e_t) <= KERNEL_RTOL,
                  f"{name} {N}x{K}: vs f64 rel err p {e_p:.2e} tt {e_tt:.2e} t {e_t:.2e} "
                  f"> {KERNEL_RTOL}")
            check(max(q_p, q_tt, q_t) <= KERNEL_RTOL,
                  f"{name} {N}x{K}: vs plain rel err p {q_p:.2e} tt {q_tt:.2e} t {q_t:.2e} "
                  f"> {KERNEL_RTOL}")
            abs_err[name] = max(abs_err[name],
                                float(max((p - pp).abs().max(), (t - tp).abs().max())))
        del X32
    torch.cuda.empty_cache()
    return abs_err


def psd_batch(B: int, M: int, dtype, g) -> torch.Tensor:
    """B random PSD M×M matrices G Gᵀ, made in float64 on the card."""
    G = torch.randn((B, M, M), generator=g, device=g.device, dtype=torch.float64)
    return (G @ G.mT).to(dtype)


def phase_eigen(eigen, dev, seed: int) -> float:
    """E1 against its twin and float64 eigh at EIGEN_SHAPES; returns the
    largest |kernel − twin| (0: they agree bit for bit)."""
    g = torch.Generator(dev).manual_seed(seed + 7)
    worst = 0.0
    for B, M in EIGEN_SHAPES:
        for dtype, atol in EIGEN_ATOL.items():
            C = psd_batch(B, M, dtype, g)
            before = eigen.path_calls["kernel"]
            v, v2 = eigen.jacobi_dominant_cuda(C), eigen.jacobi_dominant_cuda(C)
            torch.cuda.synchronize()
            name = f"jacobi_dominant {dtype} ({B}, {M}, {M})"
            check(eigen.path_calls["kernel"] == before + 2, f"{name}: launches not counted")
            check(v.dtype == dtype and tuple(v.shape) == (B, M), f"{name}: output")
            check(torch.equal(v, v2), f"{name}: two launches differ")
            plain, sweeps = eigen._jacobi(C.cpu())
            u = torch.linalg.eigh(C.double()).eigenvectors[..., -1]
            vd = v.double()
            u = torch.where((vd * u).sum(-1, keepdim=True) < 0, -u, u)
            e_eigh = float((vd - u).abs().max())
            e_plain = float((v.cpu() - plain).abs().max())
            print(f"{name}: vs twin max abs {e_plain:.3e} ({int(sweeps.max())} sweeps at most); "
                  f"vs f64 eigh up to sign {e_eigh:.3e}; bit-identical relaunch")
            check(torch.equal(v.cpu(), plain), f"{name}: differs from its twin by {e_plain:.2e}")
            check(e_eigh <= atol, f"{name}: vs f64 eigh {e_eigh:.2e} > {atol}")
            worst = max(worst, e_plain)
    return worst


def run_cli(args: list[str]) -> str:
    from pls_tpu_torch.cli import main as cli_main

    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli_main(args)
    check(rc == 0, f"CLI {args} exited {rc}:\n{err.getvalue()[-2000:]}")
    check(out.getvalue() == "", "CLI wrote to stdout")
    return err.getvalue()


def phase_cli(deflate, eigen) -> dict:
    walls = {}
    for name, xf, yf, A, n_eig in [
        ("nir", "nir.csv", "octane.csv", 10, 0),
        ("toy", "toyX.csv", "toyY.csv", 2, 3 * 2),
    ]:
        before, e_before = dict(deflate.launches), eigen.path_calls["kernel"]
        t0 = time.perf_counter()
        text = run_cli([str(DATA / xf), str(DATA / yf), str(A)])
        walls[name] = time.perf_counter() - t0
        d32 = deflate.launches["deflate_f32"] - before["deflate_f32"]
        d16 = deflate.launches["deflate_bf16"] - before["deflate_bf16"]
        d_eig = eigen.path_calls["kernel"] - e_before
        errs = golden_errors(parse_report(text), name)
        print(f"cli {name} A={A}: wall {walls[name]:.3f} s, launches f32 {d32} bf16 {d16} "
              f"jacobi_dominant {d_eig}, vs golden {json.dumps(errs)}")
        check(d32 == A and d16 == 0, f"cli {name}: {d32} f32 launches, expected {A}")
        check(d_eig == n_eig, f"cli {name}: {d_eig} eigenvector launches, expected {n_eig}")
        check(errs["coef_rel"] <= COEF_RTOL, f"cli {name}: coefficients {errs['coef_rel']:.2e}")
        check(errs["ev_abs"] <= EV_ATOL, f"cli {name}: explained variance {errs['ev_abs']:.2e}")
        for m in ("loo", "lso"):
            check(errs[f"{m}_rmse_rel"] <= RMSE_RTOL,
                  f"cli {name}: {m} RMSE {errs[f'{m}_rmse_rel']:.2e}")
            check(errs[f"{m}_opt_equal"], f"cli {name}: {m} optimal components differ")
    return walls


def make_big(dev, seed: int):
    """100000×5000 X, 10 Y: a rank-30 latent model plus noise, z-scored."""
    from pls_tpu_torch.ops.stats import colwise_z_scores

    N, K = BIG
    g = torch.Generator(dev).manual_seed(seed)
    lat = torch.randn((N, 30), generator=g, device=dev)
    X = lat @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = lat @ torch.randn((30, 10), generator=g, device=dev)
    Y += 0.1 * torch.randn((N, 10), generator=g, device=dev)
    return colwise_z_scores(X), colwise_z_scores(Y)


def fit_big(X, Y, **kw):
    from pls_tpu_torch.model import PLSModel

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = PLSModel(X, Y, max_components=20, **kw)
    B, ev = m.coefficients(), m.explained_variance()
    torch.cuda.synchronize()
    return m, B, ev, time.perf_counter() - t0


def phase_big(deflate, dev, seed: int) -> float:
    X, Y = make_big(dev, seed)
    before = dict(deflate.launches)
    m32, B32, ev32, wall = fit_big(X, Y)
    d32 = deflate.launches["deflate_f32"] - before["deflate_f32"]
    check(d32 == 20, f"100k×5k f32 fit: {d32} launches, expected 20")
    check(tuple(B32.shape) == (5000, 10) and bool(torch.isfinite(B32).all())
          and tuple(m32.T.shape) == (100_000, 20), "100k×5k f32 fit: shapes / non-finite")
    _, B64, ev64, wall64 = fit_big(X.double(), Y.double())
    check(deflate.launches["deflate_f32"] - before["deflate_f32"] == 20,
          "f64 fit launched the kernel")
    e_b, e_ev = rel_err(B32, B64), float((ev32.double() - ev64).abs().max())
    print(f"100k×5k×10 A=20 f32: wall {wall:.3f} s (first fit), launches {d32}; "
          f"vs f64 (plain path, wall {wall64:.3f} s): coef rel {e_b:.3e}, ev abs {e_ev:.3e}")
    check(e_b <= FIT_COEF_RTOL and e_ev <= FIT_EV_ATOL, "100k×5k f32 fit disagrees with f64")
    del B64, ev64
    before, cols_before = dict(deflate.launches), deflate.path_calls["cols"]
    _, B16, ev16, wall16 = fit_big(X, Y, x_storage="bf16")
    d16 = deflate.launches["deflate_bf16"] - before["deflate_bf16"]
    d_cols = deflate.path_calls["cols"] - cols_before
    e_b16, e_ev16 = rel_err(B16, B32), float((ev16 - ev32).abs().max())
    print(f"100k×5k×10 A=20 bf16 storage: wall {wall16:.3f} s, launches {d16} ({d_cols} on the "
          f"cols path); vs f32: coef rel {e_b16:.3e}, ev abs {e_ev16:.3e}")
    check(d16 == 20 and d_cols == 20, f"bf16 fit: {d16} launches, {d_cols} cols, expected 20")
    check(e_b16 <= BF16_COEF_RTOL and e_ev16 <= BF16_EV_ATOL, "bf16 fit outside its budget")
    walls = {"f32": [], "bf16": []}
    for storage in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):  # in turns
        walls[storage].append(fit_big(X, Y, **({"x_storage": "bf16"} if storage == "bf16"
                                              else {}))[3])
    fit_walls = {k: statistics.median(v) for k, v in walls.items()}
    for k, v in walls.items():
        print(f"100k×5k×10 A=20 {k} fit wall, warm: median {fit_walls[k]:.4f} s "
              f"of {[round(w, 4) for w in v]}")
    return fit_walls


def times_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 1,
             hold: int = 0) -> list[float]:
    """CUDA-event times of `inner` calls of fn back to back, per call;
    with hold, the calls queue behind a sleep of the stream of that many
    cycles, so that the host's time between launches does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(hold)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return times


def median_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 1) -> float:
    return statistics.median(times_ms(fn, reps, warmup, inner))


def bound(N: int, K: int, itemsize: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one pass on the
    published H100 SXM peaks, X and r read once, t, p and tt written once,
    against 4·N·K + 2·K f32 flops."""
    byte_ms = (N * K * itemsize + 4 * (2 * K + N + 1)) / HBM_BYTES_PER_S * 1e3
    flop_ms = (4 * N * K + 2 * K) / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def library_pass(X: torch.Tensor, r: torch.Tensor):
    """The two library products of the pass: t = X r, p = Xᵀt; on bf16 X
    with r and t rounded to bf16 (cuBLAS has no bf16 × f32 product)."""
    rr = r.to(X.dtype)
    t = X @ rr
    return t, X.T @ t


def phase_timing(deflate, dev, seed: int) -> dict:
    """{kernel name: (ms, plain ms, library ms, bound ms, bound_by)} of K1
    and K2 at 100000×5000."""
    N, K = BIG
    g = torch.Generator(dev).manual_seed(seed + 1)
    X = torch.randn((N, K), generator=g, device=dev)
    Xb = X.to(torch.bfloat16)
    r = torch.randn(K, generator=g, device=dev)
    check(deflate.plan_for(Xb, r).path == "cols" and deflate.staged_plan_for(Xb, r).path
          == "staged", f"K2 {N}x{K}: the two designs are not planned")
    designs = {"K1": lambda: deflate.deflate_pass_cuda(X, r),
               "K2 cols": lambda: deflate.deflate_pass_cuda(Xb, r),
               "K2 staged": lambda: deflate._launch(Xb, r, deflate.staged_plan_for)}
    one, b2b = {k: [] for k in designs}, {k: [] for k in designs}
    # K2's two designs in turns: cols, staged, staged, cols
    for key in ("K1", "K2 cols", "K2 staged", "K2 staged", "K2 cols"):
        one[key] += times_ms(designs[key])
        b2b[key] += times_ms(designs[key], reps=5, inner=10)
    out = {}
    for name, XX, key in (("deflate_f32", X, "K1"), ("deflate_bf16", Xb, "K2 cols")):
        plain_ms = median_ms(lambda: deflate.deflate_pass_plain(XX, r))
        lib_ms = median_ms(lambda: library_pass(XX, r))
        b_ms, b_by = bound(N, K, XX.element_size())
        out[name] = (statistics.median(b2b[key]), plain_ms, lib_ms, b_ms, b_by)
        print(f"{name} {N}x{K} {deflate.plan_for(XX, r)}: bound {b_ms:.4f} ms ({b_by}); plain "
              f"{plain_ms:.4f} ms; library (two {'bf16' if XX.element_size() == 2 else 'f32'} "
              f"products) {lib_ms:.4f} ms")
    for key in designs:
        XX = X if key == "K1" else Xb
        b_ms = bound(N, K, XX.element_size())[0]
        ms, ms2 = statistics.median(one[key]), statistics.median(b2b[key])
        gbs = N * K * XX.element_size() / ms2 / 1e6
        print(f"{key} {N}x{K}: one call {ms:.4f} ms (spread {min(one[key]):.4f}-"
              f"{max(one[key]):.4f}), back to back {ms2:.4f} ms per call (spread "
              f"{min(b2b[key]):.4f}-{max(b2b[key]):.4f}) = {gbs:.1f} GB/s one-pass; "
              f"{b_ms / ms:.3f} / {b_ms / ms2:.3f} of the bound")
    gain = [statistics.median(d["K2 staged"]) / statistics.median(d["K2 cols"]) for d in (one, b2b)]
    print(f"K2 cols vs staged at {N}x{K}: {gain[0]:.3f}x (one call), {gain[1]:.3f}x (back to "
          f"back) faster")
    dst = torch.empty_like(X)
    copy_ms = median_ms(lambda: dst.copy_(X))
    print(f"device-to-device copy of {4 * N * K} B: {copy_ms:.4f} ms = "
          f"{2 * 4 * N * K / copy_ms / 1e6:.1f} GB/s (read + write)")
    del X, Xb, dst
    torch.cuda.empty_cache()
    out.update(wide_timing(deflate, dev, g))
    out["staging"] = pancan_timing(deflate, dev, g)
    return out


def pancan_timing(deflate, dev, g) -> dict:
    """The cluster kernel at PANCAN's plan (C = 2, R = 1, 5 slots) in three
    forms, in turns, back to back: vec 1 at PANCAN, vec 4 at K + 1 (its
    16-byte staging), and vec 1 at K + 1 from a view one element into its
    storage (the staging apart from K).  Returns {form: {ms, bound_ms,
    share, vec, staging}}."""
    N, K = PANCAN
    buf = torch.randn(N * (K + 1) + 1, generator=g, device=dev)
    forms = {"vec1": buf[:N * K].view(N, K), "vec4": buf[:N * (K + 1)].view(N, K + 1),
             "vec1_offset": buf[1:].view(N, K + 1)}
    rs = {k: torch.randn(X.shape[1], generator=g, device=dev) for k, X in forms.items()}
    out, b2b = {}, {k: [] for k in forms}
    for key, X in forms.items():
        plan = deflate.plan_for(X, rs[key])
        check((plan.path, plan.vec, plan.C, plan.R, plan.stages)
              == ("cluster", 4 if key == "vec4" else 1, 2, 1, 5),
              f"pancan {key} {tuple(X.shape)}: planned {plan}")
        before = dict(deflate.staging_calls)
        t, _, p = deflate.deflate_pass_cuda(X, rs[key])
        staging = [k for k, v in deflate.staging_calls.items() if v != before[k]]
        tp, _, pp = deflate.deflate_pass_plain(X, rs[key])
        err = max(rel_err(t, tp), rel_err(p, pp))
        check(err < KERNEL_RTOL, f"pancan {key}: {err:.3g} from the plain form")
        out[key] = {"vec": plan.vec, "staging": staging[0] if staging else None}
    for key in (*forms, *reversed(forms)):
        b2b[key] += times_ms(lambda: deflate.deflate_pass_cuda(forms[key], rs[key]), reps=5,
                             inner=10)
    for key, X in forms.items():
        b_ms = bound(*X.shape, 4)[0]
        ms = statistics.median(b2b[key])
        out[key].update(ms=ms, bound_ms=b_ms, share=b_ms / ms)
        print(f"deflate_f32_cluster {key} {N}x{X.shape[1]} (vec {out[key]['vec']}, "
              f"{out[key]['staging']}): {ms:.4f} ms back to back (spread {min(b2b[key]):.4f}-"
              f"{max(b2b[key]):.4f}), bound {b_ms:.4f} ms, {b_ms / ms:.3f} of the bound")
    del buf, forms
    torch.cuda.empty_cache()
    return out


def wide_timing(deflate, dev, g) -> dict:
    """The cluster path against the two-pass form it replaces, in turns
    (cluster, two-pass, two-pass, cluster), back to back, at WIDE_TIMED in
    f32 and bf16; with the plain form and the library's two products.
    Returns the kernels-line entries of the cluster kernels at WIDE, and
    {dtype: two-pass ms - cluster ms} there under "gain"."""
    out, gain = {}, {}
    for N, K in WIDE_TIMED:
        X32 = torch.randn((N, K), generator=g, device=dev)
        r = torch.randn(K, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            X = X32 if dtype == torch.float32 else X32.to(dtype)
            plan, two = deflate.plan_for(X, r), deflate.staged_plan_for(X, r)
            check(plan.path == "cluster" and two.path == "wide",
                  f"{N}x{K} {dtype}: planned {plan.path} / {two.path}")
            forms = {"cluster": lambda: deflate.deflate_pass_cuda(X, r),
                     "two-pass": lambda: deflate._launch(X, r, deflate.staged_plan_for)}
            b2b = {k: [] for k in forms}
            for key in ("cluster", "two-pass", "two-pass", "cluster"):
                b2b[key] += times_ms(forms[key], reps=5, inner=10)
            plain_ms = median_ms(lambda: deflate.deflate_pass_plain(X, r))
            lib_ms = median_ms(lambda: library_pass(X, r))
            b_ms, b_by = bound(N, K, X.element_size())
            nbytes = N * K * X.element_size()
            ms = {k: statistics.median(v) for k, v in b2b.items()}
            name = deflate.kernel_name(dtype, "cluster")
            print(f"{name} {N}x{K} {plan}: {plan.G} clusters x {plan.C} = {plan.G * plan.C} "
                  f"CTAs of the card's {torch.cuda.get_device_properties(dev).multi_processor_count}"
                  f" SMs; bound {b_ms:.4f} ms ({b_by})")
            for key, v in list(b2b.items()) + [("plain", [plain_ms]), ("library", [lib_ms])]:
                m = statistics.median(v)
                print(f"  {key} {m:.4f} ms (spread {min(v):.4f}-{max(v):.4f}) = "
                      f"{nbytes / m / 1e6:.1f} GB/s one-pass, {b_ms / m:.3f} of the bound")
            print(f"  cluster vs two-pass: {ms['two-pass'] / ms['cluster']:.3f}x faster")
            check(max(b2b["cluster"]) < min(b2b["two-pass"]),
                  f"{name} {N}x{K}: the cluster path is not faster than the two-pass form")
            if (N, K) == WIDE:
                out[name] = (ms["cluster"], plain_ms, lib_ms, b_ms, b_by)
                gain[dtype] = ms["two-pass"] - ms["cluster"]
            del X
        del X32
        torch.cuda.empty_cache()
    out["gain"] = gain
    return out


def eigen_timing(eigen, dev, seed: int) -> dict:
    """E1 against eigh at EIGEN_SHAPES in float32 and float64; returns its
    kernels-line entry at (1, 10, 10) float32."""
    g = torch.Generator(dev).manual_seed(seed + 8)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for B, M in EIGEN_SHAPES:
            C = psd_batch(B, M, dtype, g)
            ms = statistics.median(times_ms(lambda: eigen.jacobi_dominant_cuda(C), reps=5,
                                            inner=10, hold=EIGEN_HOLD_CYCLES))
            lib_ms = median_ms(lambda: torch.linalg.eigh(C).eigenvectors[..., -1])
            sweeps = eigen._jacobi(C.cpu())[1]
            m = M + M % 2
            rounds = int(sweeps.max()) * (m - 1)
            # each rotated pair of entries costs 8 flops: rows p and q of A
            # (its upper half), then V's columns, m/2 pairs a round
            flops = float(sweeps.sum()) * (m - 1) * (m // 2) * 8 * (m + M)
            nbytes = (B * M * M + B * M) * C.element_size()
            byte_ms, flop_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOPS * 1e3
            b_ms, b_by = (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")
            print(f"jacobi_dominant {dtype} ({B}, {M}, {M}): {ms * 1e3:.2f} us a call back to "
                  f"back (queued); eigh {lib_ms * 1e3:.2f} us a call; {int(sweeps.max())} "
                  f"sweeps at most, {ms * 1e6 / rounds:.1f} ns a dependent round of {rounds}; "
                  f"bound {b_ms * 1e3:.6f} us ({b_by})")
            if (B, M, dtype) == (1, 10, torch.float32):
                out["jacobi_dominant"] = (ms, None, lib_ms, b_ms, b_by)
    return out


def phase_wide_fit(dev, seed: int, gain: dict) -> dict:
    """`models.kernel_pls.fit` at WIDE_FIT, A = 20, on the cluster path, in
    f32 and with x_storage="bf16", warm: f32 against float64 on the card,
    bf16 against f32 (phase 4's bounds); the warm walls beside 20 × the
    pass-time gain over the two-pass form (`gain`, from phase 5)."""
    import pls_tpu_torch as ptt
    from pls_tpu_torch.models import kernel_pls
    from pls_tpu_torch.ops.stats import colwise_z_scores

    N, K, M = WIDE_FIT
    g = torch.Generator(dev).manual_seed(seed + 7)
    lat = torch.randn((N, 30), generator=g, device=dev)
    X = lat @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = lat @ torch.randn((30, M), generator=g, device=dev)
    Y += 0.1 * torch.randn((N, M), generator=g, device=dev)
    X, Y = colwise_z_scores(X), colwise_z_scores(Y)

    def fit(XX, YY, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        B = ptt.coefficients(kernel_pls.fit(XX, YY, 20, **kw))
        torch.cuda.synchronize()
        return B, time.perf_counter() - t0

    B32, _ = fit(X, Y)
    B16, _ = fit(X, Y, x_storage="bf16")
    B64, wall64 = fit(X.double(), Y.double())
    e32, e16 = rel_err(B32, B64), rel_err(B16, B32)
    check(tuple(B32.shape) == (K, M) and bool(torch.isfinite(B32).all())
          and bool(torch.isfinite(B16).all()), "wide fit: shapes / non-finite")
    check(e32 <= FIT_COEF_RTOL, f"wide fit f32 vs f64 coef rel {e32:.3e} > {FIT_COEF_RTOL}")
    check(e16 <= BF16_COEF_RTOL, f"wide fit bf16 vs f32 coef rel {e16:.3e} > {BF16_COEF_RTOL}")
    walls = {"f32": [], "bf16": []}
    for storage in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):  # in turns
        walls[storage].append(fit(X, Y, **({"x_storage": "bf16"} if storage == "bf16"
                                           else {}))[1])
    out = {"coef_rel_f32_vs_f64": e32, "coef_rel_bf16_vs_f32": e16, "wall_f64_s": wall64}
    for (k, v), dtype in zip(walls.items(), (torch.float32, torch.bfloat16)):
        out[f"wall_{k}_s"] = statistics.median(v)
        print(f"wide fit {N}x{K}x{M} A=20 {k}: warm wall median {statistics.median(v):.4f} s of "
              f"{[round(w, 4) for w in v]}; 20 x (two-pass - cluster) pass time "
              f"{20 * gain[dtype]:.3f} ms")
    print(f"wide fit coef rel: f32 vs f64 {e32:.3e} (f64 wall {wall64:.3f} s), "
          f"bf16 vs f32 {e16:.3e}")
    del X, Y
    torch.cuda.empty_cache()
    return out


def _fmt(errs) -> str:
    return "/".join(f"{e:.2e}" for e in errs)


def _rel3(out, ref) -> tuple[float, float, float]:
    """Relative errors of (t, p, tt) against a reference triple."""
    (t, tt, p), (tr, ttr, pr) = out, ref
    return rel_err(t, tr), rel_err(p, pr), abs(float(tt) - float(ttr)) / abs(float(ttr))


def phase_variants(dv, kv, dev, seed: int) -> dict:
    """Every variant of the sweep's default lists against its plain version
    and f64 truth, with a bit-identical relaunch.  Returns {kernel name:
    max |kernel - plain| of t and p}."""
    abs_err = {name: 0.0 for name in dv.launches}
    variants = kv.default_variants(False) + kv.default_variants(True)
    g = torch.Generator(dev).manual_seed(seed + 2)
    for N, K in VARIANT_SHAPES:
        X32 = torch.randn((N, K), generator=g, device=dev)
        r = torch.randn(K, generator=g, device=dev)
        truth = {}
        for dtype in (torch.float32, torch.bfloat16):
            Xd = X32.to(dtype).double()  # f64 truth of the stored (rounded) X
            td = Xd @ r.double()
            truth[dtype] = (td, td @ td, Xd.T @ td)
            del Xd
        worst = [0.0] * 6  # VPU forms: t, p, tt vs plain, then vs f64
        for v in variants:
            prec = getattr(v, "prec", None)  # K4's; the column-owning rows have none
            X = X32.to(v.dtype)
            if not v.takes(X):  # cols_bf16 at K % 8 != 0: refuses, never falls back
                try:
                    v.cuda(X, r)
                except ValueError:
                    continue
                raise SmokeFailure(f"{v.name} {N}x{K}: ran a shape it does not take")
            paths = dict(dv.mxu_path_launches)
            out = v.cuda(X, r)
            again = v.cuda(X, r)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"{v.name} {N}x{K}: two launches differ")
            path = [k for k, n in dv.mxu_path_launches.items() if n != paths[k]]
            check(tuple(out[0].shape) == (N,) and tuple(out[2].shape) == (K,)
                  and out[1].dim() == 0 and all(o.dtype == torch.float32 for o in out),
                  f"{v.name} {N}x{K}: output shapes / dtypes")
            plain = v.plain(X, r)
            q = _rel3(out, plain)
            e = _rel3(out, truth[v.dtype])
            budget = KERNEL_RTOL
            if prec in ("DEFAULT", "HIGH"):
                # against f64: within 10× the error of the plain emulation itself
                budget = 10 * max(_rel3(plain, truth[v.dtype]))
            if prec:
                want = "ring" if K % 4 == 0 else "staged"  # X from torch is 16-byte aligned
                check(path == [want], f"{v.name} {N}x{K}: launched on {path}, not {want}")
                # K4's p against the plain second product on the kernel's own t
                # (see mxu_plain_p); at DEFAULT the whole chain's p is printed
                # only, as a last-bit flip of tᵢ can move its bf16 rounding
                p_own = dv.mxu_plain_p(X, out[0], prec)
                q_own = rel_err(out[2], p_own)
                check(max(q[0], q_own, q[2]) <= KERNEL_RTOL,
                      f"{v.name} {N}x{K}: vs plain rel err t {q[0]:.2e} p (own t) "
                      f"{q_own:.2e} tt {q[2]:.2e} > {KERNEL_RTOL}")
                line = f"{want} path, p on own t {q_own:.2e}"
                if prec == "DEFAULT":
                    # the check's power: p with t left unrounded (a kernel that
                    # skips t's bf16 re-rounding) must fall outside the bound
                    ctrl = rel_err(X.to(torch.bfloat16).float().T @ out[0], p_own)
                    check(ctrl > KERNEL_RTOL, f"{v.name} {N}x{K}: control {ctrl:.2e} "
                          f"within {KERNEL_RTOL}: the p check cannot see t's rounding")
                    line += f", control (t not re-rounded) {ctrl:.2e}"
                else:
                    check(q[1] <= KERNEL_RTOL,
                          f"{v.name} {N}x{K}: vs plain rel err p {q[1]:.2e} > {KERNEL_RTOL}")
                print(f"  {v.name} {N}x{K}: rel err t/p/tt vs plain {_fmt(q)}, {line}, "
                      f"vs f64 {_fmt(e)} (budget {budget:.3e})")
                del p_own
            else:
                check(max(q) <= KERNEL_RTOL,
                      f"{v.name} {N}x{K}: vs plain rel err t/p/tt {_fmt(q)} > {KERNEL_RTOL}")
                worst = [max(w, a) for w, a in zip(worst, q + e)]
            check(max(e) <= budget,
                  f"{v.name} {N}x{K}: vs f64 rel err t/p/tt {_fmt(e)} > {budget:.3e}")
            abs_err[v.kind] = max(abs_err[v.kind], float(max(
                (out[0] - plain[0]).abs().max(), (out[2] - plain[2]).abs().max())))
            del X, out, again, plain
        print(f"variants {N}x{K}: {len(variants)} variants, bit-identical relaunches; "
              f"VPU forms' largest rel err t/p/tt vs plain {_fmt(worst[:3])}, "
              f"vs f64 {_fmt(worst[3:])}")
        del X32, truth
        torch.cuda.empty_cache()
    return abs_err


def phase_sweep(kv, seed: int) -> dict:
    """The sweep at its default size in f32 and bf16 and at the repo's full
    size; returns {(n, k, bf16): rows}."""
    tables = {}
    for (n, k), bf16 in [(SWEEP, False), (SWEEP, True), (BIG, False), (BIG, True)]:
        rows = kv.sweep(n, k, SWEEP_ITERS, bf16, seed)
        failed = [row["name"] for row in rows if "error" in row]
        check(not failed, f"sweep {n}x{k} bf16={bf16}: {failed} failed")
        for row in rows[1:]:  # all but the copy: err_p, err_tt against f64 of the f32 X
            tol = SWEEP_BF16_RTOL if bf16 else SWEEP_RTOL.get(row["name"].split("_r")[0],
                                                              KERNEL_RTOL)
            check(max(row["err_p"], row["err_tt"]) <= tol,
                  f"sweep {n}x{k} {row['name']}: err_p {row['err_p']:.2e} "
                  f"err_tt {row['err_tt']:.2e} > {tol}")
        tables[(n, k, bf16)] = rows
        torch.cuda.empty_cache()
    return tables


def best_variant_times(dv, kv, tables: dict, dev, seed: int) -> dict:
    """{kernel name: (ms, its plain version's ms, the library products' ms,
    bound ms, bound_by)} at the sweep's default size.  Each kernel's best
    variant by the sweep's chain slope is timed again back to back (10
    calls per event pair): the chain slope carries the host's time per
    chained step.  K5's best row-staged and best column-owning variants
    are timed in turns, and its ms is the faster one's."""
    out = {}
    n, k = SWEEP
    g = torch.Generator(dev).manual_seed(seed + 3)
    X32 = torch.randn((n, k), generator=g, device=dev)
    r = torch.randn(k, generator=g, device=dev)
    for name, prefixes in (("vpu_f32", ("vpu_1k_",)), ("mxu_f32", ("mxu_",)),
                           ("vpu_bf16", ("vpu_bf16_", "cols_bf16_"))):
        bf16 = name == "vpu_bf16"
        variants = {v.name: v for v in kv.default_variants(bf16)}
        best = {}
        for prefix in prefixes:
            rows = [row for row in tables[(n, k, bf16)] if row["name"].startswith(prefix)]
            row = min(rows, key=lambda row: row["ms"])
            best[row["name"]] = (variants[row["name"]], row["ms"])
        X = X32.to(torch.bfloat16 if bf16 else torch.float32)
        times = {v_name: [] for v_name in best}
        order = list(best) + list(best)[::-1]  # in turns: a, b, b, a
        for v_name in order:
            v = best[v_name][0]
            times[v_name] += times_ms(lambda: v.cuda(X, r), reps=5, inner=10)
        ms = {v_name: statistics.median(t) for v_name, t in times.items()}
        b_ms, b_by = bound(n, k, X.element_size())
        for v_name, t in times.items():
            print(f"{name}: {v_name} at {n}x{k}: back to back {ms[v_name]:.4f} ms per call "
                  f"(spread {min(t):.4f}-{max(t):.4f}; chain slope {best[v_name][1]:.4f}), "
                  f"{b_ms / ms[v_name]:.3f} of the {b_ms:.4f} ms bound ({b_by})")
        fastest = min(ms, key=ms.get)
        v = best[fastest][0]
        out[name] = (ms[fastest], median_ms(lambda: v.plain(X, r)),
                     median_ms(lambda: library_pass(X, r)), b_ms, b_by)
        print(f"{name}: best variant at {n}x{k} {fastest} {ms[fastest]:.4f} ms; its plain "
              f"version {out[name][1]:.4f} ms; library (two {'bf16' if bf16 else 'f32'} "
              f"products) {out[name][2]:.4f} ms")
    return out


def make_stats_data(dev, seed: int):
    """Raw 50000×10000 X and 10 Y on the card: make_big's rank-30 latent
    model plus noise, with column offsets of 0.5-3 column σ."""
    N, K, M = STATS
    g = torch.Generator(dev).manual_seed(seed + 7)
    lat = torch.randn((N, 30), generator=g, device=dev)
    X = lat @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = lat @ torch.randn((30, M), generator=g, device=dev)
    Y += 0.1 * torch.randn((N, M), generator=g, device=dev)
    for T in (X, Y):
        T += (0.5 + 2.5 * torch.rand(T.shape[1], generator=g, device=dev)) * T.std(0)
    return X, Y


def f64_stats(X, Y, chunk: int = 4096):
    """XᵀX, XᵀY, YᵀY and the column sums in float64 on the card, in chunks."""
    K, M = X.shape[1], Y.shape[1]
    XX = torch.zeros((K, K), dtype=torch.float64, device=X.device)
    XY = torch.zeros((K, M), dtype=torch.float64, device=X.device)
    YY = torch.zeros((M, M), dtype=torch.float64, device=X.device)
    sx = torch.zeros(K, dtype=torch.float64, device=X.device)
    sy = torch.zeros(M, dtype=torch.float64, device=X.device)
    for i in range(0, X.shape[0], chunk):
        x, y = X[i : i + chunk].double(), Y[i : i + chunk].double()
        XX.addmm_(x.T, x)
        XY.addmm_(x.T, y)
        YY.addmm_(y.T, y)
        sx += x.sum(0)
        sy += y.sum(0)
    return XX, XY, YY, sx, sy


def fro_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))


def synced_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fsync(path: str) -> None:
    """Flush a written file to the disk, so that a later read does not
    wait on its write-back."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def direct_io_ok(path: str) -> bool:
    try:
        os.close(os.open(path, os.O_RDONLY | os.O_DIRECT))
        return True
    except OSError:
        return False


def phase_stats(dev, seed: int) -> dict:
    """The statistics path on the card (phase 7).  Returns its measurements."""
    from pls_tpu_torch.cv.kfold import kfold_assignments
    from pls_tpu_torch.cv.loo import cv_loo_from_stats
    from pls_tpu_torch.cv.validation import optimal_num_components
    from pls_tpu_torch.models.kernel_pls import fit_from_stats
    from pls_tpu_torch.models.predict import coefficients, residuals_all_components
    from pls_tpu_torch.models.streaming import zscore_stats
    from pls_tpu_torch.utils import binio

    N, K, M = STATS
    A = STATS_A
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    X, Y = make_stats_data(dev, seed)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stats_", dir=ROOT / "build"))
    try:
        xp, yp = str(tmp / "X.npy"), str(tmp / "Y.npy")
        _, wall_w = synced_wall(lambda: (
            binio.write_npy_chunked(xp, (X[i : i + STATS_CHUNK] for i in range(0, N, STATS_CHUNK))),
            binio.write_npy_chunked(yp, [Y]), fsync(xp), fsync(yp)))
        xbytes = os.path.getsize(xp)
        direct = direct_io_ok(xp)
        chunk_rows = binio.auto_chunk_rows(torch.float32)
        # the file's read rate (pooled pinned reader, no copies) and the
        # pinned host→device copy rate of one chunk
        t0 = time.perf_counter()
        for _ in binio.stream_npy(xp, chunk_rows, reuse_buffers=True, pin_memory=True):
            pass
        read_gbs = xbytes / (time.perf_counter() - t0) / 1e9
        host = torch.empty((chunk_rows, K), pin_memory=True)
        devbuf = torch.empty((chunk_rows, K), device=dev)
        h2d_ms = median_ms(lambda: devbuf.copy_(host, non_blocking=True), reps=9, warmup=2)
        h2d_gbs = host.numel() * 4 / h2d_ms / 1e6
        del host, devbuf
        print(f"stats data {N}x{K}x{M} f32: X file {xbytes} B written and synced in {wall_w:.3f} s "
              f"(O_DIRECT {'yes' if direct else 'no, buffered'}); read rate "
              f"{read_gbs:.3f} GB/s; pinned host->device {h2d_gbs:.3f} GB/s "
              f"({h2d_ms:.4f} ms per {chunk_rows}-row chunk)")

        # the stats pass, held to f64 on the card
        acc, wall_s = synced_wall(lambda: binio.stats_from_npy(
            xp, yp, device=dev, stats_precision="highest"))
        XX64, XY64, YY64, sx64, sy64 = f64_stats(X, Y)
        e_xx, e_xy = fro_rel(acc.XX, XX64), fro_rel(acc.XY, XY64)
        stats_gbs = (xbytes + os.path.getsize(yp)) / wall_s / 1e9
        print(f"stats_from_npy: {wall_s:.3f} s = {stats_gbs:.3f} GB/s disk->card; XX rel Frobenius "
              f"{e_xx:.3e}, XY {e_xy:.3e} vs f64 on the card (bound {STATS_RTOL})")
        check(acc.n == N and e_xx <= STATS_RTOL and e_xy <= STATS_RTOL,
              f"stats pass: n {acc.n}, XX {e_xx:.2e}, XY {e_xy:.2e} > {STATS_RTOL}")
        devices = {acc.XX.device.type, acc.XY.device.type}
        del acc

        # the streamed fit (A = 20, z-scored in closed form) against the fit
        # from the f64 statistics
        Z64 = zscore_stats(XX64, XY64, sx64, sy64, N, YY=YY64)
        del XX64, XY64
        fit, wall_f = synced_wall(lambda: binio.fit_streaming_npy(
            xp, yp, A, device=dev, zscore=True))
        B32 = coefficients(fit)
        B64 = coefficients(fit_from_stats(Z64[0], Z64[1], A))
        e_b = rel_err(B32, B64)
        print(f"fit_streaming_npy A={A} zscore: wall {wall_f:.3f} s; coef rel {e_b:.3e} vs the f64 "
              f"statistics' fit (bound {FIT_COEF_RTOL})")
        check(tuple(B32.shape) == (K, M) and bool(torch.isfinite(B32).all()),
              "streamed fit: shape / non-finite")
        check(e_b <= FIT_COEF_RTOL, f"streamed fit: coef rel {e_b:.2e} > {FIT_COEF_RTOL}")
        devices.add(B32.device.type)
        del fit, B32, B64

        # k-fold CV from the files: two passes, errors kept on the card
        assign = kfold_assignments(N, STATS_K, seed)
        (summary, res), wall_k = synced_wall(lambda: binio.cv_kfold_npy(
            xp, yp, A, k=STATS_K, assignments=assign, zscore=True, residual_pass=True,
            device=dev))
        check(tuple(res.errors.shape) == (M, N, A) and bool(torch.isfinite(res.errors).all()),
              "k-fold: errors shape / non-finite")
        press_res = (res.errors.double() ** 2).sum(1).cpu().numpy()
        energy = float(N - 1)  # Σ y² of a z-scored column
        gap = np.abs(summary.press - press_res)
        worst = float((gap / (2e-4 * np.abs(press_res) + 1e-5 * energy)).max())
        opt, wall_o = synced_wall(lambda: optimal_num_components(res))
        print(f"cv_kfold_npy k={STATS_K} A={A} zscore: wall {wall_k:.3f} s (stats pass, closed "
              f"form, residual pass); PRESS one-pass vs Σ errors² max gap {float(gap.max()):.4e} "
              f"({worst:.3f} of the bound); RMSE at A=1/{A} "
              f"{summary.rmse[:, 0].round(4).tolist()} / {summary.rmse[:, -1].round(4).tolist()}; "
              f"optimal components {opt.tolist()} ({wall_o:.3f} s on the device errors)")
        check(worst <= 1.0, "k-fold: one-pass PRESS disagrees with the residual pass")
        check(bool(((opt >= 1) & (opt <= A)).all()), "k-fold: optimal components out of range")
        devices |= {summary.B.device.type, res.errors.device.type, opt.device.type}
        del summary, res

        # LOO over 1000 held-out rows from the (z-scored) statistics
        acc = binio.stats_from_npy(xp, yp, device=dev, stats_precision="highest")
        XXz, XYz, _, mx, sdx, my, sdy = acc.zscored()
        del acc
        rows = torch.arange(LOO_FOLDS, device=dev)
        fx, fy = (X[rows] - mx) / sdx, (Y[rows] - my) / sdy
        loo, wall_l = synced_wall(lambda: cv_loo_from_stats(XXz, XYz, fx, fy, A))
        del XXz, XYz
        check(tuple(loo.errors.shape) == (M, LOO_FOLDS, A) and bool(torch.isfinite(loo.errors).all()),
              "LOO: errors shape / non-finite")
        mx64, sdx64, my64, sdy64 = Z64[3:]
        worst_loo = 0.0
        for i in range(LOO_CHECKED):
            x = (X[i].double() - mx64) / sdx64
            y = (Y[i].double() - my64) / sdy64
            f64 = fit_from_stats(Z64[0] - torch.outer(x, x), Z64[1] - torch.outer(x, y), A)
            ref = residuals_all_components(f64, x[None], y[None])[0]  # (A, M)
            worst_loo = max(worst_loo, float((loo.errors[:, i, :].T.double() - ref).abs().max()))
        print(f"cv_loo_from_stats {LOO_FOLDS} folds A={A}: wall {wall_l:.3f} s = "
              f"{LOO_FOLDS / wall_l:.1f} folds/s; {LOO_CHECKED} folds vs explicit f64 downdated "
              f"fits: max |err| {worst_loo:.3e} (bound {LOO_ATOL})")
        check(worst_loo <= LOO_ATOL, f"LOO: {worst_loo:.2e} > {LOO_ATOL} against f64")
        devices.add(loo.errors.device.type)
        check(devices == {"cuda"}, f"phase 7 tensors on {devices}")
        peak = torch.cuda.max_memory_allocated()
        print(f"phase 7 peak device memory {peak} B ({peak / 2**30:.2f} GiB); {nvidia_smi()}")
        return {"write_s": wall_w, "read_gbs": read_gbs, "h2d_gbs": h2d_gbs, "stats_s": wall_s,
                "stats_gbs": stats_gbs, "kfold_s": wall_k, "loo_per_s": LOO_FOLDS / wall_l,
                "peak_bytes": peak}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del X, Y
        torch.cuda.empty_cache()


def event_wall(fn):
    """(fn(), seconds between CUDA events recorded around it)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1) / 1e3


def hard_data(seed: int = 0):
    """tests/test_fit_parity.py:287-293's deep-A stress data, float64 numpy."""
    N, K, M, _ = DD_STRESS
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(N, 60)) * (1.5 ** -np.arange(60))
    X = L @ rng.normal(size=(60, K)) + 0.01 * rng.normal(size=(N, K))
    Y = L @ rng.normal(size=(60, M)) + 0.01 * rng.normal(size=(N, M))
    return X, Y


def nir_zscored() -> tuple[torch.Tensor, torch.Tensor]:
    """nir/octane z-scored in float64 on the CPU, as the CLI reads them."""
    from pls_tpu_torch.ops.stats import colwise_z_scores
    from pls_tpu_torch.utils.io import read_matrix_file

    return tuple(colwise_z_scores(torch.as_tensor(read_matrix_file(str(DATA / f)),
                                                  dtype=torch.float64))
                 for f in ("nir.csv", "octane.csv"))


def phase_slice(deflate, dev, seed: int) -> dict:
    """Phase 8.  Returns its walls and errors."""
    from pls_tpu_torch.cv.bootstrap import bootstrap_coefficient_intervals
    from pls_tpu_torch.models import nipals
    from pls_tpu_torch.models.kernel_pls import fit
    from pls_tpu_torch.models.predict import coefficients
    from pls_tpu_torch.spectral import apply_chain, savgol, savgol_coeffs, snv
    from pls_tpu_torch.tools.precision_at_scale import run as precision_run
    from pls_tpu_torch.types import METHOD

    out: dict = {}
    X, Y = make_big(dev, seed)
    X64, Y64 = X.double(), Y.double()

    def k1_fit(method, A, **kw):
        before = deflate.launches["deflate_f32"]
        f, wall = event_wall(lambda: fit(X, Y, A, method, **kw))
        return f, wall, deflate.launches["deflate_f32"] - before

    # walls warm: kernel type 1 and SIMPLS take their second fit (the first
    # after phase 7 emptied the allocator's cache runs cold); NIPALS, seconds
    # long, runs once after them
    for _ in range(2):
        _, wall_k1, d = k1_fit(METHOD.KERNEL_TYPE1, SLICE_A)
        check(d == SLICE_A, f"kernel type 1 fit: {d} K1 launches, expected {SLICE_A}")
    out["kernel1_s"] = wall_k1
    for method, A in ((METHOD.SIMPLS, SLICE_A), (METHOD.NIPALS, NIPALS_A)):
        name = method.value
        for _ in range(2 if method == METHOD.SIMPLS else 1):
            f32, wall, d = k1_fit(method, A)
            check(d == A, f"{name} f32 fit: {d} K1 launches, expected {A}")
        iters = list(nipals.last_iterations) if method == METHOD.NIPALS else None
        B32 = coefficients(f32)
        check(tuple(B32.shape) == (BIG[1], 10) and bool(torch.isfinite(B32).all())
              and tuple(f32.T.shape) == (BIG[0], A), f"{name} f32 fit: shapes / non-finite")
        f64, wall64 = event_wall(lambda: fit(X64, Y64, A, method))
        iters64 = list(nipals.last_iterations) if method == METHOD.NIPALS else None
        e = rel_err(B32, coefficients(f64))
        out[f"{name}_s"], out[f"{name}_f64_s"], out[f"{name}_coef_rel"] = wall, wall64, e
        print(f"{name} 100k×5k×10 A={A} f32: wall {wall:.4f} s (CUDA events; kernel type 1 "
              f"A={SLICE_A} {wall_k1:.4f} s), K1 launches {d}; vs {name} f64 (wall "
              f"{wall64:.4f} s): coef rel {e:.3e} (bound {METHOD_COEF_RTOL})")
        if iters is not None:
            out["nipals_iterations"], out["nipals_f64_iterations"] = iters, iters64
            print(f"nipals inner iterations per component: f32 {iters}; f64 {iters64}")
        check(e <= METHOD_COEF_RTOL, f"{name} f32 fit: coef rel {e:.2e} > {METHOD_COEF_RTOL}")
        del f32, f64, B32

    # precision="dd": the float64 loop, on float64 and on float32 input
    for method in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
        B64, wall64 = event_wall(lambda: coefficients(fit(X64, Y64, SLICE_A, method)))
        Bdd, wall_dd = event_wall(lambda: coefficients(fit(X64, Y64, SLICE_A, method,
                                                           precision="dd")))
        B32dd, wall32 = event_wall(lambda: coefficients(fit(X, Y, SLICE_A, method,
                                                            precision="dd")))
        e, e32 = rel_err(Bdd, B64), rel_err(B32dd, B64)
        out[f"dd_{method.value}"] = {"rel": e, "rel_f32_state": e32, "s": wall_dd,
                                     "f32_input_s": wall32, "f64_s": wall64}
        print(f"dd {method.value} 100k×5k×10 A={SLICE_A}: wall {wall_dd:.4f} s (f32 input "
              f"{wall32:.4f} s; plain f64 {wall64:.4f} s); vs f64 coef rel {e:.3e} (bound "
              f"{DD_RTOL}), f32 state {e32:.3e} (bound {DD_F32_RTOL})")
        check(B32dd.dtype == torch.float32 and Bdd.dtype == torch.float64, "dd: state dtypes")
        check(e <= DD_RTOL and e32 <= DD_F32_RTOL, f"dd {method.value}: {e:.2e} / {e32:.2e}")
    del X64, Y64
    Xh, Yh = hard_data()
    A_h = DD_STRESS[3]
    Xs, Ys = (torch.as_tensor(v, device=dev) for v in (Xh, Yh))
    X32, Y32 = Xs.float(), Ys.float()
    for method in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
        B64 = coefficients(fit(Xs, Ys, A_h, method))
        (Bdd, wall) = event_wall(lambda: coefficients(fit(X32, Y32, A_h, method,
                                                          precision="dd")))
        e = rel_err(Bdd, B64)
        e_plain = rel_err(coefficients(fit(X32, Y32, A_h, method)), B64)
        out[f"dd_stress_{method.value}"] = {"rel": e, "plain_f32_rel": e_plain, "s": wall}
        print(f"dd deep-A stress {Xh.shape[0]}×{Xh.shape[1]}×{Yh.shape[1]} A={A_h} "
              f"{method.value}: vs f64 coef rel {e:.3e} (bound {DD_STRESS_RTOL}; plain f32 "
              f"{e_plain:.3e}), wall {wall:.4f} s")
        check(e <= DD_STRESS_RTOL, f"dd stress {method.value}: {e:.2e} > {DD_STRESS_RTOL}")

    # compensated statistics
    n, chunk, K, M = COMP_STATS
    rec, wall = event_wall(lambda: precision_run(n, chunk, K, M, seed, dev))
    last = rec["curves"][-1]
    out["compensated_stats"] = {**last, "s": wall}
    print(f"StatsAccumulator(compensated=True) {rec['n_total']} rows × K={K}: XX err "
          f"{last['xx_err_comp']:.3e} (plain f32 {last['xx_err_plain']:.3e}; bound "
          f"{COMP_XX_RTOL}), XY err {last['xy_err_comp']:.3e} (plain {last['xy_err_plain']:.3e}); "
          f"wall {wall:.3f} s with the f64 truth and the plain accumulator")
    check(last["xx_err_comp"] <= COMP_XX_RTOL and last["xy_err_comp"] <= COMP_XX_RTOL,
          f"compensated statistics: XX {last['xx_err_comp']:.2e} XY {last['xy_err_comp']:.2e}")

    # spectral preprocessing at full size
    Xc, wall = event_wall(lambda: apply_chain(X, CHAIN))
    e = rel_err(Xc, apply_chain(X.double(), CHAIN))
    out["chain_s"], out["chain_rel"] = wall, e
    print(f"apply_chain({CHAIN!r}) 100k×5k f32: wall {wall:.4f} s; vs f64 rel {e:.3e} "
          f"(bound {CHAIN_RTOL})")
    check(tuple(Xc.shape) == BIG and e <= CHAIN_RTOL, f"chain: {e:.2e} > {CHAIN_RTOL}")
    # warm, and by part (CUDA events, median of 5 after one call)
    coeffs = torch.as_tensor(savgol_coeffs(11, 2, 1), dtype=X.dtype, device=dev)[None, None, :]
    parts = {"chain": lambda: apply_chain(X, CHAIN), "savgol:11:2:1": lambda: savgol(X, 11, 2, 1),
             "its conv1d": lambda: torch.nn.functional.conv1d(X[:, None, :], coeffs),
             "snv": lambda: snv(Xc)}
    warm = {k: median_ms(fn, reps=5, warmup=1) for k, fn in parts.items()}
    out["chain_warm_ms"] = warm
    print(f"apply_chain warm, ms: {json.dumps(warm)}; a copy of X takes "
          f"{median_ms(lambda: X.clone(), reps=5, warmup=1):.4f} ms")
    del X, Y, Xc
    torch.cuda.empty_cache()

    # the CLI on nir: float32 on the card against float64 on the CPU
    for extra in (["--method", "nipals"], ["--method", "simpls"], ["--preprocess", CHAIN]):
        argv = [str(DATA / "nir.csv"), str(DATA / "octane.csv"), "10", *extra]
        before = deflate.launches["deflate_f32"]
        card, wall = event_wall(lambda: parse_report(run_cli(argv)))
        d = deflate.launches["deflate_f32"] - before
        cpu = parse_report(run_cli(argv + ["--device", "cpu"]))
        errs = {"coef_rel": float(np.abs(card["coefficients"] - cpu["coefficients"]).max()
                                  / np.abs(cpu["coefficients"]).max()),
                "ev_abs": float(np.abs(card["ev"] - cpu["ev"]).max())}
        for m in ("loo", "lso"):
            errs[f"{m}_rmse_rel"] = float(np.abs(card[f"{m}_rmse"] - cpu[f"{m}_rmse"]).max()
                                          / np.abs(cpu[f"{m}_rmse"]).max())
            errs[f"{m}_opt_equal"] = bool(np.array_equal(card[f"{m}_opt"], cpu[f"{m}_opt"]))
        out[" ".join(extra)] = {**errs, "s": wall, "launches": d}
        print(f"cli nir {' '.join(extra)}: wall {wall:.3f} s, K1 launches {d}; f32 card vs "
              f"f64 CPU {json.dumps(errs)}")
        check(d == 10, f"cli nir {extra}: {d} K1 launches, expected 10")
        coef_rtol = SIMPLS_NIR_COEF_RTOL if extra[-1] == "simpls" else COEF_RTOL
        check(errs["coef_rel"] <= coef_rtol and errs["ev_abs"] <= EV_ATOL,
              f"cli nir {extra}: {errs}")
        for m in ("loo", "lso"):
            check(errs[f"{m}_rmse_rel"] <= RMSE_RTOL and errs[f"{m}_opt_equal"],
                  f"cli nir {extra}: {m} {errs}")

    # the bootstrap on nir: float32 on the card against float64 on the CPU
    Xn, Yn = nir_zscored()
    Xg, Yg = Xn.float().to(dev), Yn.float().to(dev)
    (lo, up, Bs), wall = event_wall(lambda: bootstrap_coefficient_intervals(
        Xg, Yg, BOOT_A, BOOT_REPS, seed, x64=False))
    lo64, up64, _ = bootstrap_coefficient_intervals(Xn, Yn, BOOT_A, BOOT_REPS, seed, x64=False)
    e = max(rel_err(lo.cpu(), lo64), rel_err(up.cpu(), up64))
    out["bootstrap_s"], out["bootstrap_rel"] = wall, e
    print(f"bootstrap nir A={BOOT_A} {BOOT_REPS} replicates: wall {wall:.3f} s (CUDA events); "
          f"intervals vs f64 on the CPU rel {e:.3e} (bound {BOOT_RTOL})")
    check(tuple(Bs.shape) == (BOOT_REPS, 401, 1) and bool(torch.isfinite(Bs).all())
          and bool((lo <= up).all()), "bootstrap: shapes / non-finite / lower > upper")
    check(e <= BOOT_RTOL, f"bootstrap: {e:.2e} > {BOOT_RTOL}")
    return out


def table_dist(a: np.ndarray, b: np.ndarray, state: bool) -> float:
    """max |a − b| / max |b|, state columns sign-aligned."""
    if state:
        s = np.sign(np.sum(a * b, axis=0))
        s[s == 0] = 1
        a = a * s
    return float(np.abs(a - b).max() / np.abs(b).max())


def np_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_bf16_cli(deflate) -> dict:
    """Phase 9, part 1: `--dtype bfloat16` on toy and nir on the card, held
    to the port's bf16 run on the CPU and to the f64 goldens."""
    out = {}
    for name, xf, yf, A in [("toy", "toyX.csv", "toyY.csv", 2),
                            ("nir", "nir.csv", "octane.csv", 10)]:
        argv = [str(DATA / xf), str(DATA / yf), str(A), "--dtype", "bfloat16"]
        before = dict(deflate.launches)
        card, wall = event_wall(lambda: parse_report(run_cli(argv)))
        d16 = deflate.launches["deflate_bf16"] - before["deflate_bf16"]
        d32 = deflate.launches["deflate_f32"] - before["deflate_f32"]
        cpu = parse_report(run_cli(argv + ["--device", "cpu"]))
        f64 = parse_report((GOLDEN / f"{name}_cli_stderr.txt").read_text())
        errs, bad = {}, []
        for table in ("W", "P", "Q", "R", "coefficients", "ev", "loo_rmse", "lso_rmse"):
            state = table in ("W", "P", "Q", "R", "coefficients")
            bound = BF16_D_JAX[(name, table)]
            e_cpu = table_dist(card[table], cpu[table], state)
            e_f64 = table_dist(card[table], f64[table], state)
            errs[table] = {"vs_cpu_bf16": round(e_cpu, 6), "vs_f64": round(e_f64, 6),
                           "d_jax": bound}
            if not (e_cpu <= min(bound, BF16_SAME_ARITH_RTOL) and e_f64 <= 2 * bound):
                bad.append(table)
        opt = {m: [card[m].tolist(), cpu[m].tolist()] for m in ("loo_opt", "lso_opt")}
        out[name] = {"s": wall, "launches_bf16": d16, "errors": errs, "optimal_card_cpu": opt}
        print(f"bf16 cli {name} A={A}: wall {wall:.3f} s, K2 launches {d16} (K1 {d32}); "
              f"card vs the port's CPU bf16 run (bound {BF16_SAME_ARITH_RTOL}, within d_jax) "
              f"and vs f64 (bound 2·d_jax): {json.dumps(errs)}; optimal components (card, cpu) "
              f"{opt}")
        check(not bad, f"bf16 cli {name}: {bad} outside their bounds")
        check(all(a == b for a, b in opt.values()), f"bf16 cli {name}: optimal components {opt}")
        check(d16 == A and d32 == 0, f"bf16 cli {name}: {d16} K2 launches, expected {A}")
    return out


def grid_reference(X, Y, splits, A) -> np.ndarray:
    """(F, A) fold RMSE of `grid_search_cv`, from one un-batched fit per
    fold on its training rows alone (K1 on the card), each fold z-scored
    by a ZScorer of those rows: no code of tune.py."""
    from pls_tpu_torch.models.kernel_pls import fit
    from pls_tpu_torch.models.predict import residuals_all_components
    from pls_tpu_torch.preprocess import ZScorer

    rmse = []
    for train, test in splits:
        tr, te = (torch.as_tensor(i, device=X.device) for i in (train, test))
        sx, sy = ZScorer.fit(X[tr]), ZScorer.fit(Y[tr])
        f = fit(sx.transform(X[tr]), sy.transform(Y[tr]), A)
        err = residuals_all_components(f, sx.transform(X[te]), sy.transform(Y[te])) * sy.stdev
        rmse.append(torch.sqrt((err * err).mean((0, 2))).cpu().numpy())
    return np.stack(rmse)


def phase_estimators(deflate, dev, seed: int) -> dict:
    """Phase 9, parts 2-3: the estimators at 100000×5000×10, A = 20, and the
    families whose cost grows past the width.  Returns walls and errors."""
    import pls_tpu_torch as tt
    from pls_tpu_torch.models import crossdecomp
    from pls_tpu_torch.tune import kfold_split

    out: dict = {}
    laps, t_last = {}, [time.perf_counter()]

    def lap(name):  # host seconds of each part of the phase
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_last[0], 3)
        t_last[0] = now

    X, Y = make_big(dev, seed)
    X64, Y64 = X.double(), Y.double()
    Xn, Xn64 = X[:N_NEW], X64[:N_NEW]
    lap("data")

    def launched(fn):
        before = dict(deflate.launches)
        res, wall = event_wall(fn)
        return res, wall, {k: deflate.launches[k] - before[k] for k in before}

    # PLSRegressor: fit, predict, score, in float32 (K1), bf16 storage (K2), float64
    est, wall, d = launched(lambda: tt.PLSRegressor(EST_A).fit(X, Y))
    check(d == k12_counts(EST_A, 0), f"PLSRegressor.fit launches {d}")
    (pred, score), wall_p = event_wall(lambda: (est.predict(X), est.score(X, Y)))
    est64, wall64 = event_wall(lambda: tt.PLSRegressor(EST_A).fit(X64, Y64))
    pred64 = est64.predict(X)
    e_pred, e_coef = np_rel(pred, pred64), np_rel(est.coef_, est64.coef_)
    score64 = est64.score(X64, Y64)
    out["PLSRegressor"] = {"fit_s": wall, "predict_score_s": wall_p, "f64_fit_s": wall64,
                           "pred_rel": e_pred, "coef_rel": e_coef, "score": score,
                           "score_f64": score64, "launches": d}
    print(f"PLSRegressor({EST_A}) 100k×5k×10 f32: fit {wall:.4f} s, predict+score "
          f"{wall_p:.4f} s, launches {d}; vs f64 (fit {wall64:.4f} s): pred rel {e_pred:.3e}, "
          f"coef_ rel {e_coef:.3e} (bound {EST_RTOL}); R² {score:.6f} (f64 {score64:.6f})")
    check(pred.shape == (BIG[0], 10) and pred.dtype == np.float32 and np.isfinite(pred).all(),
          "PLSRegressor.predict: shape / dtype / non-finite")
    check(max(e_pred, e_coef) <= EST_RTOL and abs(score - score64) <= EST_RTOL,
          "PLSRegressor f32 disagrees with f64")
    est16, wall16, d16 = launched(lambda: tt.PLSRegressor(EST_A, x_storage="bf16").fit(X, Y))
    e16 = np_rel(est16.coef_, est.coef_)
    out["PLSRegressor_bf16"] = {"fit_s": wall16, "coef_rel_f32": e16, "launches": d16}
    print(f"PLSRegressor({EST_A}, x_storage='bf16'): fit {wall16:.4f} s, launches {d16}; "
          f"coef_ vs f32 rel {e16:.3e} (bound {BF16_COEF_RTOL})")
    check(d16 == k12_counts(0, EST_A), f"bf16 fit launches {d16}")
    check(e16 <= BF16_COEF_RTOL, "PLSRegressor bf16 outside its budget")

    lap("PLSRegressor")

    # the T²/SPE monitor
    # the first build imports scipy.stats for the limits; the second is warm
    _, wall_m_cold = event_wall(lambda: est.build_monitor(X))
    mon, wall_m = event_wall(lambda: est.build_monitor(X))
    mon64 = est64.build_monitor(X64)
    c, wall_c = event_wall(lambda: est.check(X[:4 * N_NEW] * 1.5))
    c64 = est64.check(X64[:4 * N_NEW] * 1.5)
    e_t2, e_spe = np_rel(c["t2"], c64["t2"]), np_rel(c["spe"], c64["spe"])
    e_lim = max(abs(float(mon.t2_lim) / float(mon64.t2_lim) - 1),
                abs(float(mon.spe_lim) / float(mon64.spe_lim) - 1))
    # a flag may differ only where its statistic lies within EST_RTOL of the limit
    near = (np.abs(c64["t2"] / float(mon64.t2_lim) - 1) <= EST_RTOL) | (
        np.abs(c64["spe"] / float(mon64.spe_lim) - 1) <= EST_RTOL)
    flips = int(((c["ok"] != c64["ok"]) & ~near).sum())
    out["monitor"] = {"build_s": wall_m, "first_build_s": wall_m_cold, "check_s": wall_c,
                      "t2_rel": e_t2, "spe_rel": e_spe,
                      "limits_rel": e_lim, "flagged": int((~c["ok"]).sum()), "flips": flips}
    print(f"build_monitor 100k×5k: {wall_m:.4f} s warm ({wall_m_cold:.4f} s first, with the "
          f"scipy.stats import); check {4 * N_NEW} rows {wall_c:.4f} s; vs "
          f"f64: t2 rel {e_t2:.3e}, spe rel {e_spe:.3e}, limits rel {e_lim:.3e}; "
          f"{out['monitor']['flagged']} flagged, {flips} flags differ away from a limit")
    check(max(e_t2, e_spe, e_lim) <= EST_RTOL and flips == 0, "monitor disagrees with f64")

    lap("monitor")

    # PLSB export into build/, and back
    path = ROOT / "build" / "phase9_model.plsb"
    path.parent.mkdir(parents=True, exist_ok=True)
    _, wall_x = event_wall(lambda: est.export_c(str(path)))
    blob = tt.load_model_c(str(path))
    est64.export_c(str(path))
    blob64 = tt.load_model_c(str(path))
    path.unlink()
    e_b = np_rel(blob["B_raw"], est.coef_.T)
    # R and P columns carry an eigenvector's free sign (M = 10): aligned
    e_x = max(table_dist(blob[k], blob64[k], k in ("R_raw", "P_mon"))
              for k in ("B_raw", "R_raw", "P_mon", "s2"))
    raw = (Xn.cpu().numpy() - blob["x_mean"]) @ blob["B_raw"] + blob["b0"]
    e_raw = np_rel(raw, pred[:N_NEW])
    out["export"] = {"s": wall_x, "B_vs_coef_rel": e_b, "vs_f64_rel": e_x, "predict_rel": e_raw}
    print(f"export_c/load_model_c: {wall_x:.4f} s, {blob['K']}×{blob['M']}×{blob['A']}; B_raw vs "
          f"coef_ rel {e_b:.3e}; vs the f64 model's file rel {e_x:.3e}; raw-unit prediction from "
          f"the file vs predict rel {e_raw:.3e}")
    check(e_b <= 1e-6 and e_x <= EST_RTOL and e_raw <= 1e-5 and blob["t2_lim"] > 0,
          "export disagrees")

    lap("export")

    # prediction intervals: CV+ (10 folds, one un-batched fit each) and split
    for kind in ("cv+", "split"):
        (lo, hi, p), wall_i, di = launched(
            lambda: est.predict_interval(X, Y, Xn, kind=kind, n_folds=10))
        lo64, hi64, _ = est64.predict_interval(X64, Y64, Xn64, kind=kind, n_folds=10)
        e_i = max(np_rel(lo, lo64), np_rel(hi, hi64))
        cover = float(((Y[:N_NEW].cpu().numpy() >= lo) & (Y[:N_NEW].cpu().numpy() <= hi)).mean())
        out[f"interval_{kind}"] = {"s": wall_i, "rel": e_i, "launches": di, "train_cover": cover}
        print(f"predict_interval {kind}: {wall_i:.4f} s, launches {di}; vs f64 rel {e_i:.3e} "
              f"(bound {EST_RTOL}); width {float(np.mean(hi - lo)):.4f}; covers {cover:.3f} of "
              f"{N_NEW} training rows")
        expect = EST_A * (11 if kind == "cv+" else 1)
        check(di["deflate_f32"] == expect, f"{kind}: {di} launches, expected {expect} K1")
        check(e_i <= EST_RTOL and bool((hi >= lo).all()), f"{kind} intervals disagree")

    lap("predict_interval")

    # the IRLS families: RobustPLSRegressor (10 reweightings), PLSGLMClassifier
    rob, wall_r, dr = launched(lambda: tt.RobustPLSRegressor(EST_A).fit(X, Y))
    rob64, wall_r64 = event_wall(lambda: tt.RobustPLSRegressor(EST_A).fit(X64, Y64))
    e_r = np_rel(rob.coef_, rob64.coef_)
    e_w = float(np.abs(rob.sample_weight_ - rob64.sample_weight_).max())
    lap("RobustPLSRegressor")
    out["RobustPLSRegressor"] = {"fit_s": wall_r, "f64_fit_s": wall_r64, "coef_rel": e_r,
                                 "weights_abs": e_w, "launches": dr}
    print(f"RobustPLSRegressor({EST_A}) f32: fit {wall_r:.4f} s, launches {dr}; vs f64 (fit "
          f"{wall_r64:.4f} s): coef_ rel {e_r:.3e}, weights abs {e_w:.3e} (bound {IRLS_RTOL})")
    check(dr["deflate_f32"] == EST_A * 11, f"robust launches {dr}")
    check(e_r <= IRLS_RTOL and e_w <= IRLS_RTOL, "robust f32 disagrees with f64")
    g = torch.Generator(dev).manual_seed(seed + 9)
    y01 = ((Y[:, 0] + torch.randn(BIG[0], generator=g, device=dev)) > 0).to(torch.int64)
    glm, wall_g, dg = launched(lambda: tt.PLSGLMClassifier(EST_A, n_irls=10).fit(X, y01))
    glm64, wall_g64 = event_wall(lambda: tt.PLSGLMClassifier(EST_A, n_irls=10).fit(X64, y01))
    p_g, p_g64 = glm.predict_proba(X), glm64.predict_proba(X64)
    e_g = float(np.abs(p_g - p_g64).max())
    acc = glm.score(X, y01)
    out["PLSGLMClassifier"] = {"fit_s": wall_g, "f64_fit_s": wall_g64, "proba_abs": e_g,
                               "accuracy": acc, "launches": dg}
    print(f"PLSGLMClassifier({EST_A}, n_irls=10) f32: fit {wall_g:.4f} s, launches {dg}; vs f64 "
          f"(fit {wall_g64:.4f} s): proba abs {e_g:.3e} (bound {IRLS_RTOL}); accuracy {acc:.4f}")
    check(dg["deflate_f32"] == EST_A * 10, f"plsglm launches {dg}")
    check(e_g <= IRLS_RTOL, "plsglm f32 disagrees with f64")
    del est64, rob64, glm64, X64, Y64
    torch.cuda.empty_cache()
    lap("PLSGLMClassifier")

    # grid search: at this size a fold's z-scored copy of X is past the
    # fold-batch budget, so each fold is an un-batched fit (K1); at GRID_SMALL
    # the five folds are one batched fit
    for (n, k) in (BIG, GRID_SMALL):
        Xg, Yg = (X, Y) if n == BIG[0] else (X[:n, :k].contiguous(), Y[:n])
        torch.cuda.reset_peak_memory_stats(dev)
        before = deflate.launches["deflate_f32"]
        (best, results), wall_gs = event_wall(lambda: tt.grid_search_cv(
            lambda: tt.PLSRegressor(), {"n_components": list(range(1, EST_A + 1))}, Xg, Yg,
            n_folds=GRID_FOLDS, key=seed))
        d_gs = deflate.launches["deflate_f32"] - before
        peak = torch.cuda.max_memory_allocated(dev)
        ref, wall_ref = event_wall(lambda: grid_reference(
            Xg, Yg, kfold_split(n, GRID_FOLDS, seed), EST_A))
        mine = np.stack([r.fold_rmse for r in results], 1)  # (F, A)
        e_gs = np_rel(mine, ref)
        key = f"grid_search_cv_{n}x{k}"
        out[key] = {"s": wall_gs, "reference_s": wall_ref, "rel": e_gs, "best": best.params,
                    "peak_bytes": peak, "launches": d_gs}
        print(f"grid_search_cv {n}×{k}×10, n_components 1..{EST_A}, {GRID_FOLDS} folds: "
              f"{wall_gs:.4f} s, {d_gs} K1 launches, peak device memory {peak / 2**30:.2f} GiB, "
              f"best {best.params} (rmse {best.rmse:.5f}); vs un-batched f32 fits on each "
              f"fold's own scaled rows ({wall_ref:.4f} s) rel {e_gs:.3e} (bound {GRID_RTOL})")
        expect = GRID_FOLDS * EST_A if n == BIG[0] else 0
        check(d_gs == expect and e_gs <= GRID_RTOL, f"grid search {n}×{k} disagrees")
        del Xg, Yg

    lap("grid_search_cv")

    # the families whose cost grows past the width
    for name, (n, a) in FAMILIES.items():
        cls = getattr(tt, name)
        kw = {"keep_x": 500} if name == "SPLSRegressor" else {}
        if name == "OPLSRegressor":
            kw = {"n_ortho": 2}
        if name == "CCA":
            # two latent directions of distinct strength in X: X's singular
            # values stay within the float32 pseudo-inverse's cutoff (10·N·eps
            # of the largest, which the float64 run does not have), and the
            # two canonical correlations stand apart from each other and from
            # the ones K/N = 0.5 fits to noise, so the power iteration
            # converges in tens of steps instead of hundreds
            g = torch.Generator(dev).manual_seed(seed + 1)
            lat = torch.randn((n, 2), generator=g, device=dev)
            Xf = (lat * torch.tensor([0.2, 0.06], device=dev)) @ torch.randn(
                (2, BIG[1]), generator=g, device=dev) + torch.randn((n, BIG[1]), generator=g,
                                                                    device=dev)
            Yf = lat @ torch.randn((2, 10), generator=g, device=dev) + 0.3 * torch.randn(
                (n, 10), generator=g, device=dev)
        else:
            Xf, Yf = X[:n], Y[:n]
        crossdecomp.counts["host_reads"] = 0
        before = dict(deflate.launches)
        e32, wall_f = event_wall(lambda: cls(n_components=a, **kw).fit(Xf, Yf))
        dl = {k: deflate.launches[k] - before[k] for k in before}
        reads = crossdecomp.counts["host_reads"]
        e64, wall_f64 = event_wall(lambda: cls(n_components=a, **kw).fit(Xf.double(), Yf.double()))
        if name == "PLSSVD":
            got, want = e32.transform(Xf[:N_NEW]), e64.transform(Xf[:N_NEW].double())
        else:
            got, want = e32.predict(Xf[:N_NEW]), e64.predict(Xf[:N_NEW].double())
        e = np_rel(got, want)
        out[name] = {"N": n, "A": a, "fit_s": wall_f, "f64_fit_s": wall_f64, "rel": e,
                     "launches": dl, "host_reads": reads}
        print(f"{name}({a}) {n}×{BIG[1]}×10 f32: fit {wall_f:.4f} s, launches {dl}, power-"
              f"iteration host reads {reads}; vs f64 (fit {wall_f64:.4f} s): "
              f"{'transform' if name == 'PLSSVD' else 'predict'} rel {e:.3e} (bound {FAMILY_RTOL})")
        check(np.isfinite(got).all() and e <= FAMILY_RTOL, f"{name} disagrees with f64")
        if name == "OPLSRegressor":
            check(dl["deflate_f32"] == a, f"OPLS launches {dl}")
        del e32, e64, Xf, Yf
        torch.cuda.empty_cache()
        lap(name)
    del X, Y
    torch.cuda.empty_cache()
    out["part_s"] = laps
    print(f"phase 9 parts, s: {json.dumps(laps)}")
    return out


def coef_rel(f, ref) -> float:
    from pls_tpu_torch.models.predict import coefficients

    return rel_err(coefficients(f), coefficients(ref))


def run_call(deflate, fn):
    """(fn(), its CUDA-event wall, its launches by path), printed later."""
    before = dict(deflate.path_calls)
    res, wall = event_wall(fn)
    return res, wall, {k: v - before[k] for k, v in deflate.path_calls.items() if v != before[k]}


def par_check(lines: list, name: str, wall: float, paths: dict, err: float, tol: float,
              extra: str = "") -> dict:
    lines.append(f"  {name}: wall {wall:.4f} s, launches by path {paths}, rel err {err:.3e} "
                 f"(bound {tol:g}){extra}")
    check(err <= tol, f"phase 10 {name}: rel err {err:.2e} > {tol}")
    return {"s": wall, "launches_by_path": paths, "rel_err": err}


def phase_parallel(deflate, dev, seed: int, fit_walls: dict) -> tuple[dict, dict]:
    """Phase 10: the parallel slice.  NCCL at world size 1 on this card, each
    call held to the same work on one device; then two gloo ranks sharing
    the card (`phase_parallel_rank`).  Returns (its walls and errors, the K1/K2
    launches of its sharded calls, both runs)."""
    import torch.distributed as dist

    from pls_tpu_torch.cv.loo import cv_loo
    from pls_tpu_torch.cv.lso import cv_lso, random_partitions
    from pls_tpu_torch.models.kernel_pls import fit
    from pls_tpu_torch.parallel import (cv_lso_rowsharded, cv_lso_sharded, cv_loo_sharded,
                                        fit_colsharded, fit_rowsharded_shardmap, fit_sharded,
                                        initialize_distributed, make_pls_mesh, train_step)
    from pls_tpu_torch.parallel.launch import spawn_ranks
    from pls_tpu_torch.types import KERNEL_TYPE2

    out, lines = {}, []
    X, Y = make_big(dev, seed)
    n, k = PAR_CV
    Xc, Yc = X[:n, :k].contiguous(), Y[:n].contiguous()
    Xo, Yo = Xc[:PAR_LOO_N], Yc[:PAR_LOO_N]
    parts = random_partitions(torch.Generator(dev).manual_seed(seed + 4), n, PAR_TRIALS)
    train = 3 * n // 4
    # the same work on one device, before the counts start
    ref = {"f32": fit(X, Y, PAR_A), "bf16": fit(X, Y, PAR_A, x_storage="bf16"),
           "type2": fit(X, Y, PAR_A, KERNEL_TYPE2), "cv": fit(Xc, Yc, PAR_CV_A)}
    lso_ref = cv_lso(Xc, Yc, PAR_CV_A, (n - train) / n, PAR_TRIALS, partitions=parts).errors
    loo_ref = cv_loo(Xo, Yo, PAR_CV_A).errors
    press_ref = (lso_ref * lso_ref).sum(1)  # (M, A)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0, device=dev, timeout_sec=PAR_TIMEOUT)
        try:
            check(dist.get_backend() == "nccl", f"world size 1 runs {dist.get_backend()}")
            mesh = make_pls_mesh(rows=1, folds=1)
            check(mesh.device == dev, f"mesh device {mesh.device}")
            # NCCL sets its communicator up on the first collective
            out["nccl_setup_s"] = synced_wall(lambda: mesh.psum(torch.ones(1, device=dev),
                                                                "rows"))[1]
            for counts in (deflate.launches, deflate.path_calls):  # phase 10's run starts here
                for c in counts:
                    counts[c] = 0
            calls = [
                ("fit_sharded f32", lambda: fit_sharded(X, Y, PAR_A, mesh=mesh), ref["f32"]),
                ("fit_sharded bf16", lambda: fit_sharded(X, Y, PAR_A, mesh=mesh,
                                                         x_storage="bf16"), ref["bf16"]),
                ("fit_rowsharded_shardmap type1 use_kernel",
                 lambda: fit_rowsharded_shardmap(X, Y, PAR_A, mesh=mesh, use_kernel=True),
                 ref["f32"]),
                ("fit_rowsharded_shardmap type2",
                 lambda: fit_rowsharded_shardmap(X, Y, PAR_A, False, mesh=mesh), ref["type2"]),
                ("fit_colsharded", lambda: fit_colsharded(X, Y, PAR_A, mesh=mesh), ref["f32"]),
            ]
            for name, fn, r in calls:
                f, wall, paths = run_call(deflate, fn)
                diff = max(float((getattr(f, a) - getattr(r, a)).abs().max()) for a in "WPQR")
                extra = f"; state max |diff| {diff:.3e}"
                if "shardmap type1" in name:
                    check(tuple(f.T.shape) == (BIG[0], PAR_A), f"{name}: T {tuple(f.T.shape)}")
                    extra += f", T gathered rel err {rel_err(f.T, r.T):.3e}"
                    check(rel_err(f.T, r.T) <= PAR_RTOL, f"{name}: T off")
                elif name.startswith("fit_sharded"):
                    check(tuple(f.T.shape) == (0, PAR_A), f"{name}: T {tuple(f.T.shape)}")
                out[name] = par_check(lines, name, wall, paths, coef_rel(f, r), PAR_RTOL, extra)
                out[name]["state_max_abs_diff"] = diff
            cv_calls = [
                ("cv_lso_sharded", lambda: cv_lso_sharded(Xc, Yc, PAR_CV_A, parts, train,
                                                          mesh=mesh).errors, lso_ref),
                ("cv_lso_rowsharded trial_batch=2",
                 lambda: cv_lso_rowsharded(Xc, Yc, PAR_CV_A, parts, train, mesh=mesh,
                                           trial_batch=2).errors, lso_ref),
                ("cv_loo_sharded", lambda: cv_loo_sharded(Xo, Yo, PAR_CV_A, mesh=mesh).errors,
                 loo_ref),
            ]
            for name, fn, r in cv_calls:
                e, wall, paths = run_call(deflate, fn)
                check(e.shape == r.shape, f"{name}: errors {tuple(e.shape)}")
                out[name] = par_check(lines, name, wall, paths, rel_err(e, r), PAR_CV_RTOL)
            (f, press), wall, paths = run_call(
                deflate, lambda: train_step(Xc, Yc, PAR_CV_A, parts, train, mesh=mesh))
            check(tuple(press.shape) == tuple(press_ref.shape) and bool(torch.isfinite(press).all()),
                  "train_step: press shape / non-finite")
            out["train_step"] = par_check(
                lines, "train_step", wall, paths, coef_rel(f, ref["cv"]), PAR_RTOL,
                f"; press rel err {rel_err(press, press_ref):.3e}")
            check(rel_err(press, press_ref) <= PAR_CV_RTOL, "train_step: press off")
            launches = dict(deflate.launches)  # ... and ends here (the two ranks' come below)
            expect = k12_counts(2 * PAR_A + PAR_CV_A, PAR_A)
            check(launches == expect, f"phase 10 world size 1: launches {launches}, not {expect}")
            # the cost of the collective path: the one-device and the sharded
            # fit in pairs, alternating which goes first
            walls = {"fit": [], "fit_sharded": []}
            fns = {"fit": lambda: fit(X, Y, PAR_A),
                   "fit_sharded": lambda: fit_sharded(X, Y, PAR_A, mesh=mesh)}
            for i in range(PAR_PAIRS):
                for key in (("fit", "fit_sharded") if i % 2 == 0 else ("fit_sharded", "fit")):
                    walls[key].append(event_wall(fns[key])[1])
            out["fit_walls"] = {key: statistics.median(w) for key, w in walls.items()}
            out["fit_walls_range"] = {key: (min(w), max(w)) for key, w in walls.items()}
        finally:
            dist.destroy_process_group()
    print(f"phase 10, NCCL at world size 1 on {torch.cuda.get_device_name(0)} (first "
          f"all-reduce, the communicator's set-up: {out['nccl_setup_s']:.3f} s):")
    for ln in lines:
        print(ln)
    w, rng = out["fit_walls"], out["fit_walls_range"]
    print(f"  100k×5k×10 A={PAR_A} f32 fit wall, warm, median of {PAR_PAIRS} pairs: fit_sharded "
          f"{w['fit_sharded']:.4f} s ({rng['fit_sharded'][0]:.4f}-{rng['fit_sharded'][1]:.4f}) "
          f"against one-device fit {w['fit']:.4f} s ({rng['fit'][0]:.4f}-{rng['fit'][1]:.4f}); "
          f"phase 4's PLSModel fit {fit_walls['f32']:.4f} s: {w['fit_sharded'] - w['fit']:+.4f} s "
          f"for {PAR_A} all-reduces of {BIG[1] + 1} floats and one of XᵀY")
    del X, Y, Xc, Yc, Xo, Yo, ref, lso_ref, loo_ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    outs = spawn_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed)], 2,
                       timeout_sec=PAR_TIMEOUT, cwd=ROOT)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    out["gloo_2_ranks"] = {"s": time.perf_counter() - t0, **ranks[0]}
    print(f"phase 10, two gloo ranks sharing the card ({time.perf_counter() - t0:.1f} s with "
          f"start-up):")
    for r, res in enumerate(ranks):
        print(f"  rank {r}: launches {res['launches']}, by path {res['path_calls']}")
        check(res["launches"] == k12_counts(3 * PAR_A, 0),
              f"rank {r}: launches {res['launches']}, expected {3 * PAR_A} K1")
        check(res["path_calls"]["staged"] == 3 * PAR_A, f"rank {r}: K1 left the staged path")
    for name, res in ranks[0]["calls"].items():
        par_check([], name, res["s"], {}, res["rel_err"], PAR_RTOL)
        print(f"  {name}: wall {res['s']:.4f} s warm ({res['first_s']:.4f} s first), rel err "
              f"{res['rel_err']:.3e} against the one-device fit (bound {PAR_RTOL:g})"
              f"{res.get('extra', '')}")
    for c in launches:
        launches[c] += sum(res["launches"][c] for res in ranks)
    return out, launches


def phase_parallel_rank(args) -> int:
    """One of phase 10's two gloo ranks on the one card: fit_sharded,
    fit_rowsharded_shardmap(use_kernel=True) and train_step at BIG, A =
    PAR_A, on this rank's half of the rows (K1 on 50 000 rows); rank 0
    holds them to the one-device fit and press.  Prints one JSON line."""
    from datetime import timedelta

    import torch.distributed as dist

    from pls_tpu_torch.cv.lso import lso_errors, random_partitions
    from pls_tpu_torch.models.kernel_pls import fit
    from pls_tpu_torch.ops import deflate
    from pls_tpu_torch.parallel import (fit_rowsharded_shardmap, fit_sharded, make_pls_mesh,
                                        train_step)
    from pls_tpu_torch.parallel.sharded import shard_rows

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=args.init_method, world_size=args.world_size,
                            rank=args.rank, timeout=timedelta(seconds=PAR_TIMEOUT))
    try:
        mesh = make_pls_mesh(rows=args.world_size, folds=1, device=dev)
        X, Y = make_big(dev, args.seed)
        N = BIG[0]
        parts = random_partitions(torch.Generator(dev).manual_seed(args.seed + 5), N,
                                  PAR_STEP_TRIALS)
        train = 3 * N // 4
        Xl, Yl = shard_rows(X, mesh), shard_rows(Y, mesh)
        for counts in (deflate.launches, deflate.path_calls):
            for c in counts:
                counts[c] = 0
        calls = {
            "fit_sharded": lambda: fit_sharded(Xl, Yl, PAR_A, mesh=mesh),
            "fit_rowsharded_shardmap use_kernel": lambda: fit_rowsharded_shardmap(
                Xl, Yl, PAR_A, mesh=mesh, use_kernel=True),
            "train_step": lambda: train_step(Xl, Yl, PAR_A, parts, train, mesh=mesh),
        }
        res = {name: event_wall(fn) for name, fn in calls.items()}
        result = {"launches": dict(deflate.launches), "path_calls": dict(deflate.path_calls)}
        # timed again, warm, after the counts are read
        warm = {name: event_wall(fn)[1] for name, fn in calls.items()}
        if args.rank == 0:
            ref = fit(X, Y, PAR_A)
            f_step, press = res["train_step"][0]
            errs = lso_errors(X, Y, PAR_A, parts, train)
            press_ref = (errs * errs).sum(1)
            T = res["fit_rowsharded_shardmap use_kernel"][0].T
            result["calls"] = {
                name: {"s": warm[name], "first_s": wall,
                       "rel_err": coef_rel(f_step if name == "train_step" else f, ref)}
                for name, (f, wall) in res.items()}
            result["calls"]["fit_rowsharded_shardmap use_kernel"]["extra"] = (
                f"; T {tuple(T.shape)} gathered, rel err {rel_err(T, ref.T):.3e}")
            result["calls"]["train_step"]["extra"] = (
                f"; press rel err {rel_err(press, press_ref):.3e}")
            check(tuple(T.shape) == (N, PAR_A) and rel_err(T, ref.T) <= PAR_RTOL,
                  "two ranks: T gathered off")
            check(rel_err(press, press_ref) <= PAR_CV_RTOL, "two ranks: press off")
    finally:
        dist.destroy_process_group()
    print(json.dumps(result))
    return 0


def rel_any(a, b, align: bool = False) -> float:
    """max |a − b| / max |b| in float64 over tensors or arrays, columns
    sign-aligned with `align` (a free eigenvector or singular-vector sign)."""
    a = a.double().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = b.double().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    return table_dist(a, b, align)


def maxmin_sequence(Zs, picks) -> np.ndarray:
    """Each pick's joint distance to the nearest earlier pick (the seed
    pair's own distance first), in float64: the sequence max-min selection
    maximises, over blocks Zs of float64 coordinates and their scales."""
    idx = torch.as_tensor(np.asarray(picks), device=Zs[0][0].device)
    D = sum(torch.cdist(Z[idx], Z[idx]) / s for Z, s in Zs)
    D = D + torch.triu(torch.full_like(D, torch.inf))
    seq = D.min(1).values[1:]
    return seq.cpu().numpy()


def sem_data(dev, seed: int, N: int, per_block: int, L: int) -> torch.Tensor:
    """A structural-equation model's manifests, z-scored: latent ξ₀ ~ N(0, 1),
    ξᵢ = 0.5 ξᵢ₋₁ + 0.3 ξ₀ + 0.8 ε, each measured by `per_block` columns
    λ ξ_b + ε (λ uniform on [0.3, 0.9]), made on the card from the seed."""
    from pls_tpu_torch.ops.stats import colwise_z_scores

    g = torch.Generator(dev).manual_seed(seed + 14)
    xi = [torch.randn(N, generator=g, device=dev)]
    for _ in range(1, L):
        xi.append(0.5 * xi[-1] + 0.3 * xi[0] + 0.8 * torch.randn(N, generator=g, device=dev))
    lam = 0.3 + 0.6 * torch.rand((L, per_block), generator=g, device=dev)
    return colwise_z_scores(torch.cat([
        xi[b][:, None] * lam[b] + torch.randn((N, per_block), generator=g, device=dev)
        for b in range(L)], 1))


def o2pls_data(dev, seed: int, N: int, K: int, M: int):
    """Two z-scored blocks of the model O2PLS fits, made on the card: five
    joint latent directions (strengths 3 to 1.4), two specific to X (4,
    3.4) and two to Y (2, 1.6), noise 0.5."""
    from pls_tpu_torch.ops.stats import colwise_z_scores

    g = torch.Generator(dev).manual_seed(seed + 12)
    lat = torch.randn((N, 9), generator=g, device=dev) * torch.tensor(
        [3.0, 2.6, 2.2, 1.8, 1.4, 4.0, 3.4, 2.0, 1.6], device=dev)
    X = lat[:, :7] @ torch.randn((7, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    Y = torch.cat([lat[:, :5], lat[:, 7:]], 1) @ torch.randn((7, M), generator=g, device=dev)
    Y += 0.5 * torch.randn((N, M), generator=g, device=dev)
    return colwise_z_scores(X), colwise_z_scores(Y)


def phase_api(deflate, dev, seed: int) -> dict:
    """Phase 11: the rest of the public API at 100000×5000×10 (make_big).
    One line a call: the float32 call's CUDA-event wall and K1 launches, the
    same call's in float64, the error.  Returns walls and errors."""
    import pls_tpu_torch as tt
    from pls_tpu_torch import sampling
    from pls_tpu_torch.models import missing, oplsda
    from pls_tpu_torch.models.predict import coefficients, explained_variance
    from pls_tpu_torch.ops.stats import colwise_z_scores
    from pls_tpu_torch.utils import jax_prng, profiling
    from pls_tpu_torch.utils.debug import fit_health

    out: dict = {}
    laps, t_last = {}, [time.perf_counter()]

    def lap(name):  # host seconds of each part of the phase
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_last[0], 3)
        t_last[0] = now

    X, Y = make_big(dev, seed)
    X64, Y64 = X.double(), Y.double()
    N, K = BIG
    lap("data")

    def run(name, f32, f64, err, tol, k1=None, note=None):
        """f32() and f64(), the same call on X and X64; err(r32, r64) held
        to tol; k1 the float32 call's K1 launches, where it is fixed."""
        before = deflate.launches["deflate_f32"]
        r32, w32 = event_wall(f32)
        d = deflate.launches["deflate_f32"] - before
        r64, w64 = event_wall(f64)
        e = err(r32, r64)
        extra = note(r32, r64) if note else ""
        out[name] = {"s": w32, "f64_s": w64, "k1": d, "rel_err": e}
        print(f"  {name}: f32 {w32:.4f} s, K1 {d}; f64 {w64:.4f} s; rel err {e:.3e} "
              f"(bound {tol:g}){extra}")
        check(e <= tol, f"phase 11 {name}: rel err {e:.2e} > {tol}")
        check(k1 is None or d == k1, f"phase 11 {name}: {d} K1 launches, expected {k1}")
        return r32, r64

    # multiblock: five blocks of 1000 columns, one K1 fit of their concatenation
    def mb(Z, W):
        blocks = [Z[:, b * 1000:(b + 1) * 1000] for b in range(5)]
        f = tt.fit_mbpls(blocks, W, API_A)
        new = [B[:N_NEW] for B in blocks]
        return f, (coefficients(f.pls), tt.block_importance(f), tt.super_scores(f, new),
                   tt.predict_mbpls(f, new))

    (mb32, _), _ = run(
        "fit_mbpls 5×1000 A=20 (block_importance, super_scores, predict_mbpls)",
        lambda: mb(X, Y), lambda: mb(X64, Y64),
        lambda a, b: max(rel_any(x, y, i == 2) for i, (x, y) in enumerate(zip(a[1], b[1]))),
        API_RTOL, k1=API_A)
    lap("mbpls")

    # OPLS-DA: two classes from the sign of Y[:, 0], two orthogonal components
    labels = (Y[:, 0] > 0).long()

    def oda(Z):
        f = tt.fit_oplsda(Z, labels, 2, 2)
        d = oplsda.decision_values(f, Z[:N_NEW])
        Xf, _ = tt.opls_correct(f, Z)
        cov, corr = tt.s_plot(Xf, Xf @ f.pls.R[:, 0])
        return f, d, oplsda.predict_classes(f, Z[:N_NEW]), torch.stack([cov, corr], 1)

    def oda_err(a, b):
        s = float(torch.sign((a[3][:, 0].double() * b[3][:, 0]).sum()))  # t's free sign
        return max(rel_any(a[1], b[1]), rel_any(s * a[3].double(), b[3]))

    def margin_classes(a, b):  # equal classes wherever the decision is not a near-tie
        clear = (b[1][:, 1] - b[1][:, 0]).abs() > API_RTOL * b[1].abs().max()
        diff = int(((a[2] != b[2]) & clear).sum())
        check(diff == 0, f"phase 11 fit_oplsda: {diff} classes differ")
        return f"; classes equal ({int(clear.sum())} of {N_NEW} clear of a tie)"

    (oda32, *_), _ = run("fit_oplsda n_ortho=2 A=1 (predict_classes, s_plot)",
                         lambda: oda(X), lambda: oda(X64), oda_err, API_RTOL, k1=1,
                         note=margin_classes)
    y_np = labels.cpu().numpy()

    def clf(Z):
        est = tt.OPLSDAClassifier(1, 2).fit(Z, y_np)
        return est, est.decision_function(Z[:N_NEW]), est.predict(Z[:N_NEW])

    run("OPLSDAClassifier(1, 2).fit/predict", lambda: clf(X), lambda: clf(X64),
        lambda a, b: rel_any(a[1], b[1]), API_RTOL, k1=1,
        note=lambda a, b: f"; predictions equal on {int((a[2] == b[2]).sum())} of {N_NEW}")
    lap("oplsda")

    # PLS-Cox: survival times from the latent response, about 30 % censored
    g = torch.Generator(dev).manual_seed(seed + 11)
    times = -torch.log(torch.rand(N, generator=g, device=dev, dtype=torch.float64)) * \
        torch.exp(-0.5 * Y64[:, 0])
    event = (torch.rand(N, generator=g, device=dev) > 0.3).double()

    def cox(Z):
        f = tt.fit_plscox(Z, times, event, 5)
        return f, tt.predict_plscox(f, Z[:N_NEW])

    (cox32, _), (cox64, _) = run(
        "fit_plscox A=5 (Newton 20 steps; predict_plscox)", lambda: cox(X), lambda: cox(X64),
        lambda a, b: max(rel_any(a[0].coef, b[0].coef), rel_any(a[1], b[1])), API_ITER_RTOL,
        k1=5)
    c = [tt.concordance_index(times[:COX_C_N], event[:COX_C_N],
                              tt.predict_plscox(f, Z[:COX_C_N])) for f, Z in
         ((cox32, X), (cox64, X64))]
    print(f"  concordance_index on {COX_C_N} rows: f32 {c[0]:.6f}, f64 {c[1]:.6f}; censored "
          f"{float(1 - event.mean()):.3f}")
    check(abs(c[0] - c[1]) <= API_ITER_RTOL, "phase 11 concordance_index disagrees")
    lap("plscox")

    # the permutation test: 21 un-batched fits, the permutations jax_prng's
    p32, _ = run(
        f"permutation_test A={API_A}, {N_PERM} permutations",
        lambda: tt.permutation_test(X, Y, API_A, N_PERM, seed),
        lambda: tt.permutation_test(X64, Y64, API_A, N_PERM, seed),
        lambda a, b: max(rel_any(torch.cat([a[0][None], a[1]]), torch.cat([b[0][None], b[1]])),
                         abs(float(a[2]) - float(b[2]))),
        API_RTOL, k1=(N_PERM + 1) * API_A,
        note=lambda a, b: f"; R² {float(a[0]):.5f}, null max {float(a[1].max()):.3e}, "
                          f"p {float(a[2]):.4f}")
    perm0 = torch.as_tensor(jax_prng.permutation(jax_prng.split(seed, N_PERM)[0], N),
                            device=dev)
    r2_0 = float(explained_variance(tt.fit(X, Y[perm0], API_A), X, Y[perm0]).mean())
    gaps = (p32[1].double() - r2_0).abs() / abs(r2_0)
    print(f"  permutation 0 = jax_prng.permutation(split({seed}, {N_PERM})[0], {N}): "
          f"a direct fit's R² {r2_0:.6e} vs the test's {float(p32[1][0]):.6e}, rel "
          f"{float(gaps[0]):.2e} (the other permutations' {float(gaps[1:].min()):.2e} or more)")
    check(float(gaps[0]) <= 1e-4 and float(gaps[0]) < float(gaps[1:].min()),
          "phase 11: the permutation test's draws are not jax_prng's")
    lap("permutation_test")

    # iPLS: 20 intervals and the full spectrum, 5 folds, un-batched K1 fits
    n_int, A_ipls, k_ipls = IPLS

    def ip_err(a, b):
        check(a.best_interval == b.best_interval and a.best_ncomp == b.best_ncomp,
              "phase 11 ipls: the best interval differs")
        return max(rel_any(a.rmsecv, b.rmsecv), rel_any(a.global_rmsecv, b.global_rmsecv))

    run(f"ipls {n_int} intervals A={A_ipls} k={k_ipls}",
        lambda: tt.ipls(X, Y, n_int, A_ipls, k_ipls, key=seed),
        lambda: tt.ipls(X64, Y64, n_int, A_ipls, k_ipls, key=seed), ip_err, API_RTOL,
        k1=(n_int + 1) * k_ipls * A_ipls,
        note=lambda a, b: f"; best interval {a.best_interval} at {a.best_ncomp} components")
    n = IPLS_FWD_N

    def fwd_err(a, b):
        check(a.selected == b.selected and a.ncomp == b.ncomp,
              f"phase 11 ipls_forward: picks {a.selected} vs {b.selected}")
        return rel_any(a.rmsecv_path, b.rmsecv_path)

    run(f"ipls_forward {n}×{K} max_intervals=3",
        lambda: tt.ipls_forward(X[:n], Y[:n], n_int, A_ipls, k_ipls, key=seed, max_intervals=3),
        lambda: tt.ipls_forward(X64[:n], Y64[:n], n_int, A_ipls, k_ipls, key=seed,
                                max_intervals=3),
        fwd_err, API_RTOL, note=lambda a, b: f"; selected {a.selected}, {a.ncomp} components")
    lap("ipls")

    # UVE: X with K noise columns (100000×10000), 10 folds, un-batched K1 fits.
    # float32 and float64 draw their own noise (32- and 64-bit draws): the
    # real variables' reliability is held; the cutoffs are two noise maxima
    def uve_note(a, b):
        lo, hi = sorted((a.cutoff, b.cutoff))
        clear = (b.reliability < lo * (1 - API_ITER_RTOL)) | (b.reliability > hi * (1 + API_ITER_RTOL))
        diff = int(((a.selected != b.selected) & clear).sum())
        check(diff == 0, f"phase 11 uve_pls: {diff} selections differ away from the cutoffs")
        return (f"; cutoff f32 {a.cutoff:.4g} f64 {b.cutoff:.4g}, selected {int(a.selected.sum())}"
                f" / {int(b.selected.sum())}, equal wherever clear of the cutoffs")

    run("uve_pls k=10 A=10 (X with 5000 noise columns)",
        lambda: tt.uve_pls(X, Y, 10, 10, key=seed), lambda: tt.uve_pls(X64, Y64, 10, 10, key=seed),
        lambda a, b: rel_any(a.reliability, b.reliability), API_ITER_RTOL, k1=10 * 10,
        note=uve_note)
    torch.cuda.empty_cache()
    lap("uve_pls")

    # the jackknife on the first JACK_N rows: its folds in batches of copies
    n = JACK_N

    def jk_note(a, b):
        return (f"; se rel {rel_any(a[1], b[1]):.3e}, t rel {rel_any(a[2], b[2]):.3e}, "
                f"{int(((a[3] < 0.05) != (b[3] < 0.05)).sum())} of {a[3].numel()} "
                f"p < 0.05 calls differ")

    run(f"coefficient_significance {n}×{K} A=10 ({n} jackknife fits)",
        lambda: tt.coefficient_significance(X[:n], Y[:n], 10),
        lambda: tt.coefficient_significance(X64[:n], Y64[:n], 10),
        lambda a, b: rel_any(a[0], b[0]), API_RTOL, k1=10, note=jk_note)
    lap("jackknife")

    # sample selection, tie-aware: each pick's max-min distance (in float64)
    # against the float64 call's picks'
    def seq_err(blocks):
        def err(a, b):
            sa, sb = maxmin_sequence(blocks, a), maxmin_sequence(blocks, b)
            return float(np.abs(sa - sb).max() / np.abs(sb).max())
        return err

    def same(a, b):
        return f"; {int(np.sum(np.asarray(a) == np.asarray(b)))} of {len(b)} picks equal in place"

    _, ks64 = run(f"kennard_stone {PICKS} of {N}", lambda: tt.kennard_stone(X, PICKS),
                  lambda: tt.kennard_stone(X64, PICKS), seq_err([(X64, 1.0)]), PICK_RTOL,
                  note=same)
    # SPXY's metric: each block over its largest pairwise distance (float64):
    # X's farthest pair is Kennard-Stone's seed pair
    (Yc,), (sq,) = sampling._prep_blocks(Y64)
    i, j = sampling._farthest_pair((Yc,), (sq,))
    scales = [float(torch.linalg.vector_norm(X64[ks64[0]] - X64[ks64[1]])),
              float(torch.linalg.vector_norm(Yc[i] - Yc[j]))]
    run(f"spxy {PICKS} of {N}", lambda: tt.spxy(X, Y, PICKS), lambda: tt.spxy(X64, Y64, PICKS),
        seq_err([(X64, scales[0]), (Y64, scales[1])]), PICK_RTOL, note=same)
    n = DUPLEX_N

    def dup_err(a, b):
        return max(seq_err([(X64[:n], 1.0)])(a[i], b[i]) for i in (0, 1))

    run(f"duplex {PICKS} of {n}", lambda: tt.duplex(X[:n], PICKS),
        lambda: tt.duplex(X64[:n], PICKS), dup_err, PICK_RTOL,
        note=lambda a, b: same(a[0], b[0]))
    lap("sampling")

    # calibration transfer: TRANSFER_N paired rows of 5000 channels; the
    # slave a smooth channel shift and gain of the master
    m = TRANSFER_N
    j = torch.arange(K, device=dev, dtype=torch.float64)

    def slave(M):
        gain = (1.0 + 0.05 * torch.sin(2 * torch.pi * j / K)).to(M.dtype)
        return gain * (0.7 * M + 0.3 * torch.roll(M, 1, 1)) + 0.02

    new32, new64 = slave(X[m:m + N_NEW]), slave(X64[m:m + N_NEW])
    for name, f32, f64 in (
            ("direct_standardization ridge=1", lambda: tt.direct_standardization(
                X[:m], slave(X[:m]), 1.0), lambda: tt.direct_standardization(
                X64[:m], slave(X64[:m]), 1.0)),
            ("piecewise_ds window=5 A=2", lambda: tt.piecewise_ds(X[:m], slave(X[:m]), 5, 2),
             lambda: tt.piecewise_ds(X64[:m], slave(X64[:m]), 5, 2))):
        run(f"{name} ({m}×{K}; apply_transfer)", f32, f64,
            lambda a, b: rel_any(tt.apply_transfer(a, new32), tt.apply_transfer(b, new64)),
            API_RTOL, k1=0)

    def epo_of(M):
        return tt.epo(tt.epo_difference_matrix(M, slave(M)), 2)

    run(f"epo g=2 ({2 * m}×{K} differences; the filter on new rows)", lambda: epo_of(X[:m]),
        lambda: epo_of(X64[:m]),
        lambda a, b: max(rel_any(a(new32), b(new64)), rel_any(a.sv_ratio, b.sv_ratio)),
        API_RTOL, k1=0)
    lap("transfer")

    # N-PLS: X as 100000×50×100
    X3, X3_64 = X.view(N, 50, 100), X64.view(N, 50, 100)
    run("fit_npls 100000×50×100 A=5 (predict_npls)",
        lambda: tt.predict_npls(tt.fit_npls(X3, Y, 5), X3[:N_NEW]),
        lambda: tt.predict_npls(tt.fit_npls(X3_64, Y64, 5), X3_64[:N_NEW]),
        rel_any, API_ITER_RTOL, k1=0)
    del X3, X3_64
    # O2PLS: 100000×5000 against 500 columns of the model it fits (phase 4's
    # X spreads 30 latent directions of one strength: its orthogonal
    # directions would be ties)
    Xo, Yo = o2pls_data(dev, seed, N, K, 500)
    Xo64, Yo64 = Xo.double(), Yo.double()

    def o2(Z, W):
        f = tt.fit_o2pls(Z, W, 5, 2, 2)
        return (tt.o2pls_predict_y(f, Z[:N_NEW]), tt.o2pls_predict_x(f, W[:N_NEW]),
                torch.cat([f.r2x_orth, f.r2y_orth]))

    run("fit_o2pls n=5 nx=2 ny=2, 500 Y columns (predict_y, predict_x, r2 orth)",
        lambda: o2(Xo, Yo), lambda: o2(Xo64, Yo64),
        lambda a, b: max(rel_any(x, y) for x, y in zip(a, b)), API_RTOL, k1=0,
        note=lambda a, b: f"; r2 orth X {[round(float(v), 4) for v in a[2][:2]]}, "
                          f"Y {[round(float(v), 4) for v in a[2][2:]]}")
    del Xo, Yo, Xo64, Yo64
    torch.cuda.empty_cache()
    lap("npls_o2pls")

    # missing data: 5 % of X's entries NaN
    g = torch.Generator(dev).manual_seed(seed + 13)
    Xn = X.masked_fill(torch.rand(X.shape, generator=g, device=dev) < 0.05, float("nan"))
    Xn64 = Xn.double()
    iters = {}

    def nm(Z, W, tag):
        f = tt.fit_nipals_missing(Z, W, 5, tol=NIPALS_TOL)
        iters[tag] = list(missing.last_iterations)
        return f, tt.predict_missing(f, Z[:N_NEW])

    run("fit_nipals_missing 5 % NaN A=5 (predict_missing)",
        lambda: nm(Xn, Y, "f32"), lambda: nm(Xn64, Y64, "f64"),
        lambda a, b: max(rel_any(coefficients(a[0]), coefficients(b[0])), rel_any(a[1], b[1])),
        API_ITER_RTOL, k1=0, note=lambda a, b: f"; iterations per component {iters}")
    n, k = IMPUTE
    gaps = torch.isnan(Xn[:n, :k])
    run(f"impute_pls {n}×{k} A=5 n_outer=5 (the imputed entries)",
        lambda: tt.impute_pls(Xn[:n, :k], Y[:n], 5, n_outer=5)[0][gaps],
        lambda: tt.impute_pls(Xn64[:n, :k], Y64[:n], 5, n_outer=5)[0][gaps],
        rel_any, API_ITER_RTOL, k1=6 * 5)
    del Xn, Xn64
    torch.cuda.empty_cache()
    lap("missing")

    # PLS-PM: ten latent variables, a chain with shortcuts from the first,
    # each measured by a block of 500 manifests (100000×5000, made on the
    # card: phase 4's X has no block structure); the last block formative
    # (mode B), the path scheme
    L = 10
    path = np.zeros((L, L))
    for i in range(1, L):
        path[i, i - 1] = 1
        path[i, 0] = 1
    modes = ["A"] * (L - 1) + ["B"]
    S = sem_data(dev, seed, N, K // L, L)
    S64 = S.double()

    def pm(Z, width):
        blocks = [list(range(b * width, (b + 1) * width)) for b in range(L)]
        return tt.fit_plspm(Z, blocks, path, modes=modes, scheme="path", tol=NIPALS_TOL)

    run(f"fit_plspm {L}×{K // L} manifests, mode B, path scheme",
        lambda: pm(S, K // L), lambda: pm(S64, K // L),
        lambda a, b: max(rel_any(getattr(a, f), getattr(b, f))
                         for f in ("paths", "loadings", "r2", "gof")),
        API_ITER_RTOL, k1=0,
        note=lambda a, b: f"; iterations f32 {int(a.n_iter)} f64 {int(b.n_iter)}, "
                          f"GoF {float(a.gof):.5f}")
    n_boot, n, k = BOOT
    # the first k // L manifests of each block, on the first n rows
    cols = torch.cat([torch.arange(b * (K // L), b * (K // L) + k // L, device=dev)
                      for b in range(L)])

    def boot(Z):  # both draw int32 resamples, as jax without x64 does
        return tt.bootstrap_plspm(Z[:n][:, cols], [list(range(b * k // L, (b + 1) * k // L))
                                                   for b in range(L)],
                                  path, n_boot, key=seed, modes=modes, scheme="path",
                                  tol=NIPALS_TOL, x64=False)

    run(f"bootstrap_plspm {n_boot} replicates of {n}×{k}", lambda: boot(S), lambda: boot(S64),
        lambda a, b: max(rel_any(getattr(a, f), getattr(b, f))
                         for f in ("paths_se", "paths_lo", "paths_hi", "loadings_se")),
        API_ITER_RTOL, k1=0)
    del S, S64
    torch.cuda.empty_cache()
    lap("plspm")

    # recursive PLS on the card: 10 chunks, λ = 1 against the statistics of
    # all rows, and λ = 0.99 against float64
    def rls(Z, W, lam, dtype):
        r = tt.RecursivePLS(K, 10, lam=lam, dtype=dtype, device=dev)
        for c in range(RLS_CHUNKS):
            rows = slice(c * N // RLS_CHUNKS, (c + 1) * N // RLS_CHUNKS)
            r.update(Z[rows], W[rows])
        return coefficients(r.fit(API_A))

    run(f"RecursivePLS {RLS_CHUNKS} chunks A={API_A} λ=1 (vs fit_from_stats on all rows)",
        lambda: rls(X, Y, 1.0, torch.float32),
        lambda: coefficients(tt.fit_from_stats(X.T @ X, X.T @ Y, API_A)),
        rel_any, API_RTOL, k1=0)
    run(f"RecursivePLS {RLS_CHUNKS} chunks A={API_A} λ=0.99",
        lambda: rls(X, Y, 0.99, torch.float32), lambda: rls(X64, Y64, 0.99, torch.float64),
        rel_any, API_RTOL, k1=0)
    lap("recursive")

    # checkpoints of every registered type fitted above, both formats,
    # round-tripped bit-equal under build/
    def same_state(a, b) -> bool:
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                if not (y.device == x.device and torch.equal(x, y)):
                    return False
            elif hasattr(x, "__dataclass_fields__"):
                if not same_state(x, y):
                    return False
            elif x != y:
                return False
        return True

    states = {"PLSFit": mb32.pls, "MBPLSFit": mb32, "OPLSFit": oda32,
              "MonitorModel": tt.fit_monitor(cox32.pls, X, 5),
              "NPLSFit": tt.fit_npls(X[:JACK_N].view(JACK_N, 50, 100), Y[:JACK_N], 3)}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        walls = {}
        for name, st in states.items():
            t0 = time.perf_counter()
            tt.save_fit(st, f"{tmp}/{name}.npz")
            a = tt.load_fit(f"{tmp}/{name}.npz", device=dev)
            tt.save_fit_orbax(st, f"{tmp}/{name}_torch")
            b = tt.load_fit_orbax(f"{tmp}/{name}_torch", device=dev)
            walls[name] = round(time.perf_counter() - t0, 4)
            check(same_state(st, a) and same_state(st, b), f"phase 11: {name} checkpoint")
    print(f"  save_fit/load_fit and save_fit_orbax/load_fit_orbax bit-equal for "
          f"{list(states)}; host s {walls}")
    out["checkpoint_s"] = walls
    health = fit_health(mb32.pls)
    print(f"  fit_health(fit_mbpls's 100000×5000 fit): finite {health['finite']}, score "
          f"orthogonality defect {health['score_orthogonality_defect']:.3e}, PᵀW diagonal "
          f"deviation {health['ptw_diag_deviation']:.3e}")
    check(health["finite"], "phase 11 fit_health: not finite")
    r = torch.randn(K, device=dev)
    saved = deflate.launches["deflate_f32"]  # timing launches stay out of the count
    secs = profiling.measure(lambda: deflate.deflate_pass(X, r), iters=20)
    deflate.launches["deflate_f32"] = saved
    roof = profiling.roofline_report(secs, 4 * (N * K + N + 2 * K), 4 * N * K)
    print(f"  roofline_report of one K1 pass at {N}×{K} (profiling.measure, CUDA events): {roof}")
    out["roofline"] = {"ms": secs * 1e3, "frac_hbm_peak": roof.frac_hbm_peak}
    lap("checkpoint_health")
    del X, Y, X64, Y64
    torch.cuda.empty_cache()

    out["nir"] = phase_api_nir(deflate, dev)
    lap("nir")
    out["part_s"] = laps
    print(f"phase 11 parts, s: {json.dumps(laps)}")
    return out


def phase_api_nir(deflate, dev) -> dict:
    """Phase 11 on real data: the flows of examples/nir_calibration.py
    (Kennard-Stone split, fit on the calibration rows) and
    examples/spectroscopy_workflow.py (savgol + SNV, ipls_forward, the fit
    on the chosen channels, piecewise_ds and apply_transfer to a simulated
    second instrument) through the port in float32 on the card, against
    the port's float64 run on the CPU at phase 3's tolerances; picks and
    chosen intervals equal."""
    import pls_tpu_torch as tt
    from pls_tpu_torch import datasets

    X_raw, Y_raw = datasets.load_nir()
    slave_raw = 1.08 * X_raw + 0.05 + 0.01 * np.random.default_rng(0).normal(size=X_raw.shape)

    def flows(device):
        dt = tt.default_float_dtype(device)

        def data(a):
            return torch.as_tensor(a, dtype=dt, device=device)

        X = tt.colwise_z_scores(data(X_raw))
        Y = tt.colwise_z_scores(data(Y_raw))
        cal, val = tt.ks_train_test_split(X, train_size=45)
        f_cal = tt.fit(X[cal], Y[cal], 5)
        rmsep = torch.sqrt(((tt.fitted_values(f_cal, X[val]) - Y[val]) ** 2).mean())
        Xp = tt.snv(tt.savgol(data(X_raw), 11, 2, 1))
        Xz = tt.colwise_z_scores(Xp)
        sel = tt.ipls_forward(Xz, Y, n_intervals=10, A=5, k=10)
        Xsel = Xz * data(sel.mask)[None, :]
        ev = tt.explained_variance(tt.fit(Xsel, Y, max(sel.ncomp, 3)), Xsel, Y)
        slave = tt.snv(tt.savgol(data(slave_raw), 11, 2, 1))
        rec = tt.apply_transfer(tt.piecewise_ds(Xp[:40], slave[:40], window=3, A=2), slave[40:])
        return cal, val, rmsep, sel, ev, rec, torch.linalg.vector_norm(rec - Xp[40:])

    before = deflate.launches["deflate_f32"]
    got, wall = event_wall(lambda: flows(dev))
    d = deflate.launches["deflate_f32"] - before
    ref = flows(torch.device("cpu"))
    check(np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1]),
          "phase 11 nir: Kennard-Stone picks differ")
    check(got[3].selected == ref[3].selected and got[3].ncomp == ref[3].ncomp,
          f"phase 11 nir: iPLS picked {got[3].selected}, the CPU run {ref[3].selected}")
    e_rmse = max(rel_any(got[2], ref[2]), rel_any(got[3].rmsecv_path, ref[3].rmsecv_path),
                 rel_any(got[6], ref[6]))
    e_ev = float((got[4].cpu().double() - ref[4]).abs().max())
    e_rec = rel_any(got[5], ref[5])
    print(f"  nir flows (ks_train_test_split 45/15 + fit A=5; savgol+snv, ipls_forward picks "
          f"{got[3].selected} at {got[3].ncomp} components, piecewise_ds + apply_transfer): "
          f"{wall:.4f} s, K1 {d}; vs the port's f64 CPU run: picks and intervals equal, "
          f"RMSEP/RMSECV/transfer residual rel {e_rmse:.3e} (bound {RMSE_RTOL}), EV abs "
          f"{e_ev:.3e} (bound {EV_ATOL}), transferred spectra rel {e_rec:.3e} (bound {COEF_RTOL})")
    check(e_rmse <= RMSE_RTOL and e_ev <= EV_ATOL and e_rec <= COEF_RTOL,
          "phase 11 nir flows disagree with the CPU run")
    return {"s": wall, "k1": d, "rmse_rel": e_rmse, "ev_abs": e_ev, "transfer_rel": e_rec}


_P10 = np.array([float(10 ** k) for k in range(13)])  # exact powers of ten
_D3 = np.frombuffer(b"".join(b"%03d\0" % i for i in range(1000)), np.uint32)  # "ddd" words
_TZ3 = np.array([3] + [len(b"%03d" % i) - len((b"%03d" % i).rstrip(b"0")) for i in range(1, 1000)])


def format_g9(V: np.ndarray, sep: str = ",") -> bytes:
    """The rows of V as headerless CSV lines, each value as `"%.9g" % v`
    prints it: nine significant digits, in fixed notation (decimal
    exponents -4 to 8) with trailing zeros dropped, built from digit tables
    in numpy; any other value (zero, tiny, huge, not finite) through
    "%.9g" itself."""
    rows, K = V.shape
    v = np.ascontiguousarray(V, np.float64).ravel()
    n, a = v.size, np.abs(v)
    fixed = (a >= 1e-4) & (a < 1e9)
    e = np.clip(np.floor(np.log10(np.where(fixed, a, 1.0))).astype(np.int64), -4, 8)
    m = np.rint(a * _P10[8 - e])  # the 9 digits, exact: 10^(8-e) ≤ 10^12
    e += (m >= 1e9).astype(np.int64) - (m < 1e8)  # log10 or the rounding crossed a power of 10
    fixed &= (e >= -4) & (e <= 8)
    e = np.clip(e, -4, 8)
    m = np.rint(a * _P10[8 - e])
    fixed &= (m >= 1e8) & (m < 1e9)
    mi = np.where(fixed, m, 1e8).astype(np.int64)
    g1 = mi // 1_000_000
    g3 = mi - g1 * 1_000_000
    g2 = g3 // 1000
    g3 -= g2 * 1000
    D = np.empty((n, 9), np.uint8)
    for j, g in enumerate((g1, g2, g3)):
        D[:, 3 * j:3 * j + 3] = _D3[g].view(np.uint8).reshape(n, 4)[:, :3]
    t3, t2 = _TZ3[g3], _TZ3[g2]
    tz = t3 + (t3 == 3) * (t2 + (t2 == 3) * _TZ3[g1])  # trailing zero digits
    out = np.zeros((n, 16), np.uint8)  # sign, up to 14 characters, separator; 0 = nothing
    out[:, 0] = np.where(np.signbit(v), ord("-"), 0)
    for k in range(-4, 9):
        idx = np.flatnonzero(fixed & (e == k))
        if idx.size == 0:
            continue
        if k >= 0:  # k + 1 integer digits, '.', 8 - k fraction digits
            body = np.empty((idx.size, 10), np.uint8)
            body[:, :k + 1] = D[idx, :k + 1]
            body[:, k + 1] = ord(".")
            body[:, k + 2:] = D[idx, k + 1:]
        else:  # "0.", -k - 1 zeros, the 9 digits
            body = np.full((idx.size, 10 - k), ord("0"), np.uint8)
            body[:, 1] = ord(".")
            body[:, 1 - k:] = D[idx]
        drop = np.minimum(tz[idx], 8 - k)
        drop += drop == 8 - k  # no fraction digit left: no '.' either
        body[np.arange(body.shape[1]) >= (body.shape[1] - drop)[:, None]] = 0
        out[idx, 1:1 + body.shape[1]] = body
    for i in np.flatnonzero(~fixed):
        s = np.frombuffer(b"%.9g" % v[i], np.uint8)
        out[i, :15] = 0
        out[i, :s.size] = s
    out[:, 15] = ord(sep)
    out.reshape(rows, K, 16)[:, -1, 15] = ord("\n")
    flat = out.ravel()
    return flat[flat != 0].tobytes()


def csv_block(seed: int, block: int) -> tuple[bytes, bytes]:
    """Rows [block·CSV_BLOCK, (block + 1)·CSV_BLOCK) of phase 12's
    calibration set as CSV text (X, Y): a rank-30 latent model plus noise,
    column offsets of 0.5-3 column σ, float32 values at %.9g.  The model
    comes from `seed` and the block's rows from (seed, block)."""
    N, K, M = CSV
    model = np.random.default_rng([seed, 12])
    W = model.standard_normal((CSV_LATENT, K))
    V = model.standard_normal((CSV_LATENT, M))
    off_x = (0.5 + 2.5 * model.random(K)) * np.sqrt((W * W).sum(0) + 0.25)
    off_y = (0.5 + 2.5 * model.random(M)) * np.sqrt((V * V).sum(0) + 0.01)
    rng = np.random.default_rng([seed, 12, block])
    n = min(CSV_BLOCK, N - block * CSV_BLOCK)
    lat = rng.standard_normal((n, CSV_LATENT))
    X = (lat @ W + 0.5 * rng.standard_normal((n, K)) + off_x).astype(np.float32)
    Y = (lat @ V + 0.1 * rng.standard_normal((n, M)) + off_y).astype(np.float32)
    return format_g9(X), format_g9(Y)


def write_csv_set(tmp: Path, seed: int) -> tuple[Path, Path, float]:
    """Phase 12's X.csv and Y.csv under tmp, blocks made and formatted on
    one thread a core (numpy releases the interpreter lock) and written in
    order; (X path, Y path, seconds)."""
    xp, yp = tmp / "X.csv", tmp / "Y.csv"
    t0 = time.perf_counter()
    with open(xp, "wb") as fx, open(yp, "wb") as fy, ThreadPoolExecutor(os.cpu_count()) as pool:
        for x, y in pool.map(lambda b: csv_block(seed, b), range(-(-CSV[0] // CSV_BLOCK))):
            fx.write(x)
            fy.write(y)
    return xp, yp, time.perf_counter() - t0


def run_tool(module: str, *args: str) -> dict:
    """Run `python -m <module> args` from this checkout; its last stdout
    line, a JSON object, parsed."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=TOOL_TIMEOUT)
    check(proc.returncode == 0,
          f"{module} exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    print(f"{module.rsplit('.', 1)[1]}: {line}")
    return json.loads(line)


def phase_csv(deflate, dev, seed: int) -> dict:
    """Phase 12: CSV ingest through the native loader.  Returns its
    measurements."""
    from pls_tpu_torch.model import PLSModel
    from pls_tpu_torch.models import streaming
    from pls_tpu_torch.models.predict import coefficients
    from pls_tpu_torch.ops.stats import colwise_z_scores
    from pls_tpu_torch.utils import io as pio, native

    N, K, M = CSV
    A = CSV_A
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_csv_", dir=ROOT / "build"))
    out: dict = {}
    try:
        xp, yp, out["write_s"] = write_csv_set(tmp, seed)
        xbytes, ybytes = os.path.getsize(xp), os.path.getsize(yp)
        print(f"phase 12 data: {N}x{K} X ({xbytes} B) and {N}x{M} Y ({ybytes} B), headerless "
              f"CSV, %.9g of float32, made and written by {os.cpu_count()} threads in "
              f"{out['write_s']:.3f} s")

        # (a) the whole file through the native loader, the plain parser on a prefix
        reads0 = dict(pio.native_reads)
        t0 = time.perf_counter()
        Xh = pio.read_matrix_file(str(xp))
        out["native_s"] = time.perf_counter() - t0
        Yh = pio.read_matrix_file(str(yp))
        out["native_mbs"] = xbytes / out["native_s"] / 1e6
        check(Xh.shape == (N, K) and Yh.shape == (N, M) and bool(np.isfinite(Xh).all()),
              f"read_matrix_file: shapes {Xh.shape}, {Yh.shape} or non-finite")
        prefix = tmp / "X_prefix.csv"
        with open(xp, "rb") as f:
            prefix.write_bytes(b"".join(itertools.islice(f, CSV_PREFIX)))
        pbytes = os.path.getsize(prefix)
        t0 = time.perf_counter()
        plain = pio._read_matrix_python(str(prefix))
        out["plain_s"] = time.perf_counter() - t0
        out["plain_mbs"] = pbytes / out["plain_s"] / 1e6
        native_prefix = pio.read_matrix_file(str(prefix))
        bit_equal = (plain.shape == native_prefix.shape == (CSV_PREFIX, K)
                     and plain.tobytes() == native_prefix.tobytes() == Xh[:CSV_PREFIX].tobytes())
        print(f"read_matrix_file (native): {out['native_s']:.3f} s = {out['native_mbs']:.1f} MB/s "
              f"of X from the page cache; plain parser on the first {CSV_PREFIX} rows "
              f"({pbytes} B): {out['plain_s']:.3f} s = {out['plain_mbs']:.1f} MB/s, "
              f"bit-equal to the native loader's: {bit_equal}")
        check(bit_equal, "phase 12: the native loader and the plain parser differ on the prefix")
        out["native_reads_a"] = pio.native_reads["read_matrix"] - reads0["read_matrix"]

        # the in-memory fit on the card: K1 in f32 against f64
        before = deflate.launches["deflate_f32"]
        Xz, Yz = (colwise_z_scores(torch.as_tensor(a, dtype=torch.float32, device=dev))
                  for a in (Xh, Yh))
        B32, wall32 = synced_wall(lambda: PLSModel(Xz, Yz, max_components=A).coefficients())
        d32 = deflate.launches["deflate_f32"] - before
        Xz64, Yz64 = (colwise_z_scores(torch.as_tensor(a, dtype=torch.float64, device=dev))
                      for a in (Xh, Yh))
        B64, wall64 = synced_wall(lambda: PLSModel(Xz64, Yz64, max_components=A).coefficients())
        d64 = deflate.launches["deflate_f32"] - before - d32
        del Xz, Yz, Xz64, Yz64
        out["fit_coef_rel"] = rel_err(B32, B64)
        out["k1"] = d32
        print(f"in-memory fit {N}x{K}x{M} A={A} f32: {wall32:.4f} s (first fit), K1 {d32}; vs f64 "
              f"on the card ({wall64:.4f} s, K1 {d64}): coef rel {out['fit_coef_rel']:.3e} "
              f"(bound {FIT_COEF_RTOL})")
        check(d32 == A and d64 == 0, f"phase 12 fit: K1 {d32} (f32), {d64} (f64); expected {A}, 0")
        check(tuple(B32.shape) == (K, M) and bool(torch.isfinite(B32).all()),
              "phase 12 fit: shape / non-finite")
        check(out["fit_coef_rel"] <= FIT_COEF_RTOL, "phase 12 f32 fit disagrees with f64")

        # (b) the streaming fit from the files: two passes, X and Y parsed
        # ahead by their readers' threads; CUDA events around each chunk's
        # device work (from the chunk's hand-off to the next request)
        chunk_rows = inspect.signature(streaming.fit_streaming_csv).parameters["chunk_rows"].default
        t0 = time.perf_counter()
        for _ in streaming.csv_chunks(str(xp), str(yp), chunk_rows):
            pass
        out["parse_pass_s"] = time.perf_counter() - t0
        spans = []
        csv_chunks = streaming.csv_chunks

        def timed_chunks(*a, **k):
            for pair in csv_chunks(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
                yield pair
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                spans.append((e0, e1))

        chunks0 = pio.native_reads["chunks"]
        streaming.csv_chunks = timed_chunks
        try:
            fit, out["stream_s"] = synced_wall(lambda: streaming.fit_streaming_csv(
                str(xp), str(yp), A, device=dev))
        finally:
            streaming.csv_chunks = csv_chunks
        out["stream_chunks"] = pio.native_reads["chunks"] - chunks0
        busy = sum(e0.elapsed_time(e1) for e0, e1 in spans) / 1e3
        out["busy_share"] = busy / out["stream_s"]
        out["stream_per_parse"] = out["stream_s"] / out["parse_pass_s"]
        # parse-bound, the fit takes its probe's chunk and two passes of parse
        out["stream_per_parse_bound"] = out["stream_per_parse"] / (2 + chunk_rows / N)
        Bs = coefficients(fit)
        out["stream_coef_rel"] = rel_err(Bs, B64)
        passes = -(-N // chunk_rows)
        print(f"fit_streaming_csv A={A} f32 chunk_rows={chunk_rows}: wall {out['stream_s']:.3f} s "
              f"= {out['stream_per_parse']:.3f} parse passes (one parse-only pass of X and Y: "
              f"{out['parse_pass_s']:.3f} s); device busy {busy:.4f} s = "
              f"{out['busy_share']:.4f} of the wall over {len(spans)} chunk hand-offs; "
              f"coef rel {out['stream_coef_rel']:.3e} vs the f64 in-memory fit "
              f"(bound {FIT_COEF_RTOL}); native chunks {out['stream_chunks']}")
        hidden = out["stream_per_parse_bound"] <= 1.1
        print(f"  the wall is {out['stream_per_parse_bound']:.3f} of the probe's chunk and two "
              "parse passes: the readers' background parse "
              + ("overlaps the device, whose work hides behind the parse" if hidden else
                 "does not hide the device's work"))
        check(tuple(Bs.shape) == (K, M) and bool(torch.isfinite(Bs).all()),
              "phase 12 streaming fit: shape / non-finite")
        check(out["stream_coef_rel"] <= FIT_COEF_RTOL,
              f"phase 12 streaming fit: coef rel {out['stream_coef_rel']:.2e} > {FIT_COEF_RTOL}")
        del fit, Bs, B32, B64

        # (c) the native loader carried (a) and (b), and every reader's thread is joined
        check(out["native_reads_a"] == 3, f"phase 12 (a): {out['native_reads_a']} native reads")
        check(out["stream_chunks"] == 2 * (1 + 2 * passes),
              f"phase 12 (b): {out['stream_chunks']} native chunks, expected {2 * (1 + 2 * passes)}")
        check(native.live_readers() == 0, "phase 12: a chunk reader's thread was left running")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    # (d) the two measurement tools, each in its own process on this card
    sweep = run_tool("pls_tpu_torch.tools.accumulator_sweep")
    check(len(sweep["sweep"]) == 8 and all(r["tflops"] > 0 for r in sweep["sweep"].values()),
          "accumulator_sweep: rows missing or empty")
    flagship = run_tool("pls_tpu_torch.tools.flagship_wall", "--runs", "3")
    check(len(flagship["walls_sec"]) == 3 and flagship["warm_best_sec"] > 0,
          "flagship_wall: walls missing")
    out["accumulator_sweep"], out["flagship_wall"] = sweep, flagship
    return out


def halving_plan(lo: int, hi: int, depth: int) -> list[tuple[int, int, int, int]]:
    """`ops.stats.gram`'s products by recursive halving of the diagonal
    block [lo, hi) on GRAM_GRID columns: its off-diagonal quarter, then
    each half, down to 2**depth diagonal leaves."""
    if depth == 0:
        return [(lo, hi, lo, hi)]
    mid = lo + ((hi - lo) // 2 + GRAM_GRID // 2) // GRAM_GRID * GRAM_GRID
    return [(lo, mid, mid, hi), *halving_plan(lo, mid, depth - 1), *halving_plan(mid, hi, depth - 1)]


def phase_gram(dev, seed: int) -> dict:
    """Phase 13: the k-fold Gram, whole against the upper block triangle,
    and the sweep of its plans.  Returns its measurements."""
    from pls_tpu_torch.models.kernel_pls import _prec_ctx
    from pls_tpu_torch.ops import stats

    N, K = BIG
    torch.cuda.empty_cache()
    X, _ = make_big(dev, seed)
    Xd = X.double()
    ref = Xd.mT @ Xd
    del Xd
    out = {"shape": [N, K], "width": stats._GRAM_WIDTH, "strips": len(stats.gram_plan(K))}
    whole_flops = 2 * N * K * K

    def whole():
        return X.mT @ X

    def timed(fn) -> float:
        return statistics.median(times_ms(fn, reps=GRAM_REPS, warmup=2))

    with _prec_ctx("highest"):
        check(not torch.backends.cuda.matmul.allow_tf32, "phase 13: TF32 is on")
        G = whole()
        out["whole_rel"] = fro_rel(G, ref)
        out["whole_symmetric"] = bool(torch.equal(G, G.mT))
        del G
        before = stats.gram_calls["triangle"]
        G = stats.gram(X)
        check(stats.gram_calls["triangle"] == before + 1, "phase 13: gram left the triangle")
        out["triangle_rel"] = fro_rel(G, ref)
        check(torch.equal(G, G.mT), "phase 13: the triangle's XᵀX is not symmetric")
        check(out["triangle_rel"] <= GRAM_RTOL,
              f"phase 13: triangle rel err {out['triangle_rel']:.2e} > {GRAM_RTOL}")
        del G
        turns = {"whole": [], "triangle": []}
        for name in ("whole", "triangle", "triangle", "whole"):
            turns[name].append(timed(whole if name == "whole" else lambda: stats.gram(X)))
        out["turns_ms"] = turns
        out["whole_ms"] = statistics.median(turns["whole"])
        out["triangle_ms"] = statistics.median(turns["triangle"])
        plan = stats.gram_plan(K)
        out["products_ms"] = timed(lambda: [
            X[:, r0:r1].mT @ X[:, c0:c1] for r0, r1, c0, c1 in plan])
        print(f"phase 13 gram {N}×{K} f32: whole {out['whole_ms']:.3f} ms "
              f"({whole_flops / out['whole_ms'] / 1e9:.1f} TFLOP/s), triangle of "
              f"{out['strips']} strips {out['triangle_ms']:.3f} ms (products alone "
              f"{out['products_ms']:.3f}); turns {turns}; rel err whole "
              f"{out['whole_rel']:.3e} triangle {out['triangle_rel']:.3e}")

        sweep = []
        plans = [(f"strips_{w}", stats.gram_plan(K, w, 0)) for w in GRAM_WIDTHS]
        plans += [(f"halving_{d}", halving_plan(0, K, d)) for d in GRAM_DEPTHS]
        for name, plan in plans:
            G = stats.gram(X, plan)
            err = fro_rel(G, ref)
            check(torch.equal(G, G.mT), f"phase 13 {name}: not symmetric")
            check(err <= GRAM_RTOL, f"phase 13 {name}: rel err {err:.2e} > {GRAM_RTOL}")
            del G
            ms = timed(lambda: stats.gram(X, plan))
            flops = sum(2 * N * (r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in plan)
            row = {"plan": name, "products": len(plan), "ms": ms,
                   "flop_share": flops / whole_flops, "tflops": flops / ms / 1e9, "rel": err}
            sweep.append(row)
            print(f"phase 13 sweep {json.dumps(row)}")
        out["sweep"] = sweep
        del ref

        by_k = []
        for k in GRAM_KS:
            Xk = X[:, :k].contiguous()
            row = {"K": k, "strips": len(stats.gram_plan(k)),
                   "whole_ms": timed(lambda: Xk.mT @ Xk),
                   "plan_ms": timed(lambda: stats.gram(Xk))}
            by_k.append(row)
            print(f"phase 13 by K {json.dumps(row)}")
            del Xk
        out["by_k"] = by_k

        peaks = {}
        for name in ("whole", "triangle"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            G = whole() if name == "whole" else stats.gram(X)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
            del G
        out["peak_bytes"] = peaks
        check(peaks["triangle"] <= peaks["whole"] + K * K * 4,
              f"phase 13: the triangle's peak {peaks} passes the whole product's by more than K²·4")
    del X
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 10's two-rank run (parallel.launch.spawn_ranks)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.rank is not None:
        return phase_parallel_rank(args)
    import pls_tpu_torch
    from pls_tpu_torch.ops import deflate, deflate_variants as dv, eigen
    from pls_tpu_torch.tools import kernel_variants as kv

    check(Path(pls_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"pls_tpu_torch imported from {pls_tpu_torch.__file__}, not this checkout")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_device(deflate, dv, eigen)
    abs_err = phase_kernel(deflate, dev, args.seed)
    abs_err.update(phase_variants(dv, kv, dev, args.seed))
    abs_err["jacobi_dominant"] = phase_eigen(eigen, dev, args.seed)

    # the main path's run starts here
    for counts in (deflate.launches, deflate.path_calls, eigen.path_calls):
        for k in counts:
            counts[k] = 0
    cli_walls = phase_cli(deflate, eigen)
    fit_walls = phase_big(deflate, dev, args.seed)
    launches = dict(deflate.launches)  # ... and ends here
    eigen_calls = dict(eigen.path_calls)
    launches["jacobi_dominant"] = eigen_calls["kernel"]
    print(f"main path launches: {launches}, by path {deflate.path_calls}; eigenvectors by "
          f"path {eigen_calls}; cli walls {cli_walls}; 20-component fit walls {fit_walls}")
    check(launches["deflate_f32"] > 0 and launches["deflate_bf16"] > 0,
          "a kernel of the path never launched")
    check(eigen_calls == {"kernel": MAIN_PATH_EIGEN, "eigh": 0, "power": 0},
          f"main path eigenvectors {eigen_calls}, expected {MAIN_PATH_EIGEN} on the kernel")

    times = phase_timing(deflate, dev, args.seed)
    gain = times.pop("gain")
    staging = times.pop("staging")
    times.update(eigen_timing(eigen, dev, args.seed))

    for counts in (deflate.launches, deflate.path_calls):  # the wide fit's run starts here
        for k in counts:
            counts[k] = 0
    wide_out = phase_wide_fit(dev, args.seed, gain)
    wide_launches = dict(deflate.launches)  # ... and ends here
    print(f"wide fit launches: {wide_launches}, by path {deflate.path_calls}; "
          f"{json.dumps(wide_out)}")
    check(wide_launches["deflate_f32_cluster"] == 80 and wide_launches["deflate_bf16_cluster"]
          == 80 and wide_launches["deflate_f32"] == wide_launches["deflate_bf16"] == 0,
          "the wide fits left the cluster path")
    for k in ("deflate_f32_cluster", "deflate_bf16_cluster"):
        launches[k] += wide_launches[k]

    for counts in (dv.launches, dv.mxu_path_launches):  # the sweep path's run starts here
        for k in counts:
            counts[k] = 0
    tables = phase_sweep(kv, args.seed)
    sweep_launches = dict(dv.launches)  # ... and ends here
    print(f"sweep path launches: {sweep_launches}; K4 by path {dv.mxu_path_launches}")
    check(all(v > 0 for v in sweep_launches.values()), "a kernel of the sweep never launched")
    check(dv.mxu_path_launches["ring"] == sweep_launches["mxu_f32"],
          "K4 left its ring on the sweep path")
    launches.update(sweep_launches)
    times.update(best_variant_times(dv, kv, tables, dev, args.seed))

    for counts in (deflate.launches, dv.launches):  # the stats path's run starts here
        for k in counts:
            counts[k] = 0
    stats = phase_stats(dev, args.seed)
    stats_launches = {**deflate.launches, **dv.launches}  # ... and ends here
    print(f"stats path launches: {stats_launches} (the path runs none of K1-K5); "
          f"{json.dumps(stats)}")

    for counts in (deflate.launches, dv.launches):  # phase 8's run starts here
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    slice_out = phase_slice(deflate, dev, args.seed)
    slice_launches = {**deflate.launches, **dv.launches}  # ... and ends here
    print(f"phase 8 launches: {slice_launches}; {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(slice_out)}")
    check(slice_launches["deflate_f32"] > 0, "phase 8 never launched K1")
    launches["deflate_f32"] += slice_launches["deflate_f32"]

    for counts in (deflate.launches, dv.launches):  # phase 9's run starts here
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    est_out = {"bf16_cli": phase_bf16_cli(deflate), **phase_estimators(deflate, dev, args.seed)}
    est_launches = {**deflate.launches, **dv.launches}  # ... and ends here
    print(f"phase 9 launches: {est_launches}; {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(est_out, default=str)}")
    check(est_launches["deflate_f32"] > 0 and est_launches["deflate_bf16"] > 0,
          "phase 9 never launched K1 or K2")
    for k in ("deflate_f32", "deflate_bf16"):
        launches[k] += est_launches[k]

    t0 = time.perf_counter()
    # phase 10 sets the counts to 0 after its one-device references, just
    # before its sharded calls, and reads them just after; its two ranks'
    # launches are added from their own counts
    par_out, par_launches = phase_parallel(deflate, dev, args.seed, fit_walls)
    print(f"phase 10 launches: {par_launches}; {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(par_out)}")
    for k in ("deflate_f32", "deflate_bf16"):
        launches[k] += par_launches[k]

    for counts in (deflate.launches, dv.launches):  # phase 11's run starts here
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    api_out = phase_api(deflate, dev, args.seed)
    api_launches = {**deflate.launches, **dv.launches}  # ... and ends here
    print(f"phase 11 launches: {api_launches}; {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(api_out, default=str)}")
    check(api_launches["deflate_f32"] > 0, "phase 11 never launched K1")
    launches["deflate_f32"] += api_launches["deflate_f32"]

    for counts in (deflate.launches, dv.launches):  # phase 12's run starts here
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    csv_out = phase_csv(deflate, dev, args.seed)
    csv_launches = {**deflate.launches, **dv.launches}  # ... and ends here
    tools = {k: csv_out.pop(k) for k in ("accumulator_sweep", "flagship_wall")}  # printed
    print(f"phase 12 launches: {csv_launches}; {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(csv_out)}; tools' devices {[t['device'] for t in tools.values()]}")
    check(csv_launches["deflate_f32"] == CSV_A, "phase 12 launched K1 other than its fit's A times")
    launches["deflate_f32"] += csv_launches["deflate_f32"]

    t0 = time.perf_counter()
    gram_out = phase_gram(dev, args.seed)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s; {json.dumps(gram_out)}")

    check("jax" not in sys.modules and "pls_tpu" not in sys.modules, "jax was imported")
    check(all(sum(launches[c] for c in counters) > 0 for *_, counters in KERNELS),
          "a kernel of the record never launched on its path")
    print(nvidia_smi())  # again, beside the record: the run's tail carries the card
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"pls_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": sum(launches[c] for c in counters),
         "max_abs_err": max(abs_err[c] for c in counters), "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][3], "bound_by": times[name][4],
         "library_ms": times[name][2]}
        for name, source, replaces, counters in KERNELS
    ], "k1_wide_staging": staging}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
