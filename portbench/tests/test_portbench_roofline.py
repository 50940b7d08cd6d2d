"""The byte and flop counts of portbench/roofline.py on shapes worked by
hand, on the CPU."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_one_pass():
    # X 4×3 f32 (48 bytes), r 3, t 4, p 3, tt 1 floats: 48 + 4·11
    assert roofline.pass_bytes(4, 3, 4) == 92
    assert roofline.pass_bytes(4, 3, 2) == 24 + 44
    assert roofline.pass_flops(4, 3) == 4 * 12 + 8


def test_the_pass_at_the_cell_shape_is_bound_by_bytes():
    b, f = roofline.pass_bytes(100_000, 5_000, 4), roofline.pass_flops(100_000, 5_000)
    assert roofline.least_seconds(b, f) == pytest.approx(b / 3.35e12)
    assert roofline.least_seconds(b, f) == pytest.approx(0.5971e-3, rel=1e-3)  # PERF.md's K1 bound


def test_a_fit_reads_x_a_plus_one_times():
    N, K, M, A = 10, 4, 2, 3
    assert roofline.fit_bytes(N, K, M, A, 4) == 4 * (4 * N * K + N * M + A * (2 * K + N + 1))
    assert roofline.fit_bytes(N, K, M, A, 2) - roofline.fit_bytes(N, K, M, A, 4) == -2 * 4 * N * K


def test_fit_flops_by_hand():
    # M = 1: no eigenvector; per component 4NK + 2N, Gram-Schmidt 4aK, q 2K, deflation 3K
    N, K, A = 5, 3, 2
    per = [4 * N * K + 2 * N + 4 * a * K + 2 * K + 3 * K for a in range(A)]
    assert roofline.fit_flops(N, K, 1, A) == 2 * N * K + sum(per)
    # M = 2 adds XYᵀXY (2KM²) and XY q (2KM) a component
    with_eig = roofline.fit_flops(N, K, 2, A) - roofline.fit_flops(N, K, 1, A)
    assert with_eig == 2 * N * K + A * (2 * K * 4 + 2 * K * 2 + 5 * K)


def test_kfold_counts_xtx_as_its_unique_half():
    N, K, M, A, k = 1000, 50, 1, 1, 10
    gram = N * K * (K + 1)
    full = 2 * N * K * K
    rest = roofline.kfold_flops(N, K, M, A, k) - gram
    assert 0 < rest < gram  # the Gram term dominates at this shape
    assert roofline.kfold_flops(N, K, M, A, k) < full + rest  # not the full product
    # a fold: 2·nf·K·(M + A) + 2·nf·A·M, then a component: 2K² + 4·nf·K + 2K + small
    nf = N // k
    fold = 2 * nf * K * M + 2 * nf * K * A + 2 * nf * A * M
    fold += 2 * K * K + 4 * nf * K + 2 * K + 5 * K
    assert rest == 2 * N * K * M + k * fold


def test_kfold_counts_every_row_of_uneven_folds():
    # 103 rows in 10 folds: three folds of 11; each extra row adds its share of XᵀX and
    # XᵀY, its fold's downdate and residual products, and 4·K flops a component
    K, M, A = 7, 2, 3
    row = K * (K + 1) + 2 * K * M + 2 * K * M + 2 * K * A + 2 * A * M + A * 4 * K
    assert roofline.kfold_flops(103, K, M, A, 10) - roofline.kfold_flops(100, K, M, A, 10) == 3 * row


def test_kfold_bytes():
    N, K, M, A = 100, 5, 2, 3
    want = 4 * (N * K + N * M + K * K + K * M + M * N * A)
    assert roofline.kfold_bytes(N, K, M, A, 10, 4) == want


def test_the_cells_least_times():
    # synth100k: a fit reads 2.0 GB 21 times; the CV is bound by XᵀX's 2.5 TFLOP
    fit = roofline.least_seconds(roofline.fit_bytes(100_000, 5_000, 10, 20, 4),
                                 roofline.fit_flops(100_000, 5_000, 10, 20))
    assert fit == pytest.approx(21 * 2e9 / 3.35e12, rel=1e-3)
    cv_b = roofline.kfold_bytes(100_000, 5_000, 10, 20, 10, 4)
    cv_f = roofline.kfold_flops(100_000, 5_000, 10, 20, 10)
    assert roofline.least_seconds(cv_b, cv_f) == pytest.approx(cv_f / 67e12)
    assert 2.5e12 < cv_f < 2.6e12
