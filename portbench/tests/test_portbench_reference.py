"""The benchmark's plain reference and libstdc++ replay against the
reference CLI's own numbers (tests/golden/, read as data), on the CPU.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import gcc_rng, inputs
from portbench.reference import pls as ref

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden"


def golden(name: str) -> np.ndarray:
    return np.loadtxt(GOLDEN / f"{name}.csv", delimiter=",", ndmin=2)


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def aligned(a: np.ndarray, gold: np.ndarray) -> np.ndarray:
    """a with each column's sign matched to gold's."""
    return a * np.sign((a * gold).sum(0, keepdims=True))


@pytest.fixture(scope="module", params=["toy", "nir"])
def data(request):
    name = request.param
    A = {"toy": 2, "nir": 10}[name]
    X, Y = t(golden(f"{name}_Xz")), t(golden(f"{name}_Yz"))
    return name, X, Y, A


def test_z_scores_of_the_raw_files():
    X = t(inputs.csv_matrix("portbench/data/nir.csv"))
    np.testing.assert_allclose(ref.z_scores(X).numpy(), golden("nir_Xz"), atol=1e-12)


def test_kernel_pls_state_and_explained_variance(data):
    name, X, Y, A = data
    fit = ref.kernel_pls(X, Y, A)
    B = fit.coefficients()
    np.testing.assert_allclose(B[-1].numpy().reshape(golden(f"{name}_B").shape),
                               golden(f"{name}_B"), atol=1e-9)
    np.testing.assert_allclose(B[0].numpy().reshape(golden(f"{name}_B1").shape),
                               golden(f"{name}_B1"), atol=1e-9)
    T = fit.T.numpy()
    np.testing.assert_allclose(aligned(T, golden(f"{name}_T")), golden(f"{name}_T"), atol=1e-9)
    ev = ref.explained_variance(fit, X, Y).numpy()
    np.testing.assert_allclose(ev.ravel(), golden(f"{name}_ev").ravel(), atol=1e-9)


def test_kernel_2_from_the_statistics_equals_kernel_1(data):
    name, X, Y, A = data
    f1 = ref.kernel_pls(X, Y, A)
    f2 = ref.kernel_pls_from_stats(X.T @ X, X.T @ Y, A)
    np.testing.assert_allclose(f2.coefficients().numpy(), f1.coefficients().numpy(), atol=1e-9)
    np.testing.assert_allclose(f2.coefficients()[-1].numpy().reshape(golden(f"{name}_t2_B").shape),
                               golden(f"{name}_t2_B"), atol=1e-9)


def test_loo_and_its_choice(data):
    name, X, Y, A = data
    E = ref.loo_errors(X, Y, A)
    for m in range(Y.shape[1]):
        np.testing.assert_allclose(E[m].numpy(), golden(f"{name}_loo_resid_y{m}"), atol=1e-9)
    np.testing.assert_allclose(ref.press(E).numpy(), golden(f"{name}_loo_press").reshape(
        Y.shape[1], A), rtol=1e-10)
    np.testing.assert_allclose(ref.rmse(E).numpy(), golden(f"{name}_loo_rmse").reshape(
        Y.shape[1], A), rtol=1e-10)
    chosen = [min(s) for s in ref.admissible_counts(E)]
    assert all(len(s) == 1 for s in ref.admissible_counts(E))
    assert chosen == golden(f"{name}_loo_opt").ravel().astype(int).tolist()


def test_lso_on_the_reference_partitions(data):
    name, X, Y, A = data
    N = X.shape[0]
    trials = 10 * N
    parts = gcc_rng.lso_partitions(5489, N, trials)
    np.testing.assert_array_equal(parts, golden(f"{name}_lso_parts").astype(int))
    test = int(0.3 * N + 0.5)
    E = ref.lso_errors(X, Y, A, torch.from_numpy(parts), N - test)
    np.testing.assert_allclose(ref.rmse(E).numpy(), golden(f"{name}_lso_rmse").reshape(
        Y.shape[1], A), rtol=1e-9)
    assert [min(s) for s in ref.admissible_counts(E)] == golden(
        f"{name}_lso_opt").ravel().astype(int).tolist()


def test_calibration_is_the_cli_job_on_the_raw_files():
    X = t(inputs.csv_matrix("portbench/data/nir.csv"))
    Y = t(inputs.csv_matrix("portbench/data/octane.csv"))
    parts = torch.from_numpy(gcc_rng.lso_partitions(5489, 60, 600))
    out = ref.calibration(X, Y, 10, parts, 42)
    np.testing.assert_allclose(out["state"]["coefficients"].numpy(), golden("nir_B"), atol=1e-9)
    np.testing.assert_allclose(ref.rmse(out["loo"]).numpy().ravel(),
                               golden("nir_loo_rmse").ravel(), rtol=1e-10)
    np.testing.assert_allclose(ref.rmse(out["lso"]).numpy().ravel(),
                               golden("nir_lso_rmse").ravel(), rtol=1e-9)


def test_wilcoxon_and_normalcdf():
    errs = golden("nir_loo_resid_y0")
    A = errs.shape[1]
    mine = [[ref.wilcoxon(t(errs[:, i]), t(errs[:, j])) for j in range(A)] for i in range(A)]
    np.testing.assert_allclose(mine, golden("nir_wilcoxon"), atol=1e-12)
    table = golden("normalcdf")
    np.testing.assert_allclose([ref.normalcdf(z) for z in table[:, 0]], table[:, 1], atol=1e-13)


def test_admissible_counts_take_a_borderline_decision_both_ways():
    rng = np.random.default_rng(0)
    e = rng.normal(size=400)
    s = np.where(np.arange(400) % 20 < 11, 1.0, -1.0)  # 55 % of component 2's errors larger
    E = t(np.stack([3 * e, e * (1 + 0.01 * s), e]).T[None])  # (1, n, 3): 3 has least PRESS
    p = ref.wilcoxon(E[0, :, 2], E[0, :, 1])
    assert 0 < p < 1
    assert ref.admissible_counts(E, alpha=p - 1e-9) == [{2}]
    assert ref.admissible_counts(E, alpha=p + 1e-9) == [{3}]
    assert ref.admissible_counts(E, alpha=p + 1e-9, p_margin=1e-6) == [{2, 3}]
    press = ref.press(E)[0]
    near = float(press[1] / press[2] - 1)  # component 2's PRESS, just above the least
    assert 0 < near and ref.admissible_counts(E, alpha=1.0, press_margin=2 * near) == [{2, 3}]


def test_kfold_by_downdates_equals_refits_on_the_other_rows():
    X, Y = t(golden("nir_Xz")), t(golden("nir_Yz"))
    assign = torch.from_numpy(np.random.default_rng(3).permutation(np.arange(60) % 5))
    E = ref.kfold_errors(X, Y, assign, 5, 6)
    for f in range(5):
        rows = assign == f
        fit = ref.kernel_pls(X[~rows], Y[~rows], 6)
        want = ref.residuals(fit, X[rows], Y[rows]).permute(2, 0, 1)
        np.testing.assert_allclose(E[:, rows].numpy(), want.numpy(), atol=1e-9)


@pytest.mark.parametrize("n", [7, 10, 60, 128])
def test_shuffle_is_libstdcxx(n):
    gold = golden(f"shuffle{n}").astype(int)
    rng = gcc_rng.MT19937(5489)
    v = list(range(n))
    for row in gold:
        gcc_rng.shuffle(v, rng)
        np.testing.assert_array_equal(v, row)


def test_mt19937_is_libstdcxx():
    gold = golden("mt19937_raw").ravel().astype(np.uint64)
    rng = gcc_rng.MT19937(5489)
    np.testing.assert_array_equal([rng() for _ in range(len(gold))], gold)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 3 * 2**-11), 3.0e38, -2.5e-5])
    got = ref.to_tf32(x)
    assert got[:4].tolist() == [1.0, 1.0, 1 + 2**-9, -(1 + 2**-9)]
    y = torch.randn(1000, 7, generator=torch.Generator().manual_seed(0)).mT  # not contiguous
    r = ((ref.to_tf32(y) - y).abs() / y.abs()).max()
    assert 2**-13 < r <= 2**-11
    assert torch.isfinite(got).all()
