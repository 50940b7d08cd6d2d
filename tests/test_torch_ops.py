"""The port's small host-side and numerical modules against the JAX package.

Covers pls_tpu_torch.ops.{stats, special, eigen, wilcoxon} and
pls_tpu_torch.utils.{io, gcc_rng, reporting}.  Inputs are made from a seed
with numpy and passed to both packages as the same arrays.

Tolerances: float64 throughout.  Statistics 1e-12 (another summation
order); the A&S normal CDF and the Wilcoxon p-values are exact (the same
operations in the same order; the rank sum is exact in both); eigenvectors
1e-10 after aligning signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.ops.eigen import dominant_eigenvector as jax_dominant_eigenvector
from pls_tpu.ops.special import normalcdf_exact
from pls_tpu.utils.gcc_rng import GccRng as JaxGccRng
from pls_tpu.utils.reporting import format_eigen as jax_format_eigen
from pls_tpu.utils.reporting import format_eigen_complex as jax_format_eigen_complex
from pls_tpu_torch.ops import special, stats, wilcoxon
from pls_tpu_torch.ops.eigen import dominant_eigenvector
from pls_tpu_torch.utils import io, reporting
from pls_tpu_torch.utils.gcc_rng import GccRng


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def test_stats_match_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 6)) * 3 + 1
    X[:, 2] = 4.0  # a constant column z-scores to exactly 0 (DEVIATIONS.md #2)
    for name in ("sst", "colwise_stdev", "colwise_z_scores"):
        mine = getattr(stats, name)(_t(X)).numpy()
        ref = np.asarray(getattr(pt, name)(jnp.asarray(X)))
        np.testing.assert_allclose(mine, ref, rtol=1e-12, atol=1e-12, err_msg=name)
    assert np.all(stats.colwise_z_scores(_t(X)).numpy()[:, 2] == 0.0)
    mean, sd = X.mean(0), X.std(0, ddof=1)
    np.testing.assert_allclose(
        stats.z_scores(_t(X[0]), _t(mean), _t(sd)).numpy(),
        np.asarray(pt.z_scores(jnp.asarray(X[0]), jnp.asarray(mean), jnp.asarray(sd))),
        rtol=1e-12, atol=1e-12,
    )
    assert stats.sst(_t(X[:1])).tolist() == [0.0] * 6  # N < 2 convention
    assert stats.colwise_z_scores(_t(X[:, 0])).shape == (30, 1)


def test_normalcdf_bit_parity(golden):
    table = golden("normalcdf")
    z = np.concatenate([table[:, 0], np.linspace(-8, 8, 1001)])
    mine = special.normalcdf(_t(z)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(pt.normalcdf(jnp.asarray(z))))
    np.testing.assert_allclose(mine[: len(table)], table[:, 1], atol=1e-13)
    np.testing.assert_allclose(
        special.normalcdf_exact(_t(z)).numpy(), np.asarray(normalcdf_exact(jnp.asarray(z))),
        rtol=1e-12, atol=1e-15,
    )


def test_wilcoxon_matches_jax_and_reference(golden):
    errs = golden("nir_loo_resid_y0")  # (60, 10)
    A = errs.shape[1]
    E = _t(errs.T)  # (A, n)
    mine = wilcoxon.wilcoxon(E[:, None, :].expand(A, A, -1), E[None, :, :].expand(A, A, -1))
    np.testing.assert_allclose(mine.numpy(), golden("nir_wilcoxon"), atol=1e-12)
    ref = np.array([[float(pt.wilcoxon(jnp.asarray(errs[:, i]), jnp.asarray(errs[:, j])))
                     for j in range(A)] for i in range(A)])
    np.testing.assert_array_equal(mine.numpy(), ref)
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 257))
    b[:40] = -a[:40]  # ties in |err_1| - |err_2|, broken stably by both
    assert float(wilcoxon.wilcoxon(_t(a), _t(b))) == float(pt.wilcoxon(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("power_iters", [None, 40])
def test_dominant_eigenvector_batched(power_iters):
    rng = np.random.default_rng(2)
    B = rng.normal(size=(5, 4, 4))
    C = B @ np.swapaxes(B, 1, 2)  # symmetric PSD
    mine = dominant_eigenvector(_t(C), power_iters).numpy()
    for k in range(5):
        ref = np.asarray(jax_dominant_eigenvector(jnp.asarray(C[k]), power_iters))
        s = np.sign(mine[k] @ ref)
        np.testing.assert_allclose(mine[k] * s, ref, atol=1e-10)


def test_read_matrix_file(tmp_path):
    good = tmp_path / "x.csv"
    good.write_text("1,2,3\n4,5,6\n")
    np.testing.assert_array_equal(io.read_matrix_file(str(good)), [[1, 2, 3], [4, 5, 6]])
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n4,5\n")
    with pytest.raises(io.RaggedMatrixError) as e:
        io.read_matrix_file(str(bad))
    assert str(e.value) == "Error: row 1 has 2 columns, but previous row(s) have 3 columns."
    assert e.value.exit_code == 1
    nonnum = tmp_path / "nn.csv"
    nonnum.write_text("1,a\n")
    with pytest.raises(ValueError, match="non-numeric"):
        io.read_matrix_file(str(nonnum))
    npy = tmp_path / "y.npy"
    np.save(npy, np.arange(4.0))
    assert io.read_matrix_file(str(npy)).shape == (4, 1)


def test_gcc_rng_partitions_match(golden):
    parts = GccRng().lso_partitions(60, 600)
    np.testing.assert_array_equal(parts, golden("nir_lso_parts").astype(int))
    np.testing.assert_array_equal(
        GccRng(7).lso_partitions(13, 50), JaxGccRng(7).lso_partitions(13, 50)
    )


def test_reporting_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(4, 3)) * 10.0 ** rng.integers(-7, 4, size=(4, 3))
    assert reporting.format_eigen(M) == jax_format_eigen(M)
    assert reporting.format_eigen_complex(M) == jax_format_eigen_complex(M)
