"""The port's cross-validation (pls_tpu_torch.cv) against the JAX package.

LOO and LSO (with the reference's GccRng partitions) run through both
packages on the same numpy arrays: the toy data and a small synthetic
case with M = 2.  The error tensors agree to 1e-10 in float64 (batched
folds sum in another order); `validation`, `optimal_num_components` and
the printed tables agree exactly.  The port alone is also held against
the reference's nir goldens (600-trial LSO, as the CLI runs it) to 1e-9.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu_torch.cv.validation import print_validation


def _synthetic(seed=3, n=24, k=10, m=2):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3))
    X = L @ rng.normal(size=(3, k)) + 0.3 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(3, m)) + 0.3 * rng.normal(size=(n, m))
    return (X - X.mean(0)) / X.std(0, ddof=1), (Y - Y.mean(0)) / Y.std(0, ddof=1)


def _data(name, golden):
    if name == "toy":
        return golden("toy_Xz"), golden("toy_Yz"), 2
    X, Y = _synthetic()
    return X, Y, 3


def _compare_residuals(mine: tt.Residual, ref, alpha=0.1):
    assert mine.method == ref.method
    np.testing.assert_allclose(mine.errors.numpy(), np.asarray(ref.errors), atol=1e-10)
    for out in (tt.RESS, tt.MSE):
        np.testing.assert_allclose(
            tt.validation(mine, out).numpy(),
            np.asarray(pt.validation(ref, pt.VALIDATION_OUTPUT(out.value))), rtol=1e-10,
        )
    np.testing.assert_array_equal(
        tt.optimal_num_components(mine, alpha).numpy(),
        np.asarray(pt.optimal_num_components(ref, alpha)),
    )
    buf_mine, buf_ref = io.StringIO(), io.StringIO()
    print_validation(mine, file=buf_mine, alpha=alpha)
    pt.print_validation(ref, file=buf_ref, alpha=alpha)
    assert buf_mine.getvalue() == buf_ref.getvalue()


@pytest.mark.parametrize("name", ["toy", "synthetic"])
@pytest.mark.parametrize("method", ["kernel1", "kernel2"])
def test_cv_loo_matches_jax(name, method, golden):
    X, Y, A = _data(name, golden)
    ref = pt.cv_loo(jnp.asarray(X), jnp.asarray(Y), A, pt.METHOD(method))
    mine = tt.cv_loo(torch.from_numpy(X), torch.from_numpy(Y), A, tt.METHOD(method), batch_size=7)
    _compare_residuals(mine, ref)


@pytest.mark.parametrize("name", ["toy", "synthetic"])
def test_cv_lso_matches_jax(name, golden):
    X, Y, A = _data(name, golden)
    trials = 10 * X.shape[0] if name == "toy" else 40
    parts = tt.GccRng().lso_partitions(X.shape[0], trials)
    ref = pt.cv_lso(jnp.asarray(X), jnp.asarray(Y), A, 0.3, trials, partitions=parts)
    mine = tt.cv_lso(torch.from_numpy(X), torch.from_numpy(Y), A, 0.3, trials, partitions=parts)
    _compare_residuals(mine, ref)
    for alpha in (1e-9, 0.5):
        np.testing.assert_array_equal(
            tt.optimal_num_components(mine, alpha).numpy(),
            np.asarray(pt.optimal_num_components(ref, alpha)),
        )


def test_toy_cv_matches_reference_goldens(toy, golden):
    X, Y = (torch.from_numpy(v) for v in toy)
    loo = tt.cv_loo(X, Y, 2)
    for k in range(2):
        np.testing.assert_allclose(loo.errors[k].numpy(), golden(f"toy_loo_resid_y{k}"), atol=1e-10)
    np.testing.assert_allclose(tt.validation(loo, tt.RESS).numpy(), golden("toy_loo_press"), atol=1e-10)
    lso = tt.PLSModel(X, Y, tt.KERNEL_TYPE1, 2).cv_LSO(0.3, 100, tt.GccRng())
    for k in range(2):
        np.testing.assert_allclose(lso.errors[k].numpy(), golden(f"toy_lso_resid_y{k}"), atol=1e-10)
    np.testing.assert_array_equal(
        tt.optimal_num_components(lso).numpy(), golden("toy_lso_opt").ravel().astype(int)
    )
    f = tt.fit(X, Y, 2)
    nd = tt.cv_new_data(f, X[5:], Y[5:])
    assert nd.method == "NEW DATA"
    for k in range(2):
        np.testing.assert_allclose(nd.errors[k].numpy(), golden(f"toy_newdata_resid_y{k}"), atol=1e-10)
    with pytest.raises(ValueError):
        tt.cv_new_data(f, X[:, :3], Y)


def test_nir_cv_matches_reference_goldens(nir, golden):
    X, Y = (torch.from_numpy(v) for v in nir)
    model = tt.PLSModel(X, Y, tt.KERNEL_TYPE1, 10)
    loo = model.cv_LOO()
    np.testing.assert_allclose(loo.errors[0].numpy(), golden("nir_loo_resid_y0"), atol=1e-9)
    np.testing.assert_allclose(
        tt.validation(loo, tt.MSE).sqrt().numpy(), golden("nir_loo_rmse"), atol=1e-9
    )
    assert tt.optimal_num_components(loo).tolist() == golden("nir_loo_opt").ravel().astype(int).tolist()
    lso = model.cv_LSO(0.3, 600, tt.GccRng())
    np.testing.assert_allclose(lso.errors[0].numpy(), golden("nir_lso_resid_y0"), atol=1e-9)
    np.testing.assert_allclose(
        tt.validation(lso, tt.MSE).sqrt().numpy(), golden("nir_lso_rmse"), atol=1e-9
    )
    assert tt.optimal_num_components(lso).tolist() == golden("nir_lso_opt").ravel().astype(int).tolist()


def test_lso_torch_generator(toy):
    X, Y = (torch.from_numpy(v) for v in toy)
    parts = tt.random_partitions(torch.Generator().manual_seed(4), 10, 8)
    assert parts.shape == (8, 10)
    assert all(sorted(p.tolist()) == list(range(10)) for p in parts)
    assert torch.equal(parts, tt.random_partitions(torch.Generator().manual_seed(4), 10, 8))
    model = tt.PLSModel(X, Y, tt.KERNEL_TYPE1, 2)
    a, b = model.cv_LSO(0.3, 8, 4), model.cv_LSO(0.3, 8, torch.Generator().manual_seed(4))
    assert a.errors.shape == (2, 8 * 3, 2)
    assert torch.equal(a.errors, b.errors)
    assert tt.lso_sizes(60, 0.3) == (42, 18)
    with pytest.raises(ValueError):
        tt.lso_sizes(10, 0.01)
    with pytest.raises(ValueError):
        tt.cv_lso(X, Y, 2, 0.3, 8)  # neither generator nor partitions


def test_bf16_storage_cv_within_budget(nir):
    X, Y = (torch.from_numpy(v) for v in nir)
    ref = tt.validation(tt.cv_loo(X, Y, 4), tt.MSE).sqrt()
    b16 = tt.validation(tt.cv_loo(X, Y, 4, x_storage="bf16"), tt.MSE).sqrt()
    assert b16.dtype == torch.float64  # f32 state, f64 data: promoted as in JAX
    assert float((b16 - ref).abs().max() / ref.abs().max()) < 2e-2
