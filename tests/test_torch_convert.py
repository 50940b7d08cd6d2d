"""Weights carried between the JAX package and the port (pls_tpu_torch.convert).

A model saved by `pls_tpu.PLSModel.save` and loaded by the port predicts
the same values, and the reverse holds too (float64, 1e-12: the same
weights, products in another order).  A fresh interpreter that imports
every module of the port has neither jax nor pls_tpu in sys.modules.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu_torch.convert import fit_from_numpy, fit_to_numpy

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data(toy):
    X, Y = toy
    X_new = np.random.default_rng(0).normal(size=(7, X.shape[1]))
    return X, Y, X_new


@pytest.mark.parametrize("method", ["kernel1", "kernel2"])
@pytest.mark.parametrize("include_data", [False, True])
def test_jax_save_port_load(tmp_path, data, method, include_data):
    X, Y, X_new = data
    path = str(tmp_path / "m.npz")
    ref = pt.PLSModel(jnp.asarray(X), jnp.asarray(Y), pt.METHOD(method), 2)
    ref.save(path, include_data=include_data)
    mine = tt.PLSModel.load(path, device="cpu")
    assert mine.method.value == method and mine.A == 2
    np.testing.assert_allclose(
        mine.fitted_values(X_new).numpy(), np.asarray(ref.fitted_values(jnp.asarray(X_new))),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        mine.scores(X_new, 1).numpy(), np.asarray(ref.scores(jnp.asarray(X_new), 1)), atol=1e-12
    )
    if include_data:
        np.testing.assert_allclose(
            mine.explained_variance().numpy(), np.asarray(ref.explained_variance()), atol=1e-12
        )
    else:
        with pytest.raises(ValueError, match="data-less"):
            mine.cv_LOO()


def test_port_save_jax_load(tmp_path, data):
    X, Y, X_new = data
    path = str(tmp_path / "m.npz")
    mine = tt.PLSModel(torch.from_numpy(X), torch.from_numpy(Y), tt.KERNEL_TYPE1, 2)
    mine.save(path, include_data=True)
    ref = pt.PLSModel.load(path)
    assert ref.method == pt.KERNEL_TYPE1 and ref.A == 2
    np.testing.assert_allclose(
        np.asarray(ref.fitted_values(jnp.asarray(X_new))), mine.fitted_values(X_new).numpy(),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(ref.residuals()), mine.residuals().numpy(), atol=1e-12
    )


def test_fit_numpy_roundtrip(data):
    X, Y, _ = data
    f_jax = pt.fit(jnp.asarray(X), jnp.asarray(Y), 2)
    arrays = {k: np.asarray(getattr(f_jax, k)) for k in "WPQRT"}
    f = fit_from_numpy(arrays, "kernel1", device="cpu")
    assert f.method == tt.KERNEL_TYPE1 and f.A == 2 and f.K == X.shape[1] and f.M == 2
    back = fit_to_numpy(f)
    for k in "WPQRT":
        np.testing.assert_array_equal(back[k], arrays[k])
    np.testing.assert_array_equal(
        tt.coefficients(f).numpy(), np.asarray(f_jax.R @ f_jax.Q.T)
    )


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pls_tpu_torch\n"
        "for m in pkgutil.walk_packages(pls_tpu_torch.__path__, 'pls_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'pls_tpu')))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
