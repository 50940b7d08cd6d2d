"""The port's kernel-PLS fit (pls_tpu_torch.models.kernel_pls) against the JAX package.

Every case makes its inputs from a seed with numpy and fits them with
`pls_tpu.models.kernel_pls.fit` and with the port's `fit`, in float64 on
the CPU.  W, P, R, Q and T agree to 1e-10 after aligning each component's
sign (an eigenvector's sign is arbitrary, so for M > 1 a component may
come out negated); the coefficients, which are sign-invariant, agree to
1e-10 directly.  The fit is also held against the reference's toy and nir
goldens as tests/test_fit_parity.py does (toy 1e-10, nir 1e-9), and
x_storage="bf16" against the f64 fit within the tests/test_bf16.py budget
(coefficients 2e-2 relative, explained variance 2e-3 absolute).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.models import kernel_pls as jax_kernel_pls
import pls_tpu_torch as tt
from pls_tpu_torch.models import kernel_pls


def _data(seed=0, n=40, k=12, m=2, a=4, noise=0.1):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + noise * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + noise * rng.normal(size=(n, m))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    return X, Y


def _signs(mine: np.ndarray, ref: np.ndarray) -> np.ndarray:
    s = np.sign(np.sum(mine * ref, axis=0))
    s[s == 0] = 1.0
    return s


def _assert_fits_equal(f_torch, f_jax, atol=1e-10):
    s = _signs(f_torch.W.numpy(), np.asarray(f_jax.W))
    for name in ("W", "P", "R", "Q", "T"):
        mine, ref = getattr(f_torch, name).numpy(), np.asarray(getattr(f_jax, name))
        assert mine.shape == ref.shape, name
        if mine.size:
            np.testing.assert_allclose(mine * s, ref, atol=atol, err_msg=name)
    np.testing.assert_allclose(
        tt.coefficients(f_torch).numpy(), np.asarray(pt.coefficients(f_jax)), atol=atol
    )
    assert f_torch.method.value == f_jax.method.value


CASES = {
    "type1_m1": dict(method="kernel1", m=1),
    "type1_m2": dict(method="kernel1", m=2),
    "type2_m1": dict(method="kernel2", m=1),
    "type2_m2": dict(method="kernel2", m=3),
    "row_mask": dict(method="kernel1", m=2, row_mask=True),
    "row_mask_type2": dict(method="kernel2", m=2, row_mask=True),
    "sample_weight": dict(method="kernel1", m=2, sample_weight=True),
    "power_iters": dict(method="kernel1", m=3, power_iters=60),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax(case):
    c = CASES[case]
    X, Y = _data(seed=len(case), m=c["m"])
    rng = np.random.default_rng(5)
    kw_np = {}
    if c.get("row_mask"):
        kw_np["row_mask"] = (rng.random(X.shape[0]) > 0.25).astype(np.float64)
    if c.get("sample_weight"):
        kw_np["sample_weight"] = rng.integers(0, 4, size=X.shape[0]).astype(np.float64)
    A = 5
    f_jax = jax_kernel_pls.fit(
        jnp.asarray(X), jnp.asarray(Y), A, pt.METHOD(c["method"]),
        power_iters=c.get("power_iters"), **{k: jnp.asarray(v) for k, v in kw_np.items()},
    )
    f_torch = kernel_pls.fit(
        torch.from_numpy(X), torch.from_numpy(Y), A, tt.METHOD(c["method"]),
        power_iters=c.get("power_iters"), **{k: torch.from_numpy(v) for k, v in kw_np.items()},
    )
    _assert_fits_equal(f_torch, f_jax)


@pytest.mark.parametrize("method", ["kernel1", "kernel2"])
def test_fit_folds_equal_single_fits(method):
    X, Y = _data(seed=11, n=24, k=9, m=2)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    masks = torch.from_numpy(np.random.default_rng(6).random((5, 24)) > 0.3)
    batched = kernel_pls.fit_folds(Xt, Yt, masks, 4, tt.METHOD(method))
    assert batched.W.shape == (5, 9, 4) and batched.Q.shape == (5, 2, 4)
    for f in range(5):
        single = kernel_pls.fit(Xt, Yt, 4, tt.METHOD(method), row_mask=masks[f])
        for name in ("W", "P", "R", "Q", "T"):
            np.testing.assert_allclose(
                getattr(batched, name)[f].numpy(), getattr(single, name).numpy(),
                atol=1e-12, err_msg=name,
            )


# the same values in layouts that are not contiguous (e.g. pandas' .values)
LAYOUTS = {
    "fortran": lambda X: X.T.contiguous().T,
    "row_slice": lambda X: X.repeat_interleave(2, dim=0)[::2],
    "column_slice": lambda X: X.repeat_interleave(2, dim=1)[:, ::2],
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fit_of_non_contiguous_x_matches_jax(layout):
    X, Y = _data(seed=3, m=2)
    Xt = LAYOUTS[layout](torch.from_numpy(X))
    assert not Xt.is_contiguous() and np.array_equal(Xt.numpy(), X)
    f_jax = jax_kernel_pls.fit(jnp.asarray(X), jnp.asarray(Y), 5)
    _assert_fits_equal(kernel_pls.fit(Xt, torch.from_numpy(Y), 5), f_jax)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cuda_fit_of_non_contiguous_x_takes_kernel(layout):
    # the kernel runs on the contiguous copy: the same fit, bit for bit
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from pls_tpu_torch.ops import deflate

    X, Y = _data(seed=3, n=200, k=40, m=2)
    Xc, Yc = torch.from_numpy(X).float().cuda(), torch.from_numpy(Y).float().cuda()
    Xs = LAYOUTS[layout](Xc)
    assert not Xs.is_contiguous() and torch.equal(Xs, Xc)
    before = deflate.launches["deflate_f32"]
    f_strided = kernel_pls.fit(Xs, Yc, 5)
    assert deflate.launches["deflate_f32"] == before + 5
    f_dense = kernel_pls.fit(Xc, Yc, 5)
    for name in ("W", "P", "Q", "R", "T"):
        assert torch.equal(getattr(f_strided, name), getattr(f_dense, name)), name


def test_bf16_storage_within_budget():
    X, Y = _data(seed=0, n=256, k=48, m=2, a=4)
    Xt, Yt = torch.from_numpy(X).float(), torch.from_numpy(Y).float()
    f16 = kernel_pls.fit(Xt, Yt, 4, x_storage="bf16")
    for name in ("W", "P", "Q", "R", "T"):
        assert getattr(f16, name).dtype == torch.float32
    f64 = pt.fit(jnp.asarray(X), jnp.asarray(Y), 4)
    B64 = np.asarray(pt.coefficients(f64))
    B16 = tt.coefficients(f16).double().numpy()
    assert np.abs(B16 - B64).max() / np.abs(B64).max() < 2e-2
    ev16 = tt.explained_variance(f16, Xt, Yt).double().numpy()
    ev64 = np.asarray(pt.explained_variance(f64, jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(ev16, ev64, atol=2e-3)
    # folds under bf16 storage: masked rows are exact zeros before rounding
    masks = torch.ones((2, 256), dtype=torch.bool)
    masks[1, 200:] = False
    ff = kernel_pls.fit_folds(Xt, Yt, masks, 3, x_storage="bf16")
    single = kernel_pls.fit(Xt[:200], Yt[:200], 3, x_storage="bf16")
    np.testing.assert_allclose(ff.W[1].numpy(), single.W.numpy(), atol=1e-5)


@pytest.mark.parametrize("name,A", [("toy", 2), ("nir", 10)])
def test_fit_matches_reference_goldens(name, A, golden):
    X, Y = (torch.from_numpy(golden(f"{name}_{v}z")) for v in ("X", "Y"))
    atol = 1e-10 if name == "toy" else 1e-9
    f1 = tt.fit(X, Y, A)
    np.testing.assert_allclose(tt.coefficients(f1).numpy(), golden(f"{name}_B"), atol=atol)
    np.testing.assert_allclose(tt.coefficients(f1, 1).numpy(), golden(f"{name}_B1"), atol=atol)
    T = tt.scores(f1, X).numpy()
    np.testing.assert_allclose(T * _signs(T, golden(f"{name}_T")), golden(f"{name}_T"), atol=atol)
    np.testing.assert_allclose(f1.T.numpy(), T, atol=1e-12)
    ev = np.stack([tt.explained_variance(f1, X, Y, c).numpy() for c in range(1, A + 1)])
    sse = np.stack([tt.sse(f1, X, Y, c).numpy() for c in range(1, A + 1)])
    np.testing.assert_allclose(ev, golden(f"{name}_ev"), atol=atol)
    np.testing.assert_allclose(sse, golden(f"{name}_sse"), atol=10 * atol)
    f2 = tt.fit(X, Y, A, tt.KERNEL_TYPE2)
    np.testing.assert_allclose(tt.coefficients(f2).numpy(), golden(f"{name}_t2_B"), atol=atol)
    assert f2.T.shape == (0, A)
    np.testing.assert_allclose(
        tt.coefficients_all_components(f1)[-1].numpy(), tt.coefficients(f1).numpy(), atol=1e-14
    )
    assert tt.loadings_x(f1, 1).shape == (X.shape[1], 1)
    assert tt.loadings_y(f1).shape == (Y.shape[1], A)


JAX_PRECISION_NAMES = ("highest", "float32", "high", "tensorfloat32", "default", "bfloat16")


@pytest.mark.parametrize("precision", JAX_PRECISION_NAMES)
@pytest.mark.parametrize("name,A", [("toy", 2), ("nir", 10)])
def test_fit_takes_every_jax_precision_name(name, A, precision, golden):
    """Each name `jax.default_matmul_precision` takes fits toy and nir and
    matches pls_tpu under the same name (float64 on the CPU, where the
    setting changes no product)."""
    X, Y = golden(f"{name}_Xz"), golden(f"{name}_Yz")
    f_jax = jax_kernel_pls.fit(jnp.asarray(X), jnp.asarray(Y), A, precision=precision)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    f_torch = kernel_pls.fit(torch.from_numpy(X), torch.from_numpy(Y), A, precision=precision)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
    _assert_fits_equal(f_torch, f_jax, atol=1e-10 if name == "toy" else 1e-9)


@pytest.mark.parametrize("precision,tf32", [
    ("highest", False), ("float32", False), ("high", True), ("tensorfloat32", True),
    ("default", True), ("bfloat16", True),
])
def test_precision_names_set_tf32_and_restore(precision, tf32):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for start in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = start
            with kernel_pls._prec_ctx(precision):
                assert torch.backends.cuda.matmul.allow_tf32 is tf32
                assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cuda.matmul.allow_tf32 is start
            assert torch.backends.cudnn.allow_tf32 is start
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("precision", ["fastest", "HIGHEST", "bogus"])
def test_precision_name_jax_refuses_raises(precision):
    X, Y = _data()
    with pytest.raises(ValueError):
        jax_kernel_pls.fit(jnp.asarray(X), jnp.asarray(Y), 2, precision=precision)
    with pytest.raises(ValueError, match="unknown precision"):
        tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 2, precision=precision)


def test_unported_options_raise():
    """The options once left for later (NIPALS, SIMPLS, "compensated",
    "dd") now fit as the JAX package does; what it refuses still raises."""
    X, Y = _data()
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    X, Y = torch.from_numpy(X), torch.from_numpy(Y)
    for method in (tt.METHOD.NIPALS, tt.METHOD.SIMPLS):
        f = tt.fit(X, Y, 2, method)
        assert f.method == method
        _assert_fits_equal(f, jax_kernel_pls.fit(Xj, Yj, 2, pt.METHOD(method.value)))
    for precision in ("compensated", "dd"):
        f = tt.fit(X, Y, 2, precision=precision)
        ref = jax_kernel_pls.fit(Xj, Yj, 2, precision=precision)
        np.testing.assert_allclose(tt.coefficients(f).numpy(), np.asarray(pt.coefficients(ref)),
                                   atol=1e-6)  # "dd": JAX's float32 pairs
    with pytest.raises(ValueError):
        tt.fit(X, Y, 2, precision="bogus")
    with pytest.raises(ValueError):
        tt.fit(X, Y, 13)  # A > K
    with pytest.raises(ValueError):
        tt.fit(X, Y, 2, x_storage="fp8")
    assert tt.fit(X, Y, 2, precision=None).A == 2


def test_model_facade_matches_jax(toy):
    X, Y = toy
    ref = pt.PLSModel(jnp.asarray(X), jnp.asarray(Y), pt.KERNEL_TYPE1, 2)
    mine = tt.PLSModel(torch.from_numpy(X), torch.from_numpy(Y), tt.KERNEL_TYPE1, 2)
    assert mine.A == 2 and mine.method == tt.KERNEL_TYPE1 and mine.fit_state.K == 15
    X_new, Y_new = X[:4] * 0.5, Y[:4]
    for name, args in [
        ("coefficients", (1,)), ("fitted_values", (X_new, 1)), ("residuals", (X_new, Y_new)),
        ("SSE", (X_new, Y_new, 2)), ("explained_variance", (None, None, 1)),
        ("residuals", ()),
    ]:
        a = getattr(mine, name)(*args).numpy()
        b = np.asarray(getattr(ref, name)(*(jnp.asarray(v) if isinstance(v, np.ndarray) else v for v in args)))
        np.testing.assert_allclose(a, b, atol=1e-10, err_msg=name)
    for a, b in zip(mine.explained_variance_profile(), ref.explained_variance_profile()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
    np.testing.assert_allclose(
        mine.cv_NEW_DATA(X_new, Y_new).errors.numpy(),
        np.asarray(ref.cv_NEW_DATA(jnp.asarray(X_new), jnp.asarray(Y_new)).errors), atol=1e-10,
    )
    out_mine, out_ref = io.StringIO(), io.StringIO()
    mine.print_explained_variance(file=out_mine)
    ref.print_explained_variance(file=out_ref)
    assert out_mine.getvalue() == out_ref.getvalue()
    assert mine.loadingsX(1).shape == (15, 1) and mine.loadingsY().shape == (2, 2)
    assert mine.scores().shape == (10, 2) and mine.T.shape == (10, 2)
    re = mine.refit(torch.from_numpy(X[:8]), torch.from_numpy(Y[:8]))
    assert re.A == 2 and re.X.shape == (8, 15)
    with pytest.raises(ValueError):
        tt.PLSModel(torch.from_numpy(X), torch.from_numpy(Y[:5]))
    with pytest.raises(ValueError):
        mine.coefficients(3)
