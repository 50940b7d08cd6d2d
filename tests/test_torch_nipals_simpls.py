"""The port's NIPALS and SIMPLS (models/nipals.py, models/simpls.py) and the
`predict` diagnostics against the JAX package.

Inputs are made from a seed with numpy and fitted by `pls_tpu` and by the
port in float64 on the CPU.  Fits, their CV residuals (LOO, LSO on the
reference's partitions, k-fold) and the diagnostics agree to 1e-10.  The
batched NIPALS loop gives every fold its unbatched iterates: a fold batch
whose folds stop after different numbers of inner iterations equals the
per-fold fits to 1e-12.  The `gpu` cases run the fits on the card, where
the X pass of each component is the CUDA kernel K1: A launches per fit,
and the fit within 1e-5 of the same fit through the kernel's plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.cv.kfold import cv_kfold as jax_cv_kfold
from pls_tpu.models.nipals import fit_nipals as jax_fit_nipals
import pls_tpu_torch as tt
from pls_tpu_torch.models import nipals, simpls
from pls_tpu_torch.utils.gcc_rng import GccRng

METHODS = {"nipals": (pt.NIPALS, tt.NIPALS), "simpls": (pt.SIMPLS, tt.SIMPLS)}


def _data(seed=0, n=40, k=12, m=3, a=4, noise=0.3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + noise * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + noise * rng.normal(size=(n, m))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    return X, Y


def _signs(mine: np.ndarray, ref: np.ndarray) -> np.ndarray:
    s = np.sign(np.sum(mine * ref, axis=-2, keepdims=True))
    s[s == 0] = 1.0
    return s


def _assert_fits_equal(f_torch, f_jax, atol=1e-10):
    """Every state tensor after aligning each component's sign (an
    eigenvector's sign is arbitrary: SIMPLS with M > 1), and the
    sign-invariant coefficients directly."""
    s = _signs(f_torch.W.numpy(), np.asarray(f_jax.W))
    for name in ("W", "P", "R", "Q", "T"):
        mine, ref = getattr(f_torch, name).numpy(), np.asarray(getattr(f_jax, name))
        assert mine.shape == ref.shape, name
        np.testing.assert_allclose(mine * s, ref, atol=atol, err_msg=name)
    np.testing.assert_allclose(
        tt.coefficients(f_torch).numpy(), np.asarray(pt.coefficients(f_jax)), atol=atol
    )
    assert f_torch.method.value == f_jax.method.value


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("method", list(METHODS))
def test_fit_matches_jax(method, m):
    X, Y = _data(seed=m, m=m)
    jm, tm = METHODS[method]
    f_jax = pt.fit(jnp.asarray(X), jnp.asarray(Y), 6, jm)
    f_torch = tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 6, tm)
    _assert_fits_equal(f_torch, f_jax)
    # R maps X to the scores the fit stored
    np.testing.assert_allclose(tt.scores(f_torch, torch.from_numpy(X)).numpy(),
                               f_torch.T.numpy(), atol=1e-10)


@pytest.mark.parametrize("method", list(METHODS))
def test_masked_weighted_fit_matches_jax(method):
    X, Y = _data(seed=5)
    jm, tm = METHODS[method]
    mask = (np.arange(40) % 5 != 0).astype(np.float64)
    w = np.random.default_rng(1).integers(0, 3, size=40).astype(np.float64)
    f_jax = pt.fit(jnp.asarray(X), jnp.asarray(Y), 4, jm, row_mask=jnp.asarray(mask),
                   sample_weight=jnp.asarray(w))
    f_torch = tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 4, tm,
                     row_mask=torch.from_numpy(mask), sample_weight=torch.from_numpy(w))
    _assert_fits_equal(f_torch, f_jax)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("method", list(METHODS))
def test_cv_residuals_match_jax(method, m):
    """LOO, LSO (the reference's partitions) and k-fold residuals by batched
    masked refits of each method."""
    X, Y = _data(seed=10 + m, n=24, k=8, m=m)
    jm, tm = METHODS[method]
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), torch.from_numpy(X), torch.from_numpy(Y)
    ref = pt.cv_loo(Xj, Yj, 4, jm)
    mine = tt.cv_loo(Xt, Yt, 4, tm, batch_size=7)
    np.testing.assert_allclose(mine.errors.numpy(), np.asarray(ref.errors), atol=1e-10)
    parts = GccRng(5489).lso_partitions(24, 12)
    ref = pt.cv_lso(Xj, Yj, 4, 0.3, 12, jm, partitions=jnp.asarray(parts))
    mine = tt.cv_lso(Xt, Yt, 4, 0.3, 12, tm, partitions=torch.from_numpy(parts), batch_size=5)
    np.testing.assert_allclose(mine.errors.numpy(), np.asarray(ref.errors), atol=1e-10)
    ref = jax_cv_kfold(Xj, Yj, 4, k=4, method=jm, key=jax.random.key(2))
    mine = tt.cv_kfold(Xt, Yt, 4, k=4, method=tm, key=2)
    np.testing.assert_allclose(mine.errors.numpy(), np.asarray(ref.errors), atol=1e-10)


def test_batched_nipals_gives_each_fold_its_own_iterates():
    """Folds that stop after different numbers of inner iterations: the
    batch equals the per-fold fits, and each fold's count equals its
    unbatched count (no fold stopped early or iterated past its stop)."""
    X, Y = _data(seed=3, n=30, k=10, m=3, noise=0.8)
    masks = np.ones((5, 30))
    for f, rows in enumerate([slice(0, 3), slice(5, 15), slice(None, None, 3), slice(20, 30),
                              slice(1, 2)]):
        masks[f, rows] = 0
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    batch = tt.fit_folds(Xt, Yt, torch.from_numpy(masks), 4, tt.NIPALS)
    batch_iters = [list(c) for c in nipals.last_iterations]
    assert any(len(set(c)) > 1 for c in batch_iters), batch_iters
    for f in range(5):
        single = tt.fit(Xt, Yt, 4, tt.NIPALS, row_mask=torch.from_numpy(masks[f]))
        assert [c[f] for c in batch_iters] == list(nipals.last_iterations)
        for name in ("W", "P", "Q", "R", "T"):
            np.testing.assert_allclose(getattr(batch, name)[f].numpy(),
                                       getattr(single, name).numpy(), atol=1e-12, err_msg=name)


@pytest.mark.parametrize("max_iter", [1, 3, 500])
def test_nipals_iteration_cap_and_tol_match_jax(max_iter):
    X, Y = _data(seed=4, m=3, noise=0.8)
    ref = jax_fit_nipals(jnp.asarray(X), jnp.asarray(Y), 3, max_iter=max_iter, tol=1e-9)
    reads = nipals.counts["host_reads"]
    mine = nipals.fit_nipals(torch.from_numpy(X), torch.from_numpy(Y), 3, max_iter=max_iter,
                             tol=1e-9)
    assert all(i <= max_iter for i in nipals.last_iterations)
    # one host read per inner iteration and one to stop, per component
    assert nipals.counts["host_reads"] - reads == sum(nipals.last_iterations) + 3
    _assert_fits_equal(mine, ref)


def test_simpls_is_its_own_module_with_jax_buffer():
    X, Y = _data(seed=6, m=2)
    f = simpls.fit_simpls(torch.from_numpy(X), torch.from_numpy(Y), 5)
    # SIMPLS's scores are orthonormal and W = R
    T = f.T.numpy()
    np.testing.assert_allclose(T.T @ T, np.eye(5), atol=1e-12)
    assert torch.equal(f.W, f.R) and f.method == tt.SIMPLS


def test_nir_simpls_state_matches_jax(nir):
    """The nir state whose printed block has two borderline sixth digits
    (tests/test_torch_cli.py), held numerically at 1e-10 of its scale."""
    X, Y = nir
    f_jax = pt.fit(jnp.asarray(X), jnp.asarray(Y), 10, pt.SIMPLS)
    f_torch = tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 10, tt.SIMPLS)
    for name in ("W", "P", "Q", "R", "T"):
        ref = np.asarray(getattr(f_jax, name))
        err = np.abs(getattr(f_torch, name).numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-10, (name, err)
    B = np.asarray(pt.coefficients(f_jax))
    assert np.abs(tt.coefficients(f_torch).numpy() - B).max() / np.abs(B).max() < 1e-10


def test_method_refusals_match_jax():
    X, Y = _data()
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), torch.from_numpy(X), torch.from_numpy(Y)
    for jm, tm in METHODS.values():
        with pytest.raises(ValueError, match="requires a kernel method") as ej:
            pt.fit(Xj, Yj, 2, jm, x_storage="bf16")
        with pytest.raises(ValueError, match="requires a kernel method") as et:
            tt.fit(Xt, Yt, 2, tm, x_storage="bf16")
        assert str(et.value) == str(ej.value)
        with pytest.raises(ValueError):
            pt.fit(Xj, Yj, 2, jm, precision="dd")
        with pytest.raises(ValueError, match="dd"):
            tt.fit(Xt, Yt, 2, tm, precision="dd")
        # "compensated" reads as "highest" for these methods
        _assert_fits_equal(tt.fit(Xt, Yt, 3, tm, precision="compensated"),
                           pt.fit(Xj, Yj, 3, jm, precision="compensated"))
    with pytest.raises(ValueError, match="unknown method"):
        tt.fit(Xt, Yt, 2, tt.SPLS)


@pytest.mark.parametrize("method", list(METHODS))
def test_model_facade_matches_jax(method):
    X, Y = _data(seed=8, n=20, k=6, m=2)
    jm, tm = METHODS[method]
    ref = pt.PLSModel(jnp.asarray(X), jnp.asarray(Y), jm, 3)
    mine = tt.PLSModel(torch.from_numpy(X), torch.from_numpy(Y), tm, 3)
    _assert_fits_equal(mine.fit_state, ref.fit_state)
    np.testing.assert_allclose(mine.cv_LOO().errors.numpy(), np.asarray(ref.cv_LOO().errors),
                               atol=1e-10)
    np.testing.assert_allclose(mine.cv_KFOLD(4, key=1).errors.numpy(),
                               np.asarray(ref.cv_KFOLD(4, key=jax.random.key(1)).errors),
                               atol=1e-10)
    other = METHODS["simpls" if method == "nipals" else "nipals"]
    _assert_fits_equal(mine.refit(torch.from_numpy(X), torch.from_numpy(Y), other[1]).fit_state,
                       ref.refit(jnp.asarray(X), jnp.asarray(Y), other[0]).fit_state)
    with pytest.raises(ValueError, match="downdate"):
        mine.cv_LOO(downdate=True)


# ---------- predict diagnostics ----------
@pytest.mark.parametrize("method", ["kernel1", "kernel2", "nipals", "simpls"])
def test_vip_matches_jax(method):
    X, Y = _data(seed=9, m=2)
    jm, tm = pt.METHOD(method), tt.METHOD(method)
    f_jax = pt.fit(jnp.asarray(X), jnp.asarray(Y), 4, jm)
    f_torch = tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 4, tm)
    for comp in (None, 2):
        ref = np.asarray(pt.vip(f_jax, jnp.asarray(X), comp))
        mine = tt.vip(f_torch, torch.from_numpy(X), comp).numpy()
        np.testing.assert_allclose(mine, ref, atol=1e-10)
        np.testing.assert_allclose(np.mean(mine**2), 1.0, atol=1e-10)  # mean VIP² is 1
    if method == "kernel2":  # no stored scores: X is needed
        with pytest.raises(ValueError, match="pass X"):
            tt.vip(f_torch)
    else:
        np.testing.assert_allclose(tt.vip(f_torch).numpy(), np.asarray(pt.vip(f_jax)), atol=1e-10)


@pytest.mark.parametrize("method", ["kernel1", "kernel2", "simpls"])
def test_target_projection_and_selectivity_ratio_match_jax(method):
    X, Y = _data(seed=11, m=3)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    f_jax = pt.fit(Xj, jnp.asarray(Y), 5, pt.METHOD(method))
    f_torch = tt.fit(Xt, torch.from_numpy(Y), 5, tt.METHOD(method))
    for comp, y_col in ((None, 0), (3, 2)):
        (tj, pj), (tm, pm) = (pt.target_projection(f_jax, Xj, comp, y_col),
                              tt.target_projection(f_torch, Xt, comp, y_col))
        np.testing.assert_allclose(tm.numpy(), np.asarray(tj), atol=1e-10)
        np.testing.assert_allclose(pm.numpy(), np.asarray(pj), atol=1e-10)
        np.testing.assert_allclose(tt.selectivity_ratio(f_torch, Xt, comp, y_col).numpy(),
                                   np.asarray(pt.selectivity_ratio(f_jax, Xj, comp, y_col)),
                                   rtol=1e-9, atol=1e-10)
    Xz = X.copy()
    Xz[:, 3] = 0.0  # a zero column: its residual is 0, read as 1
    f_torch = tt.fit(torch.from_numpy(Xz), torch.from_numpy(Y), 3, tt.METHOD(method))
    assert tt.selectivity_ratio(f_torch, torch.from_numpy(Xz))[3] == 0.0


# ---------- on the card: K1 on the SIMPLS and NIPALS paths ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from pls_tpu_torch.ops import deflate

    return deflate


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(METHODS))
def test_cuda_fit_launches_k1_and_matches_plain_twin(method, monkeypatch):
    deflate = _card()
    # eight strong latent directions for six components: SIMPLS in float32
    # amplifies a pass's rounding past 1e-5 once a component is noise
    X, Y = _data(seed=12, n=3000, k=300, m=3, a=8, noise=0.05)
    Xc, Yc = torch.from_numpy(X).float().cuda(), torch.from_numpy(Y).float().cuda()
    tm = METHODS[method][1]
    before = deflate.launches["deflate_f32"]
    f = tt.fit(Xc, Yc, 6, tm)
    torch.cuda.synchronize()
    assert deflate.launches["deflate_f32"] - before == 6
    monkeypatch.setattr(deflate, "deflate_pass", deflate.deflate_pass_plain)
    from pls_tpu_torch.models import kernel_pls

    monkeypatch.setattr(kernel_pls, "deflate_pass", deflate.deflate_pass_plain)
    before = deflate.launches["deflate_f32"]
    f_plain = tt.fit(Xc, Yc, 6, tm)
    assert deflate.launches["deflate_f32"] == before
    B, Bp = tt.coefficients(f), tt.coefficients(f_plain)
    assert float((B - Bp).abs().max() / Bp.abs().max()) < 1e-5
    s = torch.sign((f.T * f_plain.T).sum(0))
    assert float((f.T * s - f_plain.T).abs().max() / f_plain.T.abs().max()) < 1e-5


@pytest.mark.gpu
def test_cuda_fit_folds_take_no_kernel():
    deflate = _card()
    X, Y = _data(seed=13, n=200, k=40, m=2)
    Xc, Yc = torch.from_numpy(X).float().cuda(), torch.from_numpy(Y).float().cuda()
    masks = torch.ones((3, 200), device="cuda")
    masks[1, :50] = 0
    before = deflate.launches["deflate_f32"]
    for tm in (tt.NIPALS, tt.SIMPLS):
        f = tt.fit_folds(Xc, Yc, masks, 4, tm)
        single = tt.fit(Xc[50:], Yc[50:], 4, tm)
        B1, Bs = tt.coefficients(f)[1], tt.coefficients(single)
        assert float((B1 - Bs).abs().max() / Bs.abs().max()) < 1e-4
    # the single fits launch K1 (4 each); the batches take batched products
    assert deflate.launches["deflate_f32"] - before == 8
