"""The port's float64 precision modes against the JAX package's targets.

precision="compensated" and "dd" run the kernel-PLS component loop in
float64 (models/kernel_pls.py, models/kernel_dd.py), where the JAX package
carries float32 pairs; `StatsAccumulator(compensated=True)` keeps float64
sums and exposes the JAX package's hi/lo pair fields.  The cases are the
JAX package's own (tests/test_fit_parity.py::TestCompensatedDeflation, the
deep-A noise-spectrum stress N = 256, K = 128, M = 3): compensated no
worse than 1.10 × plain float32 at A = 40, dd within 1e-4 of float64 at
A = 50, `fit_from_stats_dd` on hi/lo statistics within 1e-4 at A = 30;
and the compensated statistics within 1e-12 of the float64 truth, with
the JAX package's two refusals.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.models import kernel_pls as jkp
from pls_tpu.models.kernel_dd import fit_from_stats_dd as jax_fit_from_stats_dd
from pls_tpu.models.streaming import StatsAccumulator as JaxStatsAccumulator
import pls_tpu_torch as tt
from pls_tpu_torch.models import kernel_pls
from pls_tpu_torch.models.kernel_dd import fit_dd, fit_from_stats_dd
from pls_tpu_torch.models.streaming import StatsAccumulator
from pls_tpu_torch.tools import precision_at_scale

KERNELS = {"kernel1": (pt.KERNEL_TYPE1, tt.KERNEL_TYPE1), "kernel2": (pt.KERNEL_TYPE2, tt.KERNEL_TYPE2)}


def _hard_data():
    """tests/test_fit_parity.py:287-293."""
    rng = np.random.default_rng(0)
    N, K, M = 256, 128, 3
    L = rng.normal(size=(N, 60)) * (1.5 ** -np.arange(60))
    X = L @ rng.normal(size=(60, K)) + 0.01 * rng.normal(size=(N, K))
    Y = L @ rng.normal(size=(60, M)) + 0.01 * rng.normal(size=(N, M))
    return X, Y


def _B(f) -> np.ndarray:
    return tt.coefficients(f).double().numpy()


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("method", list(KERNELS))
def test_compensated_no_worse_than_plain_at_deep_A(method):
    X, Y = _hard_data()
    jm, tm = KERNELS[method]
    B64 = np.asarray(pt.coefficients(pt.fit(jnp.asarray(X), jnp.asarray(Y), 40, jm)))
    X32, Y32 = torch.from_numpy(X).float(), torch.from_numpy(Y).float()
    f = tt.fit(X32, Y32, 40, tm, precision="compensated")
    assert f.W.dtype == torch.float32
    e_comp = _rel(_B(f), B64)
    e_plain = _rel(_B(tt.fit(X32, Y32, 40, tm)), B64)
    e_jax_comp = _rel(pt.coefficients(pt.fit(jnp.asarray(X, jnp.float32),
                                             jnp.asarray(Y, jnp.float32), 40, jm,
                                             precision="compensated")), B64)
    assert e_comp <= 1.10 * e_plain, (e_comp, e_plain)
    assert e_comp <= 1.10 * e_jax_comp, (e_comp, e_jax_comp)  # at least as accurate as JAX's


@pytest.mark.parametrize("method", list(KERNELS))
def test_dd_hits_deep_A_target(method):
    X, Y = _hard_data()
    jm, tm = KERNELS[method]
    B64 = np.asarray(pt.coefficients(pt.fit(jnp.asarray(X), jnp.asarray(Y), 50)))
    X32, Y32 = torch.from_numpy(X).float(), torch.from_numpy(Y).float()
    f = tt.fit(X32, Y32, 50, tm, precision="dd")
    assert f.W.dtype == torch.float32 and f.method == tm
    e_dd = _rel(_B(f), B64)
    assert e_dd < 1e-4, e_dd
    assert _rel(_B(tt.fit(X32, Y32, 50, tm)), B64) > 1e-3  # the regime is real
    # the JAX package's pair loop on the same float32 inputs
    f_jax = pt.fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), 50, jm,
                   precision="dd")
    assert _rel(_B(f), np.asarray(pt.coefficients(f_jax), np.float64)) < 1e-4
    # fit_dd is the routed function; float64 input keeps a float64 state
    f64 = fit_dd(torch.from_numpy(X), torch.from_numpy(Y), 50, method == "kernel1")
    assert f64.W.dtype == torch.float64
    np.testing.assert_allclose(_B(f64), _B(f), rtol=0, atol=1e-6 * np.abs(B64).max())


def test_dd_is_the_float64_fit_of_the_float32_rounded_data():
    X, Y = _hard_data()
    X32, Y32 = (torch.from_numpy(v).float() for v in (X, Y))
    for tm in (tt.KERNEL_TYPE1, tt.KERNEL_TYPE2):
        dd = tt.fit(X32.double(), Y32.double(), 20, tm, precision="dd")
        ref = tt.fit(X32.double(), Y32.double(), 20, tm)
        for name in ("W", "P", "Q", "R", "T"):
            assert torch.equal(getattr(dd, name), getattr(ref, name)), name
        # float64 input with digits past float32: dd rounds it first, as JAX
        dd = tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 20, tm, precision="dd")
        np.testing.assert_array_equal(_B(dd), _B(ref))


def test_dd_from_pair_stats():
    """tests/test_fit_parity.py::test_dd_from_pair_stats: float64 XX/XY split
    into float32 hi/lo parts reproduce the float64 fit at A = 30."""
    X, Y = _hard_data()
    XX64, XY64 = X.T @ X, X.T @ Y
    B64 = np.asarray(pt.coefficients(jkp.fit_from_stats(jnp.asarray(XX64), jnp.asarray(XY64), 30)))
    xxh = XX64.astype(np.float32)
    xxl = (XX64 - xxh.astype(np.float64)).astype(np.float32)
    xyh = XY64.astype(np.float32)
    xyl = (XY64 - xyh.astype(np.float64)).astype(np.float32)
    t = torch.from_numpy
    f = fit_from_stats_dd(t(xxh), t(xyh), 30, XX_lo=t(xxl), XY_lo=t(xyl))
    assert f.W.dtype == torch.float32 and f.method == tt.KERNEL_TYPE2
    e = _rel(_B(f), B64)
    assert e < 1e-4, e
    f_jax = jax_fit_from_stats_dd(xxh, xyh, 30, XX_lo=xxl, XY_lo=xyl)
    assert e <= 1.10 * _rel(pt.coefficients(f_jax), B64) + 1e-6
    # without the lo parts the statistics are the float32 hi parts alone
    f_hi = fit_from_stats_dd(t(xxh), t(xyh), 30)
    assert _rel(_B(f_hi), B64) > e
    # fit_from_stats(precision="dd") routes there
    np.testing.assert_array_equal(_B(tt.fit_from_stats(t(xxh), t(xyh), 30, precision="dd")),
                                  _B(f_hi))


@pytest.mark.parametrize("precision", ["compensated", "dd"])
def test_from_stats_fits_run_in_float64(precision):
    X, Y = _hard_data()
    X32, Y32 = torch.from_numpy(X).float(), torch.from_numpy(Y).float()
    XX, XY = X32.T @ X32, X32.T @ Y32
    ref = tt.fit_from_stats(XX.double(), XY.double(), 10)
    f = tt.fit_from_stats(XX, XY, 10, precision=precision)
    assert f.W.dtype == torch.float32
    np.testing.assert_allclose(_B(f), _B(ref), rtol=0, atol=1e-6 * np.abs(_B(ref)).max())
    # the downdated fits: LOO row 3 and a block of rows 5..9
    x, y = X32[3], Y32[3]
    ref = tt.fit_from_stats(XX.double() - torch.outer(x, x).double(),
                            XY.double() - torch.outer(x, y).double(), 10)
    f = tt.fit_from_stats_downdated(XX, XY, x, y, 10, precision=precision)
    np.testing.assert_allclose(_B(f), _B(ref), rtol=0, atol=1e-6 * np.abs(_B(ref)).max())
    Xf, Yf = X32[5:10], Y32[5:10]
    ref = tt.fit_from_stats(XX.double() - (Xf.T @ Xf).double(), XY.double() - (Xf.T @ Yf).double(),
                            10)
    f = tt.fit_from_stats_blockdowndated(XX, XY, Xf, Yf, 10, precision=precision)
    np.testing.assert_allclose(_B(f), _B(ref), rtol=0, atol=1e-5 * np.abs(_B(ref)).max())
    # the JAX package's compensated statistics fit agrees within float32
    if precision == "compensated":
        f_jax = jkp.fit_from_stats(jnp.asarray(XX.numpy()), jnp.asarray(XY.numpy()), 10,
                                   precision="compensated")
        assert _rel(_B(tt.fit_from_stats(XX, XY, 10, precision=precision)),
                    np.asarray(pt.coefficients(f_jax), np.float64)) < 1e-3


@pytest.mark.parametrize("precision", ["compensated", "dd"])
def test_fold_batches_and_cv_run_in_float64(precision):
    X, Y = _hard_data()
    X32, Y32 = torch.from_numpy(X[:64, :32]).float(), torch.from_numpy(Y[:64]).float()
    masks = torch.ones((3, 64))
    masks[1, :10] = 0
    masks[2, 30:] = 0
    folds = tt.fit_folds(X32, Y32, masks, 8, precision=precision)
    assert folds.W.dtype == torch.float32 and folds.W.shape == (3, 32, 8)
    for f in range(3):
        single = tt.fit(X32, Y32, 8, precision=precision, row_mask=masks[f])
        ref = tt.fit(X32.double(), Y32.double(), 8, row_mask=masks[f].double())
        np.testing.assert_allclose(tt.coefficients(folds)[f].double().numpy(), _B(single),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(_B(single), _B(ref), rtol=0, atol=1e-5 * np.abs(_B(ref)).max())
    loo = tt.cv_loo(X32, Y32, 4, precision=precision).errors
    ref = tt.cv_loo(X32.double(), Y32.double(), 4).errors
    assert loo.dtype == torch.float32
    np.testing.assert_allclose(loo.double().numpy(), ref.numpy(), atol=1e-5)
    kf = tt.cv_kfold_downdate(X32, Y32, 4, k=4, key=1, precision=precision).errors
    ref = tt.cv_kfold_downdate(X32.double(), Y32.double(), 4, k=4, key=1).errors
    np.testing.assert_allclose(kf.double().numpy(), ref.numpy(), atol=1e-4)


def test_dd_refusals_match_jax():
    X, Y = _hard_data()
    X32, Y32 = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
    with pytest.raises(ValueError, match="dd") as ej:
        pt.fit(X32, Y32, 4, precision="dd", x_storage="bf16")
    with pytest.raises(ValueError, match="dd") as et:
        tt.fit(torch.from_numpy(X).float(), torch.from_numpy(Y).float(), 4, precision="dd",
               x_storage="bf16")
    assert str(et.value) == str(ej.value)


def test_dd_shallow_matches_plain():
    X, Y = _hard_data()
    X32, Y32 = torch.from_numpy(X).float(), torch.from_numpy(Y).float()
    B_dd, B_pl = _B(tt.fit(X32, Y32, 5, precision="dd")), _B(tt.fit(X32, Y32, 5))
    assert _rel(B_dd, B_pl) < 1e-4


def test_precision_names_take_highest_products():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        for name in kernel_pls.F64_PRECISIONS:
            with kernel_pls._prec_ctx(name):
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------- compensated statistics ----------
def _chunks(seed=0, n_chunks=6, rows=512, K=16, M=3, offset=50.0):
    rng = np.random.default_rng(seed)
    return [((offset + rng.normal(size=(rows, K))).astype(np.float32),
             rng.normal(size=(rows, M)).astype(np.float32)) for _ in range(n_chunks)]


def test_compensated_stats_within_1e12_of_float64():
    chunks = _chunks()
    acc = StatsAccumulator(16, 3, compensated=True, device="cpu")
    plain = StatsAccumulator(16, 3, precision="highest", device="cpu")
    jax_acc = JaxStatsAccumulator(16, 3, jnp.float32, compensated=True)
    XX64, XY64 = np.zeros((16, 16)), np.zeros((16, 3))
    for Xc, Yc in chunks:
        acc.update(Xc, Yc)
        plain.update(Xc, Yc)
        jax_acc.update(Xc, Yc)
        XX64 += Xc.astype(np.float64).T @ Xc.astype(np.float64)
        XY64 += Xc.astype(np.float64).T @ Yc.astype(np.float64)
    for hi, lo, truth in ((acc.XX, acc.XXe, XX64), (acc.XY, acc.XYe, XY64)):
        assert hi.dtype == lo.dtype == torch.float32
        got = hi.double().numpy() + lo.double().numpy()
        assert np.abs(got - truth).max() / np.abs(truth).max() <= 1e-12
        assert torch.equal(hi, torch.from_numpy(truth).float())  # hi: the sum rounded
    e_comp = _rel(acc.XX.double() + acc.XXe.double(), XX64)
    e_jax = _rel(np.asarray(jax_acc.XX, np.float64) + np.asarray(jax_acc.XXe, np.float64), XX64)
    assert e_comp <= e_jax + 1e-15  # at least as accurate as the JAX package's pairs
    assert _rel(plain.XX.double(), XX64) > 1e-9  # and the plain sum is not
    for name in ("YY", "sx", "sy"):
        np.testing.assert_allclose(getattr(acc, name).numpy(), np.asarray(getattr(jax_acc, name)),
                                   rtol=1e-6)
    assert acc.n == 6 * 512
    # the fit reads the hi parts, as the JAX package's; the lo parts feed fit_from_stats_dd
    np.testing.assert_array_equal(_B(acc.fit(4)), _B(tt.fit_from_stats(acc.XX, acc.XY, 4)))
    f = fit_from_stats_dd(acc.XX, acc.XY, 4, XX_lo=acc.XXe, XY_lo=acc.XYe)
    ref = tt.fit_from_stats(torch.from_numpy(XX64), torch.from_numpy(XY64), 4)
    np.testing.assert_allclose(_B(f), _B(ref), rtol=0, atol=1e-6 * np.abs(_B(ref)).max())


def test_compensated_stats_merge_and_refusals():
    chunks = _chunks(seed=1)
    whole = StatsAccumulator(16, 3, compensated=True, device="cpu")
    a = StatsAccumulator(16, 3, compensated=True, device="cpu")
    b = StatsAccumulator(16, 3, compensated=True, device="cpu")
    for i, (Xc, Yc) in enumerate(chunks):
        whole.update(Xc, Yc)
        (a if i % 2 else b).update(Xc, Yc)
    a.merge(b)
    for name in ("XX", "XY"):
        got = getattr(a, name).double() + getattr(a, name + "e").double()
        ref = getattr(whole, name).double() + getattr(whole, name + "e").double()
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-14
    plain = StatsAccumulator(16, 3, device="cpu")
    for mine, ref in ((lambda: a.merge(plain), lambda: JaxStatsAccumulator(
            16, 3, compensated=True).merge(JaxStatsAccumulator(16, 3))),
                      (lambda: StatsAccumulator(16, 3, compensated=True, x_storage="bf16",
                                                device="cpu"),
                       lambda: JaxStatsAccumulator(16, 3, compensated=True, x_storage="bf16"))):
        with pytest.raises(ValueError) as ej:
            ref()
        with pytest.raises(ValueError) as et:
            mine()
        assert str(et.value) == str(ej.value)
    assert plain.XXe.numel() == 0 and plain.XYe.numel() == 0


def test_stats_from_npy_compensated(tmp_path):
    from pls_tpu_torch.utils import binio

    chunks = _chunks(seed=2, n_chunks=3, rows=300)
    X = np.concatenate([c[0] for c in chunks])
    Y = np.concatenate([c[1] for c in chunks])
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "Y.npy", Y)
    acc = binio.stats_from_npy(str(tmp_path / "X.npy"), str(tmp_path / "Y.npy"), chunk_rows=128,
                               compensated=True, device="cpu")
    truth = X.astype(np.float64).T @ X.astype(np.float64)
    assert acc.compensated and acc.n == 900
    assert _rel(acc.XX.double() + acc.XXe.double(), truth) <= 1e-12


def test_precision_at_scale_tool(capsys):
    rec = precision_at_scale.run(8 * 256, 256, 8, 2, seed=0, device=torch.device("cpu"))
    json.dumps(rec)
    assert rec["n_total"] == 2048 and rec["device"] == "cpu" and rec["card"] == "cpu"
    assert [c["n_chunks"] for c in rec["curves"]][-1] == 8
    last = rec["curves"][-1]
    assert last["xx_err_comp"] <= 1e-12 and last["xy_err_comp"] <= 1e-12
    assert last["xx_err_plain"] > last["xx_err_comp"]
    if not torch.cuda.is_available():
        assert precision_at_scale.main(["--n", "1000"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
