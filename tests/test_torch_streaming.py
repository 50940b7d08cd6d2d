"""The port's streaming statistics (pls_tpu_torch.models.streaming) against the JAX package.

The same numpy data, in chunks, go through `pls_tpu.models.streaming` and
its port: StatsAccumulator (float64, and bf16 storage on float32 data at
1e-6), merge, zscore_stats, zscore_fold_stats, FoldStatsAccumulator with
single-fold and mixed chunks, collect_moments at a large mean,
fit_streaming, fit_streaming_csv, and `convert.stats_from_numpy`.  Float64
results agree to 1e-10 relative; fits are compared through their
coefficients (sign-free).  The port's side is asked for the CPU
(`device="cpu"`): without it every entry point runs on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu.models.streaming as js
import pls_tpu_torch as tt
import pls_tpu_torch.models.streaming as ts
from pls_tpu_torch.convert import stats_from_numpy

RTOL = 1e-10


def _raw(seed=21, n=300, K=12, M=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 4))
    X = L @ rng.normal(size=(4, K)) + 0.5 * rng.normal(size=(n, K)) + rng.uniform(0.5, 3, K)
    Y = L @ rng.normal(size=(4, M)) + 0.2 * rng.normal(size=(n, M)) - 2.0
    return X.astype(dtype), Y.astype(dtype)


def _chunks(X, Y, size):
    for i in range(0, X.shape[0], size):
        yield X[i : i + size], Y[i : i + size]


def _close(mine, ref, rtol=RTOL):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    ref = np.asarray(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref).max()))


def _coef(fit_t, fit_j):
    _close(tt.coefficients(fit_t), pt.coefficients(fit_j))


def _accumulate(mod, X, Y, size, **kw):
    acc = mod.StatsAccumulator(X.shape[1], Y.shape[1], **kw)
    for Xc, Yc in _chunks(X, Y, size):
        acc.update(Xc, Yc)
    return acc


@pytest.mark.parametrize("size", [7, 64, 300])
def test_stats_accumulator_f64(size):
    X, Y = _raw()
    mine = _accumulate(ts, torch.from_numpy(X), torch.from_numpy(Y), size, dtype=torch.float64,
                       device="cpu")
    ref = _accumulate(js, jnp.asarray(X), jnp.asarray(Y), size, dtype=jnp.float64)
    for name in ("XX", "XY", "YY", "sx", "sy"):
        _close(getattr(mine, name), getattr(ref, name))
    assert mine.n == int(ref.n) == 300
    _close(mine.XX, X.T @ X)
    for zscore in (False, True):
        _coef(mine.fit(4, zscore=zscore), ref.fit(4, zscore=zscore))


def test_stats_accumulator_bf16_storage():
    X, Y = _raw(dtype=np.float32)
    mine = _accumulate(ts, X, Y, 64, x_storage="bf16", device="cpu")
    ref = _accumulate(js, X, Y, 64, x_storage="bf16")
    for name in ("XX", "XY", "YY", "sx", "sy"):
        assert getattr(mine, name).dtype == torch.float32
        _close(getattr(mine, name), getattr(ref, name), rtol=1e-6)
    # the rounding is real: bf16 storage differs from the float32 sums
    assert float((mine.XX - torch.from_numpy(X.T @ X)).abs().max()) > 1e-3


def test_stats_accumulator_options():
    acc = ts.StatsAccumulator(3, 1, compensated=True, device="cpu")
    acc.update(np.ones((2, 3), np.float32), np.ones(2, np.float32))
    assert acc.compensated and acc.XXe.shape == (3, 3) and float(acc.XX[0, 0]) == 2.0
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.StatsAccumulator(3, 1, compensated=True, x_storage="bf16", device="cpu")
    with pytest.raises(ValueError, match="x_storage"):
        ts.StatsAccumulator(3, 1, x_storage="fp8", device="cpu")
    acc = ts.StatsAccumulator(4, 1, torch.float64, device="cpu").update(np.ones((3, 4)), np.ones(3))
    assert acc.XY.shape == (4, 1) and acc.n == 3


def test_merge_equals_single_pass():
    X, Y = (torch.from_numpy(v) for v in _raw())
    a = _accumulate(ts, X[:110], Y[:110], 50, dtype=torch.float64, device="cpu")
    b = _accumulate(ts, X[110:], Y[110:], 50, dtype=torch.float64, device="cpu")
    whole = _accumulate(ts, X, Y, 300, dtype=torch.float64, device="cpu")
    a.merge(b)
    for name in ("XX", "XY", "YY", "sx", "sy"):
        _close(getattr(a, name), getattr(whole, name).numpy())
    assert a.n == 300


def test_zscore_stats_matches_jax():
    X, Y = _raw()
    S = (X.T @ X, X.T @ Y, X.sum(0), Y.sum(0), X.shape[0])
    mine = ts.zscore_stats(*(torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in S),
                           YY=torch.from_numpy(Y.T @ Y))
    ref = js.zscore_stats(*(jnp.asarray(v) for v in S), YY=jnp.asarray(Y.T @ Y))
    for m, r in zip(mine, ref):
        _close(m, r)
    Xz = (X - X.mean(0)) / X.std(0, ddof=1)
    _close(mine[0], Xz.T @ Xz, rtol=1e-9)
    no_yy = ts.zscore_stats(*(torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in S))
    assert no_yy[2] is None and torch.equal(no_yy[6], torch.ones(3, dtype=torch.float64))


def _assign(kind, n=300, k=4):
    if kind == "blocks":
        return np.repeat(np.arange(k), n // k)
    return np.asarray(tt.kfold_assignments(n, k, 5))


@pytest.mark.parametrize("kind,size", [("blocks", 25), ("blocks", 40), ("random", 33)])
def test_fold_stats_accumulator_matches_jax(kind, size):
    X, Y = _raw()
    a = _assign(kind)
    mine = ts.FoldStatsAccumulator(12, 3, 4, torch.float64, device="cpu")
    ref = js.FoldStatsAccumulator(12, 3, 4, jnp.float64)
    for i in range(0, 300, size):
        mine.update(X[i : i + size], Y[i : i + size], a[i : i + size])
        ref.update(jnp.asarray(X[i : i + size]), jnp.asarray(Y[i : i + size]), a[i : i + size])
    for name in ("XXf", "XYf", "YYf", "sxf", "syf"):
        _close(getattr(mine, name), getattr(ref, name))
    assert np.array_equal(mine.nf.numpy(), np.asarray(ref.nf)) and mine.n == 300
    _close(mine.XX, X.T @ X)
    _close(mine.XY, X.T @ Y)
    _coef(mine.fit(3), ref.fit(3))
    zm, zr = mine.zscored(), ref.zscored()
    for name in ("XXf", "XYf", "YYf", "sxf", "syf", "mx", "sdx", "my", "sdy"):
        _close(getattr(zm, name), getattr(zr, name))
    # zscore_fold_stats is the function zscored() applies
    out = ts.zscore_fold_stats(mine.XXf, mine.XYf, mine.YYf, mine.sxf, mine.syf, mine.nf,
                               zm.mx, zm.sdx, zm.my, zm.sdy)
    ref_out = js.zscore_fold_stats(ref.XXf, ref.XYf, ref.YYf, ref.sxf, ref.syf, ref.nf,
                                   zr.mx, zr.sdx, zr.my, zr.sdy)
    for m, r in zip(out, ref_out):
        _close(m, r)


def test_fold_stats_merge_and_checks():
    X, Y = _raw()
    a = _assign("random")
    cpu = dict(dtype=torch.float64, device="cpu")
    whole = ts.FoldStatsAccumulator(12, 3, 4, **cpu).update(X, Y, a)
    p = ts.FoldStatsAccumulator(12, 3, 4, **cpu).update(X[:100], Y[:100], a[:100])
    q = ts.FoldStatsAccumulator(12, 3, 4, **cpu).update(X[100:], Y[100:], a[100:])
    p.merge(q)
    for name in ("XXf", "XYf", "YYf", "sxf", "syf"):
        _close(getattr(p, name), getattr(whole, name).numpy())
    assert torch.equal(p.nf, whole.nf)
    with pytest.raises(ValueError, match="k=1"):
        ts.FoldStatsAccumulator(3, 1, 1, device="cpu")


def test_fold_stats_bf16_matches_jax():
    X, Y = _raw(dtype=np.float32)
    a = _assign("random")
    mine = ts.FoldStatsAccumulator(12, 3, 4, x_storage="bf16", device="cpu")
    ref = js.FoldStatsAccumulator(12, 3, 4, x_storage="bf16")
    for i in range(0, 300, 50):
        mine.update(X[i : i + 50], Y[i : i + 50], a[i : i + 50])
        ref.update(X[i : i + 50], Y[i : i + 50], a[i : i + 50])
    for name in ("XXf", "XYf", "YYf", "sxf", "syf"):
        _close(getattr(mine, name), getattr(ref, name), rtol=1e-6)


def test_collect_moments_large_mean_f32():
    rng = np.random.default_rng(0)
    X = (1e4 + rng.normal(size=(4000, 3))).astype(np.float32)
    Y = (5e3 + rng.normal(size=(4000, 1))).astype(np.float32)
    mx, sdx, my, sdy, n = ts.collect_moments(_chunks(X, Y, 512), 3, 1, device="cpu")
    rx, rsdx, rmy, rsdy, rn = js.collect_moments(_chunks(X, Y, 512), 3, 1, dtype=jnp.float32)
    assert n == rn == 4000
    np.testing.assert_allclose(mx.numpy(), X.mean(0), rtol=1e-5)
    np.testing.assert_allclose(sdx.numpy(), X.std(0, ddof=1), rtol=1e-2)
    assert bool((sdx > 0.5).all())
    # float32 sums in another order: means to 1e-6, σ (of deviations 1e-4
    # of the mean) to 1e-4
    for m, r, tol in ((mx, rx, 1e-6), (sdx, rsdx, 1e-4), (my, rmy, 1e-6), (sdy, rsdy, 1e-4)):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=tol)


def test_fit_streaming_matches_jax():
    X, Y = _raw()
    K, M = 12, 3
    for zscore in (False, True):
        kw = dict(zscore=zscore)
        mom_t = (ts.collect_moments(_chunks(X, Y, 40), K, M, torch.float64, "cpu") if zscore
                 else None)
        mom_j = js.collect_moments(_chunks(X, Y, 40), K, M, jnp.float64) if zscore else None
        mine = ts.fit_streaming(_chunks(X, Y, 40), K, M, 4, moments=mom_t, dtype=torch.float64,
                                device="cpu", **kw)
        ref = js.fit_streaming(_chunks(X, Y, 40), K, M, 4, moments=mom_j, dtype=jnp.float64, **kw)
        _coef(mine, ref)
    with pytest.raises(ValueError, match="moments"):
        ts.fit_streaming(_chunks(X, Y, 40), K, M, 4, zscore=True, device="cpu")


def test_fit_streaming_csv_matches_jax(tmp_path):
    X, Y = _raw(n=90)
    xp, yp = tmp_path / "x.csv", tmp_path / "y.csv"
    np.savetxt(xp, X, delimiter=",", fmt="%.17g")
    np.savetxt(yp, Y, delimiter=",", fmt="%.17g")
    mine = ts.fit_streaming_csv(xp, yp, 3, chunk_rows=16, dtype=torch.float64, device="cpu")
    ref = js.fit_streaming_csv(str(xp), str(yp), 3, chunk_rows=16, dtype=jnp.float64)
    _coef(mine, ref)
    # the z-scored streaming fit is the in-memory fit of z-scored data
    Xz = (X - X.mean(0)) / X.std(0, ddof=1)
    Yz = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    full = tt.fit(torch.from_numpy(Xz), torch.from_numpy(Yz), 3, tt.KERNEL_TYPE2)
    _close(tt.coefficients(mine), tt.coefficients(full).numpy(), rtol=1e-9)
    bad = tmp_path / "short.csv"
    np.savetxt(bad, Y[:50], delimiter=",")
    with pytest.raises(ValueError, match="different numbers of rows"):
        list(ts.csv_chunks(xp, bad, 16))


def test_stats_from_numpy_round_trip():
    X, Y = _raw()
    ref = _accumulate(js, jnp.asarray(X), jnp.asarray(Y), 64, dtype=jnp.float64)
    mine = stats_from_numpy(ref, device="cpu")
    assert isinstance(mine, tt.StatsAccumulator) and mine.n == 300
    for name in ("XX", "XY", "YY", "sx", "sy"):
        _close(getattr(mine, name), getattr(ref, name), rtol=0)
    _coef(mine.fit(4, zscore=True), ref.fit(4, zscore=True))
    a = _assign("random")
    fref = js.FoldStatsAccumulator(12, 3, 4, jnp.float64).update(jnp.asarray(X), jnp.asarray(Y), a)
    fmine = stats_from_numpy({n: np.asarray(getattr(fref, n))
                              for n in ("XXf", "XYf", "YYf", "sxf", "syf", "nf")}, device="cpu")
    assert isinstance(fmine, tt.FoldStatsAccumulator) and fmine.k == 4 and fmine.n == 300
    _close(fmine.XXf, fref.XXf, rtol=0)
    _coef(fmine.fit(3), fref.fit(3))
