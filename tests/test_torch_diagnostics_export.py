"""The port's T²/SPE monitor (models/diagnostics.py) and PLSB export
(export.py) against the JAX package.

Inputs are made from a seed with numpy; both packages fit in float64 on
the CPU.  The per-sample statistics, the contributions, leverage and the
control limits agree to 1e-10 (relative); the monitor's flags are equal.
A JAX monitor carried across with `convert.state_from_numpy` gates a batch
exactly as the JAX one does.  A PLSB file the port writes loads in
`pls_tpu.load_model_c` and one the JAX package writes loads in the port's:
header bytes identical, arrays within 1e-12.  The `gpu` case builds the
monitor from a float32 fit on the card (K1 launches) and holds it to the
CPU's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu_torch.convert import state_from_numpy, state_to_numpy
from pls_tpu_torch.models.diagnostics import MonitorModel

RTOL = 1e-10


def _data(seed=0, n=50, k=10, m=2, a=3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + 0.3 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + 0.3 * rng.normal(size=(n, m))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    Xn = rng.normal(size=(7, k)) * 1.5
    return X, Y, Xn


@pytest.fixture(scope="module")
def fits():
    X, Y, Xn = _data()
    fj = pt.fit(jnp.asarray(X), jnp.asarray(Y), 3)
    ft = tt.fit(torch.as_tensor(X), torch.as_tensor(Y), 3)
    fj2 = pt.fit(jnp.asarray(X), jnp.asarray(Y), 3, pt.KERNEL_TYPE2)
    ft2 = tt.fit(torch.as_tensor(X), torch.as_tensor(Y), 3, tt.KERNEL_TYPE2)
    return X, Y, Xn, fj, ft, fj2, ft2


def _close(mine, ref, rtol=RTOL):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("name", ["x_residuals", "spe", "hotelling_t2", "spe_contributions",
                                  "t2_contributions"])
@pytest.mark.parametrize("comp", [None, 2])
def test_statistics_match_jax(name, comp, fits):
    X, Y, Xn, fj, ft, _, _ = fits
    _close(getattr(tt, name)(ft, torch.as_tensor(Xn), comp),
           getattr(pt, name)(fj, jnp.asarray(Xn), comp))


def test_type2_fit_needs_training_x(fits):
    X, Y, Xn, _, _, fj2, ft2 = fits
    with pytest.raises(ValueError, match="pass X_train"):
        tt.hotelling_t2(ft2, torch.as_tensor(Xn))
    _close(tt.hotelling_t2(ft2, torch.as_tensor(Xn), X_train=torch.as_tensor(X)),
           pt.hotelling_t2(fj2, jnp.asarray(Xn), X_train=jnp.asarray(X)))
    _close(tt.t2_contributions(ft2, torch.as_tensor(Xn), 2, X_train=torch.as_tensor(X)),
           pt.t2_contributions(fj2, jnp.asarray(Xn), 2, X_train=jnp.asarray(X)))


@pytest.mark.parametrize("new", [False, True])
def test_leverage_matches_jax(new, fits):
    X, Y, Xn, fj, ft, _, _ = fits
    mine = tt.leverage(ft, torch.as_tensor(Xn) if new else None)
    _close(mine, pt.leverage(fj, jnp.asarray(Xn) if new else None))


def test_contributions_sum_to_statistics(fits):
    _, _, Xn, _, ft, _, _ = fits
    Xn = torch.as_tensor(Xn)
    _close(tt.spe_contributions(ft, Xn).sum(1), tt.spe(ft, Xn))
    _close(tt.t2_contributions(ft, Xn).sum(1), tt.hotelling_t2(ft, Xn))


@pytest.mark.parametrize("alpha", [0.05, 0.01])
def test_limits_match_jax(alpha, fits):
    X, _, _, fj, ft, _, _ = fits
    assert tt.t2_limit(50, 3, alpha) == pt.t2_limit(50, 3, alpha)
    q = tt.spe(ft, torch.as_tensor(X))
    _close(tt.spe_limit(q, alpha), pt.spe_limit(pt.spe(fj, jnp.asarray(X)), alpha))
    with pytest.raises(ValueError, match="n_train > comp"):
        tt.t2_limit(3, 3)


@pytest.mark.parametrize("alpha", [0.05, 0.5])
def test_monitor_check_matches_jax(alpha, fits):
    X, _, Xn, fj, ft, _, _ = fits
    mj = pt.fit_monitor(fj, jnp.asarray(X), alpha=alpha)
    mt = tt.fit_monitor(ft, torch.as_tensor(X), alpha=alpha)
    for f in ("R", "P", "s2", "t2_lim", "spe_lim"):
        _close(getattr(mt, f), getattr(mj, f))
    # the training rows and the new rows: some flags of each kind
    batch = np.concatenate([X, Xn])
    cj, ct = mj.check(jnp.asarray(batch)), mt.check(torch.as_tensor(batch))
    for k in ("t2", "spe"):
        _close(ct[k], cj[k])
    for k in ("t2_ok", "spe_ok", "ok"):
        np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
    assert not ct["ok"].all() and ct["ok"].any()
    con_j, con_t = mj.contributions(jnp.asarray(Xn)), mt.contributions(torch.as_tensor(Xn))
    for k in ("spe", "t2"):
        _close(con_t[k], con_j[k])


def test_monitor_carried_from_jax(fits):
    X, _, Xn, fj, _, _, _ = fits
    mj = pt.fit_monitor(fj, jnp.asarray(X), comp=2)
    mt = state_from_numpy(MonitorModel, mj, device="cpu")
    assert mt.alpha == mj.alpha and mt.R.shape == (10, 2)
    ct, cj = mt.check(torch.as_tensor(Xn)), mj.check(jnp.asarray(Xn))
    _close(ct["t2"], cj["t2"])
    np.testing.assert_array_equal(ct["ok"].numpy(), np.asarray(cj["ok"]))
    back = state_from_numpy(MonitorModel, state_to_numpy(mt), device="cpu")
    assert torch.equal(back.R, mt.R) and float(back.spe_lim) == float(mt.spe_lim)


def _header(path) -> bytes:
    return path.read_bytes()[:32]


@pytest.mark.parametrize("monitor", [False, True])
def test_plsb_round_trips_between_packages(tmp_path, monitor, fits):
    X, Y, _, fj, ft, _, _ = fits
    zx = pt.ZScorer.fit(jnp.asarray(X * 3.0 + 1.0))
    zy = pt.ZScorer.fit(jnp.asarray(Y * 2.0 - 5.0))
    zxt = tt.ZScorer(mean=torch.tensor(np.asarray(zx.mean)), stdev=torch.tensor(np.asarray(zx.stdev)))
    zyt = tt.ZScorer(mean=torch.tensor(np.asarray(zy.mean)), stdev=torch.tensor(np.asarray(zy.stdev)))
    mj = pt.fit_monitor(fj, jnp.asarray(X)) if monitor else None
    mt = tt.fit_monitor(ft, torch.as_tensor(X)) if monitor else None
    pj, ptorch = tmp_path / "jax.plsb", tmp_path / "torch.plsb"
    pt.export_model_c(str(pj), fj, x_scaler=zx, y_scaler=zy, monitor=mj)
    tt.export_model_c(str(ptorch), ft, x_scaler=zxt, y_scaler=zyt, monitor=mt)
    assert _header(pj) == _header(ptorch)
    assert pj.stat().st_size == ptorch.stat().st_size
    for a, b in ((tt.load_model_c(str(pj)), pt.load_model_c(str(ptorch))),
                 (tt.load_model_c(str(ptorch)), pt.load_model_c(str(pj)))):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                _close(a[k], b[k], 1e-12)
            elif k in ("K", "M", "A"):
                assert a[k] == b[k]
            else:
                _close(a[k], b[k], 1e-12)
    if not monitor:
        assert tt.load_model_c(str(ptorch))["t2_lim"] == 0.0


def test_plsb_truncation_and_bad_magic(tmp_path, fits):
    _, _, _, fj, ft, _, _ = fits
    p = tmp_path / "a.plsb"
    tt.export_model_c(str(p), ft, comp=2)
    d = tt.load_model_c(str(p))
    assert (d["K"], d["M"], d["A"]) == (10, 2, 2)
    _close(d["B_raw"], pt.coefficients(fj, 2), 1e-12)
    p.write_bytes(b"NOTPLSB0" + p.read_bytes()[8:])
    with pytest.raises(ValueError, match="bad magic"):
        tt.load_model_c(str(p))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_monitor_on_the_card_launches_k1(fits):
    from pls_tpu_torch.ops import deflate

    X, Y, Xn, _, ft, _, _ = fits
    dev = torch.device("cuda", 0)
    before = deflate.launches["deflate_f32"]
    f32 = tt.fit(torch.as_tensor(X, dtype=torch.float32, device=dev),
                 torch.as_tensor(Y, dtype=torch.float32, device=dev), 3)
    assert deflate.launches["deflate_f32"] - before == 3
    m = tt.fit_monitor(f32, torch.as_tensor(X, dtype=torch.float32, device=dev))
    ref = tt.fit_monitor(ft, torch.as_tensor(X))
    c = m.check(torch.as_tensor(Xn, dtype=torch.float32, device=dev))
    cref = ref.check(torch.as_tensor(Xn))
    np.testing.assert_allclose(c["t2"].cpu().numpy(), cref["t2"].numpy(), rtol=1e-4)
    np.testing.assert_allclose(c["spe"].cpu().numpy(), cref["spe"].numpy(), rtol=1e-4)
