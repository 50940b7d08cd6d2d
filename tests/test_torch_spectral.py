"""The port's spectral preprocessing (pls_tpu_torch/spectral.py) and
`ZScorer` (pls_tpu_torch/preprocess.py) against the JAX package.

Seeded spectra-like rows go through each `pls_tpu.spectral` function and
its counterpart in float64 on the CPU: equal to 1e-12 (SNV, MSC with the
mean or a given reference, Savitzky–Golay over windows, orders,
derivatives and spacings, detrend, each normalisation, the CLI's chains),
with the JAX package's argument errors; the transformer facades' params
and numpy results; `ZScorer` with and without weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu.spectral as js
from pls_tpu.preprocess import ZScorer as JaxZScorer
from pls_tpu_torch import spectral as ts
from pls_tpu_torch.preprocess import ZScorer


def _spectra(seed=0, n=12, k=40):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 3, k)
    base = np.exp(-((x[None, :] - rng.uniform(0.5, 2.5, (n, 1))) ** 2) / 0.3)
    return (rng.uniform(0.5, 2.0, (n, 1)) * base + rng.uniform(-0.2, 0.2, (n, 1))
            + 0.01 * rng.normal(size=(n, k)))


def _eq(mine, ref, atol=1e-12):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=0, atol=atol)


def test_snv_and_constant_rows():
    X = _spectra()
    X[3] = 2.5  # a constant row maps to 0
    _eq(ts.snv(torch.from_numpy(X)), js.snv(jnp.asarray(X)))
    assert float(ts.snv(torch.from_numpy(X))[3].abs().max()) == 0.0
    _eq(ts.snv(torch.from_numpy(X[0])), js.snv(jnp.asarray(X[0])))  # 1-D: one row


def test_msc_default_and_given_reference():
    X = _spectra(seed=1)
    _eq(ts.msc(torch.from_numpy(X)), js.msc(jnp.asarray(X)))
    ref = X[:5].mean(0)
    _eq(ts.msc(torch.from_numpy(X), ref), js.msc(jnp.asarray(X), ref))
    Xd = X.copy()
    Xd[2] = 1.0  # a degenerate (flat) row passes through unchanged
    _eq(ts.msc(torch.from_numpy(Xd))[2], Xd[2])
    _eq(ts.msc(torch.from_numpy(Xd)), js.msc(jnp.asarray(Xd)))


def test_msc_correction_uses_the_training_mean():
    Xtr, Xte = _spectra(seed=2), _spectra(seed=3)
    mine = ts.MSCorrection(device="cpu").fit(torch.from_numpy(Xtr))
    ref = js.MSCorrection().fit(Xtr)
    _eq(mine.reference_, ref.reference_)
    out = mine.transform(Xte)
    assert isinstance(out, np.ndarray)
    _eq(out, ref.transform(Xte))
    _eq(ts.MSCorrection(device="cpu").fit_transform(Xtr), js.MSCorrection().fit_transform(Xtr))
    with pytest.raises(RuntimeError, match="before fit"):
        ts.MSCorrection(device="cpu").transform(Xte)
    assert mine.set_params(device="cpu").get_params() == {"device": "cpu"}


@pytest.mark.parametrize("window,polyorder,deriv,delta", [
    (5, 2, 0, 1.0), (11, 2, 1, 1.0), (7, 3, 2, 0.5), (3, 1, 1, 2.0), (15, 4, 0, 1.0),
    (11, 2, 0, 1.0),
])
def test_savgol_matches_jax(window, polyorder, deriv, delta):
    X = _spectra(seed=4)
    _eq(ts.savgol(torch.from_numpy(X), window, polyorder, deriv, delta),
        js.savgol(jnp.asarray(X), window, polyorder, deriv, delta))
    np.testing.assert_array_equal(ts.savgol_coeffs(window, polyorder, deriv, delta),
                                  js.savgol_coeffs(window, polyorder, deriv, delta))
    for mine, ref in zip(ts._sg_matrices(window, polyorder, deriv, delta),
                         js._sg_matrices(window, polyorder, deriv, delta)):
        np.testing.assert_array_equal(mine, ref)


def test_savgol_matches_scipy_where_installed():
    signal = pytest.importorskip("scipy.signal")
    X = _spectra(seed=5)
    _eq(ts.savgol(torch.from_numpy(X), 9, 3, 1), signal.savgol_filter(X, 9, 3, deriv=1, axis=1),
        atol=1e-10)


@pytest.mark.parametrize("args,match", [
    ((4, 2), "odd"), ((5, 5), "polyorder"), ((5, 2, 3), "deriv"), ((41, 2), "n_channels"),
])
def test_savgol_refusals(args, match):
    X = torch.from_numpy(_spectra())
    with pytest.raises(ValueError, match=match):
        ts.savgol(X, *args)
    with pytest.raises(ValueError, match=match):
        js.savgol(jnp.asarray(X.numpy()), *args)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_detrend_matches_jax(order):
    X = _spectra(seed=6) + np.linspace(0, 1, 40)[None, :] ** 2
    _eq(ts.detrend(torch.from_numpy(X), order), js.detrend(jnp.asarray(X), order), atol=1e-11)


@pytest.mark.parametrize("norm", ["l1", "l2", "max", "area"])
def test_normalize_matches_jax(norm):
    X = _spectra(seed=7)
    X[4] = 0.0  # a zero row stays zero
    _eq(ts.normalize(torch.from_numpy(X), norm), js.normalize(jnp.asarray(X), norm))
    with pytest.raises(ValueError, match="unknown norm"):
        ts.normalize(torch.from_numpy(X), "l3")


@pytest.mark.parametrize("chain", [
    "savgol:11:2:1,snv", "msc,detrend:2", "snv", "savgol:7:2", "norm,detrend",
    "savgol:5:2:1:0.5, msc ,norm:max", "detrend:1,savgol:9:3:2,snv", "",
])
def test_apply_chain_matches_jax(chain):
    X = _spectra(seed=8)
    _eq(ts.apply_chain(torch.from_numpy(X), chain), js.apply_chain(jnp.asarray(X), chain),
        atol=1e-11)


@pytest.mark.parametrize("chain,match", [("savgol:11", "window:polyorder"), ("fft", "unknown")])
def test_apply_chain_refusals(chain, match):
    with pytest.raises(ValueError, match=match):
        ts.apply_chain(torch.from_numpy(_spectra()), chain)


def test_transformer_facades():
    X = _spectra(seed=9)
    for mine, ref in [
        (ts.SNV(device="cpu"), js.SNV()),
        (ts.SavitzkyGolay(9, 2, 1, device="cpu"), js.SavitzkyGolay(9, 2, 1)),
        (ts.Detrend(2, device="cpu"), js.Detrend(2)),
    ]:
        out = mine.fit(X).transform(X)
        assert isinstance(out, np.ndarray)
        _eq(out, ref.fit(X).transform(X), atol=1e-11)
        _eq(mine.fit_transform(X), ref.fit_transform(X), atol=1e-11)
        params = mine.get_params()
        assert params.pop("device") == "cpu" and params == ref.get_params()
    sg = ts.SavitzkyGolay(device="cpu").set_params(window=7, deriv=1)
    _eq(sg.transform(X), js.savgol(jnp.asarray(X), 7, 2, 1))
    # a tensor on a device computes there; other data goes to the card
    _eq(ts.SNV().transform(torch.from_numpy(X)), js.snv(jnp.asarray(X)))


def test_numpy_input_needs_the_card_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy input runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.snv(_spectra())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.SNV().transform(_spectra())


def test_zscorer_matches_jax():
    rng = np.random.default_rng(10)
    X = rng.normal(size=(30, 5)) * [1, 2, 3, 4, 5] + [10, -3, 0, 1, 2]
    X[:, 2] = 7.0  # a constant column: stdev 1, z-scores 0
    mine, ref = ZScorer.fit(torch.from_numpy(X)), JaxZScorer.fit(jnp.asarray(X))
    _eq(mine.mean, ref.mean)
    _eq(mine.stdev, ref.stdev)
    assert float(mine.stdev[2]) == 1.0
    Xn = rng.normal(size=(4, 5))
    _eq(mine.transform(torch.from_numpy(Xn)), ref.transform(jnp.asarray(Xn)))
    _eq(mine.inverse(mine.transform(torch.from_numpy(Xn))), Xn)
    w = rng.integers(0, 4, size=30).astype(np.float64)
    mine = ZScorer.fit(torch.from_numpy(X), sample_weight=torch.from_numpy(w))
    ref = JaxZScorer.fit(jnp.asarray(X), sample_weight=jnp.asarray(w))
    _eq(mine.mean, ref.mean)
    _eq(mine.stdev, ref.stdev)
    # integer weights: the z-scorer of the row-repeated data
    rep = ZScorer.fit(torch.from_numpy(np.repeat(X, w.astype(int), axis=0)))
    _eq(mine.mean, rep.mean, atol=1e-12)
    _eq(mine.stdev, rep.stdev, atol=1e-12)
    with pytest.raises(Exception):
        mine.mean = mine.stdev  # frozen
