"""The port's sample selection (sampling.py) and calibration transfer
(transfer.py) against the JAX package.

Inputs are made from a seed with numpy; both packages run in float64 on
the CPU.  Kennard-Stone, SPXY and duplex picks are equal, in pick order
(the port keeps the JAX package's distance formula and first-maximum
tie-break).  DS, PDS and EPO agree to 1e-10 relative to their scale: the
maps F and the transferred spectra, EPO's filtered spectra (its basis up
to each vector's sign) and captured shares.  DS's F on an
under-determined transfer set (n < K, ridge 1e-6) is a near-singular
solve whose two LU factorisations differ at 1e-7 of F's scale; there the
transferred spectra are held at 1e-10 and F at DS_SINGULAR_RTOL.
"""

import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt

RTOL = 1e-10
DS_SINGULAR_RTOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(mine, ref, rtol=RTOL):
    mine, ref = _np(mine), _np(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=rtol * max(np.abs(ref).max(), 1e-300), rtol=0)


def _points(seed=0, n=120, k=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)) + 5.0  # far from the origin: the centring matters
    Y = X[:, :2] @ rng.normal(size=(2, 2)) + 0.1 * rng.normal(size=(n, 2))
    return X, Y


# ---------- sampling.py ----------
@pytest.mark.parametrize("seed,n,k,n_select", [(0, 120, 8, 2), (1, 120, 8, 30),
                                               (2, 300, 5, 60), (3, 600, 3, 11)])
def test_kennard_stone(seed, n, k, n_select):
    X, _ = _points(seed, n, k)
    assert np.array_equal(tt.kennard_stone(X, n_select, device="cpu"),
                          pt.kennard_stone(X, n_select))


@pytest.mark.parametrize("seed,n_select", [(0, 25), (4, 40)])
@pytest.mark.parametrize("one_d", [False, True])
def test_spxy(seed, n_select, one_d):
    X, Y = _points(seed, 280)
    Y = Y[:, 0] if one_d else Y
    assert np.array_equal(tt.spxy(X, Y, n_select, device="cpu"), pt.spxy(X, Y, n_select))


def test_spxy_with_a_constant_y_is_kennard_stone():
    X, _ = _points(5)
    Y = np.ones(X.shape[0])
    got = tt.spxy(X, Y, 15, device="cpu")
    assert np.array_equal(got, pt.spxy(X, Y, 15))


@pytest.mark.parametrize("n,n_cal", [(40, 2), (40, 20), (41, 36), (150, 50)])
def test_duplex(n, n_cal):
    X, _ = _points(6, n)
    cal, val = tt.duplex(X, n_cal, device="cpu")
    rcal, rval = pt.duplex(X, n_cal)
    assert np.array_equal(cal, rcal) and np.array_equal(val, rval)
    assert len(cal) == n_cal and len(np.union1d(cal, val)) == n


@pytest.mark.parametrize("method", ["kennard-stone", "spxy", "duplex"])
def test_ks_train_test_split(method):
    X, Y = _points(7, 90)
    got = tt.ks_train_test_split(X, Y, train_size=30, method=method, device="cpu")
    ref = pt.ks_train_test_split(X, Y, train_size=30, method=method)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def test_sampling_refusals():
    X, _ = _points(8, 10)
    with pytest.raises(ValueError, match="n_select"):
        tt.kennard_stone(X, 11, device="cpu")
    with pytest.raises(ValueError, match="n_cal"):
        tt.duplex(X, 9, device="cpu")
    with pytest.raises(ValueError, match="spxy needs Y"):
        tt.ks_train_test_split(X, train_size=3, method="spxy", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tt.ks_train_test_split(X, train_size=3, method="random", device="cpu")


# ---------- transfer.py ----------
def _instruments(seed=0, n=40, k=30):
    """Master spectra and a slave made from them by a channel shift and a
    gain, plus new slave spectra."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n + 10, 4))
    M = L @ rng.normal(size=(4, k)) + 0.05 * rng.normal(size=(n + 10, k))
    S = 1.05 * np.roll(M, 1, axis=1) + 0.2 + 0.01 * rng.normal(size=M.shape)
    return M[:n], S[:n], S[n:]


@pytest.mark.parametrize("ridge", [1e-6, 1.0])
def test_direct_standardization_overdetermined(ridge):
    Mm, Ss, Snew = _instruments(0, n=60, k=20)
    ref = pt.direct_standardization(Mm, Ss, ridge)
    got = tt.direct_standardization(Mm, Ss, ridge, device="cpu")
    for f in ("F", "offset", "intercept"):
        _close(getattr(got, f), getattr(ref, f))
    _close(got(Snew), ref(Snew))
    _close(tt.apply_transfer(got, Snew[0]), pt.apply_transfer(ref, Snew[0]))


def test_direct_standardization_underdetermined():
    Mm, Ss, Snew = _instruments(1, n=25, k=40)
    ref = pt.direct_standardization(Mm, Ss)
    got = tt.direct_standardization(Mm, Ss, device="cpu")
    _close(got.F, ref.F, DS_SINGULAR_RTOL)
    _close(got(Ss), ref(Ss))


@pytest.mark.parametrize("window,A", [(1, 1), (2, 2), (5, 3)])
def test_piecewise_ds(window, A):
    Mm, Ss, Snew = _instruments(2)
    ref = pt.piecewise_ds(Mm, Ss, window, A)
    got = tt.piecewise_ds(Mm, Ss, window, A, device="cpu")
    for f in ("F", "offset", "intercept"):
        _close(getattr(got, f), getattr(ref, f))
    _close(got(Snew), ref(Snew))
    F = _np(got.F)  # banded: nothing beyond the window
    i, j = np.indices(F.shape)
    assert np.all(F[np.abs(i - j) > window] == 0)


def test_transfer_refusals():
    Mm, Ss, _ = _instruments(3)
    with pytest.raises(ValueError, match="paired"):
        tt.direct_standardization(Mm, Ss[:-1], device="cpu")
    with pytest.raises(ValueError, match="2\\*window\\+1"):
        tt.piecewise_ds(Mm, Ss, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="n_components"):
        tt.epo(Mm, 0, device="cpu")


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("n_conditions", [2, 3])
def test_epo(g, n_conditions):
    Mm, Ss, Snew = _instruments(4)
    conds = [Mm, Ss, 0.5 * (Mm + Ss) + 0.1][:n_conditions]
    Dref = pt.epo_difference_matrix(*conds)
    D = tt.epo_difference_matrix(*conds, device="cpu")
    _close(D, Dref)
    ref, got = pt.epo(Dref, g), tt.epo(D, g)
    assert got.n_components == ref.n_components == g
    _close(got.sv_ratio, ref.sv_ratio)
    V, Vr = _np(got.V), np.asarray(ref.V)
    _close(V * np.sign(np.sum(V * Vr, axis=0)), Vr)
    _close(got(Snew), ref(Snew))
    _close(got(Snew[0]), ref(Snew[0]))
