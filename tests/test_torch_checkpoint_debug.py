"""The port's checkpointing (utils/checkpoint.py), debug and profiling
utilities (utils/debug.py, utils/profiling.py) and bundled datasets
(datasets.py) against the JAX package.

`.npz` checkpoints cross-load both ways, for every type the JAX package
registers (PLSFit of both kernel types, Residual, KPLSFit, OPLSFit,
MonitorModel, CDFit, NPLSFit, MBPLSFit): a file `pls_tpu.save_fit` writes
loads in the port with every array bit-equal and every static field
equal, and the reverse.  The torch-format pair (`save_fit_orbax`, a
`torch.save` directory) round-trips bit-equal.  `fit_health` agrees with
the JAX package's to 1e-10; `assert_finite` names the same field.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu.models import multiblock as jmb, npls as jnpls
from pls_tpu.utils import debug as jdebug
from pls_tpu_torch.convert import fit_from_numpy, state_from_numpy
from pls_tpu_torch.utils import checkpoint, debug, profiling


def _data(seed=0, n=30, k=12, m=2):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3))
    X = L @ rng.normal(size=(3, k)) + 0.3 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(3, m)) + 0.3 * rng.normal(size=(n, m))
    return (X - X.mean(0)) / X.std(0), (Y - Y.mean(0)) / Y.std(0)


def _jax_states():
    """One JAX state of each registered type, by name."""
    X, Y = _data()
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    f1 = pt.fit(Xj, Yj, 3)
    X3 = np.random.default_rng(4).normal(size=(30, 4, 5))
    return {
        "PLSFit_kernel1": f1,
        "PLSFit_kernel2": pt.fit(Xj, Yj, 3, pt.KERNEL_TYPE2),
        "Residual": pt.Residual(errors=jnp.asarray(np.arange(24.0).reshape(2, 4, 3)),
                                method="LOO"),
        "KPLSFit": pt.fit_kpls(Xj, Yj, 2, kernel="poly", degree=2, coef0=0.5),
        "OPLSFit": pt.fit_opls(Xj, Yj, 2, 1, pt.KERNEL_TYPE2),
        "MonitorModel": pt.fit_monitor(f1, Xj, 2, alpha=0.01),
        "CDFit": pt.fit_plscanonical(Xj, Yj, 2),
        "NPLSFit": jnpls.fit_npls(jnp.asarray(X3), Yj, 2),
        "MBPLSFit": jmb.fit_mbpls([Xj[:, :5], Xj[:, 5:]], Yj, 2),
    }


PORT_TYPES = {"PLSFit": tt.PLSFit, "Residual": tt.Residual, "KPLSFit": tt.KPLSFit,
              "OPLSFit": tt.OPLSFit, "MonitorModel": tt.MonitorModel, "CDFit": tt.CDFit,
              "NPLSFit": tt.NPLSFit, "MBPLSFit": tt.MBPLSFit}
STATES = _jax_states()


def _to_port(state):
    name = type(state).__name__
    if name == "PLSFit":
        return fit_from_numpy(state, state.method, device="cpu")
    if name == "Residual":
        return tt.Residual(errors=torch.from_numpy(np.asarray(state.errors)), method=state.method)
    return state_from_numpy(PORT_TYPES[name], state, device="cpu")


def _same(port, jax_state):
    """Every field equal: arrays bit for bit, static fields by value."""
    assert type(port).__name__ == type(jax_state).__name__
    for f in dataclasses.fields(jax_state):
        a, b = getattr(port, f.name), getattr(jax_state, f.name)
        if dataclasses.is_dataclass(b):
            _same(a, b)
        elif isinstance(a, torch.Tensor):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), f.name
        elif f.name == "method" and hasattr(b, "value"):
            assert a.value == b.value
        else:
            assert tuple(a) == tuple(b) if isinstance(b, (list, tuple)) else a == b, f.name


@pytest.mark.parametrize("name", sorted(STATES))
def test_npz_written_by_jax_loads_in_the_port(name, tmp_path):
    path = str(tmp_path / "fit.npz")
    pt.save_fit(STATES[name], path)
    _same(tt.load_fit(path, device="cpu"), STATES[name])


@pytest.mark.parametrize("name", sorted(STATES))
def test_npz_written_by_the_port_loads_in_jax(name, tmp_path):
    path = str(tmp_path / "fit.npz")
    tt.save_fit(_to_port(STATES[name]), path)
    back = pt.load_fit(path)
    _same(_to_port(back), STATES[name])
    with np.load(path) as z:  # the JAX package's layout, key for key
        ref = str(tmp_path / "ref.npz")
        pt.save_fit(STATES[name], ref)
        with np.load(ref) as r:
            assert sorted(z.files) == sorted(r.files)
            assert json.loads(str(z["meta"])) == json.loads(str(r["meta"]))


@pytest.mark.parametrize("name", sorted(STATES))
def test_torch_format_round_trip(name, tmp_path):
    port = _to_port(STATES[name])
    tt.save_fit_orbax(port, str(tmp_path / "ckpt"))
    tt.save_fit_orbax(port, str(tmp_path / "ckpt"))  # overwrites
    _same(tt.load_fit_orbax(str(tmp_path / "ckpt"), device="cpu"), STATES[name])


def test_unregistered_types_refused_and_registration(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class MyFit:
        B: torch.Tensor
        tag: str = "x"

    with pytest.raises(TypeError, match="not checkpointable"):
        tt.save_fit(MyFit(torch.ones(2)), str(tmp_path / "a.npz"))
    tt.register_checkpointable(MyFit)
    tt.save_fit(MyFit(torch.arange(3.0), "y"), str(tmp_path / "a.npz"))
    got = tt.load_fit(str(tmp_path / "a.npz"), device="cpu")
    assert got.tag == "y" and torch.equal(got.B, torch.arange(3.0))
    checkpoint._TYPES.pop("MyFit")


# ---------- utils/debug.py ----------
def test_assert_finite_names_the_field_as_jax_does():
    X, Y = _data(1)
    jf = pt.fit(jnp.asarray(X), jnp.asarray(Y), 2)
    jf = dataclasses.replace(jf, Q=jf.Q.at[0, 0].set(jnp.nan))
    tf = _to_port(jf)
    with pytest.raises(FloatingPointError) as ej:
        jdebug.assert_finite(jf, "fit")
    with pytest.raises(FloatingPointError) as et:
        debug.assert_finite(tf, "fit")
    assert str(et.value) == str(ej.value)
    debug.assert_finite(_to_port(pt.fit(jnp.asarray(X), jnp.asarray(Y), 2)), "fit")


def test_debug_nans_checks_the_fits_it_wraps():
    X, Y = _data(2)
    X[3, 4] = np.nan
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    tt.fit(Xt, Yt, 2)  # no check outside the context
    with debug.debug_nans():
        with pytest.raises(FloatingPointError, match="non-finite values in fit"):
            tt.fit(Xt, Yt, 2)
        with pytest.raises(FloatingPointError):
            tt.fit_folds(Xt, Yt, torch.ones(2, 30), 2)
        with debug.debug_nans(False):
            tt.fit(Xt, Yt, 2)
    assert not debug.state["check_fits"]


@pytest.mark.parametrize("method", ["kernel1", "kernel2", "nipals"])
def test_fit_health_matches_jax(method):
    X, Y = _data(3, n=40, k=10)
    jm = pt.METHOD(method)
    jf = pt.fit(jnp.asarray(X), jnp.asarray(Y), 4, jm)
    ref = jdebug.fit_health(jf)
    got = debug.fit_health(tt.fit(torch.from_numpy(X), torch.from_numpy(Y), 4, tt.METHOD(method)))
    assert got.keys() == ref.keys() and got["finite"] == ref["finite"]
    for k in ref:
        if k != "finite":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-10, atol=1e-10)


# ---------- utils/profiling.py ----------
def test_profiling_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.detect_generation() is None
    r = profiling.roofline_report(2e-3, 4_000_000_000, 10**11)
    assert (r.achieved_gbps, r.achieved_tflops) == pytest.approx((2000.0, 50.0))
    assert r.generation is None and r.frac_hbm_peak is None and "GB/s" in str(r)
    X = torch.ones(64, 64)
    assert profiling.measure(lambda a: a @ a, X, iters=3, warmup=1) > 0
    with profiling.trace(str(tmp_path / "tr")) as d:
        X @ X
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0 and d == str(tmp_path / "tr")


def test_peaks_are_the_cards_and_report_a_share(monkeypatch):
    assert set(profiling._PEAKS) == {"H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    r = profiling.roofline_report(1.0, 1675 * 10**9, 67 * 10**12 // 2)
    assert r.generation == "H100 80GB HBM3"
    assert (r.frac_hbm_peak, r.frac_flops_peak) == pytest.approx((0.5, 0.5))


# ---------- datasets.py ----------
@pytest.mark.parametrize("loader", ["load_toy", "load_nir"])
def test_datasets_equal_the_jax_packages(loader):
    import pls_tpu.datasets as jd
    import pls_tpu_torch.datasets as td

    for a, b in zip(getattr(td, loader)(), getattr(jd, loader)()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_synthetic_equals_the_jax_packages():
    import pls_tpu.datasets as jd
    import pls_tpu_torch.datasets as td

    for a, b in zip(td.make_synthetic(50, 7, 2, seed=3), jd.make_synthetic(50, 7, 2, seed=3)):
        assert np.array_equal(a, b)
