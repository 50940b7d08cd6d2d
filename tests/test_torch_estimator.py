"""The port's scikit-learn entry point (estimator.py, models/plsda.py)
against the JAX package's.

Inputs are made from a seed with numpy (raw units: offsets and scales per
column); both packages run in float64 on the CPU (`device="cpu"`).  For
every estimator, predictions, raw-unit `coef_`/`intercept_`, scores and
the other fitted attributes agree to 1e-9 relative to their scale (1e-8
for the iterative fits); return types are numpy arrays.  PLSRegressor's
sample weights, monitor (`build_monitor`/`check`), PLSB export and the
three prediction-interval kinds are held to the same calls of the JAX
estimator.  `device` is a parameter: get_params/set_params and
`sklearn.clone` carry it, and without a card an estimator given numpy
data and no device raises instead of falling back to the CPU.  The `gpu`
cases fit each estimator in float32 on the card, count K1 (K2 with
x_storage="bf16") launches where the family runs the kernel, and hold the
predictions to the CPU run.
"""

import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu.models.plsda import PLSDAClassifier as JaxPLSDA
from pls_tpu_torch.models.plsda import PLSDAClassifier


def _raw(seed=0, n=60, k=12, m=2, a=3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = (L @ rng.normal(size=(a, k)) + 0.3 * rng.normal(size=(n, k))) * rng.uniform(0.5, 3, k) \
        + rng.normal(size=k) * 4
    Y = (L @ rng.normal(size=(a, m)) + 0.3 * rng.normal(size=(n, m))) * 2.0 + 10.0
    return X, Y, rng.normal(size=(8, k)) * X.std(0) + X.mean(0)


def _close(mine, ref, rtol=1e-9):
    assert isinstance(mine, np.ndarray), type(mine)
    ref = np.asarray(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=rtol * max(np.abs(ref).max(), 1e-300))


# (port estimator, JAX estimator, constructor kwargs, rtol)
REGRESSORS = {
    "pls_kernel1": (tt.PLSRegressor, pt.PLSRegressor, {"n_components": 3}, 1e-9),
    "pls_kernel2_unscaled": (tt.PLSRegressor, pt.PLSRegressor,
                             {"n_components": 2, "scale": False}, 1e-9),
    "pls_nipals": (tt.PLSRegressor, pt.PLSRegressor, {"n_components": 3, "method": "nipals"},
                   1e-9),
    "pls_simpls_power": (tt.PLSRegressor, pt.PLSRegressor,
                         {"n_components": 3, "method": "simpls", "power_iters": 30}, 1e-9),
    "robust": (tt.RobustPLSRegressor, pt.RobustPLSRegressor,
               {"n_components": 2, "loss": "bisquare", "n_irls": 5}, 1e-8),
    "spls": (tt.SPLSRegressor, pt.SPLSRegressor, {"n_components": 2, "keep_x": 5}, 1e-9),
    "opls": (tt.OPLSRegressor, pt.OPLSRegressor, {"n_ortho": 2, "n_components": 1}, 1e-9),
    "kpls": (tt.KPLSRegressor, pt.KPLSRegressor, {"n_components": 3, "gamma": 0.05}, 1e-9),
    "plscanonical": (tt.PLSCanonical, pt.PLSCanonical, {"n_components": 2}, 1e-8),
    "cca": (tt.CCA, pt.CCA, {"n_components": 2}, 1e-8),
}
METHOD_PARAMS = {"nipals": (tt.NIPALS, pt.NIPALS), "simpls": (tt.SIMPLS, pt.SIMPLS)}


def _pair(name):
    tcls, jcls, kw, rtol = REGRESSORS[name]
    tkw, jkw = dict(kw), dict(kw)
    if "method" in kw:
        tkw["method"], jkw["method"] = METHOD_PARAMS[kw["method"]]
    if name == "pls_kernel2_unscaled":
        tkw["method"], jkw["method"] = tt.KERNEL_TYPE2, pt.KERNEL_TYPE2
    return tcls(**tkw, device="cpu"), jcls(**jkw), rtol


@pytest.mark.parametrize("name", sorted(REGRESSORS))
def test_regressor_matches_jax(name):
    X, Y, Xn = _raw(seed=1)
    et, ej, rtol = _pair(name)
    et.fit(X, Y)
    ej.fit(X, Y)
    _close(et.predict(Xn), ej.predict(Xn), rtol)
    assert et.score(X, Y) == pytest.approx(ej.score(X, Y), rel=rtol)
    if hasattr(ej, "coef_"):
        _close(et.coef_, ej.coef_, rtol)
        _close(et.intercept_, ej.intercept_, rtol)
        manual = (Xn - X.mean(0)) @ et.coef_.T + et.intercept_
        if et.scale:
            _close(manual, et.predict(Xn), 1e-9)
    if hasattr(ej, "transform") and name not in ("kpls",):
        mine, ref = et.transform(Xn), np.asarray(ej.transform(Xn))
        s = np.sign(np.sum(mine * ref, 0))
        _close(mine * s, ref, rtol)
    for attr in ("sample_weight_", "selected_", "r2x_ortho_", "x_weights_", "y_rotations_",
                 "x_scores_"):
        if hasattr(ej, attr):
            _close(np.asarray(getattr(et, attr), float), np.asarray(getattr(ej, attr), float), rtol)
    if name == "opls":
        _close(np.abs(et.transform_ortho(Xn)), np.abs(np.asarray(ej.transform_ortho(Xn))))


def test_plssvd_matches_jax():
    X, Y, Xn = _raw(seed=2, m=3)
    et, ej = tt.PLSSVD(2, device="cpu").fit(X, Y), pt.PLSSVD(2).fit(X, Y)
    xs, ys = et.transform(Xn, Xn[:, :3])
    xj, yj = ej.transform(Xn, Xn[:, :3])
    _close(xs, xj)
    _close(ys, yj)
    _close(et.coef_, ej.coef_)
    with pytest.raises(AttributeError, match="transform-only"):
        et.predict(Xn)


def test_pls_regressor_sample_weight_and_vip():
    X, Y, Xn = _raw(seed=3)
    w = np.random.default_rng(3).integers(0, 4, size=60).astype(float)
    et = tt.PLSRegressor(3, device="cpu").fit(X, Y, sample_weight=w)
    ej = pt.PLSRegressor(3).fit(X, Y, sample_weight=w)
    _close(et.predict(Xn), ej.predict(Xn))
    _close(et.coef_, ej.coef_)
    _close(et.vip_, ej.vip_)
    # integer weights == repeated rows
    rep = np.repeat(np.arange(60), w.astype(int))
    _close(tt.PLSRegressor(3, device="cpu").fit(X[rep], Y[rep]).predict(Xn), et.predict(Xn), 1e-8)


def test_monitor_and_export_match_jax(tmp_path):
    X, Y, Xn = _raw(seed=4)
    et = tt.PLSRegressor(3, device="cpu").fit(X, Y)
    ej = pt.PLSRegressor(3).fit(X, Y)
    mt, mj = et.build_monitor(X, alpha=0.1), ej.build_monitor(X, alpha=0.1)
    _close(np.asarray(float(mt.t2_lim)), np.asarray(float(mj.t2_lim)))
    ct, cj = et.check(np.vstack([X, Xn * 3])), ej.check(np.vstack([X, Xn * 3]))
    for k in ("t2", "spe"):
        _close(ct[k], cj[k])
    for k in ("t2_ok", "spe_ok", "ok"):
        np.testing.assert_array_equal(ct[k], np.asarray(cj[k]))
    et.export_c(str(tmp_path / "t.plsb"))
    ej.export_c(str(tmp_path / "j.plsb"))
    a, b = tt.load_model_c(str(tmp_path / "t.plsb")), pt.load_model_c(str(tmp_path / "j.plsb"))
    for k in ("x_mean", "B_raw", "b0", "R_raw", "P_mon", "x_std", "s2"):
        _close(a[k], b[k], 1e-12)
    assert a["spe_lim"] == pytest.approx(b["spe_lim"], rel=1e-12)
    # the exported raw-unit operators reproduce predict
    _close((Xn - a["x_mean"]) @ a["B_raw"] + a["b0"], et.predict(Xn), 1e-10)


@pytest.mark.parametrize("kind", ["jackknife+", "cv+", "split"])
def test_predict_interval_matches_jax(kind):
    X, Y, Xn = _raw(seed=5, n=40)
    et = tt.PLSRegressor(2, device="cpu").fit(X, Y)
    ej = pt.PLSRegressor(2).fit(X, Y)
    mine = et.predict_interval(X, Y, Xn, kind=kind, n_folds=5, alpha=0.2)
    ref = ej.predict_interval(X, Y, Xn, kind=kind, n_folds=5, alpha=0.2)
    for a, b in zip(mine, ref):
        _close(a, b)
    with pytest.raises(ValueError, match="unknown kind"):
        et.predict_interval(X, Y, Xn, kind="bogus")


def test_plsglm_classifier_matches_jax():
    X, _, Xn = _raw(seed=6, n=80)
    y = np.where(X[:, 0] + 0.5 * X[:, 1] > np.median(X[:, 0] + 0.5 * X[:, 1]), "yes", "no")
    et = tt.PLSGLMClassifier(3, n_irls=10, device="cpu").fit(X, y)
    ej = pt.PLSGLMClassifier(3, n_irls=10).fit(X, y)
    np.testing.assert_array_equal(et.classes_, ej.classes_)
    _close(et.predict_proba(Xn), ej.predict_proba(Xn), 1e-8)
    _close(et.decision_function(Xn), ej.decision_function(Xn), 1e-8)
    _close(et.coef_, ej.coef_, 1e-8)
    _close(et.intercept_, ej.intercept_, 1e-8)
    assert et.deviance_ == pytest.approx(ej.deviance_, rel=1e-8)
    np.testing.assert_array_equal(et.predict(Xn), ej.predict(Xn))
    assert et.score(X, y) == ej.score(X, y)
    with pytest.raises(ValueError, match="binary"):
        tt.PLSGLMClassifier(device="cpu").fit(X, np.arange(80) % 3)


def test_plsda_classifier_matches_jax():
    X, _, Xn = _raw(seed=7, n=90)
    y = np.array(["a", "b", "c"])[np.argmax(X[:, :3] - X[:, :3].mean(0), axis=1)]
    et = PLSDAClassifier(3, device="cpu").fit(X, y)
    ej = JaxPLSDA(3).fit(X, y)
    _close(et.decision_function(Xn), ej.decision_function(Xn))
    _close(et.predict_proba(Xn), ej.predict_proba(Xn))
    np.testing.assert_array_equal(et.predict(Xn), ej.predict(Xn))
    assert et.score(X, y) == ej.score(X, y)
    mine, ref = et.transform(Xn), ej.transform(Xn)
    _close(mine * np.sign(np.sum(mine * ref, 0)), ref)
    assert et.get_params()["device"] == "cpu"
    with pytest.raises(ValueError, match="unknown parameter"):
        et.set_params(bogus=1)


ALL_ESTIMATORS = [tt.PLSRegressor, tt.RobustPLSRegressor, tt.SPLSRegressor, tt.OPLSRegressor,
                  tt.KPLSRegressor, tt.PLSCanonical, tt.CCA, tt.PLSSVD, tt.PLSGLMClassifier,
                  PLSDAClassifier]


@pytest.mark.parametrize("cls", ALL_ESTIMATORS, ids=lambda c: c.__name__)
def test_device_is_a_parameter_and_there_is_no_cpu_fallback(cls):
    est = cls(device="cpu")
    assert est.get_params()["device"] == "cpu"
    assert est.set_params(device=None).device is None
    X, Y, _ = _raw(seed=8)
    y = (Y[:, 0] > Y[:, 0].mean()).astype(int) if cls in (tt.PLSGLMClassifier, PLSDAClassifier) \
        else Y
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy data goes to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls().fit(X, y)
    # a CPU tensor names its device
    cls().fit(torch.as_tensor(X), y)


@pytest.mark.parametrize("cls", ALL_ESTIMATORS, ids=lambda c: c.__name__)
def test_sklearn_clone_and_tags(cls):
    base = pytest.importorskip("sklearn.base")
    est = cls(device="cpu")
    c = base.clone(est)
    assert c.get_params() == est.get_params() and c is not est
    kind = "classifier" if cls in (tt.PLSGLMClassifier, PLSDAClassifier) else "regressor"
    assert est.__sklearn_tags__().estimator_type == kind


@pytest.mark.parametrize("cls", [tt.SNV, tt.SavitzkyGolay, tt.Detrend, tt.MSCorrection],
                         ids=lambda c: c.__name__)
def test_spectral_transformer_tags(cls):
    pytest.importorskip("sklearn")
    assert cls().__sklearn_tags__().transformer_tags is not None


def test_sklearn_pipeline_and_gridsearch():
    pytest.importorskip("sklearn")
    from sklearn.model_selection import GridSearchCV
    from sklearn.pipeline import make_pipeline

    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 20))
    y = 2 * X[:, 0] - X[:, 1] + 0.05 * rng.normal(size=60)
    gs = GridSearchCV(make_pipeline(tt.SNV(device="cpu"), tt.PLSRegressor(device="cpu")),
                      {"plsregressor__n_components": [1, 2, 4]}, cv=3,
                      scoring="neg_mean_squared_error")
    gs.fit(X, y)
    assert gs.best_params_["plsregressor__n_components"] >= 2
    assert gs.predict(X[:5]).shape[0] == 5


def test_sklearn_is_imported_only_for_tags():
    import subprocess
    import sys

    code = ("import sys, numpy as np, pls_tpu_torch as tt\n"
            "X = np.random.default_rng(0).normal(size=(20, 5))\n"
            "tt.PLSRegressor(2, device='cpu').fit(X, X[:, :1]).predict(X)\n"
            "assert 'sklearn' not in sys.modules and 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---------- on the card ----------
GPU_CASES = {
    "PLSRegressor": (lambda: tt.PLSRegressor(4), "deflate_f32", 4),
    "PLSRegressor_bf16": (lambda: tt.PLSRegressor(4, x_storage="bf16"), "deflate_bf16", 4),
    "RobustPLSRegressor": (lambda: tt.RobustPLSRegressor(3, n_irls=3), "deflate_f32", 12),
    "OPLSRegressor": (lambda: tt.OPLSRegressor(1, 2), "deflate_f32", 2),
    "SPLSRegressor": (lambda: tt.SPLSRegressor(2, keep_x=30), None, 0),
    "KPLSRegressor": (lambda: tt.KPLSRegressor(3), None, 0),
    "PLSCanonical": (lambda: tt.PLSCanonical(2), None, 0),
    "CCA": (lambda: tt.CCA(2), None, 0),
    "PLSGLMClassifier": (lambda: tt.PLSGLMClassifier(3, n_irls=4), "deflate_f32", 12),
    "PLSDAClassifier": (lambda: PLSDAClassifier(3), "deflate_f32", 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_estimator_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from pls_tpu_torch.ops import deflate

    make, kernel, launches = GPU_CASES[name]
    X, Y, Xn = _raw(seed=9, n=600, k=64)
    if name in ("PLSGLMClassifier", "PLSDAClassifier"):
        Y = (Y[:, 0] > np.median(Y[:, 0])).astype(int)
    card = make()
    before = dict(deflate.launches)
    card.fit(X, Y)  # numpy data and device None: float32 on the card
    if kernel is not None:
        assert deflate.launches[kernel] - before[kernel] == launches
    cpu = make().set_params(device="cpu").fit(X, Y)
    if name == "PLSDAClassifier":
        mine, ref = card.decision_function(Xn), cpu.decision_function(Xn)
    elif name == "PLSGLMClassifier":
        mine, ref = card.predict_proba(Xn), cpu.predict_proba(Xn)
    else:
        mine = card.predict(Xn) if name != "KPLSRegressor" else card.predict(Xn)
        ref = cpu.predict(Xn)
    assert isinstance(mine, np.ndarray) and mine.dtype == np.float32
    tol = 3e-2 if name == "PLSRegressor_bf16" else 2e-3
    np.testing.assert_allclose(mine, ref, atol=tol * np.abs(ref).max())
