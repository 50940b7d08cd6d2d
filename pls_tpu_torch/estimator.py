"""Scikit-learn-style estimators.

Counterpart of `pls_tpu/estimator.py`: the fit/predict/score protocol
(get_params/set_params) over the model families, duck-typed without
importing scikit-learn; `_sklearn_tags` imports it lazily, for sklearn's
tag protocol alone.  X and y are z-scored internally (the reference CLI's
convention) and predictions come back in raw units, as numpy arrays.

Families: PLSRegressor (kernel 1/2, NIPALS, SIMPLS), RobustPLSRegressor,
SPLSRegressor, OPLSRegressor, KPLSRegressor, PLSCanonical, CCA, PLSSVD,
PLSGLMClassifier, and PLSDAClassifier in models/plsda.py.

Every estimator computes on its `device` parameter: None is the device of
a tensor X, else the card (RuntimeError without one: pass device="cpu").
`device` is one of the estimator's parameters, so `get_params`,
`set_params` and `sklearn.clone` carry it.  Data that is not a floating
tensor goes to that device in `types.default_float_dtype` (float64 on the
CPU, float32 on the card, where kernel type 1's fits launch K1).
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.config import as_data
from pls_tpu_torch.models import predict as _predict
from pls_tpu_torch.models.kernel_pls import fit as _fit
from pls_tpu_torch.models.predict import _promote
from pls_tpu_torch.preprocess import ZScorer
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD
from pls_tpu_torch.utils.profiling import span


def _sklearn_tags(kind: str):
    """sklearn's tag object for `kind` ∈ {regressor, classifier,
    transformer}, from its own mixins through a shim class, so that the
    estimators follow the tag protocol without inheriting BaseEstimator.
    The one place the port imports sklearn; shared with spectral.py."""
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin, TransformerMixin

    mixin = {"regressor": RegressorMixin, "classifier": ClassifierMixin,
             "transformer": TransformerMixin}[kind]

    class _Shim(mixin, BaseEstimator):
        pass

    return _Shim().__sklearn_tags__()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _EstimatorBase:
    """The shared plumbing: parameters, internal z-scoring, raw-unit
    coefficients and uniform-average R² scoring."""

    _params: tuple[str, ...] = ()

    def get_params(self, deep: bool = True) -> dict:
        return {k: getattr(self, k) for k in self._params}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self._params:
                raise ValueError(f"unknown parameter {k}")
            setattr(self, k, v)
        return self

    def __sklearn_tags__(self):
        return _sklearn_tags("regressor")

    def _data(self, X) -> torch.Tensor:
        return as_data(X, self.device)

    def _xy(self, X, y):
        X = self._data(X)
        y = as_data(y, X.device).to(X.dtype)
        return X, (y[:, None] if y.ndim == 1 else y)

    def _scale_fit(self, X, y, sample_weight=None):
        X, y = self._xy(X, y)
        if self.scale:
            # weighted moments keep "integer weights == repeated rows" true
            # through the internal z-scoring
            with span("pls.estimator.scale"):
                self._x_scaler = ZScorer.fit(X, sample_weight)
                Xz = self._x_scaler.transform(X)
            self._y_scaler = ZScorer.fit(y, sample_weight)
            return Xz, self._y_scaler.transform(y)
        self._x_scaler = self._y_scaler = None
        return X, y

    def _scale_x(self, X) -> torch.Tensor:
        X = self._data(X)
        return self._x_scaler.transform(X) if self._x_scaler is not None else X

    def _unscale_y(self, yz: torch.Tensor) -> torch.Tensor:
        if self._y_scaler is None:
            return yz
        yz, mean, sd = _promote(yz, self._y_scaler.mean, self._y_scaler.stdev)
        return yz * sd[None, :] + mean[None, :]

    def _set_coef(self, coef_std: torch.Tensor) -> None:
        """sklearn's raw-unit `coef_` (n_targets, n_features) and
        `intercept_`: y = (X − x_mean) @ coef_.T + intercept_.  `coef_std`
        is the (K, M) matrix in internal units, kept on the device as
        `_coef_std` for predict."""
        self._coef_std = coef_std
        c = _np(coef_std)
        K, M = c.shape
        x_std, x_mean = ((_np(self._x_scaler.stdev).reshape(K), _np(self._x_scaler.mean).reshape(K))
                         if self._x_scaler is not None else (np.ones(K), np.zeros(K)))
        y_std, y_mean = ((_np(self._y_scaler.stdev).reshape(M), _np(self._y_scaler.mean).reshape(M))
                         if self._y_scaler is not None else (np.ones(M), np.zeros(M)))
        self.coef_ = (c * y_std[None, :]).T / x_std[None, :]
        self.intercept_ = y_mean
        self._x_mean = x_mean

    def _predict_linear(self, X) -> np.ndarray:
        Xz, B = _promote(self._scale_x(X), self._coef_std)
        return _np(self._unscale_y(Xz @ B))

    def _scores(self, X) -> np.ndarray:
        Xz, R = _promote(self._scale_x(X), self._fit.R)
        return _np(Xz @ R)

    def score(self, X, y) -> float:
        """R² of the prediction, averaged over the responses."""
        y = _np(y) if isinstance(y, torch.Tensor) else np.asarray(y)
        if y.ndim == 1:
            y = y[:, None]
        pred = np.asarray(self.predict(X)).reshape(y.shape)
        ss_res = np.sum((y - pred) ** 2, axis=0)
        ss_tot = np.sum((y - y.mean(axis=0)) ** 2, axis=0)
        return float(np.mean(1.0 - ss_res / ss_tot))


class PLSRegressor(_EstimatorBase):
    """PLS regression.  n_components (default 2); method (kernel 1/2,
    NIPALS, SIMPLS); scale: z-score X and y internally; power_iters and
    precision go to the fit; x_storage None or "bf16" (X stored in
    bfloat16 with float32 accumulation: K2 on the card); device (see the
    module's docstring).  After fit, `coef_` (n_targets, n_features) and
    `intercept_` follow sklearn's raw-unit convention."""

    _params = ("n_components", "method", "scale", "power_iters", "precision", "x_storage",
               "device")

    def __init__(
        self,
        n_components: int = 2,
        method: METHOD = KERNEL_TYPE1,
        scale: bool = True,
        power_iters: int | None = None,
        precision: str | None = "highest",
        x_storage: str | None = None,
        device=None,
    ):
        self.n_components = n_components
        self.method = method
        self.scale = scale
        self.power_iters = power_iters
        self.precision = precision
        self.x_storage = x_storage
        self.device = device

    def fit(self, X, y, sample_weight=None) -> "PLSRegressor":
        """Fit; an optional (N,) `sample_weight` weights the rows of the
        cross-products (integer weights == repeated rows)."""
        X = self._data(X)
        sw = None if sample_weight is None else as_data(sample_weight, X.device).to(X.dtype)
        Xz, yz = self._scale_fit(X, y, sw)
        self._fit = _fit(Xz, yz, self.n_components, self.method, sample_weight=sw,
                         power_iters=self.power_iters, precision=self.precision,
                         x_storage=self.x_storage)
        self._set_coef(_predict.coefficients(self._fit))
        return self

    def predict(self, X) -> np.ndarray:
        return self._predict_linear(X)

    def transform(self, X) -> np.ndarray:
        """Latent scores (n, n_components)."""
        return self._scores(X)

    @property
    def vip_(self) -> np.ndarray:
        """Variable importance in projection (fits that store their scores;
        for kernel type 2 call `vip(fit, X)`)."""
        return _np(_predict.vip(self._fit))

    def build_monitor(self, X, alpha: float = 0.05):
        """The T²/SPE admission gate (models/diagnostics.py) from raw-unit
        training X; afterwards `check` flags new batches."""
        from pls_tpu_torch.models.diagnostics import fit_monitor

        self._monitor = fit_monitor(self._fit, self._scale_x(X), alpha=alpha)
        return self._monitor

    def check(self, X) -> dict:
        """Per-sample T²/SPE statistics and in-control flags for raw-unit X,
        as numpy arrays (after `build_monitor`)."""
        return {k: _np(v) for k, v in self._monitor.check(self._scale_x(X)).items()}

    def export_c(self, path: str) -> None:
        """Write the PLSB file of export.py: raw-unit prediction operators,
        and the T²/SPE gate if `build_monitor` was called."""
        from pls_tpu_torch.export import export_model_c

        export_model_c(path, self._fit, x_scaler=self._x_scaler, y_scaler=self._y_scaler,
                       monitor=getattr(self, "_monitor", None))

    def predict_interval(self, X_train, y_train, X, *, alpha: float = 0.1,
                         kind: str = "jackknife+", n_folds: int = 10):
        """Distribution-free prediction intervals (cv/conformal.py) in raw
        units, with the scalers learned at fit time: kind "jackknife+" (N
        masked fits), "cv+" (n_folds) or "split" (one).  Returns (lo, hi,
        pred), each (n, M)."""
        from pls_tpu_torch.cv import conformal as cf

        Xz = self._scale_x(X_train)
        y = as_data(y_train, Xz.device).to(Xz.dtype)
        y = y[:, None] if y.ndim == 1 else y
        yz = self._y_scaler.transform(y) if self._y_scaler is not None else y
        Xn = self._scale_x(X)
        kw = dict(alpha=alpha, method=self.method)
        if kind == "jackknife+":
            out = cf.jackknife_plus_intervals(Xz, yz, Xn, self.n_components, **kw)
        elif kind == "cv+":
            out = cf.cv_plus_intervals(Xz, yz, Xn, self.n_components, n_folds=n_folds, **kw)
        elif kind == "split":
            out = cf.split_conformal_intervals(Xz, yz, Xn, self.n_components, **kw)
        else:
            raise ValueError(f"unknown kind {kind!r}")
        return tuple(_np(self._unscale_y(v)) for v in out)


class RobustPLSRegressor(_EstimatorBase):
    """Outlier-resistant PLS by IRPLS (models/robust.py); loss "huber" or
    "bisquare".  After fit, `sample_weight_` holds the final weights (≈ 0
    marks a rejected sample)."""

    _params = ("n_components", "method", "loss", "c", "n_irls", "scale", "device")

    def __init__(self, n_components: int = 2, method: METHOD = KERNEL_TYPE1, loss: str = "huber",
                 c: float | None = None, n_irls: int = 10, scale: bool = True, device=None):
        self.n_components = n_components
        self.method = method
        self.loss = loss
        self.c = c
        self.n_irls = n_irls
        self.scale = scale
        self.device = device

    def fit(self, X, y) -> "RobustPLSRegressor":
        from pls_tpu_torch.models.robust import fit_robust

        Xz, yz = self._scale_fit(X, y)
        self._fit, w = fit_robust(Xz, yz, self.n_components, self.method, loss=self.loss,
                                  c=self.c, n_irls=self.n_irls)
        self.sample_weight_ = _np(w)
        self._set_coef(_predict.coefficients(self._fit))
        return self

    def predict(self, X) -> np.ndarray:
        return self._predict_linear(X)

    def transform(self, X) -> np.ndarray:
        return self._scores(X)


class SPLSRegressor(_EstimatorBase):
    """Sparse PLS (models/sparse.py): keep_x / keep_y variables kept per
    component (an int or a per-component tuple; keep_x=None keeps all).
    After fit: `selected_` (the support), `coef_`, `vip_`."""

    _params = ("n_components", "keep_x", "keep_y", "n_iter", "scale", "precision", "device")

    def __init__(self, n_components: int = 2, keep_x=None, keep_y=None, n_iter: int = 20,
                 scale: bool = True, precision: str | None = "highest", device=None):
        self.n_components = n_components
        self.keep_x = keep_x
        self.keep_y = keep_y
        self.n_iter = n_iter
        self.scale = scale
        self.precision = precision
        self.device = device

    def fit(self, X, y) -> "SPLSRegressor":
        from pls_tpu_torch.models.sparse import fit_spls, selected_variables

        Xz, yz = self._scale_fit(X, y)
        keep_x = Xz.shape[1] if self.keep_x is None else self.keep_x
        self._fit = fit_spls(Xz, yz, self.n_components, keep_x, self.keep_y,
                             n_iter=self.n_iter, precision=self.precision)
        self._set_coef(_predict.coefficients(self._fit))
        self.selected_ = _np(selected_variables(self._fit))
        return self

    def predict(self, X) -> np.ndarray:
        return self._predict_linear(X)

    def transform(self, X) -> np.ndarray:
        return self._scores(X)

    @property
    def vip_(self) -> np.ndarray:
        return _np(_predict.vip(self._fit))


class OPLSRegressor(_EstimatorBase):
    """OPLS (models/opls.py): `n_ortho` Y-orthogonal components stripped
    from X before an `n_components` predictive fit.  After fit:
    `r2x_ortho_`; `transform_ortho(X)` gives new data's orthogonal
    scores."""

    _params = ("n_ortho", "n_components", "method", "scale", "precision", "device")

    def __init__(self, n_ortho: int = 1, n_components: int = 1, method: METHOD = KERNEL_TYPE1,
                 scale: bool = True, precision: str | None = "highest", device=None):
        self.n_ortho = n_ortho
        self.n_components = n_components
        self.method = method
        self.scale = scale
        self.precision = precision
        self.device = device

    def fit(self, X, y) -> "OPLSRegressor":
        from pls_tpu_torch.models.opls import fit_opls

        Xz, yz = self._scale_fit(X, y)
        self._fit = fit_opls(Xz, yz, self.n_ortho, self.n_components, self.method,
                             precision=self.precision)
        self.r2x_ortho_ = _np(self._fit.r2x_o)
        return self

    def predict(self, X) -> np.ndarray:
        from pls_tpu_torch.models.opls import predict

        return _np(self._unscale_y(predict(self._fit, self._scale_x(X))))

    def transform_ortho(self, X) -> np.ndarray:
        """Orthogonal scores of new data (n, n_ortho)."""
        from pls_tpu_torch.models.opls import correct

        return _np(correct(self._fit, self._scale_x(X))[1])


class KPLSRegressor(_EstimatorBase):
    """Nonlinear kernel PLS (models/kpls.py); kernel "rbf", "poly" or
    "linear"; gamma defaults to 1/K."""

    _params = ("n_components", "kernel", "gamma", "degree", "coef0", "scale", "precision",
               "device")

    def __init__(self, n_components: int = 2, kernel: str = "rbf", gamma: float | None = None,
                 degree: int = 3, coef0: float = 1.0, scale: bool = True,
                 precision: str | None = "highest", device=None):
        self.n_components = n_components
        self.kernel = kernel
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.scale = scale
        self.precision = precision
        self.device = device

    def fit(self, X, y) -> "KPLSRegressor":
        from pls_tpu_torch.models.kpls import fit_kpls

        Xz, yz = self._scale_fit(X, y)
        self._fit = fit_kpls(Xz, yz, self.n_components, self.kernel, gamma=self.gamma,
                             degree=self.degree, coef0=self.coef0, precision=self.precision)
        return self

    def predict(self, X) -> np.ndarray:
        from pls_tpu_torch.models.kpls import predict_kpls

        return _np(self._unscale_y(predict_kpls(self._fit, self._scale_x(X))))


class _CrossDecompBase(_EstimatorBase):
    """The two-block estimators: X and Y always centred, and divided by
    their stdevs when scale=True; raw-unit coef_/intercept_."""

    def _center_fit(self, X, y):
        X, y = self._xy(X, y)
        if self.scale:
            self._x_scaler, self._y_scaler = ZScorer.fit(X), ZScorer.fit(y)
        else:
            self._x_scaler = ZScorer(mean=X.mean(0), stdev=X.new_ones(X.shape[1]))
            self._y_scaler = ZScorer(mean=y.mean(0), stdev=y.new_ones(y.shape[1]))
        return self._x_scaler.transform(X), self._y_scaler.transform(y)

    def _finalize(self):
        from pls_tpu_torch.models.crossdecomp import cd_coefficients

        f = self._fit
        self.x_weights_, self.y_weights_ = _np(f.W), _np(f.C)
        self.x_loadings_, self.y_loadings_ = _np(f.P), _np(f.Q)
        self.x_scores_, self.y_scores_ = _np(f.T), _np(f.U)
        self.x_rotations_, self.y_rotations_ = _np(f.R), _np(f.Ry)
        self._set_coef(cd_coefficients(f))
        return self

    def transform(self, X, y=None):
        xs = self._scores(X)
        if y is None:
            return xs
        y = as_data(y, self._fit.R.device).to(self._fit.R.dtype)
        y = y[:, None] if y.ndim == 1 else y
        return xs, _np(self._y_scaler.transform(y) @ self._fit.Ry)

    def predict(self, X) -> np.ndarray:
        return self._predict_linear(X)


class PLSCanonical(_CrossDecompBase):
    """Two-block mode-A PLS with canonical deflation (models/crossdecomp.py);
    sklearn's PLSCanonical."""

    _params = ("n_components", "scale", "tol", "max_iter", "device")

    def __init__(self, n_components: int = 2, scale: bool = True, tol: float = 1e-6,
                 max_iter: int = 500, device=None):
        self.n_components = n_components
        self.scale = scale
        self.tol = tol
        self.max_iter = max_iter
        self.device = device

    def fit(self, X, y) -> "PLSCanonical":
        from pls_tpu_torch.models.crossdecomp import fit_plscanonical

        Xz, yz = self._center_fit(X, y)
        self._fit = fit_plscanonical(Xz, yz, self.n_components, tol=self.tol,
                                     max_iter=self.max_iter)
        return self._finalize()


class CCA(_CrossDecompBase):
    """Canonical correlation analysis by mode-B power iteration
    (models/crossdecomp.py); sklearn's CCA."""

    _params = ("n_components", "scale", "tol", "max_iter", "device")

    def __init__(self, n_components: int = 2, scale: bool = True, tol: float = 1e-6,
                 max_iter: int = 500, device=None):
        self.n_components = n_components
        self.scale = scale
        self.tol = tol
        self.max_iter = max_iter
        self.device = device

    def fit(self, X, y) -> "CCA":
        from pls_tpu_torch.models.crossdecomp import fit_cca

        Xz, yz = self._center_fit(X, y)
        self._fit = fit_cca(Xz, yz, self.n_components, tol=self.tol, max_iter=self.max_iter)
        return self._finalize()


class PLSSVD(_CrossDecompBase):
    """One-shot PLS-SVD (the top singular triplets of XᵀY); transform only."""

    _params = ("n_components", "scale", "device")

    def __init__(self, n_components: int = 2, scale: bool = True, device=None):
        self.n_components = n_components
        self.scale = scale
        self.device = device

    def fit(self, X, y) -> "PLSSVD":
        from pls_tpu_torch.models.crossdecomp import fit_plssvd

        Xz, yz = self._center_fit(X, y)
        self._fit = fit_plssvd(Xz, yz, self.n_components)
        return self._finalize()

    def predict(self, X):
        raise AttributeError("PLSSVD is transform-only (no regression path)")


class PLSGLMClassifier(_EstimatorBase):
    """Binary logistic PLS-GLM (models/plsglm.py) with sklearn's classifier
    protocol; labels may be any two values.  n_components=n_features is an
    unregularised logistic regression; fewer components shrink as PLS
    does."""

    _params = ("n_components", "n_irls", "scale", "precision", "device")

    def __init__(self, n_components: int = 2, n_irls: int = 25, scale: bool = True,
                 precision: str | None = "highest", device=None):
        self.n_components = n_components
        self.n_irls = n_irls
        self.scale = scale
        self.precision = precision
        self.device = device

    def fit(self, X, y) -> "PLSGLMClassifier":
        from pls_tpu_torch.models.plsglm import fit_plsglm

        X = self._data(X)
        y = _np(y).reshape(-1) if isinstance(y, torch.Tensor) else np.asarray(y).reshape(-1)
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f"binary classifier: got {len(self.classes_)} classes")
        y01 = torch.as_tensor((y == self.classes_[1]).astype(float), dtype=X.dtype,
                              device=X.device)
        self._x_scaler = ZScorer.fit(X) if self.scale else None
        Xz = self._x_scaler.transform(X) if self.scale else X
        self._glm = fit_plsglm(Xz, y01, self.n_components, "binomial", n_irls=self.n_irls,
                               precision=self.precision)
        self.deviance_ = float(self._glm.deviance)
        # sklearn-convention raw-unit coefficients of the linear predictor
        coef, b0 = _np(self._glm.coef), float(self._glm.intercept)
        if self._x_scaler is not None:
            sd, mu = _np(self._x_scaler.stdev), _np(self._x_scaler.mean)
            self.coef_ = (coef / sd)[None, :]
            self.intercept_ = np.asarray(b0 - (mu / sd) @ coef).reshape(1)
        else:
            self.coef_ = coef[None, :]
            self.intercept_ = np.asarray(b0).reshape(1)
        return self

    def predict_proba(self, X) -> np.ndarray:
        from pls_tpu_torch.models.plsglm import predict_plsglm

        p1 = _np(predict_plsglm(self._glm, self._scale_x(X)))
        return np.stack([1 - p1, p1], axis=1)

    def decision_function(self, X) -> np.ndarray:
        from pls_tpu_torch.models.plsglm import predict_plsglm

        return _np(predict_plsglm(self._glm, self._scale_x(X), linear=True))

    def predict(self, X) -> np.ndarray:
        return self.classes_[(self.predict_proba(X)[:, 1] >= 0.5).astype(int)]

    def score(self, X, y) -> float:
        """Classification accuracy."""
        y = _np(y) if isinstance(y, torch.Tensor) else np.asarray(y)
        return float(np.mean(self.predict(X) == y.reshape(-1)))

    def __sklearn_tags__(self):
        return _sklearn_tags("classifier")
