"""OPLS-DA: orthogonal-filtered discriminant analysis (Bylesjö et al. 2006)
and the S-plot (Wiklund et al. 2008).

Counterpart of `pls_tpu/models/oplsda.py`: the OPLS orthogonal filter
(models/opls.py) on X against the centred class-indicator matrix, then
the predictive PLS fit on the filtered X (`kernel_pls.fit`: K1 on float32
X on the card for kernel type 1).  The S-plot ranks variables by the
covariance and correlation of each X column with the first predictive
score.

- functional: `fit_oplsda`, `decision_values`, `predict_classes`,
  `predict_proba`, `s_plot` on tensors with integer labels;
- `OPLSDAClassifier`: the sklearn protocol on any label values, numpy
  out, computed on its `device` parameter (None: the device of a tensor
  X, else the card), as estimator.py's estimators are.

Spans (`utils.profiling`): `pls.oplsda.fit` around the classifier's whole
fit, holding `pls.estimator.scale` (the z-scoring), `pls.opls.filter`,
the predictive `pls.fit` and `pls.oplsda.splot` (the filter applied again
to the training X, `pls.opls.correct`, and the S-plot's two K-vectors
read back); `pls.oplsda.decision` around the decision values of new data.
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.estimator import _EstimatorBase, _sklearn_tags
from pls_tpu_torch.models import predict as _predict
from pls_tpu_torch.models.opls import OPLSFit, correct, fit_opls
from pls_tpu_torch.models.plsda import _with_priors, one_hot
from pls_tpu_torch.models.predict import _promote
from pls_tpu_torch.preprocess import ZScorer
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD
from pls_tpu_torch.utils.profiling import span


def fit_oplsda(
    X: torch.Tensor,
    labels: torch.Tensor,
    n_classes: int,
    n_ortho: int,
    A: int = 1,
    method: METHOD = KERNEL_TYPE1,
    **kw,
) -> OPLSFit:
    """OPLS on the centred one-hot indicators of `labels` (X centred or
    z-scored by the caller).  Two classes: A = 1 is the canonical choice;
    more classes typically A = n_classes − 1."""
    Y = one_hot(torch.as_tensor(labels, device=X.device), n_classes, X.dtype)
    Y = Y - Y.mean(0, keepdim=True)
    return fit_opls(X, Y, n_ortho, A, method, **kw)


def decision_values(ofit: OPLSFit, Xn: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Predicted (centred) indicator scores after the orthogonal filter."""
    Xf, _ = correct(ofit, Xn)
    Xf, B = _promote(Xf, _predict.coefficients(ofit.pls, comp))
    return Xf @ B


def predict_classes(ofit: OPLSFit, Xn: torch.Tensor, priors=None,
                    comp: int | None = None) -> torch.Tensor:
    """argmax over the decision values (plus class priors if given)."""
    return torch.argmax(_with_priors(decision_values(ofit, Xn, comp), priors), 1)


def predict_proba(ofit: OPLSFit, Xn: torch.Tensor, priors=None,
                  comp: int | None = None) -> torch.Tensor:
    """Softmax of the decision values: a ranking convention, not a
    probability model."""
    return torch.softmax(_with_priors(decision_values(ofit, Xn, comp), priors), 1)


def s_plot(X: torch.Tensor, t: torch.Tensor):
    """S-plot coordinates against the score vector t: for each column k of
    the (centred) training X, p(cov)[k] = cov(t, x_k) and p(corr)[k] =
    corr(t, x_k) (N−1 denominators).  Returns (p_cov, p_corr), each (K,)."""
    X, t = _promote(X, t)
    n = X.shape[0]
    tc = t - t.mean()
    Xc = X - X.mean(0, keepdim=True)
    cov = (Xc.T @ tc) / (n - 1)
    sd_x = torch.sqrt((Xc * Xc).sum(0) / (n - 1))
    sd_t = torch.sqrt((tc * tc).sum() / (n - 1))
    pos = sd_x > 0
    corr = torch.where(pos, cov / torch.where(pos, sd_x * sd_t, 1.0), 0.0)
    return cov, corr


class OPLSDAClassifier(_EstimatorBase):
    """OPLS-DA with the sklearn protocol (cf. `PLSDAClassifier`).  Labels
    map to indicator columns in sorted order (`classes_`); X is z-scored
    internally by default.  `n_components` counts predictive components,
    `n_ortho` orthogonal ones."""

    _params = ("n_components", "n_ortho", "method", "scale", "power_iters", "precision",
               "device")

    def __init__(
        self,
        n_components: int = 1,
        n_ortho: int = 1,
        method: METHOD = KERNEL_TYPE1,
        scale: bool = True,
        power_iters: int | None = None,
        precision: str | None = "highest",
        device=None,
    ):
        self.n_components = n_components
        self.n_ortho = n_ortho
        self.method = method
        self.scale = scale
        self.power_iters = power_iters
        self.precision = precision
        self.device = device

    def __sklearn_tags__(self):
        return _sklearn_tags("classifier")

    def fit(self, X, y) -> "OPLSDAClassifier":
        with span("pls.oplsda.fit"):
            X = self._data(X)
            self.classes_, idx = np.unique(np.asarray(y), return_inverse=True)
            n_classes = len(self.classes_)
            if n_classes < 2:
                raise ValueError("need at least 2 classes")
            with span("pls.estimator.scale"):
                self._x_scaler = ZScorer.fit(X) if self.scale else None
                Xz = self._scale_x(X)
            self._priors = torch.as_tensor(np.bincount(idx, minlength=n_classes) / len(idx),
                                           dtype=Xz.dtype, device=Xz.device)
            self._fit = fit_oplsda(Xz, torch.as_tensor(idx, device=Xz.device), n_classes,
                                   self.n_ortho, self.n_components, self.method,
                                   power_iters=self.power_iters, precision=self.precision)
            # the S-plot's two K-vectors now, so that the (N, K) training
            # matrix is not kept
            with span("pls.oplsda.splot"):
                Xf, _ = correct(self._fit, Xz)
                t = Xf @ self._fit.pls.R[:, 0].to(Xf.dtype)
                self._s_plot = tuple(v.cpu().numpy() for v in s_plot(Xf, t))
        return self

    @property
    def r2x_ortho_(self) -> np.ndarray:
        """Share of X's sum of squares each orthogonal component removed."""
        return self._fit.r2x_o.cpu().numpy()

    def _decision(self, X) -> torch.Tensor:
        with span("pls.oplsda.decision"):
            return decision_values(self._fit, self._scale_x(X)) + self._priors[None, :]

    def decision_function(self, X) -> np.ndarray:
        return self._decision(X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[torch.argmax(self._decision(X), 1).cpu().numpy()]

    def predict_proba(self, X) -> np.ndarray:
        return torch.softmax(self._decision(X), 1).cpu().numpy()

    def score(self, X, y) -> float:
        """Mean accuracy."""
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def transform(self, X) -> np.ndarray:
        """Predictive latent scores (N, n_components) of the filtered X."""
        Xf, _ = correct(self._fit, self._scale_x(X))
        Xf, R = _promote(Xf, self._fit.pls.R)
        return (Xf @ R).cpu().numpy()

    def ortho_scores(self, X) -> np.ndarray:
        """Orthogonal scores (N, n_ortho)."""
        return correct(self._fit, self._scale_x(X))[1].cpu().numpy()

    def s_plot(self) -> tuple[np.ndarray, np.ndarray]:
        """(p_cov, p_corr) of the first predictive component against the
        orthogonality-filtered training matrix (z-scored units when
        scale=True), computed at fit time."""
        return self._s_plot
