"""PLS-DA: discriminant analysis on PLS2.

Counterpart of `pls_tpu/models/plsda.py`: class labels become centred
one-hot indicator columns, a multi-response PLS fit (`kernel_pls.fit`:
K1 on float32 X on the card for kernel type 1) maps X to them, and the
largest predicted indicator is the class.

- functional: `fit_plsda`, `decision_values`, `predict_classes`,
  `predict_proba` on tensors with integer labels;
- `PLSDAClassifier`: the sklearn protocol (fit/predict/predict_proba/
  score/transform) on any label values, returning numpy arrays, computed on
  `device` (None: that of a tensor X, else the card), as estimator.py's
  estimators are.
"""

from __future__ import annotations

import numpy as np
import torch

from pls_tpu_torch.estimator import _EstimatorBase, _sklearn_tags
from pls_tpu_torch.models import predict as _predict
from pls_tpu_torch.models.kernel_pls import fit as _fit
from pls_tpu_torch.models.predict import _promote
from pls_tpu_torch.preprocess import ZScorer
from pls_tpu_torch.types import KERNEL_TYPE1, METHOD, PLSFit
from pls_tpu_torch.utils.profiling import span


def one_hot(labels: torch.Tensor, n_classes: int, dtype=torch.float32) -> torch.Tensor:
    """(N,) integer labels in [0, n_classes) -> (N, n_classes) indicators."""
    return torch.nn.functional.one_hot(torch.as_tensor(labels).long(), n_classes).to(dtype)


def fit_plsda(
    X: torch.Tensor, labels: torch.Tensor, n_classes: int, A: int,
    method: METHOD = KERNEL_TYPE1, **kw,
) -> PLSFit:
    """PLS2 on the centred one-hot indicators (X pre-scaled by the caller)."""
    Y = one_hot(torch.as_tensor(labels, device=X.device), n_classes, X.dtype)
    return _fit(X, Y - Y.mean(0, keepdim=True), A, method, **kw)


def decision_values(f: PLSFit, Xn: torch.Tensor, comp: int | None = None) -> torch.Tensor:
    """Predicted (centred) indicator scores, (N, n_classes)."""
    Xn, B = _promote(Xn, _predict.coefficients(f, comp))
    return Xn @ B


def _with_priors(d: torch.Tensor, priors) -> torch.Tensor:
    return d if priors is None else d + torch.as_tensor(priors, device=d.device)[None, :]


def predict_classes(f: PLSFit, Xn: torch.Tensor, priors=None, comp: int | None = None):
    """argmax over the predicted indicators (plus class priors if given)."""
    return torch.argmax(_with_priors(decision_values(f, Xn, comp), priors), 1)


def predict_proba(f: PLSFit, Xn: torch.Tensor, priors=None, comp: int | None = None):
    """Softmax of the decision values: a calibration convention for ranking
    and thresholds, not a probability model."""
    return torch.softmax(_with_priors(decision_values(f, Xn, comp), priors), 1)


class PLSDAClassifier(_EstimatorBase):
    """PLS-DA with the sklearn protocol (estimator.py's parameters, `device`
    among them).  Labels map to indicator columns in sorted order
    (`classes_`); X is z-scored internally by default."""

    _params = ("n_components", "method", "scale", "power_iters", "precision", "device")

    def __init__(
        self,
        n_components: int = 2,
        method: METHOD = KERNEL_TYPE1,
        scale: bool = True,
        power_iters: int | None = None,
        precision: str | None = "highest",
        device=None,
    ):
        self.n_components = n_components
        self.method = method
        self.scale = scale
        self.power_iters = power_iters
        self.precision = precision
        self.device = device

    def __sklearn_tags__(self):
        return _sklearn_tags("classifier")

    def fit(self, X, y) -> "PLSDAClassifier":
        with span("pls.plsda.fit"):
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
            self._fit = fit_plsda(Xz, torch.as_tensor(idx, device=Xz.device), n_classes,
                                  self.n_components, self.method, power_iters=self.power_iters,
                                  precision=self.precision)
        return self

    def _decision(self, X) -> torch.Tensor:
        # the priors added back: B maps centred X to centred indicators
        with span("pls.plsda.decision"):
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
        """Latent scores (N, n_components)."""
        return self._scores(X)
