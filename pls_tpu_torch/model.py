"""The model object, mirroring the reference's `PLS::Model` API.

Counterpart of `pls_tpu/model.py` (reference pls.h:184-266): construction
fits once; every method delegates to the functions in models/ and cv/.

API (reference → here):
  Model(X, Y, algorithm, max_components) → PLSModel(X, Y, method, max_components)
  scores/coefficients/fitted_values/residuals/SSE/explained_variance(…, comp)
  loadingsX/loadingsY                    → implemented (the reference only declares them)
  cv_LOO / cv_NEW_DATA / cv_LSO          → same names; cv_LSO takes a GccRng
                                           (the reference's exact partitions),
                                           an int JAX seed or JAX key (the JAX
                                           package's partitions), or a
                                           torch.Generator
  cv_LOO(downdate=True), cv_KFOLD        → `pls_tpu/model.py:202-255`
  bootstrap_coefficient_intervals        → `pls_tpu/model.py:285-307`
  print_state / print_explained_variance → the same stderr tables
  save / load                            → the JAX package's .npz format
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pls_tpu_torch.config import resolve_device
from pls_tpu_torch.convert import fit_from_numpy, fit_to_numpy
from pls_tpu_torch.cv.kfold import cv_kfold, cv_kfold_downdate
from pls_tpu_torch.cv.loo import cv_loo, cv_loo_downdate
from pls_tpu_torch.cv.lso import cv_lso
from pls_tpu_torch.cv.newdata import cv_new_data
from pls_tpu_torch.models import predict as _predict
from pls_tpu_torch.models.kernel_pls import fit as _fit
from pls_tpu_torch.ops.stats import sst
from pls_tpu_torch.types import METHOD, PLSFit, Residual
from pls_tpu_torch.utils.gcc_rng import GccRng
from pls_tpu_torch.utils.profiling import span
from pls_tpu_torch.utils.reporting import format_eigen, format_eigen_complex, host


class PLSModel:
    """Fits on `device`; None is the device of a tensor X, or the card for
    other data (RuntimeError without one: pass device="cpu")."""

    def __init__(
        self,
        X,
        Y,
        method: METHOD = METHOD.KERNEL_TYPE1,
        max_components: int | None = None,
        *,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        power_iters: int | None = None,
        precision: str | None = "highest",
        x_storage: str | None = None,
        _fit_state: PLSFit | None = None,
    ):
        device = resolve_device(device, X)
        X = torch.as_tensor(X, dtype=dtype, device=device)
        Y = torch.as_tensor(Y, dtype=dtype, device=device)
        if Y.ndim == 1:
            Y = Y[:, None]
        if X.shape[0] == 0:
            raise ValueError("X has no rows")  # reference assert pls.cpp:346
        if X.shape[0] != Y.shape[0]:
            raise ValueError(  # reference assert pls.cpp:347
                f"X has {X.shape[0]} rows but Y has {Y.shape[0]}"
            )
        A = X.shape[1] if max_components is None else int(max_components)
        if not (0 < A <= X.shape[1]):
            raise ValueError(  # reference assert pls.cpp:345
                f"max_components={A} must be in (0, {X.shape[1]}]"
            )
        self._X = X
        self._Y = Y
        self._method = method
        self._power_iters = power_iters
        self._precision = precision
        self._fit = (
            _fit(
                X, Y, A, method, power_iters=power_iters, precision=precision,
                x_storage=x_storage,
            )
            if _fit_state is None
            else _fit_state
        )

    # ---------- state accessors ----------
    @property
    def X(self) -> torch.Tensor:
        return self._X

    @property
    def Y(self) -> torch.Tensor:
        return self._Y

    @property
    def A(self) -> int:
        return self._fit.A

    @property
    def method(self) -> METHOD:
        return self._method

    @property
    def fit_state(self) -> PLSFit:
        return self._fit

    @property
    def W(self) -> torch.Tensor:
        return self._fit.W

    @property
    def P(self) -> torch.Tensor:
        return self._fit.P

    @property
    def Q(self) -> torch.Tensor:
        return self._fit.Q

    @property
    def R(self) -> torch.Tensor:
        return self._fit.R

    @property
    def T(self) -> torch.Tensor:
        return self._fit.T

    def refit(self, X, Y, method: METHOD | None = None) -> "PLSModel":
        """A new model of the same size on new data (the reference's
        `Model::plsr` re-fit, pls.cpp:390), in the new X's own precision:
        `x_storage` applies to the fit it was given to, as in the JAX
        package."""
        return PLSModel(
            X, Y, self._method if method is None else method, self.A,
            power_iters=self._power_iters, precision=self._precision,
        )

    def _require_data(self) -> None:
        if self._X is None:
            raise ValueError(
                "this model was loaded from a data-less checkpoint "
                "(save(include_data=False)); pass X/Y explicitly"
            )

    def _on_device(self, A) -> torch.Tensor:
        """Data on the model's device; floating data keeps its dtype."""
        ref = self._fit.R
        A = torch.as_tensor(A, device=ref.device)
        return A if A.is_floating_point() else A.to(ref.dtype)

    def _x(self, X_new) -> torch.Tensor:
        if X_new is None:
            self._require_data()
            return self._X
        return self._on_device(X_new)

    def _xy(self, X_new, Y_new):
        if Y_new is None:
            self._require_data()
            Y_new = self._Y
        Y_new = self._on_device(Y_new)
        return self._x(X_new), (Y_new[:, None] if Y_new.ndim == 1 else Y_new)

    # ---------- prediction / diagnostics ----------
    def scores(self, X_new=None, comp: int | None = None) -> torch.Tensor:
        return _predict.scores(self._fit, self._x(X_new), comp)

    def loadingsX(self, comp: int | None = None) -> torch.Tensor:
        return _predict.loadings_x(self._fit, comp)

    def loadingsY(self, comp: int | None = None) -> torch.Tensor:
        return _predict.loadings_y(self._fit, comp)

    def coefficients(self, comp: int | None = None) -> torch.Tensor:
        return _predict.coefficients(self._fit, comp)

    def fitted_values(self, X_new=None, comp: int | None = None) -> torch.Tensor:
        return _predict.fitted_values(self._fit, self._x(X_new), comp)

    def residuals(self, X_new=None, Y_new=None, comp: int | None = None) -> torch.Tensor:
        return _predict.residuals(self._fit, *self._xy(X_new, Y_new), comp)

    def SSE(self, X_new=None, Y_new=None, comp: int | None = None) -> torch.Tensor:
        return _predict.sse(self._fit, *self._xy(X_new, Y_new), comp)

    def explained_variance(self, X_new=None, Y_new=None, comp: int | None = None) -> torch.Tensor:
        return _predict.explained_variance(self._fit, *self._xy(X_new, Y_new), comp)

    # ---------- cross-validation ----------
    def cv_LOO(self, *, batch_size: int | None = None, downdate: bool = False) -> Residual:
        """LOO CV: masked refits with the model's method, or (downdate=True,
        kernel methods only) rank-1 downdates of XᵀX/XᵀY, which fit kernel
        type 2 from the statistics.  The refits, like those of every CV
        method here, run in X's own precision, whatever `x_storage` the
        model was fitted with (`pls_tpu/model.py:202-221`)."""
        self._require_data()
        common = dict(batch_size=batch_size, power_iters=self._power_iters,
                      precision=self._precision)
        if downdate:
            if self._method not in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
                raise ValueError(
                    "downdate LOO computes the kernel-PLS model from "
                    "X'X/X'Y statistics; it would silently cross-validate "
                    f"a different model than {self._method} — use "
                    "cv_LOO(downdate=False)"
                )
            return cv_loo_downdate(self._X, self._Y, self.A, **common)
        return cv_loo(self._X, self._Y, self.A, self._method, **common)

    def cv_KFOLD(
        self,
        k: int = 10,
        *,
        key=0,
        assignments=None,
        downdate: bool = True,
        batch_size: int | None = None,
    ) -> Residual:
        """K-fold CV over the JAX-keyed partition of `key` (or the given
        `assignments`).  downdate=True (kernel methods) refits each fold from
        block-downdated XᵀX/XᵀY; False runs masked refits with the model's
        own method."""
        self._require_data()
        common = dict(k=k, key=key, assignments=assignments, batch_size=batch_size,
                      power_iters=self._power_iters, precision=self._precision)
        if downdate and self._method in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
            return cv_kfold_downdate(self._X, self._Y, self.A, **common)
        return cv_kfold(self._X, self._Y, self.A, method=self._method, **common)

    def cv_NEW_DATA(self, X_new, Y_new) -> Residual:
        return cv_new_data(self._fit, self._on_device(X_new), self._on_device(Y_new))

    def cv_LSO(
        self,
        test_fraction: float,
        num_trials: int,
        rng=None,
        *,
        batch_size: int | None = None,
    ) -> Residual:
        """Monte-Carlo CV (`pls_tpu/model.py:257-283`).  `rng` may be a
        GccRng (the reference's exact partitions; its state carries across
        calls like the reference's `std::mt19937&`), an int JAX seed or a
        JAX key (uint32 (2,) data; the JAX package's partitions bit for
        bit), None (JAX key 0), or a torch.Generator."""
        self._require_data()
        N = self._X.shape[0]
        partitions = generator = key = None
        if isinstance(rng, GccRng):
            with span("pls.lso.partitions"):
                partitions = rng.lso_partitions(N, num_trials)
        elif isinstance(rng, torch.Generator):
            generator = rng
        else:
            key = 0 if rng is None else rng
        return cv_lso(
            self._X, self._Y, self.A, test_fraction, num_trials, self._method,
            generator=generator, key=key, partitions=partitions, batch_size=batch_size,
            power_iters=self._power_iters, precision=self._precision,
        )

    def bootstrap_coefficient_intervals(
        self,
        num_replicates: int = 200,
        *,
        alpha: float = 0.05,
        key=None,
        comp: int | None = None,
        batch_size: int | None = None,
    ):
        """Percentile bootstrap intervals for the coefficients of a `comp`
        (default A) component fit by the model's method (cv/bootstrap.py;
        `pls_tpu/model.py:285-307`).  `key`: a JAX key's data or an int
        seed, None for key 0.  Returns (lower, upper, draws)."""
        from pls_tpu_torch.cv.bootstrap import bootstrap_coefficient_intervals

        self._require_data()
        return bootstrap_coefficient_intervals(
            self._X, self._Y, self.A if comp is None else comp, num_replicates,
            0 if key is None else key, self._method, alpha=alpha, batch_size=batch_size,
            precision=self._precision,
        )

    # ---------- reports (reference pls.cpp:551-580) ----------
    def explained_variance_profile(self, X=None, Y=None):
        """(sse, ev), each (A, M): SSE and explained variance at every
        truncation, from one residual pass."""
        X, Y = self._xy(X, Y)
        res = _predict.residuals_all_components(self._fit, X, Y)  # (n, A, M)
        sse = (res * res).sum(0)
        return sse, 1.0 - sse / sst(Y)[None, :]

    def print_explained_variance(self, X=None, Y=None, file=None) -> None:
        file = sys.stderr if file is None else file
        sse, ev = (host(v) for v in self.explained_variance_profile(X, Y))
        wd = max(1, int(np.ceil(np.log10(max(self.A, 2)))))
        for ncomp in range(1, self.A + 1):
            print(
                f"{ncomp:>{wd}} components explained variance: "
                f"{format_eigen(ev[ncomp - 1])}  - SSE: "
                f"{format_eigen(sse[ncomp - 1])}",
                file=file,
            )

    def print_state(self, file=None, complex_format: bool = False) -> None:
        """Dump P/W/R/Q/T/coefficients (pls.cpp:564-580).  complex_format
        renders entries as Eigen's complex '(re,0)' for byte diffs against
        the reference CLI."""
        fmt = format_eigen_complex if complex_format else format_eigen
        file = sys.stderr if file is None else file
        for label, mat in [
            ("P", self.P), ("W", self.W), ("R", self.R), ("Q", self.Q),
            ("T", self.T), ("coefficients", self.coefficients()),
        ]:
            print(f"{label}:", file=file)
            # Eigen prints an empty matrix as just the newline
            print(fmt(host(mat)) if mat.numel() else "", file=file)

    # ---------- checkpointing ----------
    def save(self, path: str, *, include_data: bool = False) -> None:
        """Write the fit state (W/P/Q/R/T + config) to .npz, in the JAX
        package's format; `include_data` also stores X and Y."""
        arrays = fit_to_numpy(self._fit)
        if include_data:
            arrays["X"] = self._X.cpu().numpy()
            arrays["Y"] = self._Y.cpu().numpy()
        np.savez(
            path,
            **arrays,
            meta=json.dumps({
                "method": self._method.value, "A": self.A,
                "power_iters": self._power_iters, "precision": self._precision,
            }),
        )

    @classmethod
    def load(cls, path: str, *, device: torch.device | str | None = None) -> "PLSModel":
        """Read an .npz written by either package's `save`, onto `device`
        (None: the card, as every entry point of the port)."""
        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            method = METHOD(meta["method"])
            fit_state = fit_from_numpy(z, method, device=device)
            data = (z["X"], z["Y"]) if "X" in z else None
        opts = dict(power_iters=meta.get("power_iters"), precision=meta.get("precision", "highest"))
        if data is not None:
            return cls(*data, method, meta["A"], device=device, _fit_state=fit_state, **opts)
        m = object.__new__(cls)  # data-less checkpoint: __init__ needs X/Y
        m._X = m._Y = None
        m._method = method
        m._power_iters = opts["power_iters"]
        m._precision = opts["precision"]
        m._fit = fit_state
        return m
