"""Spectral preprocessing: the chemometric transforms applied before PLS.

Counterpart of `pls_tpu/spectral.py` (rows = samples, columns =
channels):

- `snv`: standard normal variate, per-row centring and unit variance
  (Barnes, Dhanoa & Lister 1989);
- `msc` / `MSCorrection`: multiplicative scatter correction against a
  reference spectrum, by default the training mean (Geladi, MacDougall &
  Martens 1985);
- `savgol`: Savitzky–Golay smoothing and derivatives with scipy's
  mode="interp" edges (Savitzky & Golay 1964): the interior is one
  `torch.nn.functional.conv1d` (a cross-correlation, as
  `lax.conv_general_dilated`), the `window // 2` edge points on each side
  two small products with the polynomial-fit matrices;
- `detrend`: subtract a per-row least-squares polynomial baseline;
- `normalize`: per-row l1/l2/max/area scaling;
- `apply_chain`: the CLI's `--preprocess` chain, e.g. "savgol:11:2:1,snv".

The coefficient matrices are built in numpy float64, as in the JAX
package, and cast to X's dtype.  The functions take a tensor and compute
on its device; other data goes to the card (`config.resolve_device`:
RuntimeError without one).  `SNV`, `SavitzkyGolay`, `Detrend` and
`MSCorrection` follow the sklearn protocol (fit/transform/get_params/
set_params, and sklearn's tags through `estimator._sklearn_tags`) and
return numpy arrays, as the JAX package's do.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch
import torch.nn.functional as F

from pls_tpu_torch.config import resolve_device

__all__ = [
    "snv",
    "msc",
    "MSCorrection",
    "savgol",
    "savgol_coeffs",
    "detrend",
    "normalize",
    "SNV",
    "SavitzkyGolay",
    "Detrend",
]


def _rows(X, device=None) -> torch.Tensor:
    """X as a 2-D tensor (a 1-D X is one row), on `device` or its own."""
    X = torch.as_tensor(X, device=resolve_device(device, X))
    return X[None, :] if X.ndim == 1 else X


def _const(a: np.ndarray, X: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=X.dtype, device=X.device)


def snv(X) -> torch.Tensor:
    """Standard normal variate: per-row (x − mean) / stdev (ddof = 1); a
    constant row maps to 0."""
    X = _rows(X)
    Xc = X - X.mean(1, keepdim=True)
    sd = torch.sqrt((Xc * Xc).sum(1, keepdim=True) / max(X.shape[1] - 1, 1))
    zero = sd == 0
    return torch.where(zero, torch.zeros_like(Xc), Xc / torch.where(zero, torch.ones_like(sd), sd))


def _msc_apply(X: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    refc = ref - ref.mean()
    mu = X.mean(1, keepdim=True)
    # per-row least squares of x on [1, ref]: b = cov(ref, x)/var(ref), a = x̄ − b·ref̄
    b = ((X - mu) @ refc) / (refc @ refc)
    # a near-zero slope (a dead sensor) passes the row through unchanged
    degenerate = b.abs() < 1e-8
    b = torch.where(degenerate, torch.ones_like(b), b)
    a = torch.where(degenerate, torch.zeros_like(b), mu[:, 0] - b * ref.mean())
    return (X - a[:, None]) / b[:, None]


def msc(X, reference=None) -> torch.Tensor:
    """Multiplicative scatter correction against `reference` (default the
    column-mean spectrum of X itself); `MSCorrection` keeps a training
    mean for new spectra."""
    X = _rows(X)
    ref = X.mean(0) if reference is None else torch.as_tensor(reference, device=X.device)
    return _msc_apply(X, ref.to(X.dtype))


class MSCorrection:
    """Stateful MSC (sklearn protocol): the reference spectrum is the
    training set's mean, learned at fit time, on `device` (None: that of a
    tensor X, else the card)."""

    def __init__(self, device=None):
        self.device = device
        self.reference_: np.ndarray | None = None

    def fit(self, X, y=None) -> "MSCorrection":
        self.reference_ = _rows(X, self.device).mean(0).cpu().numpy()
        return self

    def transform(self, X) -> np.ndarray:
        if self.reference_ is None:
            raise RuntimeError("MSCorrection.transform called before fit")
        X = _rows(X, self.device)
        return _msc_apply(X, _const(self.reference_, X)).cpu().numpy()

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_params(self, deep: bool = True) -> dict:
        return {"device": self.device}

    def set_params(self, **params) -> "MSCorrection":
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def __sklearn_tags__(self):
        return _transformer_tags()


def savgol_coeffs(window: int, polyorder: int, deriv: int = 0, delta: float = 1.0) -> np.ndarray:
    """Centred Savitzky–Golay coefficients (length `window`): y[i] =
    c · x[i-h : i+h+1] is the `deriv`-th derivative of the local
    degree-`polyorder` least-squares polynomial at the centre; scipy's
    savgol_coeffs(..., use='dot')."""
    inter, _, _ = _sg_matrices(window, polyorder, deriv, delta)
    return inter


def _sg_matrices(window: int, polyorder: int, deriv: int, delta: float):
    """The Savitzky–Golay operators in numpy float64: the interior
    coefficients (window,) and the left/right edge matrices (half, window)
    of scipy's mode='interp', whose edge values come from the polynomial
    fitted to the first/last `window` samples (`pls_tpu/spectral.py:134-172`)."""
    if window % 2 != 1 or window < 3:
        raise ValueError(f"window={window} must be odd and >= 3")
    if polyorder >= window:
        raise ValueError(f"polyorder={polyorder} must be < window={window}")
    if deriv > polyorder:
        raise ValueError(f"deriv={deriv} must be <= polyorder={polyorder}")
    half = window // 2
    # the pseudo-inverse of the Vandermonde matrix over positions 0..w-1
    # gives the polynomial's coefficients a_j from the window's samples
    x = np.arange(window, dtype=np.float64)
    Pinv = np.linalg.pinv(x[:, None] ** np.arange(polyorder + 1)[None, :])  # (p+1, w)
    # the deriv-th derivative at t: Σ_{j>=deriv} a_j · j!/(j−deriv)! · t^(j−deriv)
    j = np.arange(polyorder + 1)
    fall = np.array([factorial(int(k)) / factorial(int(k - deriv)) if k >= deriv else 0.0
                     for k in j])

    def eval_at(ts: np.ndarray) -> np.ndarray:
        powers = np.where((j - deriv)[None, :] >= 0,
                          ts[:, None] ** np.clip(j - deriv, 0, None)[None, :], 0.0)
        return (powers * fall[None, :]) @ Pinv / (delta**deriv)

    interior = eval_at(np.array([float(half)]))[0]
    left = eval_at(np.arange(half, dtype=np.float64))
    right = eval_at(np.arange(half + 1, window, dtype=np.float64))
    return interior, left, right


def savgol(X, window: int, polyorder: int, deriv: int = 0, delta: float = 1.0) -> torch.Tensor:
    """Savitzky–Golay filter or derivative along the channels:
    scipy.signal.savgol_filter(X, window, polyorder, deriv=deriv,
    delta=delta, axis=1, mode='interp')."""
    X = _rows(X)
    if X.shape[1] < window:
        raise ValueError(f"n_channels={X.shape[1]} must be >= window={window}")
    inter, left, right = _sg_matrices(window, polyorder, deriv, delta)
    # valid cross-correlation over the channels: (N, 1, K) ⊛ (1, 1, w) → (N, 1, K−w+1)
    mid = F.conv1d(X[:, None, :], _const(inter, X)[None, None, :])[:, 0, :]
    lblk = X[:, :window] @ _const(left, X).T  # (N, half)
    rblk = X[:, -window:] @ _const(right, X).T
    return torch.cat([lblk, mid, rblk], dim=1)


def detrend(X, order: int = 1) -> torch.Tensor:
    """Subtract the per-row least-squares polynomial of degree `order` over
    the channel index."""
    X = _rows(X)
    x = np.arange(X.shape[1], dtype=np.float64)
    x = (x - x.mean()) / max(x.std(), 1.0)  # conditioning
    V = x[:, None] ** np.arange(order + 1)[None, :]
    Pr = V @ np.linalg.pinv(V)  # (K, K): the projection onto the baseline space
    return X - X @ _const(Pr.T, X)


def normalize(X, norm: str = "l2") -> torch.Tensor:
    """Per-row normalisation: 'l1', 'l2', 'max' or 'area' (signed sum)."""
    X = _rows(X)
    if norm == "l2":
        s = torch.sqrt((X * X).sum(1, keepdim=True))
    elif norm == "l1":
        s = X.abs().sum(1, keepdim=True)
    elif norm == "max":
        s = X.abs().amax(1, keepdim=True)
    elif norm == "area":
        s = X.sum(1, keepdim=True).abs()
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return X / torch.where(s == 0, torch.ones_like(s), s)


def apply_chain(X, spec: str) -> torch.Tensor:
    """Apply a comma-separated chain, e.g. "savgol:11:2:1,snv" (the CLI's
    --preprocess), left to right to the rows of X.  Tokens: `snv` | `msc`
    | `detrend[:order]` | `savgol:window:polyorder[:deriv[:delta]]` |
    `norm[:l1|l2|max|area]`."""
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        name, *ps = token.split(":")
        if name == "snv":
            X = snv(X)
        elif name == "msc":
            X = msc(X)
        elif name == "detrend":
            X = detrend(X, int(ps[0]) if ps else 1)
        elif name == "savgol":
            if len(ps) < 2:
                raise ValueError(f"savgol needs window:polyorder (got {token!r})")
            X = savgol(X, int(ps[0]), int(ps[1]), int(ps[2]) if len(ps) > 2 else 0,
                       float(ps[3]) if len(ps) > 3 else 1.0)
        elif name == "norm":
            X = normalize(X, ps[0] if ps else "l2")
        else:
            raise ValueError(f"unknown preprocessing step {name!r}")
    return X


def _transformer_tags():
    """sklearn's tag object for a transformer (estimator.py imports sklearn
    only when asked)."""
    from pls_tpu_torch.estimator import _sklearn_tags

    return _sklearn_tags("transformer")


class _StatelessTransformer:
    """sklearn-protocol facade over a stateless row transform, computed on
    `device` (None: that of a tensor X, else the card); transform returns
    a numpy array."""

    device = None

    def fit(self, X, y=None):
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.transform(X)

    def transform(self, X) -> np.ndarray:
        return self._apply(_rows(X, self.device)).cpu().numpy()

    def get_params(self, deep: bool = True) -> dict:
        return dict(self.__dict__)

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def __sklearn_tags__(self):
        return _transformer_tags()


class SNV(_StatelessTransformer):
    def __init__(self, device=None):
        self.device = device

    def _apply(self, X: torch.Tensor) -> torch.Tensor:
        return snv(X)


class SavitzkyGolay(_StatelessTransformer):
    def __init__(self, window: int = 11, polyorder: int = 2, deriv: int = 0, delta: float = 1.0,
                 device=None):
        self.window = window
        self.polyorder = polyorder
        self.deriv = deriv
        self.delta = delta
        self.device = device

    def _apply(self, X: torch.Tensor) -> torch.Tensor:
        return savgol(X, self.window, self.polyorder, self.deriv, self.delta)


class Detrend(_StatelessTransformer):
    def __init__(self, order: int = 1, device=None):
        self.order = order
        self.device = device

    def _apply(self, X: torch.Tensor) -> torch.Tensor:
        return detrend(X, self.order)
