"""Export a fitted model for native (C++) consumers.

Counterpart of `pls_tpu/export.py`: `export_model_c` writes the PLSB flat
binary that the header-only loader `native/pls_predict.hpp` reads, so a
C++ program runs the calibrated model (prediction, score projection and
the T²/SPE gate) without Python.  The bytes are the JAX package's: a file
either package writes loads in the other.

Format PLSB (little-endian):
    bytes 0..7   magic "PLSTPU01"
    int64        K, M, A
    float64[K]   x_mean      (raw-unit centring; zeros if unscaled)
    float64[K*M] B_raw       row-major, raw units: ŷ = (x−x_mean)·B + b0
    float64[M]   b0          intercept
    float64[K*A] R_raw       scores of raw x: t = (x−x_mean)·R_raw
    float64[K*A] P_mon       monitoring loadings (scaled units)
    float64[K]   x_std       (ones if unscaled)
    float64[A]   s2          training score variances (for T²)
    float64      t2_lim, spe_lim   (0 if no monitor attached)

Every array is read to the host and written in float64, whatever the
fit's device and dtype.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_MAGIC = b"PLSTPU01"


def _f64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, dtype=np.float64)


def export_model_c(
    path: str,
    fit,
    *,
    x_scaler=None,
    y_scaler=None,
    comp: int | None = None,
    monitor=None,
) -> None:
    """Write a PLSB file.  `fit` is a PLSFit; `x_scaler`/`y_scaler`
    optional ZScorers (absent: raw = scaled); `comp` the truncation
    (default fit.A); `monitor` an optional MonitorModel whose T²/SPE limits
    go into the file."""
    from pls_tpu_torch.models.predict import coefficients

    A = int(fit.A if comp is None else comp)
    B_std = _f64(coefficients(fit, A))  # (K, M)
    R_std = _f64(fit.R[:, :A])
    P_std = _f64(fit.P[:, :A])
    K, M = B_std.shape
    if x_scaler is not None:
        x_mean, x_std = _f64(x_scaler.mean).reshape(K), _f64(x_scaler.stdev).reshape(K)
    else:
        x_mean, x_std = np.zeros(K), np.ones(K)
    if y_scaler is not None:
        y_mean, y_std = _f64(y_scaler.mean).reshape(M), _f64(y_scaler.stdev).reshape(M)
    else:
        y_mean, y_std = np.zeros(M), np.ones(M)
    # the scaling baked into raw-unit operators:
    #   ŷ = ((x−x_mean)/x_std) B_std · y_std + y_mean = (x−x_mean)·B_raw + b0
    B_raw = (B_std / x_std[:, None]) * y_std[None, :]
    R_raw = R_std / x_std[:, None]
    if monitor is not None:
        s2 = _f64(monitor.s2).reshape(A)
        t2_lim, spe_lim = float(monitor.t2_lim), float(monitor.spe_lim)
    else:
        s2 = np.ones(A)
        t2_lim = spe_lim = 0.0
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqq", K, M, A))
        for arr in (x_mean, B_raw, y_mean, R_raw, P_std, x_std, s2):
            f.write(np.ascontiguousarray(arr, dtype="<f8").tobytes())
        f.write(struct.pack("<dd", t2_lim, spe_lim))


def load_model_c(path: str) -> dict:
    """Read a PLSB file back: a dict of numpy float64 arrays and the sizes."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        K, M, A = struct.unpack("<qqq", f.read(24))

        def rd(n):
            return np.frombuffer(f.read(8 * n), dtype="<f8").copy()

        out = {
            "K": K, "M": M, "A": A,
            "x_mean": rd(K),
            "B_raw": rd(K * M).reshape(K, M),
            "b0": rd(M),
            "R_raw": rd(K * A).reshape(K, A),
            "P_mon": rd(K * A).reshape(K, A),
            "x_std": rd(K),
            "s2": rd(A),
        }
        out["t2_lim"], out["spe_lim"] = struct.unpack("<dd", f.read(16))
    return out
