"""Out-of-core fits: XᵀX / XᵀY accumulated over row chunks.

Counterpart of `pls_tpu/models/streaming.py`.  Kernel type 2 needs X and Y
only through XX = XᵀX (K, K) and XY = XᵀY (K, M), so one streaming pass
over the rows suffices:

    acc = StatsAccumulator(K, M, device="cuda")
    for Xc, Yc in chunks:
        acc.update(Xc, Yc)
    fit = acc.fit(A)

Statistics of different chunks or hosts add (`merge`).  Column sums are
kept in the same pass, so the z-scored statistics follow in closed form
(`zscore_stats`, `StatsAccumulator.zscored`); the exact two-pass scheme
is `collect_moments` + `fit_streaming(zscore=True)`.
`FoldStatsAccumulator` keeps the statistics per CV fold in the same one
pass (cv/kfold.cv_kfold_onepass).

Every entry point here takes `device`; None is the card (RuntimeError
without one: pass device="cpu"), whatever device the chunks are on.

`precision` is the matmul setting of the Gram updates (`kernel_pls._prec_ctx`:
"highest" = float32 without TF32, "high"/"default" = TF32, None = PyTorch's
current settings).
`x_storage="bf16"` rounds each chunk of X (and Y in XᵀY) to bfloat16 and
accumulates in float32: the products are exact in float32, so only the
chunk's representation rounds.  The chunk is widened to float32 for the
product, which PyTorch's bf16 matmul (bf16 output) cannot replace.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from pls_tpu_torch.config import resolve_device
from pls_tpu_torch.models.kernel_pls import _prec_ctx, fit_from_stats
from pls_tpu_torch.types import PLSFit

_BF16_NAMES = ("bf16", "bfloat16")


def _check_storage(x_storage: str | None) -> None:
    if x_storage is not None and x_storage not in _BF16_NAMES:
        raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")


def _as(t, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).to(dtype)


def _col(Y: torch.Tensor) -> torch.Tensor:
    return Y[:, None] if Y.ndim == 1 else Y


def _bf16_round(t: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """t rounded to bfloat16 (nearest even), widened to `acc`."""
    return t.to(torch.bfloat16).to(acc)


@dataclass
class StatsAccumulator:
    """XᵀX, XᵀY, YᵀY, the column sums and the row count over data chunks:
    counterpart of `pls_tpu/models/streaming.py:89-221`.

    compensated=True keeps XᵀX and XᵀY in float64 accumulators, each
    chunk's product formed in float64 (the JAX package adds float32 chunk
    products into float32 pairs, `pls_tpu/ops/twofloat.py`, because the TPU
    has no float64).  It exposes the JAX package's pair fields: `XX`/`XY`
    are the float64 sums rounded to `dtype` (the hi parts) and `XXe`/`XYe`
    the rest rounded to `dtype` (the lo parts), so XX + XXe reads as the
    JAX package's tools read it, and `kernel_dd.fit_from_stats_dd(XX, XY,
    A, XX_lo=XXe, XY_lo=XYe)` takes them.  `fit` reads the hi parts, as the
    JAX package's does.  Compensated statistics merge only with
    compensated ones, and exclude x_storage="bf16" (the JAX rules and
    messages)."""

    K: int
    M: int
    dtype: torch.dtype = torch.float32
    compensated: bool = False
    x_storage: str | None = None
    precision: str | None = None
    device: torch.device | str | None = None
    XX: torch.Tensor = field(init=False)
    XY: torch.Tensor = field(init=False)
    YY: torch.Tensor = field(init=False)
    sx: torch.Tensor = field(init=False)
    sy: torch.Tensor = field(init=False)
    XXe: torch.Tensor = field(init=False)
    XYe: torch.Tensor = field(init=False)
    n: int = field(init=False, default=0)

    def __post_init__(self):
        _check_storage(self.x_storage)
        if self.x_storage is not None and self.compensated:
            raise ValueError("x_storage='bf16' and compensated are mutually exclusive")
        self.device = resolve_device(self.device)
        z = dict(dtype=self.dtype, device=self.device)
        self.XX = torch.zeros((self.K, self.K), **z)
        self.XY = torch.zeros((self.K, self.M), **z)
        self.YY = torch.zeros((self.M, self.M), **z)
        self.sx = torch.zeros((self.K,), **z)
        self.sy = torch.zeros((self.M,), **z)
        # the lo parts and the float64 sums exist only in compensated mode
        # (a K×K float64 buffer is 800 MB at K = 10 000)
        self.XXe = torch.zeros_like(self.XX) if self.compensated else torch.zeros(0, **z)
        self.XYe = torch.zeros_like(self.XY) if self.compensated else torch.zeros(0, **z)
        if self.compensated:
            self._XX64 = torch.zeros((self.K, self.K), dtype=torch.float64, device=self.device)
            self._XY64 = torch.zeros((self.K, self.M), dtype=torch.float64, device=self.device)

    def _split(self) -> None:
        """The hi and lo parts of the float64 sums in `dtype`."""
        for name, acc64 in (("XX", self._XX64), ("XY", self._XY64)):
            hi = acc64.to(self.dtype)
            setattr(self, name, hi)
            setattr(self, name + "e", (acc64 - hi.to(torch.float64)).to(self.dtype))

    def update(self, X_chunk, Y_chunk) -> "StatsAccumulator":
        acc = self.dtype
        X = torch.as_tensor(X_chunk, device=self.XX.device)
        Y = _col(torch.as_tensor(Y_chunk, device=self.XX.device))
        if self.x_storage is not None:
            X = _bf16_round(X, acc)
            Y = _bf16_round(Y, acc)
        else:
            X = X.to(acc)
            Y = Y.to(acc)
        # compensated pins full float32 products, as the JAX package pins HIGHEST
        with _prec_ctx("highest" if self.compensated else self.precision):
            if self.compensated:
                X64, Y64 = X.to(torch.float64), Y.to(torch.float64)
                self._XX64.addmm_(X64.mT, X64)
                self._XY64.addmm_(X64.mT, Y64)
                del X64, Y64
                self._split()
            else:
                self.XX.addmm_(X.mT, X)
                self.XY.addmm_(X.mT, Y)
            self.YY.addmm_(Y.mT, Y)
        self.sx += X.sum(0)
        self.sy += Y.sum(0)
        self.n += X.shape[0]
        return self

    def merge(self, other: "StatsAccumulator") -> "StatsAccumulator":
        """Add another chunk set's statistics (a psum's counterpart)."""
        if self.compensated != other.compensated:
            raise ValueError("cannot merge compensated and plain accumulators")
        if self.compensated:
            self._XX64 = self._XX64 + other._XX64
            self._XY64 = self._XY64 + other._XY64
            self._split()
        else:
            self.XX = self.XX + other.XX
            self.XY = self.XY + other.XY
        self.YY = self.YY + other.YY
        self.sx = self.sx + other.sx
        self.sy = self.sy + other.sy
        self.n = self.n + other.n
        return self

    def zscored(self):
        """(XX_z, XY_z, YY_z, mx, sdx, my, sdy): the statistics of the
        column-z-scored data, from the raw data's (`zscore_stats`)."""
        return zscore_stats(self.XX, self.XY, self.sx, self.sy, self.n, YY=self.YY)

    def fit(self, A: int, *, zscore: bool = False, **kw) -> PLSFit:
        """Fit from the statistics; zscore=True fits the z-scored model from
        the raw data's statistics in closed form."""
        if zscore:
            XX_z, XY_z, *_ = self.zscored()
            return fit_from_stats(XX_z, XY_z, A, **kw)
        return fit_from_stats(self.XX, self.XY, A, **kw)


def zscore_stats(XX, XY, sx, sy, n, *, YY=None, ddof=1):
    """Cross-products of the column-z-scored data from the raw data's XX,
    XY, (YY,) column sums and row count: counterpart of
    `pls_tpu/models/streaming.py:273-315`.

        Σ (x−μx)(x−μx)ᵀ = XX − n·μx μxᵀ,   Σ (x−μx)(y−μy)ᵀ = XY − n·μx μyᵀ,

    then row i and column j divided by σᵢ and σⱼ (σ from the diagonal of
    the centred products).  The subtraction loses about (μ/σ)² of relative
    precision; for columns with large offsets use the two-pass scheme
    (collect_moments + fit_streaming(zscore=True)).

    Returns (XX_z, XY_z, YY_z | None, mx, sdx, my, sdy); a zero-variance
    column gets σ = 1."""
    n = float(n)
    mx = sx / n
    my = sy / n
    cXX = XX - n * torch.outer(mx, mx)
    sdx = _sd(torch.diagonal(cXX) / (n - ddof))
    cXY = XY - n * torch.outer(mx, my)
    if YY is not None:
        cYY = YY - n * torch.outer(my, my)
        sdy = _sd(torch.diagonal(cYY) / (n - ddof))
        YY_z = cYY / torch.outer(sdy, sdy)
    else:
        sdy = torch.ones_like(my)
        YY_z = None
    return cXX / torch.outer(sdx, sdx), cXY / torch.outer(sdx, sdy), YY_z, mx, sdx, my, sdy


def _sd(var: torch.Tensor) -> torch.Tensor:
    sd = torch.sqrt(torch.clamp(var, min=0))
    return torch.where(sd == 0, torch.ones_like(sd), sd)


def zscore_fold_stats(XXf, XYf, YYf, sxf, syf, nf, mx, sdx, my, sdy):
    """Per-fold statistics of the globally z-scored data: counterpart of
    `pls_tpu/models/streaming.py:318-352`.  A fold's rows are centred on
    the global mean with their own sums:

        Σ_{i∈f} (x−μ)(x−μ)ᵀ = XXf − μ sxfᵀ − sxf μᵀ + n_f μμᵀ

    Inputs carry the fold axis: XXf (k, K, K), XYf (k, K, M), YYf (k, M, M),
    sxf (k, K), syf (k, M), nf (k,).  Returns (XXf_z, XYf_z, YYf_z).  Each
    result is one new (k, ·, ·) tensor updated in place: no other temporary
    of that size (4 GB for XXf at k = 10, K = 10 000)."""
    nfa = torch.as_tensor(nf, device=XXf.device).to(XXf.dtype)[:, None, None]

    def centre(S, su, sv, mu, mv, sdu, sdv):
        out = S.clone()
        out.addcmul_(mu[None, :, None], sv[:, None, :], value=-1)
        out.addcmul_(su[:, :, None], mv[None, None, :], value=-1)
        out.addcmul_(nfa, torch.outer(mu, mv)[None])
        return out.div_(torch.outer(sdu, sdv)[None])

    return (
        centre(XXf, sxf, sxf, mx, mx, sdx, sdx),
        centre(XYf, sxf, syf, mx, my, sdx, sdy),
        centre(YYf, syf, syf, my, my, sdy, sdy),
    )


@dataclass
class FoldStatsAccumulator:
    """Per-fold XXf = XfᵀXf, XYf = XfᵀYf, YYf = YfᵀYf, column sums and row
    counts, in the one streaming pass: counterpart of
    `pls_tpu/models/streaming.py:389-532`.  Each row is in one fold, so the
    global XX/XY are the fold sums.  The engine of the one-pass k-fold CV
    (cv/kfold.cv_kfold_onepass).  Memory: k·K² floats (4.0 GB at k = 10,
    K = 10 000 in float32).

    A chunk whose rows all lie in one fold is one Gram update into that
    fold's slot.  A mixed chunk gathers each present fold's rows
    (`index_select`) and runs one Gram product per fold: 1× the flops, where
    the JAX package's one-sided-mask scan (`streaming.py:224-270`) runs k
    masked products.  Both give the same sums up to summation order.

    x_storage="bf16": X rounded to bfloat16, and Y rounded in XᵀY only
    (YᵀY and the Y sums take Y as given), float32 accumulation, as in the
    JAX package."""

    K: int
    M: int
    k: int
    dtype: torch.dtype = torch.float32
    x_storage: str | None = None
    precision: str | None = None
    device: torch.device | str | None = None
    XXf: torch.Tensor = field(init=False)
    XYf: torch.Tensor = field(init=False)
    YYf: torch.Tensor = field(init=False)
    sxf: torch.Tensor = field(init=False)
    syf: torch.Tensor = field(init=False)
    nf: torch.Tensor = field(init=False)

    def __post_init__(self):
        _check_storage(self.x_storage)
        if self.k < 2:
            raise ValueError(f"k={self.k} must be >= 2")
        self.device = resolve_device(self.device)
        z = dict(dtype=self.dtype, device=self.device)
        self.XXf = torch.zeros((self.k, self.K, self.K), **z)
        self.XYf = torch.zeros((self.k, self.K, self.M), **z)
        self.YYf = torch.zeros((self.k, self.M, self.M), **z)
        self.sxf = torch.zeros((self.k, self.K), **z)
        self.syf = torch.zeros((self.k, self.M), **z)
        self.nf = torch.zeros((self.k,), dtype=torch.int64, device=self.device)

    def _add(self, f: int, X: torch.Tensor, Yn: torch.Tensor, Y: torch.Tensor) -> None:
        self.XXf[f].addmm_(X.mT, X)
        self.XYf[f].addmm_(X.mT, Yn)
        self.YYf[f].addmm_(Y.mT, Y)
        self.sxf[f] += X.sum(0)
        self.syf[f] += Y.sum(0)
        self.nf[f] += X.shape[0]

    def update(self, X_chunk, Y_chunk, assign_chunk) -> "FoldStatsAccumulator":
        """Add one (rows, K) chunk; `assign_chunk` holds each row's fold in
        [0, k)."""
        acc = self.dtype
        dev = self.XXf.device
        X = torch.as_tensor(X_chunk, device=dev)
        Y = _col(torch.as_tensor(Y_chunk, device=dev)).to(acc)
        if self.x_storage is not None:
            X = _bf16_round(X, acc)
            Yn = _bf16_round(Y, acc)
        else:
            X = X.to(acc)
            Yn = Y
        a = np.asarray(assign_chunk)
        with _prec_ctx(self.precision):
            if a.size and a.min() == a.max():
                self._add(int(a[0]), X, Yn, Y)
                return self
            for f in np.unique(a):
                rows = torch.from_numpy(np.flatnonzero(a == f)).to(dev)
                self._add(int(f), X.index_select(0, rows), Yn.index_select(0, rows),
                          Y.index_select(0, rows))
        return self

    def merge(self, other: "FoldStatsAccumulator") -> "FoldStatsAccumulator":
        for name in ("XXf", "XYf", "YYf", "sxf", "syf", "nf"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        return self

    def zscored(self) -> "FoldStatsAccumulator":
        """A new accumulator with the fold statistics of the globally
        z-scored data (`zscore_fold_stats`), carrying the transform as
        `.mx/.sdx/.my/.sdy` for the residual pass."""
        *_, mx, sdx, my, sdy = zscore_stats(
            self.XX, self.XY, self.sxf.sum(0), self.syf.sum(0), self.n, YY=self.YYf.sum(0)
        )
        out = copy.copy(self)  # no zero-filled (k, K, K) buffer to replace
        out.XXf, out.XYf, out.YYf = zscore_fold_stats(
            self.XXf, self.XYf, self.YYf, self.sxf, self.syf, self.nf, mx, sdx, my, sdy
        )
        nfa = self.nf.to(self.dtype)[:, None]
        out.sxf = (self.sxf - nfa * mx[None, :]) / sdx[None, :]
        out.syf = (self.syf - nfa * my[None, :]) / sdy[None, :]
        out.nf = self.nf.clone()
        out.mx, out.sdx, out.my, out.sdy = mx, sdx, my, sdy
        return out

    @property
    def XX(self) -> torch.Tensor:
        """Global XᵀX = Σ_f XXf."""
        return self.XXf.sum(0)

    @property
    def XY(self) -> torch.Tensor:
        return self.XYf.sum(0)

    @property
    def n(self) -> int:
        return int(self.nf.sum())

    def fit(self, A: int, **kw) -> PLSFit:
        """The full-data fit from the global statistics."""
        return fit_from_stats(self.XX, self.XY, A, **kw)


def _merge_moments(n, mean, m2, Xc):
    """Chan et al.'s merge of a chunk into a running (count, mean, centred
    sum of squares); stable in float32 at large means
    (`pls_tpu/models/streaming.py:535-548`)."""
    n_c = Xc.shape[0]
    mean_c = Xc.mean(0)
    m2_c = ((Xc - mean_c[None, :]) ** 2).sum(0)
    tot = n + n_c
    delta = mean_c - mean
    return tot, mean + delta * (n_c / tot), m2 + m2_c + delta * delta * (n * n_c / tot)


def collect_moments(chunks, K: int, M: int, dtype=torch.float32, device=None):
    """Pass 1 of exact streaming z-scoring: (mx, sdx, my, sdy, n) over an
    iterable of (X_chunk, Y_chunk), unbiased σ with the zero guard;
    counterpart of `pls_tpu/models/streaming.py:551-574`."""
    device = resolve_device(device)
    z = dict(dtype=dtype, device=device)
    mx, m2x = torch.zeros(K, **z), torch.zeros(K, **z)
    my, m2y = torch.zeros(M, **z), torch.zeros(M, **z)
    n = 0
    for Xc, Yc in chunks:
        Xc = _as(Xc, dtype, device)
        Yc = _col(_as(Yc, dtype, device))
        n_new, mx, m2x = _merge_moments(n, mx, m2x, Xc)
        _, my, m2y = _merge_moments(n, my, m2y, Yc)
        n = n_new
    return mx, _sd(m2x / (n - 1)), my, _sd(m2y / (n - 1)), n


def csv_chunks(x_path, y_path, chunk_rows: int, separator: str = ","):
    """Aligned (X_chunk, Y_chunk) blocks of two headerless CSVs
    (utils/io.stream_matrix_file: each file parsed ahead on its reader's
    thread); raises if their row counts differ;
    `pls_tpu/models/streaming.py:577-594`.  Both readers' threads are
    joined when this generator ends, raises or is closed."""
    from pls_tpu_torch.utils.io import stream_matrix_file

    with contextlib.closing(stream_matrix_file(x_path, chunk_rows, separator)) as xs, \
            contextlib.closing(stream_matrix_file(y_path, chunk_rows, separator)) as ys:
        while True:
            xc = next(xs, None)
            yc = next(ys, None)
            if xc is None and yc is None:
                return
            if xc is None or yc is None or xc.shape[0] != yc.shape[0]:
                raise ValueError(f"{x_path} and {y_path} have different numbers of rows")
            yield xc, yc


def fit_streaming_csv(
    x_path, y_path, A: int, *,
    chunk_rows: int = 8192, zscore: bool = True, separator: str = ",",
    dtype=torch.float32, device=None, **kw
) -> PLSFit:
    """Out-of-core fit from CSV files: pass 1 the column moments, pass 2
    the z-scored XᵀX/XᵀY (counterpart of `streaming.py:597-618`)."""
    device = resolve_device(device)
    probe = next(iter(csv_chunks(x_path, y_path, chunk_rows, separator)))
    K, M = probe[0].shape[1], probe[1].shape[1]
    moments = None
    if zscore:
        moments = collect_moments(
            csv_chunks(x_path, y_path, chunk_rows, separator), K, M, dtype, device
        )
    return fit_streaming(
        csv_chunks(x_path, y_path, chunk_rows, separator), K, M, A,
        zscore=zscore, moments=moments, dtype=dtype, device=device, **kw
    )


def fit_streaming(
    chunks, K: int, M: int, A: int, *,
    zscore: bool = False, moments=None, dtype=torch.float32, device=None,
    x_storage: str | None = None, **kw
) -> PLSFit:
    """One-call streaming fit over an iterable of (X_chunk, Y_chunk)
    (counterpart of `streaming.py:621-647`).  zscore=True needs `moments`
    from collect_moments and standardises each chunk before it is
    accumulated."""
    acc = StatsAccumulator(K, M, dtype, x_storage=x_storage, device=device)
    if zscore:
        if moments is None:
            raise ValueError("zscore=True requires moments=collect_moments(...)")
        mx, sdx, my, sdy, _ = moments
    for Xc, Yc in chunks:
        Xc = _as(Xc, dtype, acc.XX.device)
        Yc = _col(_as(Yc, dtype, acc.XX.device))
        if zscore:
            Xc = (Xc - mx.to(dtype)) / sdx.to(dtype)
            Yc = (Yc - my.to(dtype)) / sdy.to(dtype)
        acc.update(Xc, Yc)
    return acc.fit(A, **kw)
