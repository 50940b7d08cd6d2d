"""Profiling and roofline reporting.

Counterpart of `pls_tpu/utils/profiling.py`:

- `trace(path)`: `torch.profiler` (CPU and, on the card, CUDA activity)
  around a block, exported as a Chrome trace `path`/trace.json
  (Perfetto, chrome://tracing);
- `measure(fn, *args)`: seconds per call after warm-up: CUDA events
  around the calls on the card, `time.perf_counter` on the CPU;
- `roofline_report(seconds, bytes, flops)`: achieved GB/s and TFLOP/s,
  and their shares of the card's published peaks;
- `span(name)`: a range of the program's own (`SPANS`) in whatever
  torch.profiler trace is being collected, on the clock of its device
  events; with no profiler collecting, a shared no-op context.

`_PEAKS` holds only the published figures of the card the port is
measured on (NVIDIA H100 SXM5 80GB HBM3 at 700 W: 3.35 TB/s, 67 TFLOP/s
float32, non-tensor-core; chip_smoke.py takes its bounds against the
same); on any other device the report gives achieved numbers without a
share.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

# (device-memory GB/s, float32 TFLOP/s dense) by a name the device reports
_PEAKS = {
    "H100 80GB HBM3": (3350.0, 67.0),
}

# Every name the program gives `span`.  A span's parent is the span that
# encloses it in the trace; the caller's own range (a benchmark's job, an
# operator's request) encloses the outermost.
SPANS = (
    "pls.pipeline",  # config.run_pipeline: one whole calibration
    "pls.pipeline.read",  # both CSV reads and X's preprocessing chain
    "pls.pipeline.zscore",  # the column z-scores of X and Y
    "pls.pipeline.fit",  # the main model's construction (its fit)
    "pls.pipeline.report",  # the state and explained-variance prints and the report dict
    "pls.pipeline.loo",  # model.cv_LOO
    "pls.pipeline.lso",  # model.cv_LSO, its partitions included
    "pls.pipeline.kfold",  # model.cv_KFOLD
    "pls.pipeline.select",  # one CV's RMSE table, validation and Wilcoxon choice
    "pls.lso.partitions",  # drawing the LSO trials' partitions (GccRng, JAX key or generator)
    "pls.cv.assign",  # k-fold labels into padded row blocks, copied to the device
    "pls.cv.global_stats",  # XᵀX and XᵀY for the downdated CVs (and X's bf16 cast)
    "pls.cv.fold_batch",  # one batch of CV folds: masks, refits, residuals
    "pls.cv.select",  # the Wilcoxon choice of component count from CV errors
    "pls.fit",  # the component loop of one kernel-PLS fit or one batch of fold fits
    "pls.fit.component",  # one component of that fit's loop
    "pls.fit.eigh",  # the dominant eigenvector of XYᵀXY (eigh or power iterations)
    "pls.plsda.fit",  # PLSDAClassifier.fit: labels, priors, indicators, scaling and the fit
    "pls.plsda.decision",  # PLSDAClassifier's decision values of new data
    "pls.estimator.scale",  # an estimator's internal z-scoring of X (ZScorer.fit, transform)
    "pls.oplsda.fit",  # OPLSDAClassifier.fit: scaling, the filter, the fit and the S-plot
    "pls.opls.filter",  # the orthogonal filter of an OPLS fit (models/opls._ortho_filter_fit)
    "pls.opls.filter.component",  # one orthogonal component, the rank-1 update of X included
    "pls.opls.correct",  # the orthogonal filter applied to given data (models/opls.correct)
    "pls.oplsda.splot",  # the filter applied again to the training X, and the S-plot
    "pls.oplsda.decision",  # OPLSDAClassifier's decision values of new data
)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function(name)` while a torch profiler is
    collecting, so the range lands in its trace beside the device's
    events; otherwise one shared `contextlib.nullcontext()`, which
    allocates nothing and calls no operator.  `name` is one of `SPANS`."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(path: str = "pls_tpu_torch_trace"):
    """Capture a torch.profiler trace around a block into `path`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def measure(fn, *args, iters: int = 30, warmup: int = 3, device=None) -> float:
    """Mean seconds per call of fn(*args) over `iters` calls after
    `warmup`: CUDA events on the card (`device` None: the card if there
    is one), the host clock on the CPU."""
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    for _ in range(warmup):
        fn(*args)
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 1e3 / iters


def detect_generation() -> str | None:
    """The `_PEAKS` key of the card in use, or None (no card, or one whose
    peaks are not listed)."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    return next((k for k in _PEAKS if k in name), None)


@dataclass(frozen=True)
class Roofline:
    seconds: float
    bytes_accessed: int
    flops: int
    achieved_gbps: float
    achieved_tflops: float
    generation: str | None
    frac_hbm_peak: float | None
    frac_flops_peak: float | None

    def __str__(self) -> str:
        s = (
            f"{self.seconds*1e3:.3f} ms | {self.achieved_gbps:.1f} GB/s"
            f" | {self.achieved_tflops:.2f} TFLOP/s"
        )
        if self.frac_hbm_peak is not None:
            s += (
                f" | {self.frac_hbm_peak*100:.0f}% of {self.generation}"
                f" memory peak, {self.frac_flops_peak*100:.1f}% of FLOP peak"
            )
        return s


def roofline_report(seconds: float, bytes_accessed: int, flops: int) -> Roofline:
    gen = detect_generation()
    gbps = bytes_accessed / seconds / 1e9
    tflops = flops / seconds / 1e12
    if gen is not None:
        peak_bw, peak_fl = _PEAKS[gen]
        return Roofline(seconds, bytes_accessed, flops, gbps, tflops, gen,
                        gbps / peak_bw, tflops / peak_fl)
    return Roofline(seconds, bytes_accessed, flops, gbps, tflops, None, None, None)
