"""Profiling and roofline reporting.

Counterpart of `pls_tpu/utils/profiling.py`:

- `trace(path)`: `torch.profiler` (CPU and, on the card, CUDA activity)
  around a block, exported as a Chrome trace `path`/trace.json
  (Perfetto, chrome://tracing);
- `measure(fn, *args)`: seconds per call after warm-up: CUDA events
  around the calls on the card, `time.perf_counter` on the CPU;
- `roofline_report(seconds, bytes, flops)`: achieved GB/s and TFLOP/s,
  and their shares of the card's published peaks.

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
