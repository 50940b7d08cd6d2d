"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything a cell needs is found by name from `BENCHMARK.json`:

- the configuration's file (`configs[].file`), a JSON object of sizes;
- the traffic mix `portbench/traffic/<traffic>.json`, whose `"job"` names
  the job module `portbench/jobs/<job>.py` that drives the program;
- the cell's limits `portbench/limits/<workload>.json`;
- each metric's reader `portbench/metrics/<metric>.py`, whose `read(run)`
  returns the metric's value, or None where it finds nothing to read.

A job module's `Job(config, mix, seed, device)` makes the inputs from the
seed (set-up); `run(i)` is one timed job, which ends synchronised with the
device; `keep(answer)` keeps a seeded sample of the answers;
`release()` drops the program's state; `check(limits)` compares the kept
answers with the reference, one dict of readings per answer; `traced` is
the number of jobs in the traced slice, and `work` the (bytes, flops) of
one job from its shapes, or None.

A cell joins by new files and appends to BENCHMARK.json's lists alone;
no file the benchmark has changes.  A new configuration brings
`configs/<name>.json` (and its data under `data/` where it reads files)
and its CPU cut for the tests, `tests/cuts/<name>.json`; each cell brings
`limits/<cell>.json` and, where new, `traffic/<mix>.json` and
`jobs/<job>.py`; each new metric brings `metrics/<metric>.py`.  In
BENCHMARK.json the configuration is appended to `configs`, the cell to
`workloads`, and the cell's name to the `workloads` list of every metric
it reports.  `portbench/tests/test_portbench_add_cell.py` adds one so, on a
copy of the checkout.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level module names the timed process must not hold: JAX, its
# libraries, and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "pls_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_SPAN = "portbench.job"


def load_module(path: Path):
    """A Python file of the benchmark, loaded by its path (the names of
    metric files hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that sys.modules holds, compared whole
    (`pls_tpu_torch` is not `pls_tpu`)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, limits and
    the metrics it reports."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def load(cls, workload: str, bench_file: Path | None = None) -> "Cell":
        bench = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
        w = cells[workload]
        cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
        config = json.loads((ROOT / cfg["file"]).read_text())
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
        e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        moved = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
        return cls(workload, w["chips"], config, mix, limits, e2e, layer)


@dataclass
class Trace:
    """What the traced slice recorded: device operations (name, start s,
    end s, category), host events (name, start s, end s), the slice's jobs
    and window."""

    device: list[tuple[str, float, float, str]]
    host: list[tuple[str, float, float]]
    jobs: int
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's intervals inside the window."""
        out: list[list[float]] = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle gaps
        summed by what the host was doing (the innermost host event over the
        gap's middle)."""
        ops: dict[str, float] = {}
        for name, s, e, _ in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s)
        busy = self.busy_intervals()
        edges = [self.start] + [t for iv in busy for t in iv] + [self.end]
        gaps: dict[str, float] = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            over = [h for h in self.host if h[1] <= mid <= h[2]]
            label = min(over, key=lambda h: h[2] - h[1])[0] if over else "(Python between ops)"
            gaps[label] = gaps.get(label, 0.0) + (e - s)

        def top(d):
            return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def read_trace(path: Path, jobs: int) -> Trace:
    """The device and host events of a Chrome trace that torch.profiler
    wrote, in seconds, and the window from the first job span's start to
    the last one's end."""
    events = json.loads(path.read_text())["traceEvents"]
    device, host, spans = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        iv = (ev.get("name", ""), s, s + float(ev["dur"]) * 1e-6)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((*iv, cat))
        elif cat == "user_annotation" and iv[0] == JOB_SPAN:
            spans.append(iv)
        elif not cat.startswith("gpu_") and not iv[0].startswith("PyTorch Profiler"):
            host.append(iv)
    if not spans:
        raise RuntimeError(f"no {JOB_SPAN!r} span in {path}")
    return Trace(device, host, jobs, min(s[1] for s in spans), max(s[2] for s in spans))


def count_syncs(fn) -> int:
    """The host syncs fn() makes (torch's sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def power_limit_w() -> float | None:
    """The card's power limit in watts, by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


@dataclass
class Run:
    """One run of a cell; what the metric readers read."""

    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    job: object = None
    setup_s: float = math.nan
    latencies: list[float] = field(default_factory=list)
    window_s: float = math.nan
    trace: Trace | None = None
    counters: dict = field(default_factory=dict)

    @property
    def jobs(self) -> int:
        return len(self.latencies)

    def ms_per_job(self) -> float:
        """The whole window over the jobs completed in it, in ms."""
        return self.window_s / self.jobs * 1e3

    def work_share(self) -> float | None:
        """One job's least time (`roofline.least_seconds` of its work) over
        its time in the window, in %."""
        from portbench import roofline

        if self.job.work is None:
            return None
        return 100 * roofline.least_seconds(*self.job.work) / (self.window_s / self.jobs)

    def idle_share(self) -> float | None:
        """The traced window's share in which no operation ran on the
        device, in %; None where the device ran nothing."""
        if self.trace is None or not self.trace.device:
            return None
        return 100 * (1 - self.trace.busy_s / self.trace.window_s)


def measure(run: Run, process_start: float, trace: bool, trace_dir: Path) -> None:
    """Set up, warm up with one job, then run jobs back to back until
    `run.seconds` have passed (the window ends with the job that crosses
    it); with `trace`, then profile `job.traced` more jobs and count the
    host syncs of one."""
    cell = run.cell
    job_mod = load_module(BENCH / "jobs" / f"{cell.mix['job']}.py")
    job = job_mod.Job(cell.config, cell.mix, run.seed, run.device)
    run.job = job
    job.run(-1)  # builds and loads every kernel, warms every shape the window uses
    t0 = time.perf_counter()
    run.setup_s = time.time() - process_start
    i = 0
    while True:
        s = time.perf_counter()
        answer = job.run(i)
        e = time.perf_counter()
        run.latencies.append(e - s)
        job.keep(answer)
        del answer
        i += 1
        if e - t0 >= run.seconds:
            break
    run.window_s = e - t0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if run.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            for k in range(job.traced):
                with record_function(JOB_SPAN):
                    job.run(i + k)
        trace_dir.mkdir(parents=True, exist_ok=True)
        path = trace_dir / f"portbench-{cell.name}.json"
        prof.export_chrome_trace(str(path))
        run.trace = read_trace(path, job.traced)
        path.unlink()
        if run.device.type == "cuda":
            run.counters["host_syncs_per_job"] = count_syncs(lambda: job.run(i + job.traced))


def check(run: Run) -> tuple[bool, list[tuple[str, float, float]], int]:
    """Compare the kept answers with the reference.  Returns (correct, the
    worst reading of each number with its limit, answers that failed)."""
    limits = {k: v for k, v in run.cell.limits.items() if k != "margins"}
    readings = run.job.check(run.cell.limits)
    worst = {name: max(r[name] for r in readings) for name in limits}
    failed = sum(any(not (r[n] <= limits[n]) for n in limits) for r in readings)
    rows = [(name, worst[name], limits[name]) for name in limits]
    return bool(readings) and failed == 0, rows, failed


def metrics(run: Run, specs: list[dict]) -> dict:
    out = {}
    for spec in specs:
        value = load_module(BENCH / "metrics" / f"{spec['name']}.py").read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out
