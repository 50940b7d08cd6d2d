"""The span readers (`portbench/spans.py`) and the four metrics that use
them, on hand-built traces: self time less nested `pls.*` spans, idle
time inside spans that cross the device's busy intervals, the division by
span count or by jobs, and nothing read where the device ran nothing or
the span is absent."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness, spans

# seconds; one job from 0 to 10, the device busy in [1, 3] and [6, 7]
DEVICE = [("k1", 1.0, 3.0, "kernel"), ("k2", 6.0, 7.0, "kernel")]


def trace(host, device=DEVICE, jobs=1) -> harness.Trace:
    return harness.Trace(list(device), list(host), jobs, 0.0, 10.0)


def read(metric: str, t: harness.Trace):
    mod = harness.load_module(harness.BENCH / "metrics" / f"{metric}.py")
    return mod.read(SimpleNamespace(trace=t))


def test_self_time_leaves_out_nested_pls_spans_only():
    t = trace([
        ("pls.pipeline.report", 0.0, 8.0),
        ("pls.fit", 2.0, 3.5),  # nested: left out
        ("pls.fit.eigh", 3.0, 4.0),  # nested, crossing the fit's end: their union is left out
        ("aten::mm", 4.0, 6.0),  # not a pls span: stays
        ("pls.lso.partitions", 9.0, 9.5),  # outside: no effect
        ("pls.cv.select", 7.5, 8.5),  # crossing the end, not nested: stays
    ])
    assert spans.self_s(t, "pls.pipeline.report") == pytest.approx(8.0 - 2.0)
    assert spans.self_s(t, "pls.fit") == pytest.approx(1.5)  # the eigh is not inside it


def test_self_time_is_the_union_of_repeated_spans():
    t = trace([("pls.fit.component", 0.0, 2.0), ("pls.fit.component", 1.0, 3.0),
               ("pls.fit.component", 5.0, 6.0), ("pls.fit.eigh", 5.5, 6.0)])
    assert spans.self_s(t, "pls.fit.component") == pytest.approx(3.0 + 0.5)


def test_idle_time_inside_spans_that_cross_busy_intervals():
    t = trace([("pls.fit.component", 0.0, 2.0),  # idle [0, 1]
               ("pls.fit.component", 2.5, 6.5),  # idle [3, 6]
               ("pls.fit.component", 8.0, 9.0),  # idle all
               ("pls.fit.eigh", 0.0, 9.0)])  # another name: not counted
    assert spans.idle_in_s(t, "pls.fit.component") == pytest.approx(1.0 + 3.0 + 1.0)


def test_idle_time_counts_overlapping_device_operations_once():
    dev = DEVICE + [("copy", 2.0, 4.0, "gpu_memcpy")]
    t = trace([("pls.cv.fold_batch", 0.0, 5.0)], device=dev)
    assert spans.idle_in_s(t, "pls.cv.fold_batch") == pytest.approx(1.0 + 1.0)


def test_the_metrics_divide_by_jobs_or_by_span_count():
    host = [("pls.lso.partitions", 9.2, 9.204), ("pls.lso.partitions", 9.5, 9.502),
            ("pls.pipeline.report", 7.0, 8.0), ("pls.fit.component", 0.0, 2.0),
            ("pls.fit.component", 4.0, 5.0), ("pls.fit.component", 8.0, 9.0),
            ("pls.cv.fold_batch", 3.0, 6.5)]
    t = trace(host, jobs=2)
    assert read("lso_partitions_ms", t) == pytest.approx(1e3 * 0.006 / 2)
    assert read("report_ms", t) == pytest.approx(1e3 * 1.0 / 2)
    assert read("component_idle_ms", t) == pytest.approx(1e3 * (1.0 + 1.0 + 1.0) / 3)
    assert read("fold_batch_idle_ms", t) == pytest.approx(1e3 * (3.5 - 0.5) / 2)


@pytest.mark.parametrize("metric", ["lso_partitions_ms", "report_ms", "component_idle_ms",
                                    "fold_batch_idle_ms"])
def test_nothing_is_read_without_device_operations_or_without_the_span(metric):
    host = [(n, 1.0, 2.0) for n in ("pls.lso.partitions", "pls.pipeline.report",
                                    "pls.fit.component", "pls.cv.fold_batch")]
    assert read(metric, trace(host, device=[])) is None  # a run on the CPU
    assert read(metric, trace([("aten::mm", 1.0, 2.0)])) is None  # a program without spans
    assert read(metric, None) is None  # an untraced run
    assert read(metric, trace(host)) is not None
