"""The program's own spans in a traced slice: `torch.profiler.
record_function` ranges named `pls.*` (`pls_tpu_torch.utils.profiling.
SPANS`), which `harness.read_trace` keeps among the host events, on the
clock of the device's operations.

Both functions return None where the trace holds no device operation (a
run on the CPU) or no span of the name (a program without it), so that a
metric reading them reports nothing there.
"""

from __future__ import annotations

from bisect import bisect_right

PREFIX = "pls."
TICK = 1e-9  # the trace's resolution (1 ns), against the rounding of its µs to seconds


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """The length of the intersection of two unions of intervals, each
    sorted and disjoint."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


def _own(trace, name: str):
    """The union of the spans `name`, or None (see the module's note)."""
    if trace is None or not trace.device:
        return None
    found = [(s, e) for n, s, e in trace.host if n == name]
    return _union(found) if found else None


def self_s(trace, name: str) -> float | None:
    """The seconds the spans `name` cover, less what the `pls.*` spans
    nested in them (lying inside one of them) cover."""
    own = _own(trace, name)
    if own is None:
        return None
    starts = [s for s, _ in own]
    nested = []
    for n, s, e in trace.host:
        if n == name or not n.startswith(PREFIX):
            continue
        i = bisect_right(starts, s + TICK) - 1
        if i >= 0 and e <= own[i][1] + TICK:
            nested.append((s, e))
    return _length(own) - _overlap(own, _union(nested))


def idle_in_s(trace, name: str) -> float | None:
    """The seconds inside the spans `name` in which no operation ran on the
    device (`trace.busy_intervals()`)."""
    own = _own(trace, name)
    if own is None:
        return None
    return _length(own) - _overlap(own, trace.busy_intervals())

