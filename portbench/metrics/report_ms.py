"""report_ms (ms, device trace): the host's self time in the span
`pls.pipeline.report` a calibration (the printed state and explained
variance, their profile and the report dict), over the traced slice's
calibrations.  Layer: pipeline; moves calib_ms."""

from portbench.spans import self_s


def read(run):
    s = self_s(run.trace, "pls.pipeline.report")
    return None if s is None else 1e3 * s / run.trace.jobs
