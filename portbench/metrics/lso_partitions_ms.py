"""lso_partitions_ms (ms, device trace): the host's self time in the span
`pls.lso.partitions` a calibration (drawing the LSO trials' partitions:
`GccRng.lso_partitions`, the reference's std::shuffle drawn natively by
a live libstdc++ std::mt19937 in `csrc/native_io.cpp`), over the traced
slice's calibrations.  Layer: CV folds; moves calib_ms."""

from portbench.spans import self_s


def read(run):
    s = self_s(run.trace, "pls.lso.partitions")
    return None if s is None else 1e3 * s / run.trace.jobs
