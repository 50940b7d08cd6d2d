"""deflate_roofline (%, device trace): the deflation passes' least time
(roofline.pass_bytes / pass_flops at the cell's shape, A passes a fit)
over the device time of the kernels that do them in the traced slice.
Layer: deflation kernel (ops/deflate.py, csrc/deflate*.cu); moves fit_ms.
The kernels are those whose names match PATTERN; none found reads
nothing."""

import re

from portbench import roofline

PATTERN = re.compile(r"deflate_|row_dots|strip_partials|reduce_partials|tree_sum")


def read(run):
    t, job = run.trace, run.job
    if t is None or getattr(job, "pass_work", None) is None:
        return None
    seconds = sum(e - s for name, s, e, cat in t.device if cat == "kernel" and PATTERN.search(name))
    if seconds == 0:
        return None
    return 100 * job.passes * t.jobs * roofline.least_seconds(*job.pass_work) / seconds
