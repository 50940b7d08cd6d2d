"""fold_batch_idle_ms (ms, device trace): the device's idle time inside the
spans `pls.cv.fold_batch` (one batch of folds refitted from the downdated
statistics, with their residuals) a CV, over the traced slice's CVs.
Layer: statistics and fold downdates; moves cv_ms."""

from portbench.spans import idle_in_s


def read(run):
    s = idle_in_s(run.trace, "pls.cv.fold_batch")
    return None if s is None else 1e3 * s / run.trace.jobs
