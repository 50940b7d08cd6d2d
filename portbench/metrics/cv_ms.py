"""cv_ms (ms, host clock): the time to a k-fold cross-validated choice of
component count: the whole window over the CVs completed in it."""


def read(run):
    return run.ms_per_job()
