"""fit_ms (ms, host clock): the time to a fitted model of A components:
the whole window over the fits completed in it."""


def read(run):
    return run.ms_per_job()
