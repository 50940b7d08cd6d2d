"""calib_ms (ms, host clock): the time to a validated calibration (the
reference CLI's whole job): the whole window over the calibrations
completed in it."""


def read(run):
    return run.ms_per_job()
