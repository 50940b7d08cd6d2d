"""calib_p95_ms (ms, host clock): the 95th percentile of the times of
every calibration of the window, each from its call to its last result on
the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
