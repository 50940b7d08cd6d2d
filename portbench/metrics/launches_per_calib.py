"""launches_per_calib (count, device trace): the kernels the device ran
per calibration in the traced slice.  Layer: CV folds (cv/loo.py,
cv/lso.py, kernel_pls.fit_folds), whose batched refits launch most of
them; fewer launches should lower calib_ms."""


def read(run):
    t = run.trace
    if t is None:
        return None
    kernels = sum(cat == "kernel" for *_, cat in t.device)
    return kernels / t.jobs if kernels else None
