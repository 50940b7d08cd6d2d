"""host_syncs_per_fit (count, program counter): the times one fit makes
the host wait for the device, as torch's sync debug mode counts them.
Layer: fit loop (models/kernel_pls.py, ops/eigen.py: one eigh a
component); fewer should lower fit_ms."""


def read(run):
    n = run.counters.get("host_syncs_per_job")
    return None if n is None else float(n)
