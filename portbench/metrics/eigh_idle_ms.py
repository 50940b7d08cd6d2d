"""eigh_idle_ms (ms, device trace): the device's idle time inside the
spans `pls.fit.eigh` (the M×M dominant eigenvector of a component: on
`torch.linalg.eigh`'s path, cuSOLVER and the host's wait for its `info`),
over the number of those spans in the traced slice: what the host sync
costs a component.  Layer: fit loop (ops/eigen.py); moves fit_ms."""

from portbench.spans import idle_in_s

NAME = "pls.fit.eigh"


def read(run):
    s = idle_in_s(run.trace, NAME)
    return None if s is None else 1e3 * s / sum(n == NAME for n, _, _ in run.trace.host)
