"""component_idle_ms (ms, device trace): the device's idle time inside the
spans `pls.fit.component` (one component of the kernel-PLS loop: the
eigenvector and its sync, Gram-Schmidt, the deflation pass, the XY
update), over the number of those spans in the traced slice.  Layer: fit
loop; moves fit_ms."""

from portbench.spans import idle_in_s

NAME = "pls.fit.component"


def read(run):
    s = idle_in_s(run.trace, NAME)
    return None if s is None else 1e3 * s / sum(n == NAME for n, _, _ in run.trace.host)
