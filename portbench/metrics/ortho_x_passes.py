"""ortho_x_passes (count, program counter): the X-sized reads and writes
of the OPLS filter and of its application to given data in one job, as
the program's counter `models.opls.x_elements` tallies them (a product
with X one read, the rank-1 update's outer product one write and its
subtraction three, ‖X‖² three), over N·K of the training X: the job
keeps the counter's difference around its last run (`job.x_passes`), so
the held-out batch counts in proportion to its rows.  The tally is the
program's, from shapes, not a reading of the device's traffic; the
port's tests hold it to the X-sized tensors of the operations that
PyTorch dispatches inside `pls.opls.filter` and `pls.opls.correct`.
With the filter applied implicitly and no second filter it would count
two passes a component (t with p, t_o with p_o, as a deflation pass
reads X once), the first XᵀY and the held-out batch once: about 17 in
the OPLS-DA cell.  Layer: OPLS filter (models/opls.py); fewer should
lower fit_ms.  Read on the card only, as the fit loop's
host_syncs_per_fit is; a program without the counter reads nothing."""


def read(run):
    n = getattr(run.job, "x_passes", None)
    return None if n is None or run.device.type != "cuda" else float(n)
