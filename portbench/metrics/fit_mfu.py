"""fit_mfu (%, host clock): the share of the chip's peak that one whole fit
reaches: the least time of a kernel-#1 fit on the published peaks
(roofline.fit_bytes, fit_flops: X read A + 1 times at its storage width)
over the fit's time in the window.  Layer: fit loop; moves fit_ms.  It
still bounds a gain where a later change takes the deflation kernel off
the path and deflate_roofline reads nothing."""


def read(run):
    return run.work_share()
