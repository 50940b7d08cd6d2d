"""cv_mfu (%, host clock): the share of the chip's peak that one whole
k-fold CV reaches: the least time of a downdated k-fold CV on the
published peaks (roofline.kfold_bytes, kfold_flops: XᵀX as its unique
half, the fold downdates and the residuals) over the CV's time in the
window.  Layer: statistics and fold downdates; moves cv_ms."""


def read(run):
    return run.work_share()
