"""A stateful z-scorer for the train/apply split.

Counterpart of `pls_tpu/preprocess.py`.  The reference CLI z-scores X and
Y in place (main.cpp:24-25); `ZScorer` keeps the column means and
zero-guarded stdevs (ops/stats.py) so that new observations go into, and
predictions come back out of, the model's standardised space:

    zx, zy = ZScorer.fit(X_raw), ZScorer.fit(Y_raw)
    model  = PLSModel(zx.transform(X_raw), zy.transform(Y_raw), ...)
    y_hat  = zy.inverse(model.fitted_values(zx.transform(X_new)))

The statistics are tensors on the device of the matrix fitted.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pls_tpu_torch.ops.stats import colwise_mean, colwise_stdev


@dataclass(frozen=True)
class ZScorer:
    mean: torch.Tensor
    stdev: torch.Tensor  # zero-guarded: a constant column carries stdev 1

    @classmethod
    def fit(cls, mat: torch.Tensor, sample_weight=None) -> "ZScorer":
        """Column means and stdevs; with `sample_weight` (N,), frequency-
        weighted moments (denominator Σw − 1), so integer weights equal
        z-scoring the row-repeated data."""
        if sample_weight is None:
            mean = colwise_mean(mat)
            sd = colwise_stdev(mat, mean)
        else:
            w = torch.as_tensor(sample_weight, dtype=mat.dtype, device=mat.device).reshape(-1)
            sw = w.sum()
            mean = (w @ mat) / sw
            d = mat - mean[None, :]
            sd = torch.sqrt((w @ (d * d)) / torch.clamp(sw - 1.0, min=1.0))
        return cls(mean=mean, stdev=torch.where(sd == 0, torch.ones_like(sd), sd))

    def transform(self, mat: torch.Tensor) -> torch.Tensor:
        return (mat - self.mean[None, :]) / self.stdev[None, :]

    def inverse(self, mat: torch.Tensor) -> torch.Tensor:
        return mat * self.stdev[None, :] + self.mean[None, :]
