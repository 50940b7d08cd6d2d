"""Core types: method enums, the fit state and CV residuals, as tensors.

Counterpart of `pls_tpu/types.py`.  `PLSFit` and `Residual` are frozen
dataclasses of `torch.Tensor`s.  A fit made over a batch of CV folds
carries a leading fold axis on every tensor (W is then (F, K, A)); the
shape properties read the trailing axes, so they hold for both.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class METHOD(enum.Enum):
    """PLS fitting algorithm (same values as `pls_tpu.METHOD`).

    KERNEL_TYPE1 / KERNEL_TYPE2 are the Dayal–MacGregor improved kernel
    algorithms.  NIPALS, SIMPLS and SPLS exist so that models saved by the
    JAX package keep their labels; fitting them is not ported yet.
    """

    KERNEL_TYPE1 = "kernel1"
    KERNEL_TYPE2 = "kernel2"
    NIPALS = "nipals"
    SIMPLS = "simpls"
    SPLS = "spls"


KERNEL_TYPE1 = METHOD.KERNEL_TYPE1
KERNEL_TYPE2 = METHOD.KERNEL_TYPE2


class VALIDATION_OUTPUT(enum.Enum):
    """How to summarize CV errors (reference pls.h:143)."""

    RESS = "ress"  # residual error sum of squares (== PRESS for CV errors)
    MSE = "mse"  # mean squared error (RESS / n_observations)


RESS = VALIDATION_OUTPUT.RESS
MSE = VALIDATION_OUTPUT.MSE


@dataclass(frozen=True)
class PLSFit:
    """Result of a PLS fit.

        W : (K, A)  PLS weights for X
        P : (K, A)  PLS loadings for X
        Q : (M, A)  PLS loadings for Y
        R : (K, A)  weights mapping X directly to scores (T = X R)
        T : (N, A)  X scores for KERNEL_TYPE1; (0, A) for KERNEL_TYPE2
    """

    W: torch.Tensor
    P: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    method: METHOD = METHOD.KERNEL_TYPE1

    @property
    def A(self) -> int:
        """Number of components fit."""
        return self.W.shape[-1]

    @property
    def K(self) -> int:
        """Number of predictor variables."""
        return self.W.shape[-2]

    @property
    def M(self) -> int:
        """Number of response variables."""
        return self.Q.shape[-2]


@dataclass(frozen=True)
class Residual:
    """Cross-validation residuals: `errors` is (M, n_obs, A), per response,
    per held-out observation, per component count 1..A.  `method` is the
    label ("LOO", "LSO", "NEW DATA") printed in report headers."""

    errors: torch.Tensor
    method: str = ""

    @property
    def n_obs(self) -> int:
        return self.errors.shape[-2]

    @property
    def A(self) -> int:
        return self.errors.shape[-1]

    @property
    def M(self) -> int:
        return self.errors.shape[-3]


def default_float_dtype(device: torch.device | str) -> torch.dtype:
    """The working precision: float64 on the CPU (parity runs), float32 on
    CUDA (the reference's `config.py:47` policy, with CUDA in the TPU's
    place)."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32
