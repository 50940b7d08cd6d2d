"""Multi-device and multi-process execution on torch.distributed: the
('rows', 'folds') mesh, row- and column-sharded fits whose over-rows sums
are all-reduces, and fold-sharded cross-validation.

Counterpart of `pls_tpu/parallel/`.  The reference has no parallelism of
any kind; the JAX package shards rows of X/Y over a device mesh with psums
for the cross-products and norms, and CV folds and replicates over chips.
Here each rank is one process on one device: NCCL between cards, gloo on
the CPU (`initialize_distributed`).
"""

from pls_tpu_torch.parallel.mesh import initialize_distributed, make_pls_mesh
from pls_tpu_torch.parallel.sharded import (
    cv_lso_rowsharded,
    cv_lso_sharded,
    cv_loo_sharded,
    fit_colsharded,
    fit_rowsharded_shardmap,
    fit_sharded,
    train_step,
)

__all__ = [
    "make_pls_mesh",
    "initialize_distributed",
    "fit_sharded",
    "fit_colsharded",
    "fit_rowsharded_shardmap",
    "cv_lso_sharded",
    "cv_lso_rowsharded",
    "cv_loo_sharded",
    "train_step",
]
