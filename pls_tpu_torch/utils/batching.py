"""Chunked fold batches.

Counterpart of `pls_tpu/utils/batching.py::padded_map`: the CV folds run
as batches of at most `batch_size` on a leading axis.  PyTorch compiles
nothing per shape, so the last chunk is simply shorter (the JAX helper
pads it to avoid a second compilation).
"""

from __future__ import annotations

import torch

# default fold-batch budget: the masked (F, N, K) copy of X per chunk
FOLD_BATCH_BYTES = 2**27


def default_batch_size(n_items: int, N: int, K: int, itemsize: int) -> int:
    """Folds per chunk so that a chunk's masked X stays near 128 MiB."""
    return max(1, min(n_items, FOLD_BATCH_BYTES // max(1, N * K * itemsize)))


def fold_batch_size(
    n_folds: int, X: torch.Tensor, batch_size: int | None = None, cap: int = 64
) -> int:
    """Folds (or candidates, permutations) per batch of masked fits:
    `batch_size` as the caller gives it, or as many as keep a batch's
    (F, N, K) copies of X near 128 MiB, at most `cap` (the JAX package's
    default batch size of the same call: 64 for the conformal folds and
    the grid search, 32 for UVE's folds and the permutations, 8 for
    iPLS's candidates).  A batch of one is an un-batched fit (K1 on the
    card), a larger one a batched fit (`kernel_pls.fit_folds`)."""
    if batch_size is not None:
        return batch_size
    N, K = X.shape
    return min(cap, default_batch_size(n_folds, N, K, X.element_size()))


def chunked_map(fn, xs: torch.Tensor, batch_size: int) -> torch.Tensor:
    """torch.cat of fn(chunk) over chunks of xs's leading axis."""
    return torch.cat([fn(xs[i : i + batch_size]) for i in range(0, xs.shape[0], batch_size)])
