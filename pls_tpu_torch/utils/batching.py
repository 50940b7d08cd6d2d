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


def chunked_map(fn, xs: torch.Tensor, batch_size: int) -> torch.Tensor:
    """torch.cat of fn(chunk) over chunks of xs's leading axis."""
    return torch.cat([fn(xs[i : i + batch_size]) for i in range(0, xs.shape[0], batch_size)])
