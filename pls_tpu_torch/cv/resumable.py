"""Checkpointed, resumable cross-validation sweeps.

Counterpart of `pls_tpu/cv/resumable.py`.  LOO folds and LSO trials are
deterministic given the data, A and the partitions, and their error
blocks are independent, so a sweep runs in ranges, each range's errors
are saved as it completes, and a sweep started again resumes from the
first missing range:

    runner = ResumableCV("sweep_dir")
    res = runner.run_lso(X, Y, A, 0.3, 10_000, partitions=parts, range_size=500)

A range is one `.npz` file holding `errors`, published by an atomic
rename, with the JAX package's names, so either package can finish a
sweep the other started.  Each file is read back into numpy; the
assembled errors go to the device of X (a tensor keeps its device, other
data goes to the card: `config.as_data`).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from pls_tpu_torch.cv.loo import cv_loo_downdate, make_loo_fold_fn
from pls_tpu_torch.cv.lso import cv_lso
from pls_tpu_torch.config import as_data
from pls_tpu_torch.types import METHOD, Residual
from pls_tpu_torch.utils.batching import chunked_map


class ResumableCV:
    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _range_path(self, kind: str, start: int, stop: int) -> Path:
        return self.dir / f"{kind}_{start:08d}_{stop:08d}.npz"

    def _save_range(self, path: Path, errors: np.ndarray) -> None:
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, errors=errors)
        os.replace(tmp, path)  # atomic publish

    @staticmethod
    def _load_range(path: Path) -> np.ndarray:
        with np.load(path) as z:
            return z["errors"]

    @staticmethod
    def _parse_range(path: Path) -> tuple[int, int] | None:
        """(start, stop) for a completed-range file; None for anything
        else (in particular orphaned *.tmp.npz files left by a crash
        between savez and the atomic rename)."""
        parts = path.stem.split("_")
        if len(parts) != 3 or not (parts[1].isdigit() and parts[2].isdigit()):
            return None
        return int(parts[1]), int(parts[2])

    def _sweep(self, kind: str, n: int, range_size: int, compute, device) -> Residual:
        """The errors (M, ·, A) of items 0..n-1 in ranges: each range read
        from its file, or computed by `compute(start, stop)` and saved."""
        chunks = []
        for start in range(0, n, range_size):
            stop = min(start + range_size, n)
            path = self._range_path(kind, start, stop)
            if path.exists():
                chunks.append(self._load_range(path))
                continue
            errs = compute(start, stop).cpu().numpy()
            self._save_range(path, errs)
            chunks.append(errs)
        errors = torch.as_tensor(np.concatenate(chunks, axis=1), device=device)
        return Residual(errors=errors, method=kind.upper())

    def run_lso(
        self,
        X,
        Y,
        A: int,
        test_fraction: float,
        num_trials: int,
        *,
        partitions,
        range_size: int = 256,
        method: METHOD = METHOD.KERNEL_TYPE1,
        batch_size: int | None = None,
        **kw,
    ) -> Residual:
        """LSO in resumable trial ranges.  `partitions` must be the full
        (num_trials, N) matrix (deterministic, e.g. from GccRng or
        random_partitions) so any range can be recomputed on its own."""
        X = as_data(X)
        Y = as_data(Y, X.device)
        partitions = torch.as_tensor(partitions)
        if partitions.shape[0] != num_trials:
            raise ValueError("partitions rows != num_trials")

        def compute(start, stop):
            return cv_lso(X, Y, A, test_fraction, stop - start, method,
                          partitions=partitions[start:stop], batch_size=batch_size, **kw).errors

        return self._sweep("lso", num_trials, range_size, compute, X.device)

    def run_loo(
        self,
        X,
        Y,
        A: int,
        *,
        range_size: int = 256,
        method: METHOD = METHOD.KERNEL_TYPE1,
        downdate: bool = False,
        batch_size: int | None = None,
        **kw,
    ) -> Residual:
        """LOO in resumable fold ranges: masked refits through the shared
        fold body (`make_loo_fold_fn`, batches of `batch_size`, default
        64), or with downdate=True rank-1 downdates of XᵀX/XᵀY (kernel
        type 2, `cv_loo_downdate` over the range's `fold_indices`)."""
        X = as_data(X)
        Y = as_data(Y, X.device)
        if Y.ndim == 1:
            Y = Y[:, None]
        if downdate:
            def compute(start, stop):
                return cv_loo_downdate(X, Y, A, fold_indices=torch.arange(start, stop),
                                       batch_size=batch_size, **kw).errors
        else:
            fold = make_loo_fold_fn(X, Y, A, method, **kw)

            def compute(start, stop):
                idx = torch.arange(start, stop, device=X.device)
                return chunked_map(fold, idx, batch_size or 64).permute(2, 0, 1)

        return self._sweep("loo", X.shape[0], range_size, compute, X.device)

    def completed_ranges(self, kind: str) -> list[tuple[int, int]]:
        out = []
        for p in sorted(self.dir.glob(f"{kind}_*.npz")):
            r = self._parse_range(p)
            if r is not None:
                out.append(r)
        return out

    def clean_orphans(self) -> int:
        """Remove *.tmp.npz files left by a crash mid-save; returns count.
        Safe to call any time: completed ranges are never touched."""
        n = 0
        for p in self.dir.glob("*.tmp.npz"):
            p.unlink()
            n += 1
        return n
