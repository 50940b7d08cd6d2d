"""CSV matrix IO with the reference's validation semantics.

Counterpart of `pls_tpu/utils/io.py`, numpy path only (the JAX package's
optional C++ loader is not ported).  Headerless CSV, each line a row;
ragged rows raise `RaggedMatrixError` carrying the reference's exact
message

    "Error: row R has N columns, but previous row(s) have M columns."

and exit code 1 (reference pls.cpp:54-58), which the CLI turns into the
reference's exit behaviour.  Non-numeric fields raise ValueError.
"""

from __future__ import annotations

import numpy as np


class RaggedMatrixError(ValueError):
    """Rows have inconsistent column counts (reference pls.cpp:54-58)."""

    def __init__(self, row: int, got: int, expected: int):
        self.row = row
        self.got = got
        self.expected = expected
        self.exit_code = 1
        super().__init__(
            f"Error: row {row} has {got} columns, but previous row(s) have "
            f"{expected} columns."
        )


def read_matrix_file(filename: str, separator: str = ",") -> np.ndarray:
    """Read a matrix file into a float64 (rows, cols) array.

    Files ending in ``.npy`` load as binary numpy arrays (1-D arrays become
    one column); anything else is parsed as headerless CSV.
    """
    if str(filename).endswith(".npy"):
        arr = np.load(filename)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            raise ValueError(f"{filename}: expected 1-D or 2-D array")
        return np.asarray(arr, np.float64)
    rows: list[np.ndarray] = []
    ncols: int | None = None
    with open(filename) as f:
        for line in f:
            fields = line.rstrip("\n").rstrip("\r").split(separator)
            try:
                row = np.array([float(v) for v in fields], dtype=np.float64)
            except ValueError as e:
                raise ValueError(
                    f"non-numeric field in {filename} row {len(rows)}: {e}"
                ) from e
            if ncols is not None and row.size != ncols:
                raise RaggedMatrixError(len(rows), row.size, ncols)
            ncols = row.size
            rows.append(row)
    if not rows:
        raise ValueError(f"{filename} is empty")
    return np.stack(rows)
