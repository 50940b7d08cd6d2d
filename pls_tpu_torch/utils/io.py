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


def _parse_row(line: str, separator: str, filename, row: int) -> np.ndarray:
    fields = line.rstrip("\n").rstrip("\r").split(separator)
    try:
        return np.array([float(v) for v in fields], dtype=np.float64)
    except ValueError as e:
        raise ValueError(f"non-numeric field in {filename} row {row}: {e}") from e


def stream_matrix_file(filename: str, chunk_rows: int, separator: str = ","):
    """Yield float64 (rows ≤ chunk_rows, cols) blocks of a headerless CSV:
    the numpy path of `pls_tpu/utils/io.py:62-131`.  A ragged row raises
    RaggedMatrixError with its row index counted across chunks."""
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    rows: list[np.ndarray] = []
    ncols: int | None = None
    n = 0
    with open(filename) as f:
        for line in f:
            row = _parse_row(line, separator, filename, n)
            if ncols is not None and row.size != ncols:
                raise RaggedMatrixError(n, row.size, ncols)
            ncols = row.size
            rows.append(row)
            n += 1
            if len(rows) == chunk_rows:
                yield np.stack(rows)
                rows = []
    if rows:
        yield np.stack(rows)
    elif n == 0:
        raise ValueError(f"{filename} is empty")


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
    return np.concatenate(list(stream_matrix_file(filename, 1 << 16, separator)))
