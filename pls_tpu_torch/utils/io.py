"""CSV matrix IO with the reference's validation semantics.

Counterpart of `pls_tpu/utils/io.py` on its native path: headerless CSV,
each line a row, parsed by the port's host runtime (`utils/native.py`,
`csrc/native_io.cpp`; strtod, as the JAX package's `pls_tpu._native`),
which is built with the host C++ compiler at first use.  There is no
fallback: a missing compiler raises.  Ragged rows raise
`RaggedMatrixError` carrying the reference's exact message

    "Error: row R has N columns, but previous row(s) have M columns."

and exit code 1 (reference pls.cpp:54-58), which the CLI turns into the
reference's exit behaviour.  Non-numeric fields and empty files raise
ValueError, a file that cannot be opened OSError("cannot open F").

`_read_matrix_python` and `_stream_matrix_python` are the plain twins
(Python's float() on each field, the JAX package's functions of the same
names); the tests hold the native path to them, and nothing else calls
them.  `native_reads` counts the native path's whole-file reads and the
chunks its readers delivered, so that a test or chip_smoke.py can tell
that it ran.
"""

from __future__ import annotations

import re

import numpy as np

from pls_tpu_torch.utils import native

native_reads = {"read_matrix": 0, "chunks": 0}


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


def _stream_matrix_python(filename: str, chunk_rows: int, separator: str = ","):
    """The plain twin of `stream_matrix_file`: lines split in Python, one
    chunk at a time."""
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


def _read_matrix_python(filename: str, separator: str = ",") -> np.ndarray:
    """The plain twin of `read_matrix_file` for CSV."""
    return np.concatenate(list(_stream_matrix_python(filename, 1 << 16, separator)))


def _retype_ragged(e: ValueError) -> Exception:
    """The native loader's ragged-row ValueError as RaggedMatrixError
    (row, got, expected); any other error as it is."""
    m = re.match(
        r"Error: row (\d+) has (\d+) columns, but previous row\(s\) have "
        r"(\d+) columns\.",
        str(e),
    )
    if m:
        return RaggedMatrixError(*(int(g) for g in m.groups()))
    return e


def stream_matrix_file(filename: str, chunk_rows: int, separator: str = ","):
    """Yield float64 (rows ≤ chunk_rows, cols) blocks of a headerless CSV
    (`pls_tpu/utils/io.py:103-131`).  A background thread of the native
    reader parses the next chunk while the caller uses this one; closing or
    dropping the generator stops and joins it.  A ragged row raises
    RaggedMatrixError with its row index counted across chunks, after the
    complete chunks before it."""
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    with native.ChunkReader(str(filename), int(chunk_rows), separator) as reader:
        while True:
            try:
                chunk = next(reader)
            except StopIteration:
                return
            except ValueError as e:
                raise _retype_ragged(e) from None
            native_reads["chunks"] += 1
            yield chunk


def read_matrix_file(filename: str, separator: str = ",") -> np.ndarray:
    """Read a matrix file into a float64 (rows, cols) array.

    Files ending in ``.npy`` load as binary numpy arrays (1-D arrays become
    one column); anything else is parsed as headerless CSV by the native
    loader (`pls_tpu/utils/io.py:134-162`).
    """
    if str(filename).endswith(".npy"):
        arr = np.load(filename)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            raise ValueError(f"{filename}: expected 1-D or 2-D array")
        return np.asarray(arr, np.float64)
    try:
        out = native.read_matrix(str(filename), separator)
    except ValueError as e:
        err = _retype_ragged(e)
        if err is e:
            raise
        raise err from None
    native_reads["read_matrix"] += 1
    return out
