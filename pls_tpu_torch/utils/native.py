"""The port's host runtime: ctypes bindings of `csrc/native_io.cpp`.

Counterpart of the JAX package's CPython extension `pls_tpu._native`
(native/pls_native.cpp), with the same four functions, results and
messages:

- `read_matrix(filename, sep=",")`: a headerless CSV as float64 (rows,
  cols), parsed with strtod; a ragged row, a non-numeric field or an empty
  file raises ValueError with the reference's message, a file that cannot
  be opened OSError("cannot open F");
- `ChunkReader(filename, chunk_rows, sep=",")`: an iterator of float64
  (≤ chunk_rows, cols) chunks, one background thread parsing chunk n+1
  while the caller uses chunk n; an error of the thread is raised by the
  next `next()`, after the chunk already parsed;
- `gcc_shuffle_trace(seed, n, reps)` and `mt19937_raw(seed, n)`: real
  libstdc++ std::shuffle / std::mt19937 draws, the ground truth that
  `utils/gcc_rng.py`'s emulator is held to.

One deliberate difference: a tab or space separator.  The JAX extension
skips blanks after a field before it looks for the separator, so it
refuses every such row of two fields or more; the port stops at the
separator and reads those files as the JAX package's Python parser does.

The library is built by the host C++ compiler at first use
(`utils/cxx.py`); a missing compiler or a failed build raises, and there
is no Python fallback.  `utils/io.py` keeps the Python parser as the plain
twin for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from pls_tpu_torch.utils import cxx

SOURCE = "native_io.cpp"
_VALUE, _OS = 1, 2  # the C interface's error kinds
_ERRLEN = 4096

_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_int_p = ctypes.POINTER(ctypes.c_int)


@functools.cache
def library() -> ctypes.CDLL:
    """csrc/native_io.cpp, built if needed, with its C interface declared."""
    lib = cxx.load_library(SOURCE)
    vp, lp, cp = ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p
    for name, restype, argtypes in (
        ("pio_read_matrix", vp, [cp, ctypes.c_char, _c_long_p, _c_long_p, cp, lp, _c_int_p]),
        ("pio_matrix_take", None, [vp, vp]),
        ("pio_chunk_open", vp, [cp, lp, ctypes.c_char, cp, lp, _c_int_p]),
        ("pio_chunk_next", ctypes.c_int, [vp, _c_long_p, _c_long_p, cp, lp]),
        ("pio_chunk_copy", None, [vp, vp]),
        ("pio_chunk_close", None, [vp]),
        ("pio_live_readers", lp, []),
        ("pio_gcc_shuffle_trace", None, [ctypes.c_ulong, lp, lp, vp]),
        ("pio_mt19937_raw", None, [ctypes.c_ulong, lp, vp]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _sep_byte(sep: str) -> bytes:
    b = sep.encode()
    if len(b) != 1 or b == b"\0":
        raise ValueError("separator must be a single character")
    return b


def _raise(kind: int, err) -> None:
    msg = err.value.decode(errors="replace")
    raise (OSError if kind == _OS else ValueError)(msg)


def read_matrix(filename: str, sep: str = ",") -> np.ndarray:
    """The whole file as float64 (rows, cols)."""
    sc = _sep_byte(sep)
    lib = library()
    rows, cols, kind = ctypes.c_long(), ctypes.c_long(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    handle = lib.pio_read_matrix(str(filename).encode(), sc, ctypes.byref(rows),
                                 ctypes.byref(cols), err, _ERRLEN, ctypes.byref(kind))
    if not handle:
        _raise(kind.value, err)
    try:
        out = np.empty((rows.value, cols.value), np.float64)
    except MemoryError:
        lib.pio_matrix_take(handle, None)
        raise
    lib.pio_matrix_take(handle, out.ctypes.data)
    return out


class ChunkReader:
    """Float64 chunks of a headerless CSV, parsed ahead on a background
    thread (one chunk in flight).  `close()` (or leaving a `with` block, or
    dropping the reader) stops and joins the thread at any point; use one
    reader from one thread."""

    _handle = None

    def __init__(self, filename: str, chunk_rows: int, sep: str = ","):
        chunk_rows = int(chunk_rows)
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        sc = _sep_byte(sep)
        self._lib = library()
        kind = ctypes.c_int()
        err = ctypes.create_string_buffer(_ERRLEN)
        handle = self._lib.pio_chunk_open(str(filename).encode(), chunk_rows, sc, err, _ERRLEN,
                                          ctypes.byref(kind))
        if not handle:
            _raise(kind.value, err)
        self._handle = handle

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        rows, cols = ctypes.c_long(), ctypes.c_long()
        err = ctypes.create_string_buffer(_ERRLEN)
        # waits with the interpreter lock released (ctypes drops it)
        got = self._lib.pio_chunk_next(self._handle, ctypes.byref(rows), ctypes.byref(cols),
                                       err, _ERRLEN)
        if got < 0:
            _raise(_VALUE, err)
        if got == 0:
            raise StopIteration
        out = np.empty((rows.value, cols.value), np.float64)
        self._lib.pio_chunk_copy(self._handle, out.ctypes.data)  # the one copy of the chunk
        return out

    def close(self) -> None:
        if self._handle is not None:
            handle, self._handle = self._handle, None
            self._lib.pio_chunk_close(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def live_readers() -> int:
    """Chunk readers open in this process, whose threads are not yet joined."""
    return int(library().pio_live_readers())


def gcc_shuffle_trace(seed: int, n: int, reps: int) -> np.ndarray:
    """int64 (reps, n): 0..n-1 shuffled by std::shuffle on one live
    std::mt19937(seed), row r after replicate r (not reset between)."""
    if n <= 0 or reps <= 0:
        raise ValueError("n and reps must be positive")
    out = np.empty((reps, n), np.int64)
    library().pio_gcc_shuffle_trace(seed, n, reps, out.ctypes.data)
    return out


def mt19937_raw(seed: int, n: int) -> np.ndarray:
    """uint32 (n,): the first n draws of std::mt19937(seed)."""
    out = np.empty(n, np.uint32)
    library().pio_mt19937_raw(seed, n, out.ctypes.data)
    return out
