"""Build a host C++ source of this package and load it with ctypes.

A `.cpp` under `pls_tpu_torch/csrc/` (the host runtime,
`csrc/native_io.cpp`) is compiled at first use by the host C++ compiler,
`$CXX` or else `g++` (the compiler nvcc itself uses on Linux), with
`-std=c++17 -O3 -shared -fPIC -pthread`, into `build/pls_tpu_torch/`
beside the package, as the CUDA libraries are (`utils/nvcc.py`).  The
library's name carries a hash of the source, of the compiler's name and of
the flags.  There is no fallback: a missing compiler or a failed build
raises RuntimeError.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pls_tpu_torch.utils import nvcc

CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")


def compiler() -> str:
    """The host C++ compiler: $CXX, else g++."""
    return os.environ.get("CXX") or "g++"


def library_path(source: str) -> Path:
    """Where the library built from csrc/<source> by this compiler lives."""
    return nvcc.library_path(source, (compiler(), *CXX_FLAGS))


def build(source: str) -> Path:
    """Build csrc/<source> if its library is missing; return its path.
    Raises RuntimeError naming the compiler if it is not found, or with the
    tail of its output if the build fails."""
    out = library_path(source)
    if not out.exists():
        cxx = compiler()
        if shutil.which(cxx) is None:
            raise RuntimeError(
                f"C++ compiler {cxx!r} not found: pls_tpu_torch builds csrc/{source} "
                "at first use; set CXX to a C++17 compiler or put g++ on PATH"
            )
        nvcc.compile_library([cxx, *CXX_FLAGS], source, out)
    return out


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build csrc/<source> if needed and load it (once per process)."""
    return ctypes.CDLL(str(build(source)))
