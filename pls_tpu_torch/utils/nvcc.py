"""Build a CUDA source of this package with nvcc and load it with ctypes
(the host C++ sources: `utils/cxx.py`, through the same steps).

A source under `pls_tpu_torch/csrc/` is compiled for Hopper (`sm_90a`)
into a shared library with a plain C interface, at first use, in
`build/pls_tpu_torch/` beside the package.  The library's name carries a
hash of the source, of every header of `csrc/` it includes with
`#include "…"` (and theirs), and of the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.  nvcc's output (with `-Xptxas -v`: each
kernel's registers, shared memory and spills) is kept beside the library
as `<name>.log`.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "pls_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (or CUDA_PATH), else from PATH."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on PATH"
        )
    return found


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(source: str) -> list[Path]:
    """csrc/<source>, then the headers it includes with quotes, and theirs,
    that exist beside it, in the order first seen."""
    files: list[Path] = []
    todo = [PACKAGE_DIR / "csrc" / source]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [f.parent / name for name in _QUOTED_INCLUDE.findall(f.read_text())
                 if (f.parent / name).exists()]
    return files


def library_path(source: str, command: tuple[str, ...] = NVCC_FLAGS) -> Path:
    """Where the library built from csrc/<source> by `command` (the
    compiler's flags, and for the host compiler its name) lives for this
    text of the source and its headers."""
    digest = hashlib.sha256()
    for f in source_files(source):
        digest.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    digest.update(" ".join(command).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def compile_library(argv: list[str], source: str, out: Path) -> None:
    """Run `argv + ["-o", tmp, csrc/<source>]` and move tmp to `out`.
    Concurrent builds of one library (test workers) are safe: each writes
    its own tmp and the move is atomic.  A failed build raises RuntimeError
    with the tail of the compiler's output; its output on success is kept
    beside the library as `<name>.log`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*argv, "-o", tmp, str(PACKAGE_DIR / "csrc" / source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tail = (proc.stdout + proc.stderr)[-8000:]
            raise RuntimeError(
                f"{argv[0]} failed on csrc/{source} (exit {proc.returncode}):\n{tail}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build csrc/<source> with nvcc if its library is missing, then load
    it.  A failed build raises RuntimeError with nvcc's output."""
    out = library_path(source)
    if not out.exists():
        compile_library([nvcc_path(), *NVCC_FLAGS], source, out)
    return ctypes.CDLL(str(out))
