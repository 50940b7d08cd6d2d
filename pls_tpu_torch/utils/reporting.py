"""Eigen-compatible text formatting for report tables.

The reference prints all matrices with Eigen's default `operator<<`
(std::ostream default precision 6 → printf %g semantics), right-aligning
every entry to the width of the widest entry in the matrix, single-space
separated (see e.g. the RMSE tables at reference pls.cpp:303).
`format_eigen` reproduces that layout for real matrices so our CLI tables
diff cleanly against the reference's — modulo the one documented
deviation: our model state is real-valued, so entries print as `-0.265544`
rather than Eigen's complex `(-0.265544,0)` (see DEVIATIONS.md).
"""

from __future__ import annotations

import numpy as np


def host(t) -> np.ndarray:
    """A tensor's values as a numpy array on the host; bfloat16, which
    numpy lacks, widens to float32 (exactly)."""
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _fmt_g6(v: float) -> str:
    """C++ ostream default double formatting (= printf %g, precision 6)."""
    return f"{v:.6g}"


def _fmt_complex_g6(v: float) -> str:
    """Eigen's complex formatting for our (always-real) model state:
    '(re,0)' exactly as the reference prints its zero-imaginary entries."""
    return f"({v:.6g},0)"


def format_eigen(mat: np.ndarray, fmt=_fmt_g6) -> str:
    """Format a 1D/2D array the way Eigen's default operator<< does."""
    mat = np.atleast_2d(np.asarray(mat))
    cells = [[fmt(float(v)) for v in row] for row in mat]
    width = max((len(c) for row in cells for c in row), default=0)
    return "\n".join(" ".join(c.rjust(width) for c in row) for row in cells)


def format_eigen_complex(mat: np.ndarray) -> str:
    """Reference-identical complex-tuple rendering (see DEVIATIONS.md #1:
    use for byte-level diffing of print_state against the reference CLI)."""
    return format_eigen(mat, fmt=_fmt_complex_g6)
