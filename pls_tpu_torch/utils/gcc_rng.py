"""The reference CLI's random number pipeline, drawn by libstdc++ itself.

The reference's LSO cross-validation is driven by a default-constructed
`std::mt19937` (seed 5489) passed through `std::shuffle`
(reference main.cpp:38-40 → pls.cpp:218-227),
making its output fully deterministic.  `GccRng` owns one live
`std::mt19937` of the port's host runtime (`utils/native.py`, built from
`csrc/native_io.cpp` at first use) and draws through it with the real
`std::shuffle`, so its partitions are the reference's integers and its
state carries across calls like the reference's `std::mt19937&`.  There is
no fallback: a missing compiler raises.  `native_draws` counts the calls
the native engine served, so that a test or a reader can tell it ran.

The plain twin, pure Python copied from `pls_tpu/utils/gcc_rng.py` (no
jax in it), replays the same bit stream; the tests hold the native engine
to it, and no code path of the package calls it:

- `MT19937`: the standard Mersenne Twister (MT19937 is fully specified;
  this is the textbook algorithm, not code taken from the reference).
- `gcc_shuffle`: libstdc++'s `std::shuffle` — which is NOT a plain
  Fisher–Yates: when the generator range is >= n², libstdc++ draws ONE
  uniform integer to produce TWO swap positions per iteration
  (`__gen_two_uniform_ints`), plus a leading single swap when n is even.
  Its `uniform_int_distribution` uses Lemire's nearly-divisionless
  rejection (`_uniform_int`).

Both are validated bit-for-bit against fixtures generated by running real
libstdc++ code (tests/golden/mt19937_raw.csv, shuffle*.csv,
*_lso_parts.csv; see tools/golden_gen.cpp) and against
`gcc_shuffle_trace` and `mt19937_raw` (re-exported from `utils/native.py`),
which draw from a fresh engine.
"""

from __future__ import annotations

import numpy as np

from pls_tpu_torch.utils import native
from pls_tpu_torch.utils.native import gcc_shuffle_trace, mt19937_raw  # noqa: F401

native_draws = {"raw": 0, "shuffle": 0, "lso_partitions": 0}

_U32 = 0xFFFFFFFF


class MT19937:
    """Standard MT19937 with std::mt19937-compatible single-value seeding."""

    N = 624
    M = 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        mt = np.empty(self.N, dtype=np.uint64)
        mt[0] = seed & _U32
        for i in range(1, self.N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & _U32
        self._mt = mt
        self._idx = self.N

    def _twist(self) -> None:
        # In-place like the standard implementation: entries i >= N-M read
        # values updated earlier in the same pass, so this must be sequential.
        mt = self._mt
        for i in range(self.N):
            y = int((mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER))
            val = int(mt[(i + self.M) % self.N]) ^ (y >> 1)
            if y & 1:
                val ^= self.MATRIX_A
            mt[i] = val & _U32
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= self.N:
            self._twist()
        y = int(self._mt[self._idx])
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _U32


def _uniform_int(rng: MT19937, b: int) -> int:
    """libstdc++ (GCC >= 11) uniform_int_distribution(0, b) for a generator
    whose range is exactly 2^32-1: Lemire's nearly-divisionless algorithm
    (`_S_nd<uint64>` in bits/uniform_int_dist.h) — product = g()·(b+1) in
    64 bits, rejecting only when the low 32 bits fall under
    threshold = (2^32 − (b+1)) mod (b+1)."""
    urange = b
    if urange == _U32:
        return rng()
    uerange = urange + 1  # fits in uint32 because urange < 2^32-1
    product = rng() * uerange
    low = product & _U32
    if low < uerange:
        threshold = ((1 << 32) - uerange) % uerange
        while low < threshold:
            product = rng() * uerange
            low = product & _U32
    return product >> 32


def gcc_shuffle(v: list, rng: MT19937) -> None:
    """In-place libstdc++ std::shuffle semantics."""
    n = len(v)
    if n <= 1:
        return
    urngrange = _U32
    if urngrange // n >= n:  # paired-swap fast path
        i = 1
        if n % 2 == 0:
            j = _uniform_int(rng, 1)
            v[i], v[j] = v[j], v[i]
            i += 1
        while i < n:
            swap_range = i + 1
            x = _uniform_int(rng, swap_range * (swap_range + 1) - 1)
            p1, p2 = x // (swap_range + 1), x % (swap_range + 1)
            v[i], v[p1] = v[p1], v[i]
            i += 1
            v[i], v[p2] = v[p2], v[i]
            i += 1
    else:  # generic Fisher-Yates (n > 65536)
        for i in range(1, n):
            j = _uniform_int(rng, i)
            v[i], v[j] = v[j], v[i]


class GccRng:
    """Stateful RNG mirroring the reference CLI's `std::mt19937 rng`: a live
    libstdc++ engine seeded with `seed` mod 2³².  `copy.copy` and
    `copy.deepcopy` fork the stream; a GccRng cannot be pickled.

    Pass to Model.cv_LSO / cv_lso for bit-exact reference partitions."""

    _handle = None

    def __init__(self, seed: int = 5489):
        self.seed = seed
        self._lib = native.library()
        self._handle = self._lib.pio_mt_new(int(seed) & _U32)

    def __copy__(self) -> GccRng:
        other = object.__new__(GccRng)
        other.seed, other._lib = self.seed, self._lib
        other._handle = self._lib.pio_mt_clone(self._handle)
        return other

    def __deepcopy__(self, memo) -> GccRng:
        return self.__copy__()

    def __reduce__(self):
        raise TypeError("a GccRng holds a native std::mt19937 and cannot be pickled")

    def __del__(self):
        if self._handle is not None:
            handle, self._handle = self._handle, None
            self._lib.pio_mt_free(handle)

    def raw(self) -> int:
        native_draws["raw"] += 1
        return self._lib.pio_mt_raw(self._handle)

    def shuffle(self, v: list) -> None:
        """std::shuffle of `v` in place.  Its swaps depend only on
        positions, so an index vector shuffled natively carries them to a
        list of any items."""
        perm = np.arange(len(v), dtype=np.int64)
        self._lib.pio_mt_shuffle(self._handle, perm.ctypes.data, len(v))
        native_draws["shuffle"] += 1
        v[:] = [v[i] for i in perm.tolist()]

    def lso_partitions(self, n_rows: int, num_trials: int) -> np.ndarray:
        """(num_trials, n_rows) partition matrix: row r is the shuffled index
        vector after replicate r's `rand_nchoosek` (train rows first —
        reference pls.cpp:218-227; the vector is re-shuffled, not
        reset, across replicates)."""
        out = np.empty((num_trials, n_rows), dtype=np.int64)
        self._lib.pio_mt_lso_partitions(self._handle, out.shape[1], out.shape[0], out.ctypes.data)
        native_draws["lso_partitions"] += 1
        return out
