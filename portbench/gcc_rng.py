"""The reference CLI's leave-some-out partitions, bit for bit.

The reference CLI (tjhladish/PLS, main.cpp and pls.cpp `rand_nchoosek`)
draws its LSO partitions by shuffling one index vector again and again
with `std::shuffle` under a `std::mt19937`.  This frozen copy replays
libstdc++'s algorithms, so the benchmark's plain reference draws the same
partitions as the program without reading the program's own copy:

- `MT19937`: the textbook Mersenne Twister with std::mt19937's seeding;
- `uniform_int`: libstdc++'s uniform_int_distribution(0, b) for a 32-bit
  generator (Lemire's nearly divisionless method);
- `shuffle`: libstdc++'s std::shuffle, which draws one integer for two
  swap positions while the generator's range allows it;
- `lso_partitions`: the rows of successive shuffles.

The tests hold it to draws made by real libstdc++ code.
"""

from __future__ import annotations

import numpy as np

_U32 = 0xFFFFFFFF


class MT19937:
    """std::mt19937 seeded with one value."""

    N, M = 624, 397

    def __init__(self, seed: int):
        mt = [seed & _U32]
        for i in range(1, self.N):
            mt.append((1812433253 * (mt[-1] ^ (mt[-1] >> 30)) + i) & _U32)
        self._mt = mt
        self._idx = self.N

    def _twist(self) -> None:
        mt = self._mt
        for i in range(self.N):
            y = (mt[i] & 0x80000000) | (mt[(i + 1) % self.N] & 0x7FFFFFFF)
            v = mt[(i + self.M) % self.N] ^ (y >> 1)
            mt[i] = v ^ 0x9908B0DF if y & 1 else v
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= self.N:
            self._twist()
        y = self._mt[self._idx]
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _U32


def uniform_int(rng: MT19937, b: int) -> int:
    """A draw of uniform_int_distribution(0, b) from a 32-bit generator."""
    if b == _U32:
        return rng()
    n = b + 1
    product = rng() * n
    if product & _U32 < n:
        threshold = ((1 << 32) - n) % n
        while product & _U32 < threshold:
            product = rng() * n
    return product >> 32


def shuffle(v: list, rng: MT19937) -> None:
    """std::shuffle of v in place."""
    n = len(v)
    if n <= 1:
        return
    if _U32 // n >= n:  # two swap positions from one draw
        i = 1
        if n % 2 == 0:
            j = uniform_int(rng, 1)
            v[1], v[j] = v[j], v[1]
            i = 2
        while i < n:
            span = i + 1
            x = uniform_int(rng, span * (span + 1) - 1)
            p1, p2 = x // (span + 1), x % (span + 1)
            v[i], v[p1] = v[p1], v[i]
            v[i + 1], v[p2] = v[p2], v[i + 1]
            i += 2
    else:
        for i in range(1, n):
            j = uniform_int(rng, i)
            v[i], v[j] = v[j], v[i]


def lso_partitions(seed: int, n_rows: int, trials: int) -> np.ndarray:
    """(trials, n_rows): row t is the index vector after the t-th shuffle
    of one vector under std::mt19937(seed); its first entries are the
    training rows."""
    rng = MT19937(seed)
    v = list(range(n_rows))
    out = np.empty((trials, n_rows), dtype=np.int64)
    for t in range(trials):
        shuffle(v, rng)
        out[t] = v
    return out
