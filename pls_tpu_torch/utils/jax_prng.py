"""JAX's counter-based PRNG in numpy, bit for bit, without jax.

The JAX package draws its random fold labels (`pls_tpu/cv/kfold.py:35-45`),
LSO partitions (`pls_tpu/cv/lso.py:44-49`) and repeated-k-fold keys
(`pls_tpu/utils/binio.py:755-759`) from `jax.random`.  This module gives
the same draws from the same int seeds, so that the port's partitions
equal the JAX package's on a machine without jax.

It matches jax 0.9.0 with `jax_threefry_partitionable=True` (that
release's default), the threefry2x32 implementation:

  - `key(seed)`: `jax.random.key(seed)` (`jax/_src/prng.py`
    `threefry_seed`): the seed as an int64 split into its high and low
    32-bit words.  Seeds are read as jax reads them with x64 enabled;
    without x64 a negative seed or one of 2³¹ or more keys differently.
  - `split(key, n)`: `_threefry_split_foldlike`, the hash of the pair
    (0, i) for i < n.
  - `fold_in(key, data)`: `threefry_fold_in`, the hash of (0, data).
  - `random_bits32(key, n)`: `_threefry_random_bits_partitionable` at 32
    bits, both hash words of (0, i) xor-ed.
  - `permutation(key, n_or_array)`: `jax/_src/random.py::_shuffle`,
    ceil(3·ln n / ln(2³²−1)) rounds (one up to n = 1625, two from
    1626) of a stable sort on fresh 32-bit keys.
  - `randint(key, shape, minval, maxval, dtype)`: `_randint`, for int32
    (jax's default integer without x64) and int64 (its default with x64):
    two draws of nbits from the two halves of `split(key)`, combined as
    (hi mod span)·(2^nbits mod span) + (lo mod span), mod span, in
    unsigned nbits arithmetic.  64-bit draws are the hash pair as
    (b0 << 32) | b1.

  - `normal(key, shape, dtype)`: `_normal_real`, √2·erfinv(u) of u
    uniform on [nextafter(−1, 0), 1) as `_uniform` makes it, for float32
    (32-bit draws) and float64 (64-bit): the draw's top mantissa bits
    under the exponent of 1.0, minus 1, times 2 (the span rounds to 2, so
    the scaling is exact), plus nextafter(−1, 0).  The bits and u are
    JAX's exactly;
    erfinv is torch's, where XLA's is its own polynomial, so a value may
    differ from JAX's in its last units in the place
    (tests/test_torch_prng.py measures how many).  With a `device`, the
    hash runs there in torch, in chunks, for draws too large for numpy.

A key is a (2,) uint32 array, the raw data of a jax key
(`jax.random.key_data`).
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 hash of counter pairs (x0, x1) under key
    k (..., 2), as `_threefry2x32_lowering` computes it; key and counters
    broadcast."""
    k = np.asarray(k, _U32)
    k0, k1 = k[..., 0], k[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)`'s data."""
    s = int(seed) % 2**64
    return np.array([s >> 32, s & 0xFFFFFFFF], _U32)


def _as_key(k) -> np.ndarray:
    return key(k) if isinstance(k, (int, np.integer)) else np.asarray(k, _U32)


def _counts(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(k, n: int = 2) -> np.ndarray:
    """`jax.random.split(k, n)`'s data, (n, 2) uint32; a batch of keys
    (..., 2) splits each, (..., n, 2)."""
    b0, b1 = threefry2x32(_as_key(k)[..., None, :], *_counts(n))
    return np.stack([b0, b1], axis=-1)


def fold_in(k, data: int) -> np.ndarray:
    """`jax.random.fold_in(k, data)`'s data."""
    b0, b1 = threefry2x32(_as_key(k), np.zeros(1, _U32), np.array([int(data) % 2**32], _U32))
    return np.array([b0[0], b1[0]], _U32)


def random_bits32(k, n: int) -> np.ndarray:
    """(n,) uint32: `jax.random.bits(k, (n,), uint32)`; (..., n) for a
    batch of keys (..., 2)."""
    return _random_bits(k, n, 32)


def _random_bits(k, n: int, nbits: int) -> np.ndarray:
    """(..., n) unsigned draws of `nbits` (32 or 64) per key (..., 2):
    `_threefry_random_bits_partitionable`."""
    b0, b1 = threefry2x32(_as_key(k)[..., None, :], *_counts(n))
    if nbits == 32:
        return b0 ^ b1
    return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)


def randint(k, shape, minval, maxval, dtype=np.int32) -> np.ndarray:
    """`jax.random.randint(k, shape, minval, maxval, dtype)`: values in
    [minval, maxval) of int32 or int64 (pass int64 for what jax draws with
    x64 enabled, its default there); a batch of keys (..., 2) draws one
    array per key, (..., *shape), as `jax.vmap` over the keys does."""
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
        raise TypeError(f"randint takes int32 or int64, got {dtype}")
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)
    nbits = dtype.itemsize * 8
    udt = np.uint32 if nbits == 32 else np.uint64
    info = np.iinfo(dtype)
    lo_v, hi_v = np.asarray(minval, np.int64), np.asarray(maxval, np.int64)
    out_of_range = hi_v > info.max
    lo_v, hi_v = np.clip(lo_v, info.min, info.max), np.clip(hi_v, info.min, info.max)
    k = _as_key(k)
    both = split(k)
    n = int(np.prod(shape))
    higher = _random_bits(both[..., 0, :], n, nbits).reshape(k.shape[:-1] + shape)
    lower = _random_bits(both[..., 1, :], n, nbits).reshape(k.shape[:-1] + shape)
    with np.errstate(over="ignore"):
        span = (hi_v - lo_v).astype(dtype).astype(udt)
        # span 1 where maxval <= minval (minval is drawn); one more where
        # maxval was past the dtype's range (2^nbits wraps to 0: no remainder)
        span = np.where(hi_v <= lo_v, udt(1), span).astype(udt)
        span = np.where(out_of_range & (hi_v > lo_v), span + udt(1), span).astype(udt)
        # 2^nbits mod span, as ((2^(nbits/2) mod span)² mod span); XLA's
        # remainder by 0 leaves its operand, so a span of 0 (2^nbits
        # wrapped) gives a multiplier of 2^nbits = 0 and the low draw as is
        safe = np.where(span == 0, udt(1), span).astype(udt)
        mult = udt(1 << (nbits // 2)) % safe
        mult = np.where(span == 0, udt(0), (mult * mult) % safe).astype(udt)
        offset = (higher % safe) * mult + (lower % safe)
        offset = np.where(span == 0, lower, offset % safe).astype(udt)
        return (lo_v.astype(dtype) + offset.astype(dtype)).astype(dtype)


def shuffle_rounds(n: int) -> int:
    """The rounds `_shuffle` takes for n items."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(k, x) -> np.ndarray:
    """`jax.random.permutation(k, x)`: a shuffled arange(x) for an int x, a
    shuffled copy of a 1-D array x.  A batch of keys (..., 2) gives one
    permutation per key, (..., n), as `jax.vmap` over the keys does."""
    x = np.arange(int(x)) if np.ndim(x) == 0 else np.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"permutation takes an int or a 1-D array, got shape {x.shape}")
    k = _as_key(k)
    out = np.broadcast_to(x, k.shape[:-1] + x.shape)
    for _ in range(shuffle_rounds(x.size)):
        both = split(k)
        k, sub = both[..., 0, :], both[..., 1, :]
        order = np.argsort(random_bits32(sub, x.size), axis=-1, kind="stable")
        out = np.take_along_axis(out, order, axis=-1)
    return np.array(out)


# ---------- floating draws ----------
_M32 = 0xFFFFFFFF
_CHUNK = 1 << 24  # draws per chunk of the device hash


def _threefry_torch(k, x0: "torch.Tensor", x1: "torch.Tensor"):
    """`threefry2x32` on int64 tensors holding uint32 values, under key k
    (2,) uint32; the words stay below 2³² by masking."""
    k0, k1 = int(k[0]), int(k[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def _unit_floats_torch(k, n: int, dtype, device) -> "torch.Tensor":
    """(n,) floats in [1, 2) from the key's draws, as `_uniform` makes
    them, hashed on `device`."""
    import torch

    f64 = dtype == torch.float64
    out = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, _CHUNK):
        i = torch.arange(lo, min(n, lo + _CHUNK), dtype=torch.int64, device=device)
        b0, b1 = _threefry_torch(k, i >> 32, i & _M32)
        if f64:  # the top 52 of (b0 << 32) | b1
            m = ((b0 << 20) | (b1 >> 12)) | 0x3FF0000000000000
            out[lo : lo + len(i)] = m.view(torch.float64)
        else:  # the top 23 of b0 ^ b1
            m = ((b0 ^ b1) >> 9) | 0x3F800000
            out[lo : lo + len(i)] = m.to(torch.int32).view(torch.float32)
    return out


def _unit_floats(k, n: int, dtype) -> np.ndarray:
    """(n,) floats in [1, 2) from the key's draws, in numpy."""
    dtype = np.dtype(dtype)
    nbits, nmant = dtype.itemsize * 8, np.finfo(dtype).nmant
    if nbits not in (32, 64):
        raise TypeError(f"normal takes float32 or float64, got {dtype}")
    udt = np.uint32 if nbits == 32 else np.uint64
    bits = _random_bits(k, n, nbits)
    one = np.array(1.0, dtype).view(udt)
    return ((bits >> udt(nbits - nmant)) | one).view(dtype)


def _shape(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)


def normal(k, shape, dtype=np.float32, device=None):
    """`jax.random.normal(k, shape, dtype)` for float32 and float64 (one
    key): numpy without a `device`; with one, a torch tensor made there
    (a numpy dtype or a torch one)."""
    import torch

    shape = _shape(shape)
    n = int(np.prod(shape))
    if device is None:
        npdt = np.dtype(dtype)
        floats = _unit_floats(_as_key(k), n, npdt)
        u = torch.from_numpy(floats) - 1.0
    else:
        tdt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)
        npdt = np.dtype(str(tdt).removeprefix("torch."))
        u = _unit_floats_torch(_as_key(k), n, tdt, device) - 1.0
    lo = np.nextafter(np.array(-1.0, npdt), np.array(0.0, npdt))
    span = np.array(1.0, npdt) - lo
    u = torch.clamp(u * float(span) + float(lo), min=float(lo))
    out = (float(np.array(np.sqrt(2), npdt)) * torch.erfinv(u)).reshape(shape)
    return out.numpy() if device is None else out
