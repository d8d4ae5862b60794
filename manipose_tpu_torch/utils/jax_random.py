"""JAX's default random streams, in numpy.

The draws of ``jax.random`` with the default ``threefry2x32``
implementation (``jax_threefry_partitionable`` on, JAX's default): the
Threefry-2x32 hash of 20 rounds, ``PRNGKey``, ``fold_in``, 32-bit random
bits keyed by each element's flat index, ``uniform`` and
``truncated_normal``, and flax's per-parameter keys (the SHA-1 of a
module path and a call count folded into the key, ``flax/core/scope.py``
``_fold_in_static``). The integer streams are bit for bit JAX's; the
floats go through numpy's float32 ``log1p`` and ``sqrt`` and XLA's
polynomial for erfinv, within a float32 rounding of JAX's.

Used where a port tool must start from the very weights its JAX
counterpart draws from a seed (``train.init.flax_init_from_key``).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under ``key``
    (two uint32), as ``jax._src.prng._threefry2x32_lowering``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):  # uint32 sums wrap, as in the hash
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the pair (0, data)."""
    a, b = threefry2x32(key, np.array([0], np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """32-bit ``jax.random.bits``: element i (row-major) is the xor of the
    hash of the pair (i // 2**32, i % 2**32)."""
    n = math.prod(shape)
    index = np.arange(n, dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """float32 ``jax.random.uniform``: 23 random mantissa bits of a float
    in [1, 2), less 1, scaled to [minval, maxval)."""
    minval, maxval = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(minval, floats * (maxval - minval) + minval)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 erfinv by XLA's polynomial (Giles, "Approximating the erfinv
    function")."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, np.float32(_ERFINV_SMALL[0]), np.float32(_ERFINV_LARGE[0]))
    for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = np.where(small, np.float32(lo), np.float32(hi)) + p * w
    return (p * x).astype(np.float32)


def truncated_normal(key, lower: float, upper: float, shape) -> np.ndarray:
    """float32 ``jax.random.truncated_normal``: uniform between erf(lower /
    sqrt 2) and erf(upper / sqrt 2), through sqrt 2 * erfinv, clipped into
    the open interval."""
    sqrt2 = np.float32(math.sqrt(2.0))
    lower, upper = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lower / sqrt2)))
    b = np.float32(math.erf(float(upper / sqrt2)))
    out = sqrt2 * erfinv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf))).astype(np.float32)


def flax_param_key(seed: int, path, count: int = 1) -> np.ndarray:
    """The key flax hands the ``count``-th parameter a module at ``path``
    (its scope names from the root) creates, under ``init`` with
    ``jax.random.PRNGKey(seed)``: the first 4 bytes of the SHA-1 of the
    names and the count, folded into the seed's key."""
    m = hashlib.sha1()
    for name in (*path, count):
        if isinstance(name, str):
            m.update(name.encode("utf-8"))
        else:
            m.update(name.to_bytes((name.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(prng_key(seed), int.from_bytes(m.digest()[:4], byteorder="big"))
