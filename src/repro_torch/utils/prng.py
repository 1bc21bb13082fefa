"""JAX's threefry2x32 random numbers in numpy, for the serving engine's
sampler.

The reference engine samples a token at temperature > 0 with
``jax.random.categorical(fold_in(fold_in(PRNGKey(seed), rid), n), row / T)``.
This module computes the same numbers without JAX, so that the port's
engine draws the reference's tokens:

* ``prng_key(seed)`` is ``PRNGKey(seed)`` with 64-bit ints off (the
  reference's setting): the key is ``(0, seed mod 2**32)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``random_bits(key, shape)`` hashes the 64-bit iota of ``shape`` split
  into its high and low 32 bits and returns ``bits1 ^ bits2``, the
  layout of ``jax_threefry_partitionable = True`` (JAX's default);
* ``uniform`` keeps 23 random mantissa bits under the exponent of 1.0;
* ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` in float32 (JAX's
  ``mode="low"``) and ``categorical`` the Gumbel-max ``argmax(logits +
  gumbel)``;
* ``normal`` is ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))``, with
  XLA's float32 ``erf_inv`` polynomial (the synthetic data stream's
  frame and patch stubs).

Keys, bits and uniforms equal JAX's exactly.  ``erf_inv`` evaluates
XLA's polynomial with each multiply-add rounded once, as XLA fuses it,
and ``log1p`` rounded once from float64, where XLA's float32 ``log1p``
is up to two ulps off; so a normal value may differ from JAX's by a few
float32 ulps (tests/test_torch_train.py measures the bound).  Each ``log`` is rounded
once from float64, and XLA's float32 ``log`` may differ from that by an
ulp, so a Gumbel value may differ from JAX's by up to two float32 ulps
of ``max(|g|, 1)`` (one from each log); a draw can differ only where two
entries of ``logits + gumbel`` tie to within that.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_TINY = np.finfo(np.float32).tiny


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    ``(x0, x1)`` under ``key`` (2,) uint32, elementwise."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.array(x0, np.uint32) + ks[0], np.array(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit ints off: the seed is
    taken as an int32 and the key is ``(0, seed mod 2**32)``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the key's hash of the pair (0, data)."""
    o0, o1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([o0, o1])


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape``: the hash of each
    element's flat index (high and low 32 bits) as ``bits1 ^ bits2``."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 uniforms in [minval, maxval), as ``jax.random.uniform``:
    the top 23 bits as the mantissa of a float in [1, 2), less 1, scaled
    and shifted with one rounding (XLA fuses the two into a multiply-add;
    the float32 product is exact in float64), and clamped below at
    ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def _log32(x: np.ndarray) -> np.ndarray:
    """float32 ``log``, evaluated in float64 and rounded once."""
    return np.log(x.astype(np.float64)).astype(np.float32)


def gumbel(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """float32 standard Gumbel values, ``jax.random.gumbel``'s "low"
    mode."""
    return -_log32(-_log32(uniform(key, shape, _TINY, 1.0)))


def categorical(key: np.ndarray, logits: np.ndarray) -> int:
    """One draw from the categorical distribution of the float32
    ``logits`` (1-D), ``jax.random.categorical``'s Gumbel-max."""
    logits = np.asarray(logits, np.float32)
    return int(np.argmax(gumbel(key, logits.shape) + logits))


# XLA's float32 erf_inv (Giles' approximation): coefficients for
# w = -log1p(-x^2) < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, XLA's polynomial: each step
    ``c + p * w`` rounded once (a fused multiply-add)."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(lo), np.float32(hi)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """float32 standard normals, ``jax.random.normal``: ``sqrt(2) *
    erf_inv(u)`` of uniforms in ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, float(lo), 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)
