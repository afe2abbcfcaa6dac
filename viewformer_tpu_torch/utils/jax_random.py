"""jax.random's numbers without jax: the threefry2x32 generator, its keys,
and the draws of flax's initialisers, in numpy.

Semantics are those of jax 0.9 with `jax_threefry_partitionable` on and
x64 off, and of flax 0.12's per-variable keys:

  prng_key(seed)          jax.random.PRNGKey(seed): [0, seed mod 2**32]
                          (a Python int seed is narrowed to 32 bits).
  split(key, num)         num keys; key i is threefry2x32(key, (0, i)).
                          Keys [..., 2] split each in one pass.
  fold_in(key, data)      threefry2x32(key, (0, data)), the pair as a key;
                          data an array folds each word into key in one
                          pass.
  random_bits(key, shape) 32-bit words: for flat index i (counter
                          hi = i >> 32, lo = i mod 2**32) the xor of the
                          two threefry2x32 words.
  uniform, truncated_normal, lecun_normal
                          jax.random.uniform / truncated_normal and
                          flax's lecun_normal() in f32.
  variable_key(rng, path, count)
                          the key flax's Scope.make_rng hands a variable:
                          SHA-1 over the scope path's names, then the
                          stream's counter in that scope as big-endian
                          bytes (no separator: flax_fix_rng_separator is
                          off by default), its first 4 bytes folded in
                          (scope_word: those 4 bytes).
  power(base, exponent)   jnp.float32(base) ** exponent in f32 as XLA
                          computes it on the CPU: glibc's powf.

Keys and bits are bit for bit jax's. Uniform draws are too: XLA fuses
floats * (max - min) + min into one multiply-add, rounded once, which this
module computes exactly in f64 and rounds to f32.
truncated_normal takes erf of the bounds and erfinv of the draw in f64
and rounds them to f32, where XLA approximates both in f32: the draws
agree within a few f32 ULPs (tests/test_torch_jax_init.py states the
bound). Large draws are made in chunks of _CHUNK values, so memory stays
at the output plus a few chunks.
"""
import concurrent.futures
import ctypes
import ctypes.util
import functools
import hashlib
import math
import os

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 18
# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123's rotations and key
    schedule) of the counter pairs (x0, x1) under key (k0, k1): one key,
    or keys [..., 2] that broadcast with the counters. x0 and x1 broadcast
    together; returns the two uint32 output words."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1, *ks = np.broadcast_arrays(np.asarray(x0, np.uint32), np.asarray(x1, np.uint32),
                                      *ks)
    shape = x0.shape
    ks = [k.reshape(-1) for k in ks]
    x0 = x0.reshape(-1) + ks[0]
    x1 = x1.reshape(-1) + ks[1]
    tmp = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=tmp)
            x1 >>= np.uint32(32 - r)
            x1 |= tmp
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0.reshape(shape), x1.reshape(shape)


def prng_key(seed):
    """jax.random.PRNGKey(seed) with x64 off: uint32 [0, seed mod 2**32]."""
    return np.array([0, int(seed) & MASK], np.uint32)


def split(key, num=2):
    """jax.random.split(key, num): [num, 2] uint32; keys [..., 2] give
    [..., num, 2], each key split as jax splits it."""
    key = np.asarray(key, np.uint32)[..., None, :]
    b0, b1 = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data):
    """jax.random.fold_in(key, data) for a 32-bit data word: [2] uint32;
    for an array of words, [..., 2], each word folded into key."""
    words = np.asarray(data, np.uint64) & np.uint64(MASK)
    b0, b1 = threefry2x32(key, np.zeros(words.shape, np.uint32), words.astype(np.uint32))
    return np.stack([b0, b1], axis=-1)


def _flat_bits(key, start, stop):
    """random_bits's words at flat indices [start, stop)."""
    index = np.arange(start, stop, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (index >> np.uint64(32)).astype(np.uint32),
                          (index & np.uint64(MASK)).astype(np.uint32))
    b0 ^= b1
    return b0


def random_bits(key, shape):
    """jax.random.bits(key, shape, uint32)."""
    shape = tuple(shape)
    return _flat_bits(key, 0, math.prod(shape)).reshape(shape)


def _chunked(key, shape, transform):
    """An f32 array of `shape` whose flat chunks are transform(bits), the
    chunks drawn on a pool of threads (numpy and torch release the GIL)."""
    shape = tuple(shape)
    out = np.empty(math.prod(shape), np.float32)

    def fill(start):
        stop = min(start + _CHUNK, out.size)
        out[start:stop] = transform(_flat_bits(key, start, stop))
    starts = range(0, out.size, _CHUNK)
    if len(starts) == 1:
        fill(0)
    else:
        list(_pool().map(fill, starts))
    return out.reshape(shape)


@functools.lru_cache(maxsize=1)
def _pool():
    return concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1))


def _uniform_from_bits(bits, minval, maxval):
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    # one rounding, as XLA's fused multiply-add on the CPU: the f64 product
    # and sum are exact for the ranges drawn here (|min|, |max| < 4)
    scaled = floats.astype(np.float64) * np.float64(maxval - minval) + np.float64(minval)
    return np.maximum(minval, scaled.astype(np.float32))


def uniform(key, shape, minval=0.0, maxval=1.0):
    """jax.random.uniform(key, shape, float32, minval, maxval): the 23 high
    bits as the mantissa of a float in [1, 2), minus 1, scaled, and kept at
    least minval."""
    minval, maxval = np.float32(minval), np.float32(maxval)
    return _chunked(key, shape, lambda bits: _uniform_from_bits(bits, minval, maxval))


def _erf32(x):
    return np.float32(math.erf(float(x)))


def truncated_normal(key, lower, upper, shape):
    """jax.random.truncated_normal(key, lower, upper, shape, float32): a
    uniform draw between erf(lower / sqrt 2) and erf(upper / sqrt 2),
    sqrt 2 * erfinv of it, clipped to the open interval (lower, upper)."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    a, b = _erf32(lower / sqrt2), _erf32(upper / sqrt2)
    low = np.nextafter(lower, np.float32(np.inf))
    high = np.nextafter(upper, np.float32(-np.inf))

    def transform(bits):
        u = _uniform_from_bits(bits, a, b)
        inv = torch.special.erfinv(torch.from_numpy(u.astype(np.float64))).numpy()
        return np.clip(sqrt2 * inv.astype(np.float32), low, high)

    return _chunked(key, shape, transform)


def lecun_normal(key, shape):
    """flax.linen.initializers.lecun_normal()(key, shape, float32):
    variance_scaling(1, 'fan_in', 'truncated_normal'), the input axis -2,
    the output axis -1, the rest the receptive field."""
    fan_in = shape[-2] * math.prod(shape[:-2])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(_TRUNCATED_STD)
    out = truncated_normal(key, -2.0, 2.0, shape)
    out *= stddev
    return out


def _foldable_bytes(item):
    if isinstance(item, str):
        return item.encode('utf-8')
    return item.to_bytes((item.bit_length() + 7) // 8, byteorder='big')


@functools.lru_cache(maxsize=4096)
def scope_word(path, count):
    """The 32-bit word that variable_key folds into the stream's root key
    for (path, count)."""
    digest = hashlib.sha1()
    for item in tuple(path) + (count,):
        digest.update(_foldable_bytes(item))
    return int.from_bytes(digest.digest()[:4], byteorder='big')


def variable_key(rng, path, count):
    """The key that flax's make_rng gives in the scope at `path` (a tuple
    of module names below the root) for the `count`-th draw of a stream
    whose root key is `rng`: a Conv's kernel is count 1, its bias 2."""
    return fold_in(rng, scope_word(tuple(path), count))


@functools.lru_cache(maxsize=1)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library('m') or 'libm.so.6')
    powf = libm.powf
    powf.restype = ctypes.c_float
    powf.argtypes = (ctypes.c_float, ctypes.c_float)
    return powf


def power(base, exponent):
    """jnp.float32(base) ** exponent (f32 [n]) as XLA computes it on the
    CPU, which calls glibc's powf (not correctly rounded: f64's pow rounded
    to f32 differs from it in ~3 of 5000 draws of the pose multiplier)."""
    powf = _powf()
    base = float(np.float32(base))
    return np.array([powf(base, float(e)) for e in np.asarray(exponent, np.float32).reshape(-1)],
                    np.float32).reshape(np.shape(exponent))
