"""Dropout from an integer hash (port of viewformer_tpu/ops/dropout.py).

The noise of an element is an xxhash-style mix of two uint32 seed words and
the element's index, so it is a pure function of (seed words, index): the
same words give the same mask on the CPU and on the card, in the forward and
in a remat recompute. The JAX package derives the words from a PRNG key
(`_key_words`); the port takes the two words directly.

`hash_dropout` is the residual, MLP and embedding dropout of MIGT
(`dropout_impl='hash'`). The attention kernels (csrc/attention_tile.cuh)
regenerate the same hash over their weight indices; `hash_keep` is that
mask's plain form.

uint32 arithmetic runs in int64, masked to 32 bits after every add and
multiply (torch has no uint32 add or shift on the CPU). A product by a 32-bit
prime is taken as two products by its 16-bit halves, so that no
intermediate leaves int64.
"""
import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PRIME1 = 2654435761
_PRIME2 = 2246822519
_PRIME3 = 3266489917


def _mul32(h, prime):
    """h * prime mod 2^32 for int64 h in [0, 2^32): products stay below 2^49."""
    return (h * (prime & 0xFFFF) + (((h * (prime >> 16)) & 0xFFFF) << 16)) & _M32


def hash_bits(words, idx):
    """The 32-bit hash of each index: idx an int64 tensor (taken mod 2^32),
    words the two uint32 seed words. Returns int64 in [0, 2^32)."""
    k0, k1 = (int(w) & _M32 for w in words)
    h = (_mul32(idx & _M32, _PRIME1) + k0) & _M32
    h ^= h >> 15
    h = _mul32(h, _PRIME2)
    h ^= (h >> 13) ^ k1
    h = _mul32(h, _PRIME3)
    return h ^ (h >> 16)


def _uniform(words, idx):
    """f32 in [0, 1) from the top 24 bits of the hash, exact in f32."""
    return (hash_bits(words, idx) >> 8).to(torch.float32) / float(1 << 24)


def hash_uniform(words, shape, device=None):
    """Uniform [0, 1) f32 of `shape`, element i (row-major) from hash(i)."""
    n = math.prod(shape)
    return _uniform(words, torch.arange(n, dtype=torch.int64, device=device)).reshape(shape)


def hash_dropout(words, x, rate):
    """Inverted dropout of x: an element is kept iff its uniform is >= rate
    (compared in f32) and kept elements are x / (1 - rate), divided in x's
    dtype; identity when rate <= 0."""
    if rate <= 0.0:
        return x
    keep = hash_uniform(words, tuple(x.shape), x.device) >= float(np.float32(rate))
    divisor = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, torch.zeros((), dtype=x.dtype, device=x.device))


def hash_keep(words, idx, rate):
    """The attention kernels' scaled keep factor of each weight index: f32
    1/(1 - rate) (computed in double, rounded to f32) where the index's
    uniform is >= rate, else 0 (_hash_keep, attention_pallas.py:296)."""
    scale = float(np.float32(1.0 / (1.0 - rate)))
    keep = _uniform(words, idx) >= float(np.float32(rate))
    return keep.to(torch.float32) * scale
