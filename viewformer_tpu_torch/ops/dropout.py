"""Dropout from an integer hash (port of viewformer_tpu/ops/dropout.py).

The noise of an element is an xxhash-style mix of two uint32 seed words and
the element's index, so it is a pure function of (seed words, index): the
same words give the same mask on the CPU and on the card, in the forward and
in a remat recompute. The JAX package derives the words from a PRNG key
(`_key_words`); the port takes the two words directly.

`hash_dropout` is the residual, MLP and embedding dropout of MIGT
(`dropout_impl='hash'`), which MIGT runs as the op `viewformer::hash_dropout`
(`placed_hash_dropout`): on a CPU tensor this plain version, on a CUDA
tensor one pass of the kernel csrc/hash_dropout_sm90.cu
(attention_cuda.hash_dropout_kernel), whose backward is the same pass over the
output gradient, so no mask or input is saved. The attention kernels
(csrc/attention_tile.cuh) regenerate the same hash over their weight
indices; `hash_keep` is that mask's plain form. Every kernel takes the hash
from csrc/dropout_hash.cuh.

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


def hash_uniform(words, shape, device=None, index=None):
    """Uniform [0, 1) f32 of `shape`, element i (row-major) from hash(i),
    or from hash(index[i]) where `index` (an int64 tensor of `shape`,
    frame_slice_index) is given."""
    if index is None:
        index = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return _uniform(words, index).reshape(shape)


def frame_slice_index(shape, batch0, frame0, frames, device=None):
    """The row-major element indices, in a global array [rows, frames, ...]
    of the trailing dimensions of `shape`, of the block [batch0 : batch0 +
    shape[0], frame0 : frame0 + shape[1]]: ((b * frames + t) * L + l) * d + c
    for an element (b, t, l, c) of the block. A rank hashes these for its
    rows (the `data` axis) and frames (the `seq` axis), as XLA hashes the
    global arrays' indices under the JAX package's mesh; a slice of the
    frames gives strided indices, not one run."""
    B, T = shape[:2]
    inner = math.prod(shape[2:])
    rows = torch.arange(batch0, batch0 + B, dtype=torch.int64, device=device) * frames
    t = torch.arange(frame0, frame0 + T, dtype=torch.int64, device=device)
    starts = (rows[:, None] + t[None, :]) * inner
    index = starts[..., None] + torch.arange(inner, dtype=torch.int64, device=device)
    return index.reshape(shape)


def hash_dropout(words, x, rate, index=None):
    """Inverted dropout of x: an element is kept iff its uniform is >= rate
    (compared in f32) and kept elements are x / (1 - rate), divided in x's
    dtype; identity when rate <= 0. index: the indices of x's elements in
    the global array x is a slice of (frame_slice_index); None: x is the
    whole array."""
    if rate <= 0.0:
        return x
    keep = hash_uniform(words, tuple(x.shape), x.device, index) >= float(np.float32(rate))
    divisor = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, torch.zeros((), dtype=x.dtype, device=x.device))


def plain_placed_hash_dropout(x: torch.Tensor, s0: int, s1: int, rate: float, batch0: int,
                              frame0: int, frames: int) -> torch.Tensor:
    """hash_dropout of x [B, T, ...] with the seed words (s0, s1) at the
    indices frame_slice_index(x.shape, batch0, frame0, frames); rate in
    (0, 1). The CPU implementation of the op viewformer::hash_dropout
    (placed_hash_dropout), whose CUDA implementation is the kernel."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f'hash_dropout: dropout rate must be in (0, 1), got {rate}')
    return hash_dropout((s0, s1), x, rate, frame_slice_index(tuple(x.shape), batch0, frame0,
                                                             frames, x.device))


# The op MIGT's sites run: plain_placed_hash_dropout on a CPU tensor, the
# kernel (attention_cuda.hash_dropout_kernel) on a CUDA tensor. Its backward
# runs the same op on the output gradient and saves no tensor, so a remat
# recompute, which no policy saves it from, regenerates the mask.
placed_hash_dropout = torch.library.custom_op('viewformer::hash_dropout',
                                              plain_placed_hash_dropout, mutates_args=(),
                                              device_types='cpu')


@placed_hash_dropout.register_kernel('cuda')
def _placed_hash_dropout_cuda(x, s0, s1, rate, batch0, frame0, frames):
    from .attention_cuda import hash_dropout_kernel

    return hash_dropout_kernel(x, (s0, s1), rate, batch0, frame0, frames)


def _placed_setup(ctx, inputs, output):
    ctx.placement = inputs[1:]


def _placed_backward(ctx, grad):
    return (placed_hash_dropout(grad.contiguous(), *ctx.placement),) + (None,) * 6


placed_hash_dropout.register_autograd(_placed_backward, setup_context=_placed_setup)


def hash_keep(words, idx, rate):
    """The attention kernels' scaled keep factor of each weight index: f32
    1/(1 - rate) (computed in double, rounded to f32) where the index's
    uniform is >= rate, else 0 (_hash_keep, attention_pallas.py:296)."""
    scale = float(np.float32(1.0 / (1.0 - rate)))
    keep = _uniform(words, idx) >= float(np.float32(rate))
    return keep.to(torch.float32) * scale


def fold_rank(words, rank):
    """The attention kernels' seed words of shard `rank`: each word hashed
    with the shard index (hash_bits keyed by the words, at indices 2 * rank
    and 2 * rank + 1), so that shards draw distinct masks over their local
    (batch, head) rows. The shard index is JAX's linear (data, model)
    index, data_idx * M + model_idx (viewformer_tpu/ops/branching_attention.
    _shard_index); `seq` ranks compute the same attention and are not
    folded. The counterpart of the JAX package's jax.random.fold_in of that
    index, not bit-equal to it; used only with more than one (data, model)
    shard."""
    idx = torch.tensor([2 * rank, 2 * rank + 1], dtype=torch.int64)
    return tuple(int(w) for w in hash_bits(words, idx))
