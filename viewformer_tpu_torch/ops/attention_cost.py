"""The work of each attention kernel (B1-B8) and of the fused hash dropout
from their shapes, and the least time an H100 could take for it.

Counted as a roofline counts it: each input read once and each output
written once, whatever a kernel reads again; only the frames the mask lets a
query see (masked frames are skipped, not computed, and a stream-0 frame no
query sees is not read); the tensor-core products only (the softmax, the
dropout hash and the rest are not counted). A (query frame, key frame) pair
costs 2 products of 2*L*L*dh operations forward (S = Q K^T, O = P V) and 5
backward (S again, dP = dO V^T, dQ, dK, dV). The dropout kernels B5-B8 do the
same products as B1-B4.
"""

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core operations and HBM3
# bytes a second, at the card's full power limit of 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# 32-bit operations outside the tensor cores (the data sheet's float32 rate)
PEAK_F32_OPS = 67e12
# the fused hash dropout's operations an element: the hash's first step and
# its 9 mixing steps, the keep test (shift, compare), the f32 division and
# the select
HASH_DROPOUT_OPS = 14

_PRODUCTS = {False: 2, True: 5}  # forward, backward


def block_causal_cost(bh, frames, L, dh, backward=False, lse=False):
    """(FLOPs, bytes) of B1 (B5) forward, or with backward B3 (B6), over
    q/k/v [bh, frames*L, dh] in bf16; lse: the forward writes the f32
    log-sum-exp (the backward always reads it)."""
    pairs = bh * frames * (frames + 1) // 2
    flops = pairs * _PRODUCTS[backward] * 2 * L * L * dh
    tile = bh * frames * L * dh * 2  # one bf16 operand
    if backward:  # q, k, v, out, dout, lse in; dq, dk, dv out
        nbytes = 8 * tile + bh * frames * L * 4
    else:  # q, k, v in; out (and lse) out
        nbytes = 4 * tile + (bh * frames * L * 4 if lse else 0)
    return flops, nbytes


def branch_cost(g, q_frames, bh0, old_frames, L, dh, first_q_frame, n_old, backward=False,
                lse=False):
    """(FLOPs, bytes) of B2 (B7) forward, or with backward B4 (B8): q/kb/vb
    [g, q_frames*L, dh], k0/v0 [bh0, old_frames*L, dh] in bf16; query frame
    tq sees the stream-0 frames below min(first_q_frame + tq, n_old) and its
    own frame. The backward writes dk0/dv0 whole."""
    seen = [min(first_q_frame + tq, n_old) for tq in range(q_frames)]
    flops = g * sum(n + 1 for n in seen) * _PRODUCTS[backward] * 2 * L * L * dh
    tile = g * q_frames * L * dh * 2
    stream0 = bh0 * min(max(seen), old_frames) * L * dh * 2  # k0 or v0, the frames seen
    rows_f32 = g * q_frames * L * 4
    if backward:  # q, kb, vb, out, dout, k0, v0, lse in; dq, dkb, dvb, dk0, dv0 out
        nbytes = 8 * tile + 2 * stream0 + rows_f32 + 2 * bh0 * old_frames * L * dh * 2
    else:  # q, kb, vb, k0, v0 in; out (and lse) out
        nbytes = 4 * tile + 2 * stream0 + (rows_f32 if lse else 0)
    return flops, nbytes


def bound_ms(flops, nbytes):
    """(ms, 'operations' or 'bytes'): the larger of the two least times."""
    compute_ms = flops / PEAK_BF16_FLOPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (compute_ms, 'operations') if compute_ms >= memory_ms else (memory_ms, 'bytes')


def hash_dropout_bound_ms(numel, itemsize):
    """(operations, bytes, ms, 'operations' or 'bytes') of one pass of the
    fused hash dropout over numel elements of itemsize bytes: each element
    read once and written once, HASH_DROPOUT_OPS 32-bit operations at
    PEAK_F32_OPS."""
    ops, nbytes = HASH_DROPOUT_OPS * numel, 2 * itemsize * numel
    compute_ms = ops / PEAK_F32_OPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = (compute_ms, 'operations') if compute_ms >= memory_ms else (memory_ms, 'bytes')
    return (ops, nbytes) + bound
