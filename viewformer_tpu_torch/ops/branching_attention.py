"""Branching ("multi-end") block attention over [B, H, T, L, dh] streams.

Port of viewformer_tpu/ops/branching_attention.py. Stream 0 is block-causal:
a token of frame t attends every token of frames <= t. A side stream's token
of frame t attends stream-0 tokens of frames < t plus the L tokens of its own
frame in its own stream, under one joint softmax. No 1/sqrt(dh) scale (the
reference's checkpoints are trained without it).

`block_causal_attention` and `branch_attention` are the plain versions at the
model's layout; `multi_end_block_attention` is the dispatch the model calls,
which runs the CUDA kernels on the card (ops/attention_cuda.py).
"""
import torch

from . import attention_cuda


def block_causal_attention(q, k, v):
    """Stream-0 attention, plain. q/k/v: [B, H, T, L, dh] -> [B, H, T, L, dh]."""
    B, H, T, L, dh = q.shape
    r = lambda x: x.reshape(B * H, T * L, dh)  # noqa: E731
    return attention_cuda.block_causal_attention_plain(r(q), r(k), r(v), L).reshape(q.shape)


def branch_attention(q_branches, k0, v0, k_branches, v_branches):
    """Side-stream attention for all branches at once, plain.
    q/k/v_branches: [S, B, H, T, L, dh]; k0/v0: [B, H, T, L, dh]."""
    S, B, H, T, L, dh = q_branches.shape
    rb = lambda x: x.reshape(S * B * H, T * L, dh)  # noqa: E731
    r0 = lambda x: x.reshape(B * H, T * L, dh)  # noqa: E731
    out = attention_cuda.branch_attention_plain(
        rb(q_branches), r0(k0), r0(v0), rb(k_branches), rb(v_branches), L, 0, T)
    return out.reshape(q_branches.shape)


def multi_end_block_attention(kset, vset, qset):
    """Full branching attention over a tuple of streams, stream 0 first, each
    [B, H, T, L, dh]. Returns a tuple of per-stream outputs."""
    B, H, T, L, dh = qset[0].shape
    r0 = lambda x: x.reshape(B * H, T * L, dh).contiguous()  # noqa: E731
    k0, v0 = r0(kset[0]), r0(vset[0])
    outputs = (attention_cuda.block_causal_attention_fwd(r0(qset[0]), k0, v0, L)
               .reshape(B, H, T, L, dh),)
    if len(qset) > 1:
        S = len(qset) - 1
        rb = lambda xs: torch.stack(xs, 0).reshape(S * B * H, T * L, dh)  # noqa: E731
        outs = attention_cuda.branch_attention_fwd(
            rb(qset[1:]), k0, v0, rb(kset[1:]), rb(vset[1:]), L, 0, T)
        outputs = outputs + tuple(outs.reshape(S, B, H, T, L, dh).unbind(0))
    return outputs
