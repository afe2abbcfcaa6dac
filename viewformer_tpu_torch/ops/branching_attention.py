"""Branching ("multi-end") block attention over [B, H, T, L, dh] streams.

Port of viewformer_tpu/ops/branching_attention.py. Stream 0 is block-causal:
a token of frame t attends every token of frames <= t. A side stream's token
of frame t attends stream-0 tokens of frames < t plus the L tokens of its own
frame in its own stream, under one joint softmax. No 1/sqrt(dh) scale (the
reference's checkpoints are trained without it).

`block_causal_attention` and `branch_attention` are the plain versions at the
model's layout; `multi_end_block_attention` is the dispatch the model calls,
which runs the CUDA kernels on the card (ops/attention_cuda.py). Where a
gradient is wanted it goes through the autograd Functions BlockCausalAttention
and BranchAttention: forward kernels B1/B2 with the row log-sum-exp, backward
kernels B3/B4. With attention dropout, BlockCausalAttentionDropout and
BranchAttentionDropout: kernels B5/B7 forward and B6/B8 backward, which hash
the dropout mask from two uint32 seed words and the weights' indices in both
directions, so nothing but the seeds is kept for the backward.
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


class BlockCausalAttention(torch.autograd.Function):
    """Stream-0 attention with its backward: q/k/v [BH, T*L, dh] ->
    [BH, T*L, dh]. Forward kernel B1 (with the row log-sum-exp), backward
    kernel B3; the plain twins on CPU tensors. Counterpart of
    fused_block_causal_attention (attention_pallas.py:565-591). Saves the
    inputs, the output and the log-sum-exp; no score tensor."""

    @staticmethod
    def forward(ctx, q, k, v, L):
        out, lse = attention_cuda.block_causal_attention_fwd(q, k, v, L, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.L = L
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = attention_cuda.block_causal_attention_bwd(q, k, v, out, dout.contiguous(),
                                                          lse, ctx.L)
        return grads + (None,)


class BranchAttention(torch.autograd.Function):
    """One-shot side-stream attention with its backward: q/kb/vb
    [S*BH, T*L, dh], k0/v0 [BH, T*L, dh] shared by the S branches (branch g
    reads row g % BH, no broadcast copy) -> [S*BH, T*L, dh]. Forward kernel
    B2 (first_q_frame=0, n_old=T, with the row log-sum-exp), backward kernel
    B4, which returns dk0/dv0 already summed over the branches. Counterpart
    of fused_branch_attention (attention_pallas.py:594-636)."""

    @staticmethod
    def forward(ctx, q, k0, v0, kb, vb, L):
        T = q.shape[1] // L
        out, lse = attention_cuda.branch_attention_fwd(q, k0, v0, kb, vb, L, 0, T,
                                                       return_lse=True)
        ctx.save_for_backward(q, k0, v0, kb, vb, out, lse)
        ctx.L = L
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k0, v0, kb, vb, out, lse = ctx.saved_tensors
        grads = attention_cuda.branch_attention_bwd(q, k0, v0, kb, vb, out,
                                                    dout.contiguous(), lse, ctx.L)
        return grads + (None,)


class BlockCausalAttentionDropout(torch.autograd.Function):
    """BlockCausalAttention with inverted dropout on the softmax weights:
    forward kernel B5, backward kernel B6; seeds (two uint32 words) and rate
    are plain arguments kept on ctx, and the backward regenerates the mask
    from them. Counterpart of fused_block_causal_attention_dropout
    (attention_pallas.py:645-671)."""

    @staticmethod
    def forward(ctx, q, k, v, L, seeds, rate):
        out, lse = attention_cuda.block_causal_attention_dropout_fwd(q, k, v, L, seeds, rate,
                                                                     return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.L, ctx.seeds, ctx.rate = L, seeds, rate
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = attention_cuda.block_causal_attention_dropout_bwd(
            q, k, v, out, dout.contiguous(), lse, ctx.L, ctx.seeds, ctx.rate)
        return grads + (None, None, None)


class BranchAttentionDropout(torch.autograd.Function):
    """BranchAttention with inverted dropout on the joint softmax weights:
    forward kernel B7, backward kernel B8 (dk0/dv0 summed over the branches).
    Counterpart of fused_branch_attention_dropout
    (attention_pallas.py:674-715)."""

    @staticmethod
    def forward(ctx, q, k0, v0, kb, vb, L, seeds, rate):
        out, lse = attention_cuda.branch_attention_dropout_fwd(q, k0, v0, kb, vb, L, seeds, rate,
                                                               return_lse=True)
        ctx.save_for_backward(q, k0, v0, kb, vb, out, lse)
        ctx.L, ctx.seeds, ctx.rate = L, seeds, rate
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k0, v0, kb, vb, out, lse = ctx.saved_tensors
        grads = attention_cuda.branch_attention_dropout_bwd(
            q, k0, v0, kb, vb, out, dout.contiguous(), lse, ctx.L, ctx.seeds, ctx.rate)
        return grads + (None, None, None)


def multi_end_block_attention(kset, vset, qset, dropout_rate=0.0, seeds=None):
    """Full branching attention over a tuple of streams, stream 0 first, each
    [B, H, T, L, dh]. Returns a tuple of per-stream outputs.

    When autograd records (grad mode on and an operand requires grad), the
    streams go through the autograd Functions; otherwise through the forward
    kernels alone, with no log-sum-exp. dropout_rate > 0 drops attention
    weights with the hash mask of seeds = (stream-0 words, branch words),
    two pairs of uint32 words, as the JAX dispatch's rng0/rng1
    (branching_attention.py:306-308): kernels B5-B8. At rate 0 the seeds are
    not read and the streams take B1-B4."""
    B, H, T, L, dh = qset[0].shape
    r0 = lambda x: x.reshape(B * H, T * L, dh).contiguous()  # noqa: E731
    k0, v0 = r0(kset[0]), r0(vset[0])
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in qset + kset + vset)
    if dropout_rate > 0:
        if seeds is None:
            raise ValueError(f'attention dropout at rate {dropout_rate} needs seeds: '
                             '(stream-0 words, branch words)')
        s0, s1 = seeds
        if grad:
            causal = lambda q: BlockCausalAttentionDropout.apply(  # noqa: E731
                q, k0, v0, L, s0, dropout_rate)
            branch = lambda q, kb, vb: BranchAttentionDropout.apply(  # noqa: E731
                q, k0, v0, kb, vb, L, s1, dropout_rate)
        else:
            causal = lambda q: attention_cuda.block_causal_attention_dropout_fwd(  # noqa: E731
                q, k0, v0, L, s0, dropout_rate)
            branch = lambda q, kb, vb: attention_cuda.branch_attention_dropout_fwd(  # noqa: E731
                q, k0, v0, kb, vb, L, s1, dropout_rate)
    elif grad:
        causal = lambda q: BlockCausalAttention.apply(q, k0, v0, L)  # noqa: E731
        branch = lambda q, kb, vb: BranchAttention.apply(q, k0, v0, kb, vb, L)  # noqa: E731
    else:
        causal = lambda q: attention_cuda.block_causal_attention_fwd(q, k0, v0, L)  # noqa: E731
        branch = lambda q, kb, vb: attention_cuda.branch_attention_fwd(  # noqa: E731
            q, k0, v0, kb, vb, L, 0, T)
    outputs = (causal(r0(qset[0])).reshape(B, H, T, L, dh),)
    if len(qset) > 1:
        S = len(qset) - 1
        rb = lambda xs: torch.stack(xs, 0).reshape(S * B * H, T * L, dh)  # noqa: E731
        outs = branch(rb(qset[1:]), rb(kset[1:]), rb(vset[1:]))
        outputs = outputs + tuple(outs.reshape(S, B, H, T, L, dh).unbind(0))
    return outputs
