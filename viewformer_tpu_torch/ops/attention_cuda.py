"""Branching attention: hand-written CUDA kernels and their plain twins.

Counterpart of viewformer_tpu/ops/attention_pallas.py, each kernel in the
csrc/ source named beside it:

  block_causal_attention_fwd  replaces _block_causal_kernel3 (kernel B1;
                              attention_fwd_sm90.cu)
  branch_attention_fwd        replaces _branch_kernel3 (kernel B2), and the
                              dense _attend_cache of migt_incremental
                              (attention_fwd_sm90.cu)
  block_causal_attention_bwd  replaces _block_causal_bwd_kernel3 (kernel B3;
                              attention_bwd_sm90.cu)
  branch_attention_bwd        replaces _branch_bwd_kernel3 and the sum over
                              branches of _fb_bwd (kernel B4;
                              attention_bwd_sm90.cu)
  block_causal_attention_dropout_fwd  replaces _block_causal_do_kernel3 (B5;
                                      attention_fwd_sm90.cu)
  block_causal_attention_dropout_bwd  replaces _block_causal_do_bwd_kernel3
                                      (B6; attention_bwd_sm90.cu)
  branch_attention_dropout_fwd        replaces _branch_do_kernel3 (B7;
                                      attention_fwd_sm90.cu)
  branch_attention_dropout_bwd        replaces _branch_do_bwd_kernel3 and the
                                      sum over branches of _fbd_bwd (B8;
                                      attention_bwd_sm90.cu)

and, beside them, the one elementwise kernel of the port:

  hash_dropout_kernel                 the residual, MLP and embedding hash
                                      dropout, which the JAX package's
                                      hash_dropout (ops/dropout.py) leaves to
                                      XLA's fusion (hash_dropout_sm90.cu)

The attention kernels are built for Hopper, as two templates: the forward
kernels B1, B2, B5 and B7 (attention_fwd_sm90.cu) and the backward kernels
B3, B4, B6 and B8 (attention_bwd_sm90.cu). A producer warp feeds 64 x 64 bf16 frame
tiles by TMA through an mbarrier ring to consumer warpgroups that multiply
with wgmma and keep the softmax (and its gradient) on their accumulator
registers. The tensor cores bound B1-B4 at the training shapes, and the
dropout hash adds integer work to B5-B8; each source's note says what its
design does about that.

B5-B8 are B1-B4 with inverted dropout on the softmax weights, the mask
hashed from two uint32 seed words and each weight's global index
(ops/dropout.py; the index spaces are the Pallas kernels', see
bc_weight_index and branch_weight_indices), so the masks are the Pallas
kernels' bit for bit. The dropout kernels take the one-shot form only. The
hash itself is csrc/dropout_hash.cuh, which the attention kernels and
hash_dropout_sm90.cu both include.

Operands keep the Pallas layout, [batch*heads, frames*L, dh]. No 1/sqrt(dh)
scale, f32 scores and softmax, weights rounded to the value dtype before the
product with V (the reference's conventions). The forward kernels can also
return each query row's f32 log-sum-exp, which the backward kernels
recompute the softmax weights from. The backward kernels also take each
query row's D = rowsum(dO * O) (attention_bwd_delta_plain), which their C
entry computes in a first pass into scratch the wrapper allocates.

Each public function dispatches on where its tensors lie: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel (built from
csrc/*.cu on first use) or raises. There is no fallback from the kernel to
the plain version. Each wrapper counts its kernel launches in its
``launches`` attribute; with VIEWFORMER_LAUNCH_COUNTS=FILE in the
environment a process appends them to FILE when it exits.
"""
import atexit
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import dropout
from .dropout import hash_keep

_NEG_INF = -1e9
_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'csrc')
_BUILD_DIR = os.path.join(_CSRC_DIR, 'build')
# each source is one shared library; the headers are compiled into them
_SOURCES = ('attention_fwd_sm90.cu', 'attention_bwd_sm90.cu', 'hash_dropout_sm90.cu')
_TILE = 64  # frame length L and head width dh the kernels are compiled for
_functions = None
# weights a plain dropout twin holds at a time (f32 scores, int64 indices):
# it runs over chunks of rows, to bound memory at the training shapes
_CHUNK_WEIGHTS = 1 << 26


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the reference the kernels are held against)
# ---------------------------------------------------------------------------

def _wide(x):
    """x in at least f32: scores and softmax are f32 for bf16 operands, and
    a float64 input (gradcheck) stays float64."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _round(x, dtype):
    """x rounded to dtype and kept in its own (wide) dtype: the reference
    rounds dS and W to the operand dtype before a product with f32
    accumulation."""
    return x.to(dtype).to(x.dtype)


def block_causal_attention_plain(q, k, v, L, return_lse=False):
    """q/k/v [BH, T*L, dh] -> [BH, T*L, dh]; a query in frame t attends every
    key of frames <= t. With return_lse, also each row's log-sum-exp of its
    scores, [BH, T*L] in f32 (or wider)."""
    TL = q.shape[1]
    frames = torch.arange(TL, device=q.device) // L
    allowed = frames[:, None] >= frames[None, :]
    scores = torch.einsum('bqd,bkd->bqk', _wide(q), _wide(k))
    scores = scores.masked_fill(~allowed, _NEG_INF)
    weights = torch.softmax(scores, -1)
    out = torch.einsum('bqk,bkd->bqd', weights.to(v.dtype), v).to(q.dtype)
    return (out, torch.logsumexp(scores, -1)) if return_lse else out


def branch_attention_plain(q, k0, v0, kb, vb, L, first_q_frame, n_old, return_lse=False):
    """q/kb/vb [G, TQ*L, dh]; k0/v0 [BH0, F0*L, dh], shared by the G/BH0
    branches (branch g reads row g % BH0). Query row r lies in frame
    first_q_frame + r // L; it attends the stream-0 frames below
    min(that frame, n_old) and the kb/vb rows of its own frame, under one
    joint softmax. With return_lse, also each row's log-sum-exp of its joint
    scores, [G, TQ*L]."""
    G, TQL, dh = q.shape
    BH0, F0L, _ = k0.shape
    TQ, S = TQL // L, G // BH0
    qf = _wide(q).reshape(S, BH0, TQ, L, dh)
    kbf = kb.reshape(S, BH0, TQ, L, dh)
    vbf = vb.reshape(S, BH0, TQ, L, dh)
    q_frame = first_q_frame + torch.arange(TQ, device=q.device)
    k_frame = torch.arange(F0L, device=q.device) // L
    allowed = k_frame[None, :] < torch.clamp(q_frame, max=n_old)[:, None]  # [TQ, F0L]
    scores_old = torch.einsum('sbtld,bkd->sbtlk', qf, _wide(k0))
    scores_old = scores_old.masked_fill(~allowed[:, None, :], _NEG_INF)
    scores_new = torch.einsum('sbtld,sbtmd->sbtlm', qf, _wide(kbf))
    joint = torch.cat([scores_old, scores_new], -1)
    weights = torch.softmax(joint, -1)
    out = torch.einsum('sbtlk,bkd->sbtld', weights[..., :F0L].to(v0.dtype), v0)
    out = out + torch.einsum('sbtlm,sbtmd->sbtld', weights[..., F0L:].to(vb.dtype), vbf)
    out = out.reshape(G, TQL, dh).to(q.dtype)
    return (out, torch.logsumexp(joint, -1).reshape(G, TQL)) if return_lse else out


def attention_bwd_delta_plain(out, dout):
    """D = rowsum(dout * out) in f32 (or wider), [BH, T*L]: the backward
    kernels' stand-in for the reference's rowsum(dP * W), equal to it up to
    the rounding of out, with or without dropout, as out is the dropped
    output (the D pass of B3/B6)."""
    return (_wide(dout) * _wide(out)).sum(-1)


def block_causal_attention_bwd_plain(q, k, v, dout, L):
    """(dq, dk, dv) of block_causal_attention_plain for the output gradient
    dout, as the reference's backward kernel computes them
    (attention_pallas.py:138-179): W recomputed in f32, dP = dO V^T,
    dS = W (dP - rowsum(dP W)), dS and W rounded to the operand dtype before
    dQ = dS K, dK = dS^T Q, dV = W^T dO, f32 accumulation."""
    TL = q.shape[1]
    frames = torch.arange(TL, device=q.device) // L
    allowed = frames[:, None] >= frames[None, :]
    qf, kf, vf, df = (_wide(x) for x in (q, k, v, dout))
    scores = torch.einsum('bqd,bkd->bqk', qf, kf).masked_fill_(~allowed, _NEG_INF)
    w = torch.softmax(scores, -1)
    del scores
    ds = torch.einsum('bqd,bkd->bqk', df, vf)
    ds = _round(ds.sub_((ds * w).sum(-1, keepdim=True)).mul_(w), k.dtype)
    dq = torch.einsum('bqk,bkd->bqd', ds, kf).to(q.dtype)
    dk = torch.einsum('bqk,bqd->bkd', ds, qf).to(k.dtype)
    del ds
    dv = torch.einsum('bqk,bqd->bkd', _round(w, dout.dtype), df).to(v.dtype)
    return dq, dk, dv


def branch_attention_bwd_plain(q, k0, v0, kb, vb, dout, L):
    """(dq, dk0, dv0, dkb, dvb) of the one-shot branch_attention_plain
    (first_q_frame=0, n_old=T) for the output gradient dout, as the
    reference's backward kernel computes them (attention_pallas.py:182-237):
    one rowsum over both key sets of the joint softmax. dk0/dv0 [BH0, T*L, dh]
    are summed over the S branches that share each row, in f32 before the
    cast (attention_pallas.py:630-631). One branch at a time, to bound the
    f32 temporaries."""
    G, TL, dh = q.shape
    BH0 = k0.shape[0]
    T, S = TL // L, G // BH0
    k_frame = torch.arange(TL, device=q.device) // L
    allowed = k_frame[None, :] < torch.arange(T, device=q.device)[:, None]  # [T, TL]
    k0f, v0f = _wide(k0), _wide(v0)
    dk0 = dv0 = 0
    grads = []
    for s in range(S):
        rows = slice(s * BH0, (s + 1) * BH0)
        qf, kbf, vbf, df = (_wide(x[rows]).reshape(BH0, T, L, dh) for x in (q, kb, vb, dout))
        w_old = torch.einsum('btld,bkd->btlk', qf, k0f).masked_fill_(~allowed[:, None], _NEG_INF)
        w_new = torch.einsum('btld,btmd->btlm', qf, kbf)
        lse = torch.logaddexp(w_old.logsumexp(-1), w_new.logsumexp(-1))[..., None]
        w_old.sub_(lse).exp_()
        w_new.sub_(lse).exp_()
        ds_old = torch.einsum('btld,bkd->btlk', df, v0f)
        ds_new = torch.einsum('btld,btmd->btlm', df, vbf)
        rowsum = (ds_old * w_old).sum(-1, keepdim=True) + (ds_new * w_new).sum(-1, keepdim=True)
        ds_old = _round(ds_old.sub_(rowsum).mul_(w_old), k0.dtype)
        ds_new = _round(ds_new.sub_(rowsum).mul_(w_new), kb.dtype)
        dq = torch.einsum('btlk,bkd->btld', ds_old, k0f) + \
            torch.einsum('btlm,btmd->btld', ds_new, kbf)
        dk0 = dk0 + torch.einsum('btlk,btld->bkd', ds_old, qf)
        del ds_old
        dv0 = dv0 + torch.einsum('btlk,btld->bkd', _round(w_old, dout.dtype), df)
        del w_old
        dkb = torch.einsum('btlm,btld->btmd', ds_new, qf)
        dvb = torch.einsum('btlm,btld->btmd', _round(w_new, dout.dtype), df)
        grads.append((dq, dkb, dvb))
    dq, dkb, dvb = (torch.cat([g[i].reshape(BH0, TL, dh) for g in grads]) for i in range(3))
    return (dq.to(q.dtype), dk0.to(k0.dtype), dv0.to(v0.dtype), dkb.to(kb.dtype),
            dvb.to(vb.dtype))


# ---------------------------------------------------------------------------
# Plain versions of the dropout kernels B5-B8
# ---------------------------------------------------------------------------

def pick_q_block(total, L):
    """The Pallas q-tile (_pick_q_block, attention_pallas.py:38): the largest
    multiple of L, at most 512, that divides total; None if there is none."""
    for n_frames in range(min(512, total) // L, 0, -1):
        if total % (n_frames * L) == 0:
            return n_frames * L
    return None


def bc_weight_index(rows, TL):
    """Global index of each weight of block-causal rows (int64 [n]),
    [n, TL, TL]: (row*TL + query)*TL + key (_bc_weight_index,
    attention_pallas.py:309). Taken mod 2^32 by the hash."""
    r = torch.arange(TL, device=rows.device)
    return (rows[:, None, None] * TL + r[:, None]) * TL + r


def branch_weight_indices(rows, TL, L):
    """Global indices of the weights of one-shot branch rows g (int64 [n])
    (_branch_weight_indices, attention_pallas.py:319): rows of stride
    TL + qb with qb = pick_q_block(TL, L). Stream-0 keys [n, TL, TL]:
    (g*TL + query)*(TL + qb) + key; own-frame keys [n, T, L, L]: the row base
    + TL + the key's position inside the query's q-tile."""
    qb = pick_q_block(TL, L)
    T = TL // L
    r = torch.arange(TL, device=rows.device)
    base = (rows[:, None] * TL + r) * (TL + qb)  # [n, TL]
    own = TL + (torch.arange(T, device=rows.device) * L) % qb  # [T]
    old = base[:, :, None] + r
    new = base.reshape(-1, T, L, 1) + own[:, None, None] + torch.arange(L, device=rows.device)
    return old, new


def _row_chunks(rows, weights_per_row):
    step = max(1, _CHUNK_WEIGHTS // weights_per_row)
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


def _arange(rows, device):
    return torch.arange(rows.start, rows.stop, device=device)


def block_causal_attention_dropout_plain(q, k, v, L, seeds, rate, return_lse=False):
    """block_causal_attention_plain with inverted dropout on the f32 softmax
    weights before their rounding to the value dtype
    (_block_causal_do_kernel3): W * keep, keep = hash_keep(seeds,
    bc_weight_index). The log-sum-exp is of the undropped scores."""
    BH, TL, _ = q.shape
    frames = torch.arange(TL, device=q.device) // L
    allowed = frames[:, None] >= frames[None, :]
    outs, lses = [], []
    for rows in _row_chunks(BH, TL * TL):
        scores = torch.einsum('bqd,bkd->bqk', _wide(q[rows]), _wide(k[rows]))
        scores = scores.masked_fill_(~allowed, _NEG_INF)
        keep = hash_keep(seeds, bc_weight_index(_arange(rows, q.device), TL), rate)
        w = torch.softmax(scores, -1).mul_(keep.to(scores.dtype))
        outs.append(torch.einsum('bqk,bkd->bqd', w.to(v.dtype), v[rows]).to(q.dtype))
        if return_lse:
            lses.append(torch.logsumexp(scores, -1))
    out = torch.cat(outs)
    return (out, torch.cat(lses)) if return_lse else out


def block_causal_attention_dropout_bwd_plain(q, k, v, dout, L, seeds, rate):
    """(dq, dk, dv) of block_causal_attention_dropout_plain, as
    _block_causal_do_bwd_kernel3 computes them: dP' = (dO V^T) * keep,
    dS = W (dP' - rowsum(dP' W)), dV = (W * keep)^T dO, dS and W * keep
    rounded to the operand dtype before the products."""
    BH, TL, _ = q.shape
    frames = torch.arange(TL, device=q.device) // L
    allowed = frames[:, None] >= frames[None, :]
    grads = []
    for rows in _row_chunks(BH, TL * TL):
        qf, kf, vf, df = (_wide(x[rows]) for x in (q, k, v, dout))
        w = torch.einsum('bqd,bkd->bqk', qf, kf).masked_fill_(~allowed, _NEG_INF).softmax(-1)
        keep = hash_keep(seeds, bc_weight_index(_arange(rows, q.device), TL), rate).to(w.dtype)
        ds = torch.einsum('bqd,bkd->bqk', df, vf).mul_(keep)
        ds = _round(ds.sub_((ds * w).sum(-1, keepdim=True)).mul_(w), k.dtype)
        dq = torch.einsum('bqk,bkd->bqd', ds, kf).to(q.dtype)
        dk = torch.einsum('bqk,bqd->bkd', ds, qf).to(k.dtype)
        del ds
        dv = torch.einsum('bqk,bqd->bkd', _round(w.mul_(keep), dout.dtype), df).to(v.dtype)
        grads.append((dq, dk, dv))
    return tuple(torch.cat([g[i] for g in grads]) for i in range(3))


def _branch_chunk_weights(q, k0, kb, L, rows, seeds, rate):
    """For one chunk of one-shot branch rows: the f32 joint softmax weights
    and keep factors over [stream-0 keys | own-frame keys], each
    [n, T, L, TL + L], and the chunk's rows of K0 (row g % BH0)."""
    G, TL, dh = q.shape
    T = TL // L
    g = _arange(rows, q.device)
    n = len(g)
    k0r = _wide(k0[g % k0.shape[0]])
    qf = _wide(q[rows]).reshape(n, T, L, dh)
    allowed = (torch.arange(TL, device=q.device) // L)[None, :] < \
        torch.arange(T, device=q.device)[:, None]  # [T, TL]
    scores_old = torch.einsum('btld,bkd->btlk', qf, k0r).masked_fill_(~allowed[:, None],
                                                                      _NEG_INF)
    scores_new = torch.einsum('btld,btmd->btlm', qf, _wide(kb[rows]).reshape(n, T, L, dh))
    joint = torch.cat([scores_old, scores_new], -1)
    del scores_old, scores_new
    idx_old, idx_new = branch_weight_indices(g, TL, L)
    keep = torch.cat([hash_keep(seeds, idx_old, rate).reshape(n, T, L, TL),
                      hash_keep(seeds, idx_new, rate)], -1).to(joint.dtype)
    return joint, keep, k0r


def branch_attention_dropout_plain(q, k0, v0, kb, vb, L, seeds, rate, return_lse=False):
    """The one-shot branch_attention_plain (first_q_frame=0, n_old=T) with
    inverted dropout on the f32 joint softmax weights before their rounding
    (_branch_do_kernel3): keep = hash_keep(seeds, branch_weight_indices).
    The log-sum-exp is of the undropped joint scores."""
    G, TL, dh = q.shape
    T = TL // L
    outs, lses = [], []
    for rows in _row_chunks(G, TL * (TL + L)):
        joint, keep, _ = _branch_chunk_weights(q, k0, kb, L, rows, seeds, rate)
        n = joint.shape[0]
        w = torch.softmax(joint, -1).mul_(keep)
        v0r = v0[_arange(rows, q.device) % v0.shape[0]]
        out = torch.einsum('btlk,bkd->btld', w[..., :TL].to(v0.dtype), v0r)
        out = out + torch.einsum('btlm,btmd->btld', w[..., TL:].to(vb.dtype),
                                 vb[rows].reshape(n, T, L, dh))
        outs.append(out.reshape(n, TL, dh).to(q.dtype))
        if return_lse:
            lses.append(torch.logsumexp(joint, -1).reshape(n, TL))
    out = torch.cat(outs)
    return (out, torch.cat(lses)) if return_lse else out


def branch_attention_dropout_bwd_plain(q, k0, v0, kb, vb, dout, L, seeds, rate):
    """(dq, dk0, dv0, dkb, dvb) of branch_attention_dropout_plain, as
    _branch_do_bwd_kernel3 computes them (one rowsum over both key sets of
    the joint softmax, dP' = (dO V^T) * keep, dV = (W * keep)^T dO), with
    dk0/dv0 summed over the branches that share each row in f32 before the
    cast (_fbd_bwd, attention_pallas.py:708-709)."""
    G, TL, dh = q.shape
    BH0 = k0.shape[0]
    T = TL // L
    dk0 = torch.zeros(k0.shape, dtype=_wide(k0).dtype, device=q.device)
    dv0 = torch.zeros_like(dk0)
    grads = []
    for rows in _row_chunks(G, TL * (TL + L)):
        joint, keep, k0r = _branch_chunk_weights(q, k0, kb, L, rows, seeds, rate)
        n = joint.shape[0]
        shared = _arange(rows, q.device) % BH0
        w = torch.softmax(joint, -1)
        del joint
        qf, kbf, vbf, df = (_wide(x[rows]).reshape(n, T, L, dh) for x in (q, kb, vb, dout))
        ds = torch.cat([torch.einsum('btld,bkd->btlk', df, _wide(v0[shared])),
                        torch.einsum('btld,btmd->btlm', df, vbf)], -1).mul_(keep)
        ds = ds.sub_((ds * w).sum(-1, keepdim=True)).mul_(w)
        ds_old, ds_new = _round(ds[..., :TL], k0.dtype), _round(ds[..., TL:], kb.dtype)
        del ds
        wk = w.mul_(keep)
        w_old, w_new = _round(wk[..., :TL], dout.dtype), _round(wk[..., TL:], dout.dtype)
        dq = torch.einsum('btlk,bkd->btld', ds_old, k0r) + \
            torch.einsum('btlm,btmd->btld', ds_new, kbf)
        dk0.index_add_(0, shared, torch.einsum('btlk,btld->bkd', ds_old, qf))
        dv0.index_add_(0, shared, torch.einsum('btlk,btld->bkd', w_old, df))
        dkb = torch.einsum('btlm,btld->btmd', ds_new, qf)
        dvb = torch.einsum('btlm,btld->btmd', w_new, df)
        grads.append(tuple(x.reshape(n, TL, dh) for x in (dq, dkb, dvb)))
    dq, dkb, dvb = (torch.cat([g[i] for g in grads]) for i in range(3))
    return (dq.to(q.dtype), dk0.to(k0.dtype), dv0.to(v0.dtype), dkb.to(kb.dtype),
            dvb.to(vb.dtype))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found on PATH or under CUDA_HOME; the CUDA '
                           'toolkit is needed to build the attention kernels')
    return path


def _digest():
    """Hash of every source and header under csrc/: an edit to any of them
    rebuilds every library."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_CSRC_DIR)):
        if name.endswith(('.cu', '.cuh')):
            h.update(name.encode())
            with open(os.path.join(_CSRC_DIR, name), 'rb') as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile each csrc source into its own shared library for sm_90a, one
    nvcc for each, all started together; once per hash of the sources.
    Returns {source: library path}. The ptxas report (registers, shared
    memory, spills) of each build is kept beside it, in a .log file."""
    digest = _digest()
    libs = {src: os.path.join(_BUILD_DIR, f'lib{src[:-3]}-{digest}.so') for src in _SOURCES}
    todo = [src for src in _SOURCES if not os.path.exists(libs[src])]
    if not todo:
        return libs
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc, jobs = _nvcc(), []
    for src in todo:
        tmp = f'{libs[src]}.{os.getpid()}.tmp'
        log = open(libs[src][:-3] + '.log', 'w')
        cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', tmp,
               os.path.join(_CSRC_DIR, src)]
        jobs.append((src, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in jobs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            with open(log.name) as f:
                failed.append(f'{src}: nvcc exited {proc.returncode}\n{f.read()}')
        else:
            os.replace(tmp, libs[src])
    if failed:
        raise RuntimeError('\n'.join(failed))
    return libs


def build_log():
    """The ptxas reports of the built libraries."""
    text = []
    for src, path in build().items():
        with open(path[:-3] + '.log') as f:
            text.append(f'{src}:\n{f.read()}')
    return '\n'.join(text)


_P, _I = ctypes.c_void_p, ctypes.c_int
_DROP = [ctypes.c_uint32] * 2 + [ctypes.c_float] * 2  # seed words, rate, scale
# the argument types of each C entry point of csrc/*.cu (each returns int);
# the stream is the last pointer
_SIGNATURES = {
    'block_causal_attention_fwd': [_P] * 5 + [_I] * 2 + [_P],
    'branch_attention_fwd': [_P] * 7 + [_I] * 6 + [_P],
    'block_causal_attention_bwd': [_P] * 10 + [_I] * 2 + [_P],
    'branch_attention_bwd': [_P] * 14 + [_I] * 3 + [_P],
    'block_causal_attention_dropout_fwd': [_P] * 5 + [_I] * 2 + _DROP + [_P],
    'branch_attention_dropout_fwd': [_P] * 7 + [_I] * 4 + _DROP + [_P],
    'block_causal_attention_dropout_bwd': [_P] * 10 + [_I] * 2 + _DROP + [_P],
    'branch_attention_dropout_bwd': [_P] * 14 + [_I] * 4 + _DROP + [_P],
    # x, out, bf16, n, frames of x, inner; batch0, frame0, frames, seed
    # words; rate, divisor
    'hash_dropout': [_P] * 2 + [_I] * 4 + [ctypes.c_uint32] * 5 + [ctypes.c_float] * 2 + [_P],
}


def _kernels():
    """The libraries' C entry points by name, bound once."""
    global _functions
    if _functions is None:
        libs = [ctypes.CDLL(path) for path in build().values()]
        functions = {}
        for name, argtypes in _SIGNATURES.items():
            fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
            fn.argtypes, fn.restype = argtypes, _I
            functions[name] = fn
        _functions = functions
    return _functions


def _check_operands(name, L, *tensors):
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f'{name}: operands on {t.device} and {device}')
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{name}: the kernel takes bfloat16, got {t.dtype}')
        if t.dim() != 3 or t.shape[2] != _TILE:
            raise ValueError(f'{name}: the kernel takes [BH, frames*{_TILE}, {_TILE}], '
                             f'got {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: operands must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: operands must be 16-byte aligned')
    if L != _TILE:
        raise ValueError(f'{name}: the kernel is built for L={_TILE}, got L={L}')


def _check_lse(name, lse, rows, device):
    if (lse.device != device or lse.dtype != torch.float32 or not lse.is_contiguous()
            or tuple(lse.shape) != tuple(rows) or lse.data_ptr() % 16):
        raise ValueError(f'{name}: lse must be contiguous 16-byte aligned f32 {tuple(rows)} on '
                         f'{device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}')


def _dropout_args(name, seeds, rate):
    """(s0, s1, rate, scale) for a dropout kernel: the seed words mod 2^32,
    and rate and 1/(1 - rate) (in double) rounded to f32, as _hash_keep."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f'{name}: dropout rate must be in (0, 1), got {rate}')
    s0, s1 = (int(w) & 0xFFFFFFFF for w in seeds)
    return s0, s1, float(np.float32(rate)), float(np.float32(1.0 / (1.0 - rate)))


def _check_one_shot_branch(name, q, k0, v0, kb, vb, L, *more):
    """The shape gate of the one-shot branch kernels B4, B7 and B8 (each a
    1-D grid): q, kb, vb and `more` [G, T*L, dh], k0/v0 [BH0, T*L, dh] with
    BH0 dividing G and fewer than 2^31 rows of G (the kernels' int32 row
    offsets). Returns (G, BH0, T*L)."""
    G, TL, _ = q.shape
    BH0 = k0.shape[0]
    if (any(t.shape != q.shape for t in (kb, vb) + more) or v0.shape != k0.shape
            or k0.shape[1] != TL or TL % L or G % BH0 or G * TL >= 1 << 31):
        raise ValueError(f'{name}: shapes q {tuple(q.shape)}, k0 {tuple(k0.shape)}, '
                         f'v0 {tuple(v0.shape)}, kb {tuple(kb.shape)}, vb {tuple(vb.shape)}, '
                         f'others {[tuple(t.shape) for t in more]}')
    return G, BH0, TL


def _launch(name, *args):
    err = _kernels()[name](*args)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_device(name, q):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raises for any other device."""
    if q.device.type == 'cpu':
        return False
    if q.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for {q.device}')
    return True


# ---------------------------------------------------------------------------
# Public dispatch
# ---------------------------------------------------------------------------

def block_causal_attention_fwd(q, k, v, L, return_lse=False):
    """Kernel B1: q/k/v [BH, T*L, dh] -> [BH, T*L, dh], and with return_lse
    also the f32 row log-sum-exp [BH, T*L] (see block_causal_attention_plain)."""
    if not _on_device('block_causal_attention_fwd', q):
        return block_causal_attention_plain(q, k, v, L, return_lse)
    _check_operands('block_causal_attention_fwd', L, q, k, v)
    BH, TL, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape or TL % L or BH > 65535:
        raise ValueError(f'block_causal_attention_fwd: shapes {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    out = torch.empty_like(q)
    lse = torch.empty((BH, TL), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch('block_causal_attention_fwd', q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), _ptr(lse), BH, TL // L, stream)
    block_causal_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def branch_attention_fwd(q, k0, v0, kb, vb, L, first_q_frame, n_old, return_lse=False):
    """Kernel B2: q/kb/vb [G, TQ*L, dh], k0/v0 [BH0, F0*L, dh] -> [G, TQ*L, dh],
    and with return_lse also the f32 row log-sum-exp [G, TQ*L] (see
    branch_attention_plain). first_q_frame and n_old are host ints.

    first_q_frame=0, n_old=T is the one-shot branch attention of
    _branch_kernel3; one query frame with first_q_frame=n_old=n over a cache
    layer viewed as [B*H, F*L, dh] is _attend_cache."""
    if not _on_device('branch_attention_fwd', q):
        return branch_attention_plain(q, k0, v0, kb, vb, L, first_q_frame, n_old, return_lse)
    _check_operands('branch_attention_fwd', L, q, k0, v0, kb, vb)
    G, TQL, _ = q.shape
    BH0, F0L, _ = k0.shape
    if (kb.shape != q.shape or vb.shape != q.shape or v0.shape != k0.shape
            or TQL % L or F0L % L or G % BH0 or G > 65535
            or not 0 <= n_old <= F0L // L or first_q_frame < 0):
        raise ValueError(
            f'branch_attention_fwd: shapes q {tuple(q.shape)}, k0 {tuple(k0.shape)}, '
            f'v0 {tuple(v0.shape)}, kb {tuple(kb.shape)}, vb {tuple(vb.shape)} with '
            f'first_q_frame={first_q_frame}, n_old={n_old}')
    out = torch.empty_like(q)
    lse = torch.empty((G, TQL), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch('branch_attention_fwd', q.data_ptr(), k0.data_ptr(), v0.data_ptr(),
                kb.data_ptr(), vb.data_ptr(), out.data_ptr(), _ptr(lse), G, TQL // L, BH0,
                F0L // L, int(first_q_frame), int(n_old), stream)
    branch_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def _block_causal_bwd(name, q, k, v, out, dout, lse, L, *drop):
    """Launch B3 (no drop) or B6 (drop = (s0, s1, rate, scale)): checks,
    D's scratch and the outputs; returns (dq, dk, dv)."""
    _check_operands(name, L, q, k, v, out, dout)
    BH, TL, _ = q.shape
    if any(t.shape != q.shape for t in (k, v, out, dout)) or TL % L or BH * TL >= 1 << 31:
        raise ValueError(f'{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, '
                         f'v {tuple(v.shape)}, out {tuple(out.shape)}, dout {tuple(dout.shape)}')
    _check_lse(name, lse, (BH, TL), q.device)
    delta = torch.empty((BH, TL), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(name, *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk, dv)), BH,
                TL // L, *drop, stream)
    return dq, dk, dv


def _branch_bwd(name, q, k0, v0, kb, vb, out, dout, lse, L, *drop):
    """Launch B4 (no drop) or B8 (drop = (qb, s0, s1, rate, scale)): checks,
    D's scratch and the outputs; returns (dq, dk0, dv0, dkb, dvb)."""
    _check_operands(name, L, q, k0, v0, kb, vb, out, dout)
    G, BH0, TL = _check_one_shot_branch(name, q, k0, v0, kb, vb, L, out, dout)
    _check_lse(name, lse, (G, TL), q.device)
    delta = torch.empty((G, TL), dtype=torch.float32, device=q.device)
    dq, dkb, dvb = (torch.empty_like(q) for _ in range(3))
    dk0, dv0 = torch.empty_like(k0), torch.empty_like(v0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(name, *(t.data_ptr() for t in (q, k0, v0, kb, vb, out, dout, lse, delta, dq, dk0,
                                               dv0, dkb, dvb)),
                G, BH0, TL // L, *drop, stream)
    return dq, dk0, dv0, dkb, dvb


def block_causal_attention_bwd(q, k, v, out, dout, lse, L):
    """Kernel B3: (dq, dk, dv) of block_causal_attention_fwd at output `out`
    with row log-sum-exp `lse` (both from the forward), for the output
    gradient dout; all [BH, T*L, dh] (see block_causal_attention_bwd_plain,
    which needs neither out nor lse)."""
    name = 'block_causal_attention_bwd'
    if not _on_device(name, q):
        return block_causal_attention_bwd_plain(q, k, v, dout, L)
    grads = _block_causal_bwd(name, q, k, v, out, dout, lse, L)
    block_causal_attention_bwd.launches += 1
    return grads


def branch_attention_bwd(q, k0, v0, kb, vb, out, dout, lse, L):
    """Kernel B4: (dq, dk0, dv0, dkb, dvb) of the one-shot
    branch_attention_fwd (first_q_frame=0, n_old=T) at output `out` with row
    log-sum-exp `lse`, for the output gradient dout. q/kb/vb/out/dout
    [G, T*L, dh]; k0/v0 [BH0, T*L, dh]; dk0/dv0 are summed over the G/BH0
    branches that share each row (see branch_attention_bwd_plain)."""
    name = 'branch_attention_bwd'
    if not _on_device(name, q):
        return branch_attention_bwd_plain(q, k0, v0, kb, vb, dout, L)
    grads = _branch_bwd(name, q, k0, v0, kb, vb, out, dout, lse, L)
    branch_attention_bwd.launches += 1
    return grads


def block_causal_attention_dropout_fwd(q, k, v, L, seeds, rate, return_lse=False):
    """Kernel B5: block_causal_attention_fwd with inverted dropout on the
    softmax weights; seeds are the two uint32 words, rate in (0, 1) (see
    block_causal_attention_dropout_plain). The log-sum-exp is B1's."""
    name = 'block_causal_attention_dropout_fwd'
    if not _on_device(name, q):
        return block_causal_attention_dropout_plain(q, k, v, L, seeds, rate, return_lse)
    _check_operands(name, L, q, k, v)
    BH, TL, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape or TL % L or BH > 65535:
        raise ValueError(f'{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    drop = _dropout_args(name, seeds, rate)
    out = torch.empty_like(q)
    lse = torch.empty((BH, TL), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), BH,
                TL // L, *drop, stream)
    block_causal_attention_dropout_fwd.launches += 1
    return (out, lse) if return_lse else out


def branch_attention_dropout_fwd(q, k0, v0, kb, vb, L, seeds, rate, return_lse=False):
    """Kernel B7: the one-shot branch_attention_fwd (first_q_frame=0,
    n_old=T) with inverted dropout on the joint softmax weights. q/kb/vb
    [G, T*L, dh], k0/v0 [BH0, T*L, dh] (see branch_attention_dropout_plain)."""
    name = 'branch_attention_dropout_fwd'
    if not _on_device(name, q):
        return branch_attention_dropout_plain(q, k0, v0, kb, vb, L, seeds, rate, return_lse)
    _check_operands(name, L, q, k0, v0, kb, vb)
    G, BH0, TL = _check_one_shot_branch(name, q, k0, v0, kb, vb, L)
    drop = _dropout_args(name, seeds, rate)
    out = torch.empty_like(q)
    lse = torch.empty((G, TL), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(name, q.data_ptr(), k0.data_ptr(), v0.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                out.data_ptr(), _ptr(lse), G, TL // L, BH0, pick_q_block(TL, L), *drop, stream)
    branch_attention_dropout_fwd.launches += 1
    return (out, lse) if return_lse else out


def block_causal_attention_dropout_bwd(q, k, v, out, dout, lse, L, seeds, rate):
    """Kernel B6: (dq, dk, dv) of block_causal_attention_dropout_fwd at its
    output `out` and log-sum-exp `lse`, for the output gradient dout, the
    mask regenerated from (seeds, rate) (see
    block_causal_attention_dropout_bwd_plain)."""
    name = 'block_causal_attention_dropout_bwd'
    if not _on_device(name, q):
        return block_causal_attention_dropout_bwd_plain(q, k, v, dout, L, seeds, rate)
    grads = _block_causal_bwd(name, q, k, v, out, dout, lse, L, *_dropout_args(name, seeds, rate))
    block_causal_attention_dropout_bwd.launches += 1
    return grads


def branch_attention_dropout_bwd(q, k0, v0, kb, vb, out, dout, lse, L, seeds, rate):
    """Kernel B8: (dq, dk0, dv0, dkb, dvb) of branch_attention_dropout_fwd at
    its output `out` and log-sum-exp `lse`, for the output gradient dout;
    dk0/dv0 summed over the branches that share each row (see
    branch_attention_dropout_bwd_plain)."""
    name = 'branch_attention_dropout_bwd'
    if not _on_device(name, q):
        return branch_attention_dropout_bwd_plain(q, k0, v0, kb, vb, dout, L, seeds, rate)
    grads = _branch_bwd(name, q, k0, v0, kb, vb, out, dout, lse, L, pick_q_block(q.shape[1], L),
                        *_dropout_args(name, seeds, rate))
    branch_attention_dropout_bwd.launches += 1
    return grads


def hash_dropout_kernel(x, words, rate, batch0=0, frame0=0, frames=None):
    """The fused hash dropout (hash_dropout_sm90.cu): inverted dropout of x
    [B, T, ...] (bf16 or f32) with the two uint32 seed words, each element
    hashed at its index in the global array [rows, frames, ...] that x is
    the block [batch0 : batch0 + B, frame0 : frame0 + T] of (frames None:
    T, x holds every frame); rate in (0, 1). Equal, bit for bit, to
    ops/dropout.hash_dropout(words, x, rate, frame_slice_index(x.shape,
    batch0, frame0, frames)), its plain twin (plain_placed_hash_dropout),
    which a CPU tensor takes. The same call on an output gradient is the
    backward."""
    name = 'hash_dropout'  # the entry point of hash_dropout_sm90.cu
    frames = x.shape[1] if frames is None else frames
    if not 0.0 < rate < 1.0:
        raise ValueError(f'{name}: dropout rate must be in (0, 1), got {rate}')
    s0, s1 = (int(w) & 0xFFFFFFFF for w in words)
    if not _on_device(name, x):
        return dropout.plain_placed_hash_dropout(x, s0, s1, rate, batch0, frame0, frames)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{name}: the kernel takes bfloat16 or float32, got {x.dtype}')
    if x.dim() < 2 or not x.is_contiguous() or x.numel() >= 1 << 31:
        raise ValueError(f'{name}: x must be contiguous [B, T, ...] of fewer than 2^31 '
                         f'elements, got {tuple(x.shape)} (contiguous: {x.is_contiguous()})')
    # (1 - rate) rounded to x's dtype, as the plain twin divides
    divisor = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    B, T = x.shape[:2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(name, x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
                T, x.numel() // (B * T), batch0 & 0xFFFFFFFF, frame0 & 0xFFFFFFFF,
                frames & 0xFFFFFFFF, s0, s1, rate, divisor, stream)
    hash_dropout_kernel.launches += 1
    return out


KERNELS = (block_causal_attention_fwd, branch_attention_fwd, block_causal_attention_bwd,
           branch_attention_bwd, block_causal_attention_dropout_fwd,
           block_causal_attention_dropout_bwd, branch_attention_dropout_fwd,
           branch_attention_dropout_bwd, hash_dropout_kernel)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


def _append_launch_counts(path):
    with open(path, 'a') as f:
        f.write(json.dumps({'argv': sys.argv[1:],
                            'launches': {fn.__name__: fn.launches for fn in KERNELS}}) + '\n')


reset_launch_counts()
# VIEWFORMER_LAUNCH_COUNTS=FILE: the process appends its launch counts to
# FILE as one JSON line when it exits, so that a tool that runs the CLI's
# commands as processes (tools/quality_gate.py) can read what they launched.
if os.environ.get('VIEWFORMER_LAUNCH_COUNTS'):
    atexit.register(_append_launch_counts, os.environ['VIEWFORMER_LAUNCH_COUNTS'])
