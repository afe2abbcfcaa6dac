"""Branching attention forward: hand-written CUDA kernels and their plain twins.

Counterpart of viewformer_tpu/ops/attention_pallas.py for the serving path:

  block_causal_attention_fwd  replaces _block_causal_kernel3 (kernel B1)
  branch_attention_fwd        replaces _branch_kernel3 (kernel B2), and the
                              dense _attend_cache of migt_incremental

Operands keep the Pallas layout, [batch*heads, frames*L, dh]. No 1/sqrt(dh)
scale, f32 scores and softmax, weights rounded to the value dtype before the
product with V (the reference's conventions).

Each public function dispatches on where its tensors lie: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel (built from
csrc/branching_attention.cu on first use) or raises. There is no fallback
from the kernel to the plain version. Each wrapper counts its kernel launches
in its ``launches`` attribute.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_NEG_INF = -1e9
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     'csrc', 'branching_attention.cu')
_BUILD_DIR = os.path.join(os.path.dirname(_CSRC), 'build')
_TILE = 64  # frame length L and head width dh the kernels are compiled for
_lib = None


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the reference the kernels are held against)
# ---------------------------------------------------------------------------

def block_causal_attention_plain(q, k, v, L):
    """q/k/v [BH, T*L, dh] -> [BH, T*L, dh]; a query in frame t attends every
    key of frames <= t."""
    TL = q.shape[1]
    frames = torch.arange(TL, device=q.device) // L
    allowed = frames[:, None] >= frames[None, :]
    scores = torch.einsum('bqd,bkd->bqk', q.float(), k.float())
    scores = scores.masked_fill(~allowed, _NEG_INF)
    weights = torch.softmax(scores, -1)
    return torch.einsum('bqk,bkd->bqd', weights.to(v.dtype), v).to(q.dtype)


def branch_attention_plain(q, k0, v0, kb, vb, L, first_q_frame, n_old):
    """q/kb/vb [G, TQ*L, dh]; k0/v0 [BH0, F0*L, dh], shared by the G/BH0
    branches (branch g reads row g % BH0). Query row r lies in frame
    first_q_frame + r // L; it attends the stream-0 frames below
    min(that frame, n_old) and the kb/vb rows of its own frame, under one
    joint softmax."""
    G, TQL, dh = q.shape
    BH0, F0L, _ = k0.shape
    TQ, S = TQL // L, G // BH0
    qf = q.float().reshape(S, BH0, TQ, L, dh)
    kbf = kb.reshape(S, BH0, TQ, L, dh)
    vbf = vb.reshape(S, BH0, TQ, L, dh)
    q_frame = first_q_frame + torch.arange(TQ, device=q.device)
    k_frame = torch.arange(F0L, device=q.device) // L
    allowed = k_frame[None, :] < torch.clamp(q_frame, max=n_old)[:, None]  # [TQ, F0L]
    scores_old = torch.einsum('sbtld,bkd->sbtlk', qf, k0.float())
    scores_old = scores_old.masked_fill(~allowed[:, None, :], _NEG_INF)
    scores_new = torch.einsum('sbtld,sbtmd->sbtlm', qf, kbf.float())
    weights = torch.softmax(torch.cat([scores_old, scores_new], -1), -1)
    out = torch.einsum('sbtlk,bkd->sbtld', weights[..., :F0L].to(v0.dtype), v0)
    out = out + torch.einsum('sbtlm,sbtmd->sbtld', weights[..., F0L:].to(vb.dtype), vbf)
    return out.reshape(G, TQL, dh).to(q.dtype)


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


def build():
    """Compile csrc/branching_attention.cu for sm_90a (once per source hash)
    and return the path of the shared library. The ptxas report of the build
    is kept beside it, in a .log file."""
    with open(_CSRC, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f'libbranching_attention-{digest}.so')
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{lib_path}.{os.getpid()}.tmp'
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
           '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', tmp, _CSRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}')
    with open(lib_path[:-3] + '.log', 'w') as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def build_log():
    """The ptxas report (registers, shared memory, spills) of the built library."""
    with open(build()[:-3] + '.log') as f:
        return f.read()


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_causal_attention_fwd.argtypes = [p, p, p, p, i, i, p]
        lib.block_causal_attention_fwd.restype = i
        lib.branch_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.branch_attention_fwd.restype = i
        _lib = lib
    return _lib


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


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: CUDA error {err}')


# ---------------------------------------------------------------------------
# Public dispatch
# ---------------------------------------------------------------------------

def block_causal_attention_fwd(q, k, v, L):
    """Kernel B1: q/k/v [BH, T*L, dh] -> [BH, T*L, dh] (see
    block_causal_attention_plain)."""
    if q.device.type == 'cpu':
        return block_causal_attention_plain(q, k, v, L)
    if q.device.type != 'cuda':
        raise ValueError(f'block_causal_attention_fwd: no kernel for {q.device}')
    _check_operands('block_causal_attention_fwd', L, q, k, v)
    BH, TL, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape or TL % L or BH > 65535:
        raise ValueError(f'block_causal_attention_fwd: shapes {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(_library().block_causal_attention_fwd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), BH, TL // L, stream)
    block_causal_attention_fwd.launches += 1
    return out


def branch_attention_fwd(q, k0, v0, kb, vb, L, first_q_frame, n_old):
    """Kernel B2: q/kb/vb [G, TQ*L, dh], k0/v0 [BH0, F0*L, dh] -> [G, TQ*L, dh]
    (see branch_attention_plain). first_q_frame and n_old are host ints.

    first_q_frame=0, n_old=T is the one-shot branch attention of
    _branch_kernel3; one query frame with first_q_frame=n_old=n over a cache
    layer viewed as [B*H, F*L, dh] is _attend_cache."""
    if q.device.type == 'cpu':
        return branch_attention_plain(q, k0, v0, kb, vb, L, first_q_frame, n_old)
    if q.device.type != 'cuda':
        raise ValueError(f'branch_attention_fwd: no kernel for {q.device}')
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(_library().branch_attention_fwd, q.data_ptr(), k0.data_ptr(),
                v0.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), G,
                TQL // L, BH0, F0L // L, int(first_q_frame), int(n_old), stream)
    branch_attention_fwd.launches += 1
    return out


block_causal_attention_fwd.launches = 0
branch_attention_fwd.launches = 0
KERNELS = (block_causal_attention_fwd, branch_attention_fwd)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0
