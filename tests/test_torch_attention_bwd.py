"""The port's attention backward (viewformer_tpu_torch.ops) against the JAX
package: the plain twins of kernels B3/B4 against the Pallas backward kernels
in interpret mode and against jax.vjp of the dense attention, the autograd
Functions by gradcheck, the log-sum-exp of the forward, attention dropout's
need for seeds, the branch kernels' shape gate, the sources build()
compiles against the .cu files of csrc/, and the ctypes binding of every
kernel's C entry point against its declaration in csrc/."""
import ctypes
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viewformer_tpu.ops import attention_pallas as ap
from viewformer_tpu.ops import branching_attention as jba
from viewformer_tpu_torch.ops import attention_cuda as ac
from viewformer_tpu_torch.ops import branching_attention as tba

B, H, T, L, DH, S = 2, 2, 4, 64, 32, 2
TL = T * L
# f32 throughout; the gradients are sums over up to T*L keys of products of
# O(10) terms (raw q.k scores, no 1/sqrt(dh)), so f32 reassociation between
# XLA, the Pallas interpreter and torch leaves ~1e-5 relative.
RTOL, ATOL = 1e-4, 1e-4


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, expected):
    np.testing.assert_allclose(np.asarray(port), np.asarray(expected), rtol=RTOL, atol=ATOL)


def test_block_causal_bwd_plain_matches_jax():
    q, k, v, do = (_rand(i, B, H, T, L, DH) for i in range(4))
    r = lambda x: x.reshape(B * H, TL, DH)  # noqa: E731
    pallas = ap._run_block_causal_bwd(*(jnp.asarray(r(x)) for x in (q, k, v, do)), L,
                                      interpret=True)
    _, vjp = jax.vjp(jba.block_causal_attention, *map(jnp.asarray, (q, k, v)))
    dense = vjp(jnp.asarray(do))
    port = ac.block_causal_attention_bwd_plain(*(_t(r(x)) for x in (q, k, v, do)), L)
    for p, pl, d in zip(port, pallas, dense):
        _close(p.numpy(), pl)
        _close(p.numpy().reshape(d.shape), d)


@pytest.mark.parametrize('frames,branches', [(1, 2), (4, 2), (5, 1), (3, 3)])
def test_branch_bwd_plain_matches_jax(frames, branches):
    """At the (T, S) where B4's CTA plan has its edges: T = 1 (no query sees
    a K0 frame: dK0 = dV0 = 0), odd T (a lone last frame), S = 1 and S = 3
    branches a K0 row."""
    tl = frames * L
    k0, v0 = _rand(0, B, H, frames, L, DH), _rand(1, B, H, frames, L, DH)
    qb, kb, vb, do = (_rand(i, branches, B, H, frames, L, DH) for i in (2, 3, 4, 5))
    rb = lambda x: x.reshape(branches * B * H, tl, DH)  # noqa: E731
    r0 = lambda x: x.reshape(B * H, tl, DH)  # noqa: E731
    # the Pallas kernel takes K0/V0 broadcast over the branches and returns
    # dK0/dV0 per branch; _fb_bwd sums them over S (attention_pallas.py:630-631)
    bcast = lambda x: np.broadcast_to(  # noqa: E731
        r0(x)[None], (branches, B * H, tl, DH)).reshape(-1, tl, DH)
    dq, dk0, dv0, dkb, dvb = ap._run_branch_bwd(
        *(jnp.asarray(x) for x in (rb(qb), bcast(k0), bcast(v0), rb(kb), rb(vb), rb(do))),
        L, interpret=True)
    pallas = (dq, dk0.reshape(branches, B * H, tl, DH).sum(0),
              dv0.reshape(branches, B * H, tl, DH).sum(0), dkb, dvb)
    _, vjp = jax.vjp(jba.branch_attention, *map(jnp.asarray, (qb, k0, v0, kb, vb)))
    dense = vjp(jnp.asarray(do))
    port = ac.branch_attention_bwd_plain(_t(rb(qb)), _t(r0(k0)), _t(r0(v0)), _t(rb(kb)),
                                         _t(rb(vb)), _t(rb(do)), L)
    for p, pl, d in zip(port, pallas, dense):
        _close(p.numpy(), pl)
        _close(p.numpy().reshape(d.shape), d)
    if frames == 1:
        assert not port[1].any() and not port[2].any()


def test_multi_end_block_attention_grads_match_jax():
    """Gradients of all three streams' q/k/v through the autograd path of
    multi_end_block_attention against jax.vjp of the JAX dispatch (dense on
    the CPU)."""
    shape = (B, H, 3, 4, 8)
    qs, ks, vs = ([_rand(10 * j + i, *shape) for i in range(3)] for j in range(3))
    cot = [_rand(100 + i, *shape) for i in range(3)]
    out, vjp = jax.vjp(
        lambda ks, vs, qs: jba.multi_end_block_attention(ks, vs, qs, use_fused=False),
        *(tuple(map(jnp.asarray, x)) for x in (ks, vs, qs)))
    expected = vjp(tuple(map(jnp.asarray, cot)))
    leaves = [[_t(x).requires_grad_() for x in group] for group in (ks, vs, qs)]
    ac.reset_launch_counts()
    port = tba.multi_end_block_attention(*(tuple(group) for group in leaves))
    for p, e in zip(port, out):
        _close(p.detach().numpy(), e)
    sum((p * _t(c)).sum() for p, c in zip(port, cot)).backward()
    for group, egroup in zip(leaves, expected):
        for x, e in zip(group, egroup):
            _close(x.grad.numpy(), e)
    assert all(fn.launches == 0 for fn in ac.KERNELS)  # CPU tensors: plain twins


@pytest.mark.parametrize('name', ['block_causal', 'branch'])
def test_autograd_functions_gradcheck(name):
    """Float64 finite differences against the Functions' backward (the plain
    twins on CPU tensors), at T=3 frames of L=2 tokens, dh=3."""
    gen = torch.Generator().manual_seed(0)
    rand = lambda rows: torch.randn(rows, 6, 3, generator=gen, dtype=torch.float64,  # noqa: E731
                                    requires_grad=True)
    if name == 'block_causal':
        fn, inputs = (lambda q, k, v: tba.BlockCausalAttention.apply(q, k, v, 2),
                      (rand(2), rand(2), rand(2)))
    else:
        fn, inputs = (lambda q, k0, v0, kb, vb: tba.BranchAttention.apply(q, k0, v0, kb, vb, 2),
                      (rand(4), rand(2), rand(2), rand(4), rand(4)))
    assert torch.autograd.gradcheck(fn, inputs)


def test_forward_log_sum_exp():
    """The row log-sum-exp the forward returns for the backward: logsumexp
    of the masked f32 scores."""
    q, k, v = (_rand(i, B * H, TL, DH) for i in range(3))
    scores = np.einsum('bqd,bkd->bqk', q, k).astype(np.float64)
    frames = np.arange(TL) // L
    masked = np.where(frames[:, None] >= frames[None, :], scores, -np.inf)
    expected = np.log(np.exp(masked - masked.max(-1, keepdims=True)).sum(-1)) + \
        masked.max(-1)
    out, lse = ac.block_causal_attention_fwd(_t(q), _t(k), _t(v), L, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), expected, rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), ac.block_causal_attention_plain(
        _t(q), _t(k), _t(v), L).numpy())
    qb, kb, vb = (_rand(i, S * B * H, TL, DH) for i in range(3, 6))
    own = np.einsum('gtld,gtmd->gtlm', qb.reshape(-1, T, L, DH), kb.reshape(-1, T, L, DH))
    old = np.einsum('gqd,gkd->gqk', qb, np.concatenate([k] * S)).reshape(-1, T, L, TL)
    old = np.where((frames[None, :] < np.arange(T)[:, None])[:, None], old, -np.inf)
    joint = np.concatenate([old, own], -1).astype(np.float64)
    m = joint.max(-1, keepdims=True)
    expected = (np.log(np.exp(joint - m).sum(-1)) + m[..., 0]).reshape(-1, TL)
    _, lse = ac.branch_attention_fwd(_t(qb), _t(k), _t(v), _t(kb), _t(vb), L, 0, T,
                                     return_lse=True)
    np.testing.assert_allclose(lse.numpy(), expected, rtol=1e-6)


def test_attention_dropout_is_refused():
    """Attention dropout without seed words is refused; with them it runs,
    and at rate 0 the seeds are not read."""
    x = torch.randn(1, 1, 2, 4, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='needs seeds'):
        tba.multi_end_block_attention((x, x), (x, x), (x, x), dropout_rate=0.1)
    dropped = tba.multi_end_block_attention((x, x), (x, x), (x, x), 0.5, ((1, 2), (3, 4)))
    plain = tba.multi_end_block_attention((x, x), (x, x), (x, x))
    assert all(d.shape == p.shape and not torch.equal(d, p) for d, p in zip(dropped, plain))
    for a, b in zip(tba.multi_end_block_attention((x, x), (x, x), (x, x), 0.0, ((1, 2), None)),
                    plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_wrappers_refuse_other_devices():
    x = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device='meta')
    lse = torch.zeros(2, 64, device='meta')
    ac.reset_launch_counts()
    with pytest.raises(ValueError, match='no kernel'):
        ac.block_causal_attention_bwd(x, x, x, x, x, lse, 64)
    with pytest.raises(ValueError, match='no kernel'):
        ac.branch_attention_bwd(x, x, x, x, x, x, x, lse, 64)
    assert all(fn.launches == 0 for fn in ac.KERNELS)


def test_branch_shape_gate():
    """B4, B7 and B8 run a 1-D grid, so their shape gate lets G + BH0 > 65535
    pass. The gate on its own: on a meta tensor the wrappers raise 'no
    kernel' before they reach it."""
    G, BH0 = 3 * 16384, 16384  # G + BH0 = 65536
    q = torch.empty(G, L, 64, dtype=torch.bfloat16, device='meta')
    k0 = torch.empty(BH0, L, 64, dtype=torch.bfloat16, device='meta')
    for name in ('branch_attention_bwd', 'branch_attention_dropout_bwd'):
        assert ac._check_one_shot_branch(name, q, k0, k0, q, q, L, q, q) == (G, BH0, L)
    assert ac._check_one_shot_branch('branch_attention_dropout_fwd', q, k0, k0, q, q, L) == (
        G, BH0, L)
    with pytest.raises(ValueError, match='branch_attention_dropout_fwd: shapes'):
        ac._check_one_shot_branch('branch_attention_dropout_fwd', q, k0[:BH0 - 1],
                                  k0[:BH0 - 1], q, q, L)  # BH0 does not divide G
    lse = torch.empty(G, L, device='meta')
    for fn, extra in ((ac.branch_attention_bwd, ()), (ac.branch_attention_dropout_bwd,
                                                       ((1, 2), 0.1))):
        with pytest.raises(ValueError, match='no kernel'):
            fn(q, k0, k0, q, q, q, q, lse, L, *extra)
    with pytest.raises(ValueError, match='no kernel'):
        ac.branch_attention_dropout_fwd(q, k0, k0, q, q, L, (1, 2), 0.1)


def test_every_csrc_source_is_built():
    """The .cu files of csrc/ are exactly the sources build() compiles, so a
    source that is deleted, or added without being built, is caught here."""
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(ac._CSRC_DIR, '*.cu'))) \
        == sorted(ac._SOURCES)


def _c_entry_points():
    """{name: [parameter declarations]} of every `extern "C" int name(...)`
    in csrc/*.cu."""
    found = {}
    for path in sorted(glob.glob(os.path.join(ac._CSRC_DIR, '*.cu'))):
        with open(path) as f:
            for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', f.read()):
                assert name not in found, f'{name} declared twice'
                found[name] = [' '.join(p.split()) for p in params.split(',')]
    return found


# a pointer of any type is bound as c_void_p: as c_int it would be cut to 32 bits
_C_TYPES = {'int': ctypes.c_int, 'unsigned': ctypes.c_uint32, 'float': ctypes.c_float}


def _ctype(param):
    return ctypes.c_void_p if '*' in param else _C_TYPES[param.split()[-2]]


def test_every_c_entry_point_is_bound():
    assert set(_c_entry_points()) == set(ac._SIGNATURES)


@pytest.mark.parametrize('name', sorted(ac._SIGNATURES))
def test_c_entry_point_signature(name):
    """Each C entry point's parameters, in count and kind, against the ctypes
    argument types the wrappers bind it with."""
    params = _c_entry_points()[name]
    assert [_ctype(p) for p in params] == ac._SIGNATURES[name], params
