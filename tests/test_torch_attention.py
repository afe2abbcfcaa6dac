"""The port's attention (viewformer_tpu_torch.ops) against the JAX package:
plain versions of kernels B1/B2 against the dense XLA path and the Pallas
kernels in interpret mode, B2's cache form against _attend_cache, and the CPU
dispatch (no kernel launch on CPU tensors)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viewformer_tpu.models.migt_incremental import _attend_cache
from viewformer_tpu.ops import attention_pallas as ap
from viewformer_tpu.ops import branching_attention as jba
from viewformer_tpu_torch.ops import attention_cuda as ac
from viewformer_tpu_torch.ops import branching_attention as tba

B, H, T, L, DH = 2, 2, 4, 64, 32
TL = T * L
ATOL = 2e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_block_causal_plain_matches_jax():
    q, k, v = (_rand(i, B, H, T, L, DH) for i in range(3))
    dense = np.asarray(jba.block_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    pallas = np.asarray(ap._run_block_causal(
        *(jnp.asarray(x.reshape(B * H, TL, DH)) for x in (q, k, v)), L, interpret=True))
    port = ac.block_causal_attention_fwd(*(_t(x.reshape(B * H, TL, DH)) for x in (q, k, v)), L)
    np.testing.assert_allclose(port.numpy().reshape(q.shape), dense, atol=ATOL)
    np.testing.assert_allclose(port.numpy(), pallas, atol=ATOL)
    port5 = tba.block_causal_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(port5.numpy(), dense, atol=ATOL)


def test_branch_plain_matches_jax():
    S = 2
    k0, v0 = _rand(0, B, H, T, L, DH), _rand(1, B, H, T, L, DH)
    qb, kb, vb = (_rand(i, S, B, H, T, L, DH) for i in (2, 3, 4))
    dense = np.asarray(jba.branch_attention(*(jnp.asarray(x) for x in (qb, k0, v0, kb, vb))))
    rb = lambda x: x.reshape(S * B * H, TL, DH)  # noqa: E731
    k0f = np.broadcast_to(k0.reshape(1, B * H, TL, DH), (S, B * H, TL, DH))
    v0f = np.broadcast_to(v0.reshape(1, B * H, TL, DH), (S, B * H, TL, DH))
    pallas = np.asarray(ap._run_branch(
        *(jnp.asarray(rb(x)) for x in (qb, k0f, v0f, kb, vb)), L, interpret=True))
    # the port shares K0/V0 across branches (row g % BH) instead of broadcasting
    port = ac.branch_attention_fwd(_t(rb(qb)), _t(k0.reshape(B * H, TL, DH)),
                                   _t(v0.reshape(B * H, TL, DH)), _t(rb(kb)), _t(rb(vb)),
                                   L, 0, T)
    np.testing.assert_allclose(port.numpy().reshape(dense.shape), dense, atol=ATOL)
    np.testing.assert_allclose(port.numpy(), pallas, atol=ATOL)
    port5 = tba.branch_attention(*(_t(x) for x in (qb, k0, v0, kb, vb)))
    np.testing.assert_allclose(port5.numpy(), dense, atol=ATOL)


@pytest.mark.parametrize('n', [0, 2, 3])
def test_branch_cache_form_matches_attend_cache(n):
    """One query frame over a 5-frame cache whose frames >= n hold garbage."""
    F = 5
    q, own_k, own_v = (_rand(i, B, H, L, DH) for i in range(3))
    cache_k, cache_v = _rand(3, B, H, F, L, DH), _rand(4, B, H, F, L, DH)
    expected = np.asarray(_attend_cache(
        *(jnp.asarray(x) for x in (q, cache_k, cache_v, own_k, own_v)), n, None))
    r = lambda x: _t(x.reshape(B * H, -1, DH))  # noqa: E731
    port = ac.branch_attention_fwd(r(q), r(cache_k), r(cache_v), r(own_k), r(own_v), L, n, n)
    np.testing.assert_allclose(port.numpy().reshape(expected.shape), expected, atol=ATOL)


def test_multi_end_block_attention_matches_jax():
    qs, ks, vs = ([_rand(10 * j + i, B, H, T, 4, 8) for i in range(3)] for j in range(3))
    expected = jba.multi_end_block_attention(
        tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, vs)), tuple(map(jnp.asarray, qs)),
        use_fused=False)
    ac.reset_launch_counts()
    port = tba.multi_end_block_attention(tuple(map(_t, ks)), tuple(map(_t, vs)),
                                         tuple(map(_t, qs)))
    assert len(port) == 3
    for p, e in zip(port, expected):
        np.testing.assert_allclose(p.numpy(), np.asarray(e), atol=ATOL)
    # CPU tensors take the plain versions: no kernel was launched
    assert all(fn.launches == 0 for fn in ac.KERNELS)


def test_kernel_wrappers_refuse_other_devices():
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        ac.block_causal_attention_fwd(q, q, q, 64)
    with pytest.raises(ValueError, match='no kernel'):
        ac.branch_attention_fwd(q, q, q, q, q, 64, 0, 1)
    assert all(fn.launches == 0 for fn in ac.KERNELS)
