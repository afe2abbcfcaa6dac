"""The port's hash dropout (viewformer_tpu_torch.ops.dropout) and the plain
twins of the dropout kernels B5-B8 (ops.attention_cuda) against the JAX
package: the hash against ops/dropout.py and a numpy uint32 replica, the
twins against the Pallas kernels in interpret mode, the backward's
D = rowsum(dO * O) against the reference's rowsum, the autograd Functions
by gradcheck, multi_end_block_attention with dropout against the JAX
dispatch's fused path, and the op viewformer::hash_dropout (the fused
kernel's CPU side) against the plain hash_dropout bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_attention_pallas import _host_keep
from viewformer_tpu.ops import attention_pallas as ap
from viewformer_tpu.ops import branching_attention as jba
from viewformer_tpu.ops import dropout as jdropout
from viewformer_tpu_torch.ops import attention_cuda as ac
from viewformer_tpu_torch.ops import branching_attention as tba
from viewformer_tpu_torch.ops import dropout as tdropout

RATE = 0.1
SEEDS = np.asarray([[123456789, 987654321]], np.uint32)
WORDS = tuple(int(w) for w in SEEDS[0])
# (T, L, dh): the Pallas q-tile qb = _pick_q_block(T*L, L) is T*L (one tile),
# 320 < T*L (two tiles; the training shape has qb 320 < 1280) and L; T = 1,
# where B7 attends no K0 frame and B5's pair of query frames has one
SHAPES = [(3, 16, 32), (20, 32, 32), (11, 64, 32), (1, 64, 32)]
BH, S = 2, 2


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, expected):
    """f32 reassociation between the Pallas interpreter and torch: 1e-5 of
    the largest magnitude (the scores are raw q.k, no 1/sqrt(dh))."""
    port, expected = np.asarray(port), np.asarray(expected)
    assert port.shape == expected.shape
    assert np.abs(port - expected).max() <= 1e-5 * max(1.0, np.abs(expected).max())


def _jax_key(words):
    return jax.random.wrap_key_data(np.asarray(words, np.uint32))


@pytest.mark.parametrize('words', [(0, 0), (123456789, 987654321), (0xFFFFFFFF, 7)])
def test_hash_uniform_matches_jax(words):
    k0, k1 = jdropout._key_words(_jax_key(words))
    assert (int(k0), int(k1)) == words
    shape = (3, 5, 7, 11)
    expected = np.asarray(jdropout.hash_uniform(_jax_key(words), shape))
    port = tdropout.hash_uniform(words, shape)
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), expected)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_hash_dropout_matches_jax(dtype):
    x = _rand(0, 4, 6, 8, 16)
    expected = jdropout.hash_dropout(_jax_key(WORDS), jnp.asarray(x).astype(dtype), RATE)
    port = tdropout.hash_dropout(WORDS, _t(x).to(getattr(torch, dtype)), RATE)
    assert port.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(expected.astype(jnp.float32)))
    np.testing.assert_array_equal(tdropout.hash_dropout(WORDS, _t(x), 0.0).numpy(), x)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize('placement', [None, (3, 2, 9)], ids=['whole', 'block'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_hash_dropout_op_matches_plain(dtype, placement):
    """viewformer::hash_dropout (placed_hash_dropout), the op MIGT's sites
    run, against hash_dropout at frame_slice_index's indices, bit for bit in
    the output and the gradient, over x's own frames (the whole array, also
    against the JAX package) and over a block (rows 3.., frames 2.. of 9);
    its autograd saves no tensor, and CPU tensors launch no kernel."""
    x = _t(_rand(5, 4, 6, 8, 16)).to(dtype)
    grad = _t(_rand(6, 4, 6, 8, 16)).to(dtype)
    b0, f0, frames = placement or (0, 0, x.shape[1])
    xp, xo = x.clone().requires_grad_(), x.clone().requires_grad_()
    expected = tdropout.hash_dropout(WORDS, xp, RATE,
                                     tdropout.frame_slice_index(tuple(x.shape), b0, f0, frames))
    (expected_grad,) = torch.autograd.grad(expected, xp, grad)
    saved = []
    ac.reset_launch_counts()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = tdropout.placed_hash_dropout(xo, *WORDS, RATE, b0, f0, frames)
    (out_grad,) = torch.autograd.grad(out, xo, grad)
    assert saved == []
    assert out.dtype == dtype and torch.equal(_bits(out), _bits(expected))
    assert torch.equal(_bits(out_grad), _bits(expected_grad))
    assert all(fn.launches == 0 for fn in ac.KERNELS)
    if placement is None:
        jax_out = jdropout.hash_dropout(_jax_key(WORDS), jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), RATE)
        np.testing.assert_array_equal(out.detach().float().numpy(),
                                      np.asarray(jax_out.astype(jnp.float32)))


def test_hash_dropout_op_seq_halves_are_the_whole_arrays_frames():
    """A 1x1x2 seq split: each rank's half of the frames, dropped at its
    placement (frame0 = 0 or T/2 of T), equals those frames of the whole
    array's dropout."""
    x = _t(_rand(7, 3, 8, 4, 16)).to(torch.bfloat16)
    whole = tdropout.placed_hash_dropout(x, *WORDS, RATE, 0, 0, 8)
    for frame0 in (0, 4):
        half = tdropout.placed_hash_dropout(x[:, frame0:frame0 + 4].contiguous(), *WORDS, RATE,
                                            0, frame0, 8)
        assert torch.equal(_bits(half), _bits(whole[:, frame0:frame0 + 4]))


def test_hash_keep_matches_host_replica():
    """The twin's keep factors equal the numpy uint32 replica of _hash_keep
    bit for bit, for indices past 2^32 too (the hash takes them mod 2^32, as
    the kernels' uint32 arithmetic wraps)."""
    rng = np.random.RandomState(0)
    idx = np.concatenate([rng.randint(0, 1 << 62, 5000, dtype=np.int64),
                          np.arange(4000, dtype=np.int64), [0xFFFFFFFF, 1 << 32]])
    expected = _host_keep(SEEDS, (idx & 0xFFFFFFFF).astype(np.uint32), RATE)
    port = tdropout.hash_keep(WORDS, torch.from_numpy(idx), RATE)
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), expected)
    assert 0.05 < (expected == 0).mean() < 0.15


def _host_branch_index(G, T, L, qb):
    """_branch_weight_indices in numpy uint32, over global query rows:
    stream-0 keys [G, TL, TL] and each query's q-tile keys [G, TL, qb]."""
    TL = T * L
    g = np.arange(G, dtype=np.uint32)[:, None, None]
    r = np.arange(TL, dtype=np.uint32)[None, :, None]
    with np.errstate(over='ignore'):
        row_base = (g * np.uint32(TL) + r) * np.uint32(TL + qb)
        return (row_base + np.arange(TL, dtype=np.uint32),
                row_base + np.uint32(TL) + np.arange(qb, dtype=np.uint32))


@pytest.mark.parametrize('T,L,dh', SHAPES)
def test_weight_indices_match_pallas(T, L, dh):
    """The twins' index spaces equal the Pallas kernels' bit for bit: B5's
    over global rows and columns, B7's with the own frame's keys at their
    position inside the query's q-tile. Rows past 2^32 / TL^2 wrap."""
    TL = T * L
    qb = ac.pick_q_block(TL, L)
    assert qb == ap._pick_q_block(TL, L)
    rows = torch.tensor([0, 1, 5, 3_000_000])
    with np.errstate(over='ignore'):
        r = np.arange(TL, dtype=np.uint32)
        expected = (rows.numpy().astype(np.uint32)[:, None, None] * np.uint32(TL)
                    + r[:, None]) * np.uint32(TL) + r
    np.testing.assert_array_equal(ac.bc_weight_index(rows, TL).numpy() & 0xFFFFFFFF, expected)

    old, own = ac.branch_weight_indices(torch.arange(2 * S), TL, L)
    host_old, host_tile = _host_branch_index(2 * S, T, L, qb)
    np.testing.assert_array_equal(old.numpy(), host_old)
    query = np.arange(TL).reshape(T, L, 1)
    key = np.arange(TL).reshape(T, 1, L)
    column = key - (query // qb) * qb  # the key's position inside the q-tile
    assert column.min() >= 0 and column.max() < qb
    np.testing.assert_array_equal(own.numpy(), host_tile[:, query, column])


def _pallas_branch_inputs(T, L, dh, branches=S):
    TL = T * L
    q, kb, vb, do = (_rand(10 + i, branches * BH, TL, dh) for i in range(4))
    k0, v0 = _rand(20, BH, TL, dh), _rand(21, BH, TL, dh)
    return q, k0, v0, kb, vb, do


# the branch kernels also at S = 1 branch (B8's key CTAs then stream one
# branch row); S is the branches a K0 row has
@pytest.mark.parametrize('kernel,branches', [('B5', S), ('B6', S), ('B7', S), ('B8', S),
                                             ('B7', 1), ('B8', 1)],
                         ids=['B5', 'B6', 'B7', 'B8', 'B7-S1', 'B8-S1'])
@pytest.mark.parametrize('T,L,dh', SHAPES)
def test_dropout_twins_match_pallas(kernel, branches, T, L, dh):
    """Each plain twin against its Pallas kernel in interpret mode, with the
    same seed words at rate 0.1: every output and gradient within 1e-5."""
    TL = T * L
    seeds = jnp.asarray(SEEDS)
    if kernel in ('B5', 'B6'):
        q, k, v, do = (_rand(i, BH, TL, dh) for i in range(4))
        if kernel == 'B5':
            expected = [ap._run_block_causal_do(*map(jnp.asarray, (q, k, v)), seeds, L, RATE,
                                                interpret=True)]
            port = [ac.block_causal_attention_dropout_plain(_t(q), _t(k), _t(v), L, WORDS,
                                                            RATE)]
        else:
            expected = ap._run_block_causal_do_bwd(*map(jnp.asarray, (q, k, v)), seeds,
                                                   jnp.asarray(do), L, RATE, interpret=True)
            port = ac.block_causal_attention_dropout_bwd_plain(*map(_t, (q, k, v, do)), L, WORDS,
                                                               RATE)
    else:
        q, k0, v0, kb, vb, do = _pallas_branch_inputs(T, L, dh, branches)
        bcast = lambda x: np.concatenate([x] * branches)  # noqa: E731
        operands = tuple(map(jnp.asarray, (q, bcast(k0), bcast(v0), kb, vb)))
        if kernel == 'B7':
            expected = [ap._run_branch_do(*operands, seeds, L, RATE, interpret=True)]
            port = [ac.branch_attention_dropout_plain(*map(_t, (q, k0, v0, kb, vb)), L, WORDS,
                                                      RATE)]
        else:
            dq, dk0, dv0, dkb, dvb = ap._run_branch_do_bwd(*operands, seeds, jnp.asarray(do), L,
                                                           RATE, interpret=True)
            # _fbd_bwd sums dK0/dV0 over the branches (attention_pallas.py:708-709)
            expected = [dq, np.asarray(dk0).reshape(branches, BH, TL, dh).sum(0),
                        np.asarray(dv0).reshape(branches, BH, TL, dh).sum(0), dkb, dvb]
            port = ac.branch_attention_dropout_bwd_plain(*map(_t, (q, k0, v0, kb, vb, do)), L,
                                                         WORDS, RATE)
    assert len(port) == len(expected)
    for p, e in zip(port, expected):
        _close(p.numpy(), e)


@pytest.mark.parametrize('rate', [0.0, RATE])
def test_bwd_delta_plain_is_rowsum_dp_w(rate):
    """The D pass's twin, rowsum(dO * O) over the dropped output of
    block_causal_attention_dropout_plain, equals the reference's
    rowsum(dP' * W) (dP' = (dO V^T) * keep, W the undropped softmax), built
    from the plain twins' keep mask, in f32."""
    T, L, dh = 3, 16, 8
    TL = T * L
    q, k, v, do = (_t(_rand(30 + i, BH, TL, dh)) for i in range(4))
    out = ac.block_causal_attention_dropout_plain(q, k, v, L, WORDS, rate)
    frames = torch.arange(TL) // L
    allowed = frames[:, None] >= frames[None, :]
    w = torch.einsum('bqd,bkd->bqk', q, k).masked_fill(~allowed, -1e9).softmax(-1)
    keep = tdropout.hash_keep(WORDS, ac.bc_weight_index(torch.arange(BH), TL), rate)
    assert (keep == 0).any() == (rate > 0)
    dp = torch.einsum('bqd,bkd->bqk', do, v) * keep
    delta = ac.attention_bwd_delta_plain(out, do)
    assert delta.dtype == torch.float32 and delta.shape == (BH, TL)
    _close(delta.numpy(), (dp * w).sum(-1).numpy())


@pytest.mark.parametrize('family', ['block_causal', 'branch'])
def test_dropout_twins_chunked(monkeypatch, family):
    """The twins run over chunks of rows at the training shapes; a chunk of
    one row gives what one chunk of all rows gives."""
    T, L, dh = 3, 16, 8
    q, k0, v0, kb, vb, do = (_t(x) for x in _pallas_branch_inputs(T, L, dh))
    if family == 'block_causal':
        fwd = lambda: ac.block_causal_attention_dropout_plain(  # noqa: E731
            k0, v0, q[:BH], L, WORDS, RATE, return_lse=True)
        bwd = lambda: ac.block_causal_attention_dropout_bwd_plain(  # noqa: E731
            k0, v0, q[:BH], do[:BH], L, WORDS, RATE)
    else:
        fwd = lambda: ac.branch_attention_dropout_plain(  # noqa: E731
            q, k0, v0, kb, vb, L, WORDS, RATE, return_lse=True)
        bwd = lambda: ac.branch_attention_dropout_bwd_plain(  # noqa: E731
            q, k0, v0, kb, vb, do, L, WORDS, RATE)
    whole = fwd() + bwd()
    monkeypatch.setattr(ac, '_CHUNK_WEIGHTS', 1)
    for a, b in zip(whole, fwd() + bwd()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('name', ['block_causal', 'branch'])
def test_dropout_functions_gradcheck(name):
    """Float64 finite differences against the dropout Functions' backward
    (the plain twins on CPU tensors), T=3 frames of L=2 tokens, dh=3, with
    fixed seed words at rate 0.3."""
    gen = torch.Generator().manual_seed(0)
    rand = lambda rows: torch.randn(rows, 6, 3, generator=gen, dtype=torch.float64,  # noqa: E731
                                    requires_grad=True)
    if name == 'block_causal':
        fn, inputs = (lambda q, k, v: tba.BlockCausalAttentionDropout.apply(
            q, k, v, 2, (5, 6), 0.3), (rand(2), rand(2), rand(2)))
    else:
        fn, inputs = (lambda q, k0, v0, kb, vb: tba.BranchAttentionDropout.apply(
            q, k0, v0, kb, vb, 2, (7, 8), 0.3), (rand(4), rand(2), rand(2), rand(4), rand(4)))
    assert torch.autograd.gradcheck(fn, inputs)


def pallas_interpret(monkeypatch):
    """Run every Pallas kernel of the JAX package in interpret mode, so that
    its fused attention path runs on the CPU (where use_fused='auto' takes
    the dense path, whose branch dropout index differs)."""
    for name in ('_run_block_causal', '_run_branch', '_run_block_causal_bwd', '_run_branch_bwd',
                 '_run_block_causal_do', '_run_branch_do', '_run_block_causal_do_bwd',
                 '_run_branch_do_bwd'):
        fn = getattr(ap, name)
        monkeypatch.setattr(ap, name, lambda *a, _fn=fn, **kw: _fn(*a, interpret=True))


@pytest.fixture
def fused_interpret(monkeypatch):
    pallas_interpret(monkeypatch)


def test_multi_end_block_attention_dropout_matches_jax(fused_interpret):
    """Outputs and gradients of three streams with attention dropout against
    the JAX dispatch's fused path: stream 0 takes the first seed pair and the
    branches the second, as the dispatch's rng0/rng1."""
    shape = (2, 2, 3, 16, 8)
    qs, ks, vs = ([_rand(10 * j + i, *shape) for i in range(3)] for j in range(3))
    cot = [_rand(100 + i, *shape) for i in range(3)]
    key = jax.random.PRNGKey(3)
    out, vjp = jax.vjp(
        lambda ks, vs, qs: jba.multi_end_block_attention(
            ks, vs, qs, dropout_rate=RATE, dropout_rng=key, use_fused=True),
        *(tuple(map(jnp.asarray, x)) for x in (ks, vs, qs)))
    expected = vjp(tuple(map(jnp.asarray, cot)))
    seeds = tuple(tuple(int(w) for w in np.asarray(ap.seed_words(r))[0])
                  for r in jax.random.split(key))
    leaves = [[_t(x).requires_grad_() for x in group] for group in (ks, vs, qs)]
    ac.reset_launch_counts()
    port = tba.multi_end_block_attention(*(tuple(group) for group in leaves), RATE, seeds)
    for p, e in zip(port, out):
        _close(p.detach().numpy(), e)
    sum((p * _t(c)).sum() for p, c in zip(port, cot)).backward()
    for group, egroup in zip(leaves, expected):
        for x, e in zip(group, egroup):
            _close(x.grad.numpy(), e)
    assert all(fn.launches == 0 for fn in ac.KERNELS)  # CPU tensors: plain twins
    with torch.no_grad():
        again = tba.multi_end_block_attention(*(tuple(group) for group in leaves), RATE, seeds)
    for a, b in zip(again, port):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_wrappers_refuse_other_devices_and_rates():
    x = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device='meta')
    lse = torch.zeros(2, 64, device='meta')
    ac.reset_launch_counts()
    with pytest.raises(ValueError, match='no kernel'):
        ac.block_causal_attention_dropout_fwd(x, x, x, 64, WORDS, RATE)
    with pytest.raises(ValueError, match='no kernel'):
        ac.branch_attention_dropout_bwd(x, x, x, x, x, x, x, lse, 64, WORDS, RATE)
    with pytest.raises(ValueError, match=r'rate must be in \(0, 1\)'):
        ac._dropout_args('kernel', WORDS, 1.0)
    with pytest.raises(ValueError, match='no kernel'):
        ac.hash_dropout_kernel(x, WORDS, RATE)
    for rate in (0.0, 1.0):
        with pytest.raises(ValueError, match=r'rate must be in \(0, 1\)'):
            ac.hash_dropout_kernel(torch.zeros(2, 3), WORDS, rate)
    assert ac._dropout_args('kernel', (-1, 1 << 32), RATE) == (
        0xFFFFFFFF, 0, float(np.float32(RATE)), float(np.float32(1 / 0.9)))
    assert all(fn.launches == 0 for fn in ac.KERNELS)
