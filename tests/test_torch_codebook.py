"""The port's codebook training pieces against the JAX package's on the CPU
in f32, at test_train_codebook's TINY config and a variant whose
attn_resolutions put an AttnBlock in each tower: quantize_ema, the VQ-GAN
training forward, remat, codebook_loss_fn and its gradients (without and
with a random-weight LPIPS), 1 and 3 optimizer steps (also with the global
clip and with accumulate_grad_batches=2 against optax.MultiSteps), the eval
step, and load_model of a codebook job dir."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_config import to_port
from test_train_codebook import TINY
from viewformer_tpu.models.vqgan import VQGAN as JVQGAN
from viewformer_tpu.ops import quantizer as jq
from viewformer_tpu.train import codebook as jcb
from viewformer_tpu_torch.models import load_model
from viewformer_tpu_torch.models.lpips import LPIPS, random_lpips_params
from viewformer_tpu_torch.models.vqgan import VQGAN, Quantizer
from viewformer_tpu_torch.ops import quantizer as tq
from viewformer_tpu_torch.train import codebook as tcb
from viewformer_tpu_torch.train.checkpoint import CheckpointManager
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

ATTN = dataclasses.replace(TINY, attn_resolutions=[8])
# f32 on the CPU, the same operations in another order: forward values and
# losses agree to ~1e-6 relative; 1e-4 of the largest magnitude leaves room
# for the towers' reassociation and fails on any wrong term.
TOL = 1e-4
STATE_TOL = 1e-5  # the EMA state: one f32 update of sums over the batch


def _close(actual, expected, tol=TOL, msg='', floor=1e-6):
    """max |actual - expected| <= tol * max(max |expected|, floor)."""
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    scale = max(np.abs(expected).max(), floor)
    err = np.abs(actual - expected).max()
    assert err <= tol * scale, f'{msg}: max err {err} > {tol} * {scale}'


_VARIABLES = {}  # JAX initial weights by model structure, shared by the tests


def _jax_model(config):
    """(JAX VQGAN of config, its initial variables from PRNGKey(0) as numpy)."""
    model = JVQGAN(config)
    key = repr(dataclasses.replace(config, perceptual_weight=0.0))
    if key not in _VARIABLES:
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        _VARIABLES[key] = jax.device_get(jax.jit(lambda a, b: model.init(
            {'params': a, 'quantizer': b}, jnp.zeros((1, 16, 16, 3), jnp.float32),
            training=False))(k1, k2))
    return model, _VARIABLES[key]


def _port_model(config, variables, remat=False):
    model = VQGAN(to_port(config), generator=torch.Generator().manual_seed(0), remat=remat)
    model.load_state_dict(state_dict_from_jax(model, variables))
    return model


def _quantizer_state(model):
    return {name: buf.numpy().copy() for name, buf in model.quantizer.named_buffers()}


def _images(seed, n=4):
    return np.random.RandomState(seed).randint(0, 256, (n, 16, 16, 3)).astype(np.uint8)


def _float_images(seed, n=4):
    return (np.random.RandomState(seed).rand(n, 16, 16, 3) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize('training', [True, False])
def test_quantize_ema_matches_jax(training):
    """Indices equal, quantized and loss within TOL, the new state within
    STATE_TOL (counter exact), the straight-through gradient; with
    training=False the state is left as it was, bit for bit."""
    rng = np.random.RandomState(0)
    D, N = 8, 16
    state = {'embeddings': rng.uniform(-1.7, 1.7, (D, N)).astype(np.float32),
             'ema_cluster_size_hidden': rng.rand(N).astype(np.float32),
             'ema_dw_hidden': rng.randn(D, N).astype(np.float32),
             'counter': np.int32(3)}
    inputs = rng.randn(2, 3, 3, D).astype(np.float32)
    weights = rng.randn(2, 3, 3, D).astype(np.float32)

    def jax_fn(x):
        q, loss, idx, new = jq.quantize_ema(jq.QuantizerState(**state), x, training=training)
        return (q * weights).sum() + loss, (q, loss, idx, new)

    (_, (jquant, jloss, jidx, jnew)), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(inputs))
    quantizer = Quantizer(D, N)
    for name, value in state.items():
        getattr(quantizer, name).copy_(torch.as_tensor(value))
    x = torch.from_numpy(inputs).requires_grad_()
    quant, loss, idx = tq.quantize_ema(quantizer, x, training=training)
    ((quant * torch.from_numpy(weights)).sum() + loss).backward()

    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(quant.detach().numpy(), jquant, msg='quantized')
    _close(loss.item(), jloss, msg='e_latent_loss')
    _close(x.grad.numpy(), jgrad, msg='straight-through gradient')
    for name in state:
        new = getattr(quantizer, name).numpy()
        if training:
            _close(new, np.asarray(getattr(jnew, name)), STATE_TOL, name)
        else:
            np.testing.assert_array_equal(new, state[name])
    assert quantizer.counter.item() == 3 + training
    assert quantizer.counter.dtype == torch.int32


@pytest.mark.parametrize('config', [TINY, ATTN], ids=['tiny', 'attn'])
def test_training_forward_matches_jax(config):
    """VQGAN.forward(x, training=True) against model.apply(...,
    training=True, mutable=['quantizer']): dec, e_latent_loss, codes and
    the new quantizer state; then encode(x, training=True) against JAX's
    encode."""
    jmodel, variables = _jax_model(config)
    x = _float_images(1)
    (jdec, jloss, jquant, jcodes), mutated = jax.jit(functools.partial(
        jmodel.apply, training=True, mutable=['quantizer']))(variables, jnp.asarray(x))
    model = _port_model(config, variables)
    with torch.no_grad():
        dec, loss, quant, codes = model(torch.from_numpy(x), training=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(dec.numpy(), jdec, msg='dec')
    _close(quant.numpy(), jquant, msg='quant')
    _close(loss.item(), jloss, msg='e_latent_loss')
    for name, value in _quantizer_state(model).items():
        _close(value, jax.device_get(mutated['quantizer'][name]), STATE_TOL, name)
    # encode(training=True) quantizes and updates the state as JAX's encode
    (jquant, _, jcodes), mutated = jax.jit(functools.partial(
        jmodel.apply, training=True, mutable=['quantizer'], method=JVQGAN.encode))(
            variables, jnp.asarray(x))
    model = _port_model(config, variables)
    with torch.no_grad():
        quant, codes = model.encode(torch.from_numpy(x), training=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(quant.numpy(), jquant, msg='encode quant')
    for name, value in _quantizer_state(model).items():
        _close(value, jax.device_get(mutated['quantizer'][name]), STATE_TOL, f'encode {name}')


def test_remat_gives_equal_gradients():
    """remat recomputes the ResnetBlocks and AttnBlocks in the backward:
    the loss, the gradients and the EMA state are bit-equal to no remat."""
    _, variables = _jax_model(ATTN)
    batch = torch.from_numpy(_images(2))
    out = []
    for remat in (False, True):
        model = _port_model(ATTN, variables, remat=remat)
        loss, _ = tcb.codebook_loss_fn(model, to_port(ATTN), None, batch)
        loss.backward()
        out.append((loss, {n: p.grad for n, p in model.named_parameters()},
                    _quantizer_state(model)))
    (loss0, grads0, state0), (loss1, grads1, state1) = out
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    for name in state0:
        np.testing.assert_array_equal(state0[name], state1[name])


def _lpips_params(seed=0):
    return random_lpips_params(torch.Generator().manual_seed(seed))


def _assert_grads_close(model, grads, quantizer):
    """The model's .grad against JAX gradients (a params tree), each tensor
    within TOL of its own largest value or of 1e-2 of the model's largest
    gradient, whichever is larger: a gradient that is zero in exact
    arithmetic (a bias before a GroupNorm, the key bias under the softmax)
    is f32 noise of ~1e-7 of the largest."""
    expected = state_dict_from_jax(model, {'params': grads, 'quantizer': quantizer})
    floor = 1e-2 * max(expected[name].abs().max().item()
                       for name, _ in model.named_parameters())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), expected[name], msg=f'grad {name}', floor=floor)


@pytest.mark.parametrize('perceptual_weight', [0.0, 1.0])
def test_loss_and_gradients_match_jax(perceptual_weight):
    """codebook_loss_fn against jax.value_and_grad of JAX's on uint8
    frames: the loss, every metric and every parameter's gradient (within
    TOL of the largest), at perceptual weight 0 and at 1 with random LPIPS
    parameters."""
    config = dataclasses.replace(ATTN, perceptual_weight=perceptual_weight)
    jmodel, variables = _jax_model(config)
    params = _lpips_params()
    lpips = LPIPS(params) if perceptual_weight else None
    jlpips = {k: jnp.asarray(v) for k, v in params.items()} if perceptual_weight else None
    batch = _images(3)
    # the LPIPS weights go in as an argument, not as constants of the program
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, q, b, lp: jcb.codebook_loss_fn(jmodel, config, lp, p, q, b), has_aux=True))
    (jloss, (jmetrics, _)), jgrads = grad_fn(variables['params'], variables['quantizer'],
                                             jnp.asarray(batch), jlpips)
    model = _port_model(config, variables)
    loss, metrics = tcb.codebook_loss_fn(model, to_port(config), lpips,
                                         torch.from_numpy(batch))
    loss.backward()
    _close(loss.item(), jloss, msg='loss')
    assert list(metrics) == ['p_loss', 'rec_loss', 'quant_loss', 'total_loss', 'perplexity']
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        _close(metrics[key].item(), value, msg=key)
    if perceptual_weight:
        assert metrics['p_loss'].item() > 0
    _assert_grads_close(model, jax.device_get(jgrads), variables['quantizer'])


def test_missing_lpips_logs_nan():
    """perceptual_weight > 0 without LPIPS: the term is dropped and p_loss
    is NaN, as in the JAX package."""
    config = to_port(dataclasses.replace(TINY, perceptual_weight=1.0))
    model = VQGAN(config, generator=torch.Generator().manual_seed(0))
    loss, metrics = tcb.codebook_loss_fn(model, config, None, torch.from_numpy(_images(4)))
    assert np.isnan(metrics['p_loss'].item()) and np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), metrics['rec_loss'].item()
                               + metrics['quant_loss'].item(), rtol=1e-6)


# After Adam updates (lr 1e-3; a first update is about lr * sign(g)) the
# parameters agree to the f32 noise of the gradients; 2e-5 absolute is 2% of
# one update and fails on a wrong moment, clip or accumulation. Adam divides
# by |g| + 1e-8, so an element whose gradient is near 0 (below NULL_GRAD,
# 100 Adam epsilons, at some step: all of a bias before a GroupNorm or the
# key bias under the softmax, which change no output, and a few others)
# moves by the normalised f32 noise of its gradient in both packages; those
# elements, under 1% of all, are left out of the comparison.
PARAM_TOL = 2e-5
NULL_GRAD = 1e-6
STEP_CASES = {
    '1-step': (1, {}, 1),
    '3-steps': (3, {}, 1),
    '3-steps-clip': (3, {'gradient_clip_val': 1.0}, 1),  # the norms are ~2
    '3-steps-accumulate-2': (3, {}, 2),
}


_JAX_STEPS = {}


def _jax_steps(config, accumulate):
    """JAX's run of 3 make_codebook_train_step calls over the uint8 batches
    _images(10 + i), from the state init_codebook_state(PRNGKey(0)) builds
    (built here from _jax_model's variables, which come from the same keys,
    so the weights are not drawn again): (initial variables, [(metrics,
    state) after each call]), shared by the cases that differ in their
    number of steps only."""
    key = (repr(config), accumulate)
    if key not in _JAX_STEPS:
        optimizer = jcb.create_codebook_optimizer(config, accumulate)
        _, variables = _jax_model(config)
        jmodel = jcb.create_codebook_model(config, jnp.float32, remat=False)
        params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
        state = jcb.CodebookTrainState(params, jax.tree_util.tree_map(
            jnp.asarray, variables['quantizer']), optimizer.init(params),
            jnp.zeros((), jnp.int32))
        jstep = jcb.make_codebook_train_step(jmodel, config, optimizer, donate=False)
        after = []
        for i in range(3):
            state, jmetrics = jstep(state, jnp.asarray(_images(10 + i)))
            after.append((jax.device_get(jmetrics), state))
        _JAX_STEPS[key] = variables, after
    return _JAX_STEPS[key]


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_train_steps_match_jax(case):
    """n train steps from the same weights on the same uint8 batches
    against make_codebook_train_step (optax.MultiSteps where accumulating):
    metrics of each step, parameters and quantizer state after. With
    accumulation the third call leaves the parameters where the second put
    them, and the running mean of the gradients equals MultiSteps'."""
    n, overrides, accumulate = STEP_CASES[case]
    config = dataclasses.replace(ATTN, **overrides)
    variables, jax_after = _jax_steps(config, accumulate)
    model, tstate = tcb.init_codebook_state(to_port(config), dtype=torch.float32,
                                            device='cpu', remat=True,
                                            accumulate_grad_batches=accumulate)
    model.load_state_dict(state_dict_from_jax(model, variables))
    tstep = tcb.make_codebook_train_step(model, to_port(config))
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    for i in range(n):
        jmetrics, state = jax_after[i]
        tstate, metrics = tstep(tstate, torch.from_numpy(_images(10 + i)))
        for key, value in jmetrics.items():
            _close(metrics[key].item(), value, msg=f'step {i + 1} {key}')
        small = {name: p.grad.abs() < NULL_GRAD for name, p in model.named_parameters()}
        null = small if i == 0 else {name: null[name] | small[name] for name in null}
        if i == 0:
            if case == '3-steps-clip':
                norm = torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters()))
                assert norm.item() == pytest.approx(1.0, rel=1e-4)
        if accumulate > 1 and i == 1:
            after_update = {name: p.detach().clone() for name, p in model.named_parameters()}
    assert tstate.step == n == int(state.step)
    expected = state_dict_from_jax(model, jax.device_get(
        {'params': state.params, 'quantizer': state.quantizer}))
    for name, p in model.named_parameters():
        assert not torch.equal(p, before[name]), f'{name} did not move'
        if accumulate > 1:
            assert torch.equal(p, after_update[name]), f'{name} moved between updates'
        keep = ~null[name]
        np.testing.assert_allclose(p.detach()[keep].numpy(), expected[name][keep], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    excluded = sum(m.sum().item() for m in null.values())
    assert excluded < 0.01 * sum(m.numel() for m in null.values()), excluded
    for name, value in _quantizer_state(model).items():
        _close(value, expected[f'quantizer.{name}'], STATE_TOL, name)
    if accumulate > 1:
        assert tstate.mini_step == 1 and int(state.opt_state.mini_step) == 1
        jacc = state_dict_from_jax(model, jax.device_get(
            {'params': state.opt_state.acc_grads, 'quantizer': state.quantizer}))
        # the third batch's gradient, at parameters that agree to PARAM_TOL
        floor = 1e-2 * max(g.abs().max().item() for g in jacc.values())
        for (name, _), acc in zip(model.named_parameters(), tstate.acc_grads):
            _close(acc.numpy(), jacc[name], 1e-3, f'accumulated {name}', floor)


def test_eval_step_matches_jax():
    """make_codebook_eval_step's metrics (psnr among them) and dec against
    JAX's, at perceptual weight 1 with random LPIPS parameters; the EMA
    state does not move."""
    config = dataclasses.replace(ATTN, perceptual_weight=1.0)
    jmodel, variables = _jax_model(config)
    params = _lpips_params(1)
    jstate = jcb.CodebookTrainState(variables['params'], variables['quantizer'], None, 0)
    jmetrics, jdec = jcb.make_codebook_eval_step(
        jmodel, config, {k: jnp.asarray(v) for k, v in params.items()})(
            jstate, jnp.asarray(_images(5)))
    model = _port_model(config, variables)
    before = _quantizer_state(model)
    metrics, dec = tcb.make_codebook_eval_step(model, to_port(config), LPIPS(params))(
        None, torch.from_numpy(_images(5)))
    assert set(metrics) == set(jmetrics)
    for key, value in jax.device_get(jmetrics).items():
        _close(metrics[key].item(), value, msg=key)
    _close(dec.numpy(), jdec, msg='dec')
    for name, value in _quantizer_state(model).items():
        np.testing.assert_array_equal(value, before[name])


def test_load_model_reads_a_codebook_job(tmp_path):
    """A train_codebook checkpoint ({'model', 'optimizer', 'step'}) loads
    through load_model: f32 as saved; in bf16 the convolutions are bf16 and
    the codebook and its state stay f32."""
    config = to_port(ATTN)
    model, state = tcb.init_codebook_state(config, torch.Generator().manual_seed(0),
                                           device='cpu')
    mgr = CheckpointManager(str(tmp_path), config)
    mgr.save(3, tcb._checkpoint_state(model, state))
    mgr.close()
    loaded = load_model(str(tmp_path), device='cpu')
    for name, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name
    half = load_model(str(tmp_path), torch.bfloat16, device='cpu')
    assert half.quant_conv.weight.dtype == torch.bfloat16
    assert half.quantizer.embeddings.dtype == torch.float32
    assert half.encoder.norm_out.weight.dtype == torch.float32
