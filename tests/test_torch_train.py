"""The port's one-shot MIGT forward, losses and train step
(viewformer_tpu_torch.models.migt, .train.transformer) against the JAX
package at tiny configs, with weights through the bridge. Everything runs in
f32 on the CPU, where the attention takes its plain twins (JAX: the dense
path, or with dropout the fused path in interpret mode), so the tolerances
are f32 reassociation."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax.core import scope as flax_scope

from test_torch_config import to_port
from test_torch_dropout import pallas_interpret
from test_train_transformer import TINY
from viewformer_tpu.models import migt as jmigt
from viewformer_tpu.models.migt import MIGT
from viewformer_tpu.ops import branching_attention as jba
from viewformer_tpu.ops import dropout as jdropout
from viewformer_tpu.train import transformer as jtt
from viewformer_tpu.utils.schedules import Schedule
from viewformer_tpu_torch.models.migt import MIGT as TorchMIGT
from viewformer_tpu_torch.train import transformer as ttt
from viewformer_tpu_torch.utils import jax_random
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

VARIANTS = {
    'localization': TINY,
    'no_localization': dataclasses.replace(TINY, localization_weight=Schedule.zero()),
    'dynamic_smoothing': dataclasses.replace(TINY, use_dynamic_pose_loss=True,
                                             label_smoothing=0.1),
    'scheduled': dataclasses.replace(TINY, localization_weight=Schedule.from_str(
        'linear(0,2,100)'), n_loss_skip=0, image_generation_weight=0.5),
}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, B=2, T=4):
    rng = np.random.RandomState(seed)
    poses = rng.randn(B, T, 7).astype(np.float32)
    poses[..., 3:] /= np.linalg.norm(poses[..., 3:], axis=-1, keepdims=True)
    return poses, rng.randint(0, 16, (B, T, 2, 2))


def _port(config, params, **kwargs):
    model = TorchMIGT(to_port(config), generator=torch.Generator().manual_seed(0), **kwargs)
    model.load_state_dict(state_dict_from_jax(model, {'params': jax.device_get(params)}))
    return model


def _close(port, expected, tol=2e-5):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(port).detach()),
                               np.asarray(expected), rtol=tol, atol=tol)


@pytest.fixture(scope='module', params=sorted(VARIANTS))
def variant(request):
    config = VARIANTS[request.param]
    poses, tokens = _batch(0)
    jmodel = MIGT(config)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(poses), jnp.asarray(tokens),
                         compute_losses=True)['params']
    return config, jmodel, params, _port(config, params), poses, tokens


def test_one_shot_forward_losses_match_jax(variant):
    config, jmodel, params, port, poses, tokens = variant
    expected = jmodel.apply({'params': params}, jnp.asarray(poses), jnp.asarray(tokens),
                            compute_losses=True, step=30)
    with torch.no_grad():
        out = port(torch.from_numpy(poses), torch.from_numpy(tokens), compute_losses=True,
                   step=30)
    assert set(out) == set(expected)
    for key in sorted(set(out) - {'hidden_states'}):
        _close(out[key], expected[key])
    for p, e in zip(out['hidden_states'], expected['hidden_states']):
        _close(p, e)


def test_one_shot_eval_forward_matches_jax(variant):
    """Eval forward, stream 0 only. With localization on, 3 posed frames and
    one more frame, which takes the localization token as its pose."""
    config, jmodel, params, port, poses, tokens = variant
    posed = 3 if port.use_localization else 4
    expected = jmodel.apply({'params': params}, jnp.asarray(poses[:, :posed]),
                            jnp.asarray(tokens))
    with torch.no_grad():
        out = port(torch.from_numpy(poses[:, :posed]), torch.from_numpy(tokens))
    assert out['logits'].shape == (2, 4, 2, 2, 16)
    _close(out['logits'], expected['logits'])
    assert ('pose_prediction' in out) == ('pose_prediction' in expected)
    if 'pose_prediction' in out:
        _close(out['pose_prediction'], expected['pose_prediction'])


TRAIN_CONFIGS = {
    'tiny': TINY,
    'dynamic_clip_smoothing': dataclasses.replace(TINY, use_dynamic_pose_loss=True,
                                                  gradient_clip_val=0.05, label_smoothing=0.1),
}


@pytest.fixture(scope='module', params=sorted(TRAIN_CONFIGS))
def jax_training(request):
    """Three JAX train steps on one batch from JAX's initial weights, with
    warmup_steps=2 (updates at lr 0, lr/2, lr): the config, the initial
    parameters, each step's metrics, the parameters after each step, and the
    eval step after the last."""
    config = TRAIN_CONFIGS[request.param]
    optimizer, _ = jtt.create_transformer_optimizer(config, warmup_steps=2)
    jmodel, jstate = jtt.init_transformer_state(config, jax.random.PRNGKey(0), optimizer)
    jstep = jtt.make_transformer_train_step(jmodel, config, optimizer, donate=False)
    poses, tokens = _batch(1, B=4)
    batch = (jnp.asarray(poses), jnp.asarray(tokens))
    initial, metrics, params = jax.device_get(jstate.params), [], []
    for _ in range(3):
        jstate, step_metrics = jstep(jstate, batch, jax.random.PRNGKey(0))
        metrics.append(jax.device_get(step_metrics))
        params.append(jax.device_get(jstate.params))
    assert int(jstate.step) == 3
    evaluation = jtt.make_transformer_eval_step(jmodel, config)(jstate, batch)
    return config, initial, metrics, params, jax.device_get(evaluation), (poses, tokens)


@pytest.mark.parametrize('n_steps', [1, 3])
def test_train_steps_match_jax(jax_training, n_steps):
    """n port train steps from JAX's initial weights on the same batch:
    metrics each step, then the updated parameters through the bridge; after
    3 steps, the eval step."""
    config, initial, jax_metrics, jax_params, (jax_eval, jax_logits), (poses, tokens) = \
        jax_training
    model, state = ttt.init_transformer_state(to_port(config), dtype=torch.float32,
                                              device='cpu', warmup_steps=2)
    model.load_state_dict(state_dict_from_jax(model, {'params': initial}))
    step = ttt.make_transformer_train_step(model, to_port(config))
    batch = (torch.from_numpy(poses), torch.from_numpy(tokens))
    for expected in jax_metrics[:n_steps]:
        state, metrics = step(state, batch)
        assert set(metrics) == set(expected)
        for key in metrics:
            _close(metrics[key], expected[key])
    assert state.step == n_steps
    updated = state_dict_from_jax(model, {'params': jax_params[n_steps - 1]})
    d = config.d_model
    for name, value in model.state_dict().items():
        value, expected = value.numpy(), updated[name].numpy()
        if name.endswith('attn.c_attn.bias'):
            # the key third (chunks v, q, k) has a zero true gradient: adding
            # q.b_k to a whole row of scores leaves the softmax unchanged.
            # Adam turns its rounding noise (|g| < 1e-10) into updates of up
            # to lr * |g| / eps = 1e-5 each, different in each framework.
            np.testing.assert_allclose(value[2 * d:], expected[2 * d:], atol=5e-5, err_msg=name)
            value, expected = value[:2 * d], expected[:2 * d]
        # an Adam update moves a weight by up to lr = 1e-3
        np.testing.assert_allclose(value, expected, atol=1e-5, err_msg=name)
    if n_steps == 3:
        metrics, logits = ttt.make_transformer_eval_step(model, to_port(config))(state, batch)
        assert set(metrics) == set(jax_eval)
        for key in metrics:
            _close(metrics[key], jax_eval[key])
        _close(logits, jax_logits, tol=1e-4)


def test_random_pose_multiplier_draws_from_generator():
    """Training draws a per-sample pose scale m = random_pose_multiplier ** u,
    u ~ U(-1, 1), from the generator it is given: the same seed gives the
    same losses, another seed others, and eval (deterministic) draws none.
    m multiplies the input positions and divides the predicted ones, so the
    training forward equals the eval forward on positions scaled by the
    same draw, with its predicted positions scaled back."""
    config = dataclasses.replace(TINY, random_pose_multiplier=2.0)
    model = TorchMIGT(to_port(config), generator=torch.Generator().manual_seed(0))
    poses, tokens = (torch.from_numpy(x) for x in _batch(3))

    def run(seed=None, deterministic=False):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(poses, tokens, compute_losses=True, deterministic=deterministic,
                         generator=gen)['loss']

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.allclose(run(0), run(1))
    torch.testing.assert_close(run(deterministic=True), run(5, deterministic=True),
                               rtol=0, atol=0)
    assert not torch.allclose(run(0), run(deterministic=True))
    u = torch.rand(2, generator=torch.Generator().manual_seed(0)) * 2 - 1
    scaled = poses.clone()
    scaled[..., :3] *= (2.0 ** u)[:, None, None]
    with torch.no_grad():
        drawn = model(poses, tokens, deterministic=False,
                      generator=torch.Generator().manual_seed(0))['pose_prediction']
        fixed = model(scaled, tokens)['pose_prediction']
    torch.testing.assert_close(drawn[..., :3] * (2.0 ** u)[:, None, None, None], fixed[..., :3])
    torch.testing.assert_close(drawn[..., 3:], fixed[..., 3:])


def test_train_step_refuses_dropout():
    """The port reproduces dropout_impl='hash' only: 'rng' (threefry noise)
    raises, and a training forward with dropout needs one seed pair a site."""
    config = dataclasses.replace(TINY, dropout=0.1)
    with pytest.raises(ValueError, match="dropout_impl='rng' is not ported"):
        ttt.init_transformer_state(to_port(config), dtype=torch.float32, device='cpu',
                                   dropout_impl='rng')
    model, state = ttt.init_transformer_state(to_port(config), dtype=torch.float32, device='cpu')
    poses, tokens = (torch.from_numpy(x) for x in _batch(2))
    assert model.dropout_sites(3) == 3 + 2 * 8
    for seeds in (None, [(1, 2)] * 18):
        with pytest.raises(ValueError, match='needs 19 dropout seed pairs'):
            model(poses, tokens, compute_losses=True, deterministic=False, dropout_seeds=seeds)
    assert state.step == 0


DROPOUT_SEED = 11  # the port's generator seed, each step


def _fused_interpret(monkeypatch):
    """MIGT's attention in the JAX package takes the fused path with its
    Pallas kernels in interpret mode (the hash-dropout kernels B5-B8)."""
    pallas_interpret(monkeypatch)
    monkeypatch.setattr(jmigt, 'multi_end_block_attention',
                        functools.partial(jba.multi_end_block_attention, use_fused=True))


def _route_jax_dropout(monkeypatch, words):
    """Make the JAX package draw the port's dropout seeds: _key_words returns
    the next pair of `words` in call order (a traced forward draws its sites
    in that order), and its attention takes the fused path in interpret
    mode. Returns the list of calls, for counting the sites a trace drew."""
    calls = []

    def key_words(key):
        pair = words[len(calls) % len(words)]
        calls.append(pair)
        return jnp.uint32(pair[0]), jnp.uint32(pair[1])

    monkeypatch.setattr(jdropout, '_key_words', key_words)
    _fused_interpret(monkeypatch)
    return calls


DROPOUT_CONFIGS = {
    'tiny': dataclasses.replace(TINY, dropout=0.1),
    'no_localization': dataclasses.replace(TINY, dropout=0.1,
                                           localization_weight=Schedule.zero()),
}


@pytest.fixture(scope='module', params=sorted(DROPOUT_CONFIGS))
def jax_dropout_training(request):
    """Three JAX train steps at dropout 0.1 (dropout_impl='hash', no remat)
    on one batch, every step drawing the port's seeds of one step (the jitted
    step traces once): as jax_training, plus those seeds."""
    config = DROPOUT_CONFIGS[request.param]
    port_model, _ = ttt.init_transformer_state(to_port(config), dtype=torch.float32,
                                               device='cpu')
    words = ttt.draw_dropout_seeds(port_model, torch.Generator().manual_seed(DROPOUT_SEED))
    with pytest.MonkeyPatch.context() as monkeypatch:
        calls = _route_jax_dropout(monkeypatch, words)
        optimizer, _ = jtt.create_transformer_optimizer(config, warmup_steps=2)
        jmodel, jstate = jtt.init_transformer_state(config, jax.random.PRNGKey(0), optimizer,
                                                    dropout_impl='hash', remat=False)
        jstep = jtt.make_transformer_train_step(jmodel, config, optimizer, donate=False)
        poses, tokens = _batch(1, B=4)
        batch = (jnp.asarray(poses), jnp.asarray(tokens))
        initial, metrics, params = jax.device_get(jstate.params), [], []
        for _ in range(3):
            jstate, step_metrics = jstep(jstate, batch, jax.random.PRNGKey(0))
            metrics.append(jax.device_get(step_metrics))
            params.append(jax.device_get(jstate.params))
        # one trace drew one key a site, in the port's site count
        assert len(calls) == len(words) == port_model.dropout_sites(
            2 + port_model.use_localization)
    return config, initial, metrics, params, (poses, tokens)


@pytest.mark.parametrize('n_steps', [1, 3])
def test_dropout_train_steps_match_jax(jax_dropout_training, n_steps):
    """n port train steps at dropout 0.1 against JAX's with the same seed
    words at every site: metrics each step, then the parameters."""
    config, initial, jax_metrics, jax_params, (poses, tokens) = jax_dropout_training
    model, state = ttt.init_transformer_state(to_port(config), dtype=torch.float32,
                                              device='cpu', warmup_steps=2)
    model.load_state_dict(state_dict_from_jax(model, {'params': initial}))
    step = ttt.make_transformer_train_step(model, to_port(config))
    batch = (torch.from_numpy(poses), torch.from_numpy(tokens))
    for expected in jax_metrics[:n_steps]:
        state, metrics = step(state, batch, torch.Generator().manual_seed(DROPOUT_SEED))
        assert set(metrics) == set(expected)
        for key in metrics:
            _close(metrics[key], expected[key])
    updated = state_dict_from_jax(model, {'params': jax_params[n_steps - 1]})
    d = config.d_model
    for name, value in model.state_dict().items():
        value, expected = value.numpy(), updated[name].numpy()
        if name.endswith('attn.c_attn.bias'):  # as in test_train_steps_match_jax
            np.testing.assert_allclose(value[2 * d:], expected[2 * d:], atol=5e-5, err_msg=name)
            value, expected = value[:2 * d], expected[:2 * d]
        np.testing.assert_allclose(value, expected, atol=1e-5, err_msg=name)


# `train transformer --seed JAX_KEYS_SEED`: dropout on, the pose multiplier on
JAX_KEYS_SEED = 1337
JAX_KEYS_CONFIG = dataclasses.replace(TINY, dropout=0.1, random_pose_multiplier=1.5)


def _jax_site_words(config, dropout_rng):
    """The key data of every dropout site's key that the JAX package's
    training forward makes from the step's 'dropout' key, in its draw
    order, computed by flax and jax: the root's make_rng a stream's
    embedding dropout, then a layer's attention key split in two by
    multi_end_block_attention, one key a stream's attention output and one
    a stream's MLP output."""
    n = 2 + (not config.localization_weight.is_zero())

    def key(*path):
        return flax_scope.LazyRng.create(dropout_rng, *path).as_jax_rng()
    keys = [key(c) for c in range(1, n + 1)]
    for i in range(config.n_layer):
        keys += list(jax.random.split(key(f'h_{i}', 'attn', 1)))
        keys += [key(f'h_{i}', 'attn', c) for c in range(2, n + 2)]
        keys += [key(f'h_{i}', 'mlp', c) for c in range(1, n + 1)]
    return [[int(w) for w in np.asarray(k)] for k in keys]


def test_train_steps_from_jax_keys_match_jax(monkeypatch):
    """`train transformer --seed S` in both packages, without touching the
    JAX package's key derivation: the port starts from init_transformer_state
    (jax_seed=S) and each step draws from PRNGKey(S + 1) (jax_step_draws);
    JAX's train step runs dropout_impl='hash' with remat on the fused path
    (Pallas in interpret mode) from its own init of PRNGKey(S). Each of 3
    steps: the port's seed words equal the key data of JAX's site keys in
    draw order, its pose noise equals JAX's uniform draw and
    random_pose_multiplier ** noise XLA's pow, bit for bit; the metrics and
    then the parameters within this file's bounds."""
    config = JAX_KEYS_CONFIG
    _fused_interpret(monkeypatch)
    optimizer, _ = jtt.create_transformer_optimizer(config, warmup_steps=2)
    jmodel, jstate = jtt.init_transformer_state(config, jax.random.PRNGKey(JAX_KEYS_SEED),
                                                optimizer, dropout_impl='hash')
    jstep = jtt.make_transformer_train_step(jmodel, config, optimizer, donate=False)
    model, state = ttt.init_transformer_state(to_port(config), dtype=torch.float32, device='cpu',
                                              warmup_steps=2, jax_seed=JAX_KEYS_SEED)
    step = ttt.make_transformer_train_step(model, to_port(config))
    poses, tokens = _batch(1, B=4)
    rng = jax.random.PRNGKey(JAX_KEYS_SEED + 1)
    port_rng = jax_random.prng_key(JAX_KEYS_SEED + 1)
    for n in range(3):
        dropout_rng, pose_rng = jax.random.split(jax.random.fold_in(rng, n))
        seeds, noise = ttt.jax_step_draws(model, port_rng, n, 4)
        assert seeds == _jax_site_words(config, dropout_rng)
        assert len(seeds) == model.dropout_sites(3)
        u = jax.random.uniform(flax_scope.LazyRng.create(pose_rng, 1).as_jax_rng(), (4,),
                               jnp.float32, -1.0, 1.0)
        np.testing.assert_array_equal(noise.view(np.uint32), np.asarray(u).view(np.uint32))
        multiplier = np.asarray(jnp.float32(config.random_pose_multiplier) ** u)
        np.testing.assert_array_equal(
            jax_random.power(config.random_pose_multiplier, noise).view(np.uint32),
            multiplier.view(np.uint32))
        jstate, expected = jstep(jstate, (jnp.asarray(poses), jnp.asarray(tokens)), rng)
        state, metrics = step(state, (torch.from_numpy(poses), torch.from_numpy(tokens)),
                              port_rng)
        assert step.draw_ms is not None
        expected = jax.device_get(expected)
        assert set(metrics) == set(expected)
        for key in metrics:
            _close(metrics[key], expected[key])
    updated = state_dict_from_jax(model, {'params': jax.device_get(jstate.params)})
    d = config.d_model
    for name, value in model.state_dict().items():
        value, expected = value.numpy(), updated[name].numpy()
        if name.endswith('attn.c_attn.bias'):  # as in test_train_steps_match_jax
            np.testing.assert_allclose(value[2 * d:], expected[2 * d:], atol=5e-5, err_msg=name)
            value, expected = value[:2 * d], expected[:2 * d]
        np.testing.assert_allclose(value, expected, atol=1e-5, err_msg=name)


def test_dropout_forward_matches_jax(monkeypatch):
    """The training forward at dropout 0.1 (every dropout site on) against
    JAX's with the same seed words: losses and all three streams' hidden
    states."""
    config = DROPOUT_CONFIGS['tiny']
    poses, tokens = _batch(4)
    jmodel = MIGT(config, dropout_impl='hash')
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(poses), jnp.asarray(tokens),
                         compute_losses=True)['params']
    port = _port(config, params)
    words = ttt.draw_dropout_seeds(port, torch.Generator().manual_seed(5))
    calls = _route_jax_dropout(monkeypatch, words)
    expected = jmodel.apply({'params': params}, jnp.asarray(poses), jnp.asarray(tokens),
                            compute_losses=True, deterministic=False, step=30,
                            rngs={'dropout': jax.random.PRNGKey(2)})
    assert len(calls) == len(words)
    with torch.no_grad():
        out = port(torch.from_numpy(poses), torch.from_numpy(tokens), compute_losses=True,
                   deterministic=False, step=30, dropout_seeds=words)
        undropped = port(torch.from_numpy(poses), torch.from_numpy(tokens), compute_losses=True,
                         step=30)
    for key in ('loss', 'ce_loss', 'pose_loss', 'logits'):
        _close(out[key], expected[key])
    for p, e in zip(out['hidden_states'], expected['hidden_states']):
        _close(p, e)
    assert not torch.allclose(out['loss'], undropped['loss'])


def test_dropout_remat_and_seeds():
    """With dropout on, remat (the recompute regenerates the masks from the
    seeds passed in) gives the gradients of no remat exactly; the same
    generator seed gives the same loss, another seed another loss."""
    config = DROPOUT_CONFIGS['tiny']
    batch = tuple(torch.from_numpy(x) for x in _batch(6))

    def run(remat, seed):
        model, state = ttt.init_transformer_state(to_port(config), torch.Generator().manual_seed(0),
                                                  dtype=torch.float32, device='cpu',
                                                  remat=remat)
        state, metrics = ttt.make_transformer_train_step(model, to_port(config))(
            state, batch, torch.Generator().manual_seed(seed))
        return metrics['loss'], {name: p.grad for name, p in model.named_parameters()}

    loss, grads = run(False, 0)
    remat_loss, remat_grads = run(True, 0)
    torch.testing.assert_close(remat_loss, loss, rtol=0, atol=0)
    for name, grad in grads.items():
        torch.testing.assert_close(remat_grads[name], grad, rtol=0, atol=0, msg=name)
    assert not torch.allclose(run(True, 1)[0], loss)


@pytest.mark.parametrize('augment,split', [('relative', 'train'), ('no', 'train'),
                                           ('simple', 'train'), ('advanced', 'train'),
                                           ('simple', 'test')])
def test_process_batch_matches_jax(augment, split):
    rng = np.random.RandomState(3)
    q = rng.randn(5, 4)
    cameras = np.concatenate([rng.randn(5, 3), q / np.linalg.norm(q, axis=-1, keepdims=True)],
                             -1).astype(np.float32)
    tokens = rng.randint(0, 16, (5, 2, 2))
    expected, expected_tokens = jtt.process_batch(cameras, tokens, augment, split,
                                                  rng=np.random.RandomState(7))
    port, port_tokens = ttt.process_batch(cameras, tokens, augment, split,
                                          rng=np.random.RandomState(7))
    assert port.dtype == np.float32 and port.shape == (5, 7)
    np.testing.assert_allclose(port, expected, atol=2e-6)
    assert port_tokens is tokens and expected_tokens is tokens
    with pytest.raises(ValueError, match='not supported'):
        ttt.process_batch(cameras, tokens, 'sideways', 'train')


def test_warmup_cosine_schedule_matches_jax():
    jax_schedule = jtt.warmup_cosine_schedule(6.4e-4, 1000, warmup_steps=100)
    schedule = ttt.warmup_cosine_schedule(6.4e-4, 1000, warmup_steps=100)
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000):
        # JAX evaluates the schedule in f32: 1e-10 is ~1 f32 ulp of init_lr
        assert schedule(step) == pytest.approx(float(jax_schedule(step)), rel=1e-6, abs=1e-10)


def test_weight_decay_mask_matches_jax(jax_training):
    """The same parameters decayed: JAX's mask, as a tree of 0/1 arrays of
    the parameters' shapes, mapped through the bridge onto the port's
    names."""
    config, params = jax_training[:2]
    mask = jtt._weight_decay_mask(params)
    as_arrays = jax.tree.map(lambda p, m: np.full(np.shape(p), float(m)), params, mask)
    model = TorchMIGT(to_port(config))
    expected = {name: bool(t.flatten()[0]) for name, t in
                state_dict_from_jax(model, {'params': as_arrays}).items()}
    port = ttt._weight_decay_mask(model)
    assert port == expected
    assert port['wte.weight'] and port['wpe']
    assert port.get('pos_ori_weights', not config.use_dynamic_pose_loss)
    assert not port['h.0.ln_1.weight'] and not port['h.0.attn.c_attn.bias']
    optimizer, _ = ttt.create_transformer_optimizer(model, to_port(config))
    decayed = {id(p) for group in optimizer.param_groups if group['weight_decay'] > 0
               for p in group['params']}
    assert decayed == {id(p) for name, p in model.named_parameters() if port[name]}


def test_clip_per_tensor_norm_matches_jax():
    grads = {'a': np.full((3, 4), 0.5, np.float32),
             'b': np.random.RandomState(0).randn(7).astype(np.float32) * 1e-3,
             'c': np.zeros(2, np.float32)}
    expected, _ = jtt.clip_per_tensor_norm(0.1).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in grads.values()]
    for p, g in zip(params, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    ttt.clip_per_tensor_norm(params, 0.1)
    for p, key in zip(params, grads):
        _close(p.grad, expected[key], tol=1e-7)
