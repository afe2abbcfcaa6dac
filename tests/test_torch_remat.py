"""The port's remat policies (train/transformer.resolve_remat_policy,
MIGT(remat_policy=...)) against the port's own full remat and no remat, and
the 'attn' policy against the JAX package's, at a tiny config on the CPU
(the attention takes its plain twins; JAX its dense path)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import to_port
from viewformer_tpu.config import MIGTConfig, VQGANConfig
from viewformer_tpu.train import transformer as jtt
from viewformer_tpu.utils.schedules import Schedule
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.ops import attention_cuda
from viewformer_tpu_torch.train import transformer as ttt
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

CONFIG = MIGTConfig(n_embeddings=16, n_head=4, d_model=64, n_layer=2, dropout=0.0,
                    sequence_size=3, token_image_size=4, total_steps=100, n_loss_skip=1,
                    learning_rate=1e-3, weight_decay=0.01, batch_size=4,
                    localization_weight=Schedule.from_str('1'))
CODEBOOK = VQGANConfig(n_embed=16)
POLICIES = ('full', 'attn', 'attn_mlp', 'dots', 'nothing')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tensors here are tiny, and the CPU's thread
    pool only adds contention when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, B=4):
    rng = np.random.RandomState(seed)
    poses = rng.randn(B, CONFIG.sequence_size, 7).astype(np.float32)
    poses[..., 3:] /= np.linalg.norm(poses[..., 3:], axis=-1, keepdims=True)
    size = CONFIG.token_image_size
    return poses, rng.randint(0, 16, (B, CONFIG.sequence_size, size, size))


def _train(dropout, steps=2, **kwargs):
    """`steps` port train steps in f32 on the CPU from generator seed 0 on one
    batch, each step's seed words from generator seed 7 + step: (losses,
    state_dict)."""
    config = to_port(dataclasses.replace(CONFIG, dropout=dropout))
    model, state = ttt.init_transformer_state(config, torch.Generator().manual_seed(0),
                                              torch.float32, 'cpu', warmup_steps=1, **kwargs)
    step = ttt.make_transformer_train_step(model, config)
    batch = tuple(torch.from_numpy(x) for x in _batch())
    losses = []
    for i in range(steps):
        state, metrics = step(state, batch, torch.Generator().manual_seed(7 + i))
        losses.append(metrics['loss'])
    return losses, model.state_dict()


@pytest.fixture(scope='module', params=[0.0, 0.1], ids=['dropout0', 'dropout0.1'])
def reference(request):
    """The full-remat and no-remat runs at one dropout rate."""
    dropout = request.param
    return dropout, _train(dropout, remat=True), _train(dropout, remat=False)


def _assert_equal(run, expected):
    (losses, params), (expected_losses, expected_params) = run, expected
    for loss, expected_loss in zip(losses, expected_losses):
        torch.testing.assert_close(loss, expected_loss, rtol=0, atol=0)
    assert params.keys() == expected_params.keys()
    for name, value in params.items():
        torch.testing.assert_close(value, expected_params[name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize('policy', POLICIES)
def test_policy_matches_full_remat_bit_for_bit(reference, policy):
    """Two train steps under each policy give the losses and parameters of
    full remat, and of no remat, bit for bit: a policy chooses only what the
    recompute takes from the forward (the counterpart of the JAX package's
    test_remat_policy_dots_matches_full_remat)."""
    dropout, full, no_remat = reference
    run = _train(dropout, remat=True, remat_policy=policy)
    _assert_equal(run, full)
    _assert_equal(run, no_remat)


@pytest.mark.parametrize('dropout,forward', [
    (0.0, ('block_causal_attention_fwd', 'branch_attention_fwd')),
    (0.1, ('block_causal_attention_dropout_fwd', 'branch_attention_dropout_fwd'))])
def test_attn_recompute_runs_no_forward_attention(monkeypatch, dropout, forward):
    """Under 'attn' and 'attn_mlp' a train step calls each forward attention
    op once a layer (the forward); under full, dots and nothing twice (the
    forward and the recompute). Counted on the wrappers the ops call, which
    on CPU tensors take the plain twins."""
    calls = {name: 0 for name in forward}
    for name in forward:
        def counted(*args, _fn=getattr(attention_cuda, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(attention_cuda, name, counted)
    for policy, runs in (('attn', 1), ('attn_mlp', 1), ('full', 2), ('dots', 2),
                         ('nothing', 2)):
        calls.update((name, 0) for name in forward)
        _train(dropout, steps=1, remat=True, remat_policy=policy)
        assert calls == {name: runs * CONFIG.n_layer for name in forward}, policy


def test_resolve_remat_policy():
    assert ttt.resolve_remat_policy(None) is None
    assert ttt.resolve_remat_policy('full') is None
    assert ttt.resolve_remat_policy('nothing') is None
    assert len(ttt.resolve_remat_policy('attn')) == 4
    assert set(ttt.resolve_remat_policy('attn')) < set(ttt.resolve_remat_policy('attn_mlp'))
    assert torch.ops.viewformer.mlp_fc.default in ttt.resolve_remat_policy('dots')
    for module in (ttt, jtt):
        with pytest.raises(ValueError, match=r"unknown remat policy 'everything' "
                                             r"\(full\|attn\|attn_mlp\|dots\|nothing\)"):
            module.resolve_remat_policy('everything')


def test_attn_step_matches_jax():
    """Two train steps under 'attn' from JAX's initial weights on one batch
    (warmup_steps=2: updates at lr 0 and lr/2) against the JAX package's
    'attn' steps: metrics each step, then the parameters through the
    bridge."""
    optimizer, _ = jtt.create_transformer_optimizer(CONFIG, warmup_steps=2)
    jmodel, jstate = jtt.init_transformer_state(CONFIG, jax.random.PRNGKey(0), optimizer,
                                                remat=True, remat_policy='attn')
    jstep = jtt.make_transformer_train_step(jmodel, CONFIG, optimizer, donate=False)
    poses, tokens = _batch(1)
    initial = jax.device_get(jstate.params)
    model, state = ttt.init_transformer_state(to_port(CONFIG), dtype=torch.float32,
                                              device='cpu', warmup_steps=2,
                                              remat_policy='attn')
    model.load_state_dict(state_dict_from_jax(model, {'params': initial}))
    step = ttt.make_transformer_train_step(model, to_port(CONFIG))
    batch = (torch.from_numpy(poses), torch.from_numpy(tokens))
    for _ in range(2):
        jstate, expected = jstep(jstate, (jnp.asarray(poses), jnp.asarray(tokens)),
                                 jax.random.PRNGKey(0))
        state, metrics = step(state, batch)
        assert set(metrics) == set(expected)
        for key in metrics:
            np.testing.assert_allclose(metrics[key].numpy(), np.asarray(expected[key]),
                                       rtol=2e-5, atol=2e-5, err_msg=key)
    updated = state_dict_from_jax(model, {'params': jax.device_get(jstate.params)})
    d = CONFIG.d_model
    for name, value in model.state_dict().items():
        value, expected = value.numpy(), updated[name].numpy()
        if name.endswith('attn.c_attn.bias'):
            # the key third has a zero true gradient; Adam turns its rounding
            # noise into updates of up to lr * |g| / eps, different in each
            # framework (test_torch_train.test_train_steps_match_jax)
            np.testing.assert_allclose(value[2 * d:], expected[2 * d:], atol=5e-5, err_msg=name)
            value, expected = value[:2 * d], expected[:2 * d]
        np.testing.assert_allclose(value, expected, atol=2e-5, err_msg=name)


@pytest.mark.parametrize('command', ['transformer', 'finetune-transformer'])
def test_cli_takes_every_remat_policy(monkeypatch, command):
    """`train transformer` and `train finetune-transformer` take the five
    names and pass the policy to train_transformer ('full' as None)."""
    seen = []
    monkeypatch.setattr(ttt, 'train_transformer', lambda *a, **kw: seen.append(kw))
    # the codebook's config for `transformer`, the base job's for finetuning
    config = (to_port(CODEBOOK) if command == 'transformer' else to_port(CONFIG))
    monkeypatch.setattr(cli, 'load_config', lambda path: config)
    base = ['train', command, '--dataset', 'D', '--job-dir', 'J', '--device', 'cpu']
    base += (['--codebook-model', 'C'] if command == 'transformer' else ['--checkpoint', 'C'])
    for policy in POLICIES:
        cli.main(base + ['--remat-policy', policy])
    assert [kw['remat_policy'] for kw in seen] == [None, 'attn', 'attn_mlp', 'dots', 'nothing']
    with pytest.raises(SystemExit):
        cli.main(base + ['--remat-policy', 'everything'])
