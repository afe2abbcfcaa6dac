"""The codebook stage of the colors quality gate over its many steps,
against the JAX package on the CPU: what the 1-3 step comparisons of
test_torch_codebook.py cannot see. The gate's flags reach train_codebook
alike through both CLIs; each loop's updates over the gate's 6000 steps,
and which batch each update takes; Adam's step (a constant learning rate,
no schedule) at every one of the 6000 steps; the EMA quantizer's update and
decay chained over 48 steps. The loader's batch order at the gate's flags
is test_torch_image_data.py's 'gate-flags' case.

The JAX gate (tools/quality_gate_colors.py) trains the codebook with
--steps-per-call 10, a TPU-only flag the port leaves out: JAX's loop pads
the last window of each 601-step epoch (one batch) with 9 repeats of that
batch, and the scan trains on them, so JAX makes 6090 updates, 90 of them
on a batch it has just taken, where the port makes 6000. The two loops
read the same 6000 batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import to_port
from viewformer_tpu import cli as jcli
from viewformer_tpu.config import VQGANConfig
from viewformer_tpu.data import pipeline as jpipeline
from viewformer_tpu.ops import quantizer as jq
from viewformer_tpu.parallel import mesh as jmesh
from viewformer_tpu.train import checkpoint as jcheckpoint
from viewformer_tpu.train import codebook as jcb
from viewformer_tpu.train import logging as jlogging
from viewformer_tpu_torch import cli as tcli
from viewformer_tpu_torch.models.vqgan import Quantizer
from viewformer_tpu_torch.ops import quantizer as tq
from viewformer_tpu_torch.train import codebook as tcb

# the codebook stage of both gates (tools/quality_gate_colors.py and
# viewformer_tpu_torch/tools/quality_gate.py), but --steps-per-call
GATE_FLAGS = ['--batch-size', '32', '--epochs', '10', '--learning-rate', '1.44e-4',
              '--perceptual-weight', '0', '--total-steps', '6000', '--seed', '42']
GATE_STEPS, GATE_EPOCHS, GATE_STEPS_PER_CALL = 6000, 10, 10


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gate_calls(monkeypatch):
    """(config, kwargs) with which each CLI's `train codebook` at the gate's
    flags calls train_codebook: {'jax': ..., 'port': ...}."""
    from click.testing import CliRunner

    seen = {}
    monkeypatch.setattr(jcb, 'train_codebook', lambda config, *a, **kw: seen.setdefault(
        'jax', (config, a, kw)))
    monkeypatch.setattr(tcb, 'train_codebook', lambda config, *a, **kw: seen.setdefault(
        'port', (config, a, kw)))
    result = CliRunner().invoke(jcli.main, ['train', 'codebook', '--dataset', 'D', '--job-dir',
                                            'J', '--steps-per-call',
                                            str(GATE_STEPS_PER_CALL)] + GATE_FLAGS)
    assert result.exit_code == 0, result.output
    tcli.main(['train', 'codebook', '--dataset', 'D', '--job-dir', 'J', '--device', 'cpu']
              + GATE_FLAGS)
    return seen


def test_gate_flags_reach_train_codebook_alike(monkeypatch):
    """The same config (learning rate 1.44e-4, batch 32, 6000 steps, no
    clip) and the same loop arguments; JAX's adds steps_per_call=10."""
    seen = _gate_calls(monkeypatch)
    (jconfig, jargs, jkw), (tconfig, targs, tkw) = seen['jax'], seen['port']
    assert dataclasses.asdict(to_port(jconfig)) == dataclasses.asdict(tconfig)
    assert tconfig.learning_rate == 1.44e-4 and tconfig.gradient_clip_val == 0
    assert jargs == targs == ('D', 'J')
    assert jkw.pop('steps_per_call') == GATE_STEPS_PER_CALL
    for key in ('wandb',):
        jkw.pop(key)
    tkw.pop('device')
    assert jkw == tkw
    assert tkw['total_steps'] == GATE_STEPS and tkw['epochs'] == GATE_EPOCHS
    assert tkw['batch_size'] == 32 and tkw['seed'] == 42 and tkw['use_bf16']


class _Batches:
    """A stand-in for load_image_dataset: batch i is filled with i (mod
    256) in its first byte row and i // 256 in its second, so an update
    names the batch it took."""

    def __init__(self, *args, split='train', repeat=None, **kwargs):
        self.n = 1 if split == 'test' else None
        self.state = None

    def __iter__(self):
        i = 0
        while self.n is None or i < self.n:
            batch = np.zeros((2, 2, 2, 3), np.uint8)
            batch[0], batch[1] = i % 256, i // 256
            yield batch
            i += 1

    def close(self):
        pass


def _batch_id(batch):
    batch = np.asarray(batch)
    return int(batch[0, 0, 0, 0]) + 256 * int(batch[1, 0, 0, 0])


class _NoSave:
    def __init__(self, *args, **kwargs):
        pass

    def save(self, *args, **kwargs):
        pass

    def close(self):
        pass


class _NoLog(_NoSave):
    def log(self, *args, **kwargs):
        pass

    def log_images(self, *args, **kwargs):
        pass


def _jax_updates(monkeypatch, config):
    """The batch ids of JAX's train_codebook's updates at the gate's
    flags, its train and eval steps, state, data, checkpoints and logs
    stood in for."""
    updates = []

    def multi_step(state, batches):
        updates.extend(_batch_id(b) for b in batches)
        return state, {'total_loss': jnp.zeros(())}

    monkeypatch.setattr(jcb, 'init_codebook_state', lambda *a, **kw: (None, {}))
    monkeypatch.setattr(jcb, 'make_codebook_multi_step', lambda *a, **kw: multi_step)
    monkeypatch.setattr(jcb, 'make_codebook_eval_step', lambda *a, **kw: (
        lambda state, batch: ({'total_loss': 0.0}, np.zeros((1, 2, 2, 3), np.float32))))
    monkeypatch.setattr(jmesh, 'replicate', lambda mesh, state: state)
    monkeypatch.setattr(jmesh, 'shard_batch', lambda mesh, batch, batch_dim=0: batch)
    monkeypatch.setattr(jpipeline, 'load_image_dataset', _Batches)
    monkeypatch.setattr(jcheckpoint, 'CheckpointManager', _NoSave)
    monkeypatch.setattr(jlogging, 'MetricLogger', _NoLog)
    jcb.train_codebook(config, 'D', 'J', total_steps=GATE_STEPS, epochs=GATE_EPOCHS,
                       batch_size=32, resume=False, seed=42,
                       steps_per_call=GATE_STEPS_PER_CALL, progress=False, profile_batch=0)
    return updates


def _port_updates(monkeypatch, config):
    """The batch ids of the port's train_codebook's updates at the gate's
    flags, stood in for as _jax_updates."""
    updates = []

    def train_step(state, batch):
        updates.append(_batch_id(batch.numpy()))
        state.step += 1
        return state, {'total_loss': torch.zeros(())}

    class State:
        step = 0

    monkeypatch.setattr(tcb, 'init_codebook_state', lambda *a, **kw: (None, State()))
    monkeypatch.setattr(tcb, 'make_codebook_train_step', lambda *a, **kw: train_step)
    monkeypatch.setattr(tcb, 'make_codebook_eval_step', lambda *a, **kw: (
        lambda state, batch: ({'total_loss': torch.zeros(())}, torch.zeros(1, 2, 2, 3))))
    monkeypatch.setattr(tcb, '_checkpoint_state', lambda model, state: {})
    monkeypatch.setattr(tcb, 'load_image_dataset', _Batches)
    monkeypatch.setattr(tcb, 'CheckpointManager', _NoSave)
    monkeypatch.setattr(tcb, 'MetricLogger', _NoLog)
    tcb.train_codebook(config, 'D', 'J', total_steps=GATE_STEPS, epochs=GATE_EPOCHS,
                       batch_size=32, resume=False, seed=42, progress=False, profile_batch=0,
                       device='cpu')
    return updates


def test_gate_codebook_updates_and_batches(monkeypatch):
    """Both loops read batches 0..5999 in order. The port makes one update
    a batch; JAX (--steps-per-call 10) makes 6090: after the last batch of
    each of the 10 epochs (601 steps, the last 591) 9 more on that batch."""
    config = VQGANConfig(learning_rate=1.44e-4, batch_size=32, perceptual_weight=0.0)
    port = _port_updates(monkeypatch, to_port(config))
    jax_updates = _jax_updates(monkeypatch, config)
    assert port == list(range(GATE_STEPS))
    assert len(jax_updates) == GATE_STEPS + GATE_EPOCHS * (GATE_STEPS_PER_CALL - 1) == 6090
    assert sorted(set(jax_updates)) == port
    epoch_ends = [min(601 * (e + 1), GATE_STEPS) - 1 for e in range(GATE_EPOCHS)]
    repeated = {b: jax_updates.count(b) for b in set(jax_updates) if jax_updates.count(b) > 1}
    assert repeated == {b: GATE_STEPS_PER_CALL for b in epoch_ends}


def test_codebook_adam_matches_optax_over_the_gate_steps():
    """Each of the 6000 updates of a parameter vector under the same
    gradients, at the gate's config: the port's create_codebook_optimizer
    (torch Adam) against JAX's create_codebook_optimizer (optax) in f32,
    within 1e-5 of the update. Gradient scales span 1e-3 to 10 from step to
    step, so the moments, their bias corrections and eps are all exercised;
    a learning-rate schedule or a beta would show at once."""
    config = VQGANConfig(learning_rate=1.44e-4)
    rng = np.random.RandomState(0)
    grads = (rng.randn(GATE_STEPS, 64) * 10.0 ** rng.uniform(-3, 1, (GATE_STEPS, 1)))
    grads = grads.astype(np.float32)
    optimizer = jcb.create_codebook_optimizer(config)
    params = jnp.zeros(64, jnp.float32)

    def one(carry, g):
        p, opt_state = carry
        updates, opt_state = optimizer.update(g, opt_state, p)
        return (p, opt_state), updates

    _, jupdates = jax.lax.scan(one, (params, optimizer.init(params)), jnp.asarray(grads))
    jupdates = np.asarray(jupdates)

    module = torch.nn.Linear(64, 1, bias=False)
    p = module.weight
    with torch.no_grad():
        p.zero_()
    opt = tcb.create_codebook_optimizer(module, to_port(config))
    updates = np.empty_like(grads)
    for i, g in enumerate(grads):
        # the update does not depend on the parameter (no weight decay), so
        # each step starts from 0 and the parameter is the update, unrounded
        with torch.no_grad():
            p.zero_()
        p.grad = torch.from_numpy(g).reshape(1, 64)
        opt.step()
        updates[i] = p.detach().reshape(64).numpy()
        assert opt.param_groups[0]['lr'] == 1.44e-4
    scale = np.abs(jupdates).max(axis=1, keepdims=True)
    err = np.abs(updates - jupdates) / scale
    assert err.max() <= 1e-5, (err.max(), np.unravel_index(err.argmax(), err.shape))
    # Adam's first update is lr * sign(g) for each element
    np.testing.assert_allclose(np.abs(jupdates[0]), 1.44e-4, rtol=1e-4)


def test_quantize_ema_chained_over_many_steps():
    """48 training calls of quantize_ema on fresh latents, each from the
    state the last left (the EMA's decay 0.99, its bias correction
    1 - 0.99^n and the Laplace smoothing at n = 1..48): indices equal at
    every call and the state within 1e-5 of the largest magnitude."""
    rng = np.random.RandomState(1)
    D, N = 8, 32
    embeddings = rng.uniform(-1.0, 1.0, (D, N)).astype(np.float32)
    state = jq.QuantizerState(jnp.asarray(embeddings), jnp.zeros(N, jnp.float32),
                              jnp.zeros((D, N), jnp.float32), jnp.zeros((), jnp.int32))
    quantizer = Quantizer(D, N)
    for name, value in zip(state._fields, state):
        getattr(quantizer, name).copy_(torch.from_numpy(np.array(value)))
    step = jax.jit(lambda s, x: jq.quantize_ema(s, x, training=True))
    for i in range(48):
        x = rng.randn(4, 4, 4, D).astype(np.float32)
        _, jloss, jidx, state = step(state, jnp.asarray(x))
        _, loss, idx = tq.quantize_ema(quantizer, torch.from_numpy(x), training=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx), err_msg=f'call {i}')
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        for name in ('embeddings', 'ema_cluster_size_hidden', 'ema_dw_hidden'):
            expected = np.asarray(getattr(state, name))
            err = np.abs(getattr(quantizer, name).numpy() - expected).max()
            assert err <= 1e-5 * np.abs(expected).max(), (i, name, err)
    assert quantizer.counter.item() == int(state.counter) == 48
