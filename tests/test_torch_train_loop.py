"""The port's training entry point (viewformer_tpu_torch.train.transformer.
train_transformer and `python -m viewformer_tpu_torch train ...`) on the CPU
at tiny configs: against the JAX package's train_transformer from the same
initial weights and dataset, a kill and resume that is bit-equal to the
uninterrupted run, finetune_from, the CLI, and the refusals."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_config import to_port
from test_torch_data import _write
from test_train_transformer import TINY
from viewformer_tpu.train import transformer as jtt
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.config import VQGANConfig, load_config
from viewformer_tpu_torch.models import AutoModel, load_model
from viewformer_tpu_torch.train import transformer as ttt
from viewformer_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-5  # f32 reassociation over a few steps
CODEBOOK = VQGANConfig(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                       z_channels=32, embed_dim=8, n_embed=16, image_size=16)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('loop')), 'toy', {'train': 2, 'test': 1}, 0)


@pytest.fixture(scope='module')
def codebook(tmp_path_factory):
    """A job dir of a random-weight tiny codebook, as the port saves one."""
    job = str(tmp_path_factory.mktemp('codebook'))
    model = AutoModel.from_config(CODEBOOK, device='cpu',
                                  generator=torch.Generator().manual_seed(0))
    mgr = CheckpointManager(job, CODEBOOK)
    mgr.save(0, {'model': model.state_dict()})
    mgr.close()
    return job


def _records(job_dir):
    """{(step, prefix): record} of metrics.jsonl, the last record winning."""
    out = {}
    with open(os.path.join(job_dir, 'metrics.jsonl')) as f:
        for line in f:
            record = json.loads(line)
            prefix = next(k for k in record if '/' in k).split('/')[0]
            out[record['step'], prefix] = record
    return out


def _steps(directory):
    """The checkpoint steps in a last/ or best/ directory: orbax's step
    directories, or the port's <step>.pt files."""
    return sorted({int(os.path.splitext(name)[0]) for name in os.listdir(directory)
                   if os.path.splitext(name)[0].isdigit()})


def test_loop_matches_jax(dataset, tmp_path, monkeypatch):
    """JAX's train_transformer and the port's at TINY (dropout 0, f32), the
    port starting from JAX's initial parameters: the same metric records
    (losses within LOSS_TOL) and the same checkpoint steps."""
    config = dataclasses.replace(TINY, total_steps=4)
    initial = {}
    jax_init = jtt.init_transformer_state

    def capture_init(*args, **kwargs):
        model, state = jax_init(*args, **kwargs)
        initial['params'] = jax.device_get(state.params)
        return model, state

    monkeypatch.setattr(jtt, 'init_transformer_state', capture_init)
    jtt.train_transformer(config, dataset, str(tmp_path / 'jax'), epochs=2, use_bf16=False,
                          progress=False, log_every=1)
    port_init = ttt.init_transformer_state

    def jax_weights(*args, **kwargs):
        model, state = port_init(*args, **kwargs)
        model.load_state_dict(state_dict_from_jax(model, initial))
        return model, state

    monkeypatch.setattr(ttt, 'init_transformer_state', jax_weights)
    _, state = ttt.train_transformer(to_port(config), dataset, str(tmp_path / 'port'), epochs=2,
                                     use_bf16=False, progress=False, log_every=1, device='cpu')
    assert state.step == 4
    expected, port = _records(str(tmp_path / 'jax')), _records(str(tmp_path / 'port'))
    assert sorted(port) == sorted(expected) == [(1, 'train'), (2, 'train'), (2, 'val'),
                                                 (3, 'train'), (4, 'train'), (4, 'val')]
    for key, record in expected.items():
        assert set(port[key]) == set(record), key
        for name, value in record.items():
            if 'loss' in name or 'localization_weight' in name:
                np.testing.assert_allclose(port[key][name], value, rtol=LOSS_TOL,
                                           atol=LOSS_TOL, err_msg=f'{key} {name}')
    for sub in ('last', 'best'):
        assert _steps(str(tmp_path / 'port' / sub)) == _steps(str(tmp_path / 'jax' / sub)), sub
    aux = sorted(f for f in os.listdir(tmp_path / 'port') if f.startswith('aux-'))
    assert aux == sorted(f for f in os.listdir(tmp_path / 'jax') if f.startswith('aux-'))


class Killed(Exception):
    pass


def _kill_at(monkeypatch, at_step):
    """Make the train step raise when it is called at update `at_step`."""
    make = ttt.make_transformer_train_step

    def make_killable(model, config):
        step = make(model, config)

        def killable(state, batch, generator=None):
            if state.step == at_step:
                raise Killed
            return step(state, batch, generator)
        return killable

    monkeypatch.setattr(ttt, 'make_transformer_train_step', make_killable)


RESUME_KWARGS = dict(total_steps=6, epochs=2, checkpoint_every=2, log_every=1, use_bf16=False,
                     progress=False, device='cpu')


@pytest.fixture(scope='module')
def uninterrupted(dataset, tmp_path_factory):
    """(job dir, model) of the uninterrupted dropout-0.1 run that the killed
    and resumed runs are held against."""
    job = str(tmp_path_factory.mktemp('uninterrupted'))
    model, state = ttt.train_transformer(to_port(dataclasses.replace(TINY, dropout=0.1)),
                                         dataset, job, **RESUME_KWARGS)
    assert state.step == 6
    return job, model


def _kill_and_resume(dataset, job, monkeypatch, kill_at):
    config = to_port(dataclasses.replace(TINY, dropout=0.1))
    with monkeypatch.context() as patch:
        _kill_at(patch, kill_at)
        with pytest.raises(Killed):
            ttt.train_transformer(config, dataset, job, **RESUME_KWARGS)
    return config


def _assert_resumed_equal(uninterrupted, job, resumed, resumed_state, first_step):
    """Parameters and the train records of steps first_step.. bit-equal."""
    expected_job, model = uninterrupted
    assert resumed_state.step == 6
    for name, value in model.state_dict().items():
        assert torch.equal(resumed.state_dict()[name], value), name
    expected, port = _records(expected_job), _records(job)
    for step in range(first_step, 7):
        for name, value in expected[step, 'train'].items():
            if name != 'time':
                assert port[step, 'train'][name] == value, (step, name)
    assert port[6, 'val']['val/loss'] == expected[6, 'val']['val/loss']
    return expected, port


def test_kill_and_resume_is_bit_equal(dataset, uninterrupted, tmp_path, monkeypatch):
    """At dropout 0.1, a run killed after step 4 and resumed from its step-3
    checkpoint (the epoch end; checkpoint_every=2 saved step 2 before it)
    ends with the uninterrupted run's parameters bit for bit, and logs its
    losses after the resume bit for bit."""
    job = str(tmp_path / 'b')
    config = _kill_and_resume(dataset, job, monkeypatch, 4)
    assert _steps(os.path.join(job, 'last')) == [3]
    assert json.load(open(os.path.join(job, 'aux-3.json')))['data_iterator']['batch'] > 0
    resumed, resumed_state = ttt.train_transformer(config, dataset, job, **RESUME_KWARGS)
    _assert_resumed_equal(uninterrupted, job, resumed, resumed_state, 4)


def test_resume_from_a_mid_epoch_save(dataset, uninterrupted, tmp_path, monkeypatch):
    """Killed after step 2, the run resumes from the checkpoint_every save at
    step 2 and its data cursor, and ends bit-equal to the uninterrupted run.
    Its epoch ends are counted from step 2 (as in the JAX loop), so it
    validates and saves best/ at steps 5 and 6, not 3 and 6."""
    job = str(tmp_path / 'b')
    config = _kill_and_resume(dataset, job, monkeypatch, 2)
    assert _steps(os.path.join(job, 'last')) == [2]
    assert not os.path.exists(os.path.join(job, 'best'))
    assert json.load(open(os.path.join(job, 'aux-2.json')))['data_iterator']['batch'] > 0
    resumed, resumed_state = ttt.train_transformer(config, dataset, job, **RESUME_KWARGS)
    expected, port = _assert_resumed_equal(uninterrupted, job, resumed, resumed_state, 3)
    assert sorted(s for s, kind in expected if kind == 'val') == [3, 6]
    assert sorted(s for s, kind in port if kind == 'val') == [5, 6]
    best_loss = min(port[5, 'val']['val/loss'], port[6, 'val']['val/loss'])
    best_step = 5 if port[5, 'val']['val/loss'] == best_loss else 6
    assert _steps(os.path.join(job, 'best')) == [best_step]


def test_finetune_carries_step_and_adamw_state(dataset, tmp_path, monkeypatch):
    """finetune_from restores the parameters, the AdamW moments and counts,
    and the step (the optimizer state is restored, not restarted); the
    profiler traces step profile_batch."""
    config = to_port(TINY)
    ttt.train_transformer(config, dataset, str(tmp_path / 'base'), total_steps=2, epochs=1,
                          use_bf16=False, progress=False, device='cpu', profile_batch=1)
    assert os.listdir(tmp_path / 'base' / 'profile') == ['trace-step2.json']
    saved, step = restore_checkpoint(str(tmp_path / 'base'), prefer='last')
    assert step == 2
    seen = {}
    make = ttt.make_transformer_train_step

    def record_first(model, config):
        train_step = make(model, config)

        def step_fn(state, batch, generator=None):
            seen.setdefault('step', state.step)
            moments = state.optimizer.state_dict()['state']
            seen.setdefault('optimizer', {k: {n: t.clone() for n, t in v.items()}
                                          for k, v in moments.items()})
            seen.setdefault('model', {k: v.clone() for k, v in model.state_dict().items()})
            return train_step(state, batch, generator)
        return step_fn

    monkeypatch.setattr(ttt, 'make_transformer_train_step', record_first)
    _, state = ttt.train_transformer(config, dataset, str(tmp_path / 'tuned'), total_steps=4,
                                     epochs=1, use_bf16=False, progress=False, device='cpu',
                                     finetune_from=str(tmp_path / 'base'))
    assert seen['step'] == 2 and state.step == 4
    assert set(seen['optimizer']) == set(saved['optimizer']['state'])
    for index, moments in saved['optimizer']['state'].items():
        for name, value in moments.items():
            assert torch.equal(seen['optimizer'][index][name], value), (index, name)
    for name, value in saved['model'].items():
        assert torch.equal(seen['model'][name], value), name
    assert _steps(str(tmp_path / 'tuned' / 'last')) == [4]


def test_cli_writes_a_job_dir(dataset, codebook, tmp_path):
    """`train transformer` at --device cpu writes a job dir (config with the
    codebook's n_embeddings, metrics with val/psnr, checkpoints that
    load_model reads); `train finetune-transformer` continues it."""
    job, tuned = str(tmp_path / 'job'), str(tmp_path / 'tuned')
    cli.main(['train', 'transformer', '--dataset', dataset, '--codebook-model', codebook,
              '--job-dir', job, '--device', 'cpu', '--fp32', '--total-steps', '2', '--epochs',
              '1', '--batch-size', '2', '--d-model', '32', '--n-layer', '2', '--n-head', '2',
              '--sequence-size', '4', '--token-image-size', '2', '--n-loss-skip', '1',
              '--dropout', '0.1', '--checkpoint-every', '1'])
    config = load_config(job)
    assert config.n_embeddings == CODEBOOK.n_embed and config.d_model == 32
    records = _records(job)
    assert np.isfinite(records[2, 'val']['val/psnr'])
    assert _steps(os.path.join(job, 'last')) == [2]
    model = load_model(job, device='cpu')
    assert model.wte.weight.shape == (CODEBOOK.n_embed + 2, 32)
    cli.main(['train', 'finetune-transformer', '--dataset', dataset, '--checkpoint', job,
              '--job-dir', tuned, '--device', 'cpu', '--fp32', '--total-steps', '3',
              '--epochs', '1', '--learning-rate', '1e-3'])
    assert _steps(os.path.join(tuned, 'last')) == [3]
    assert load_config(tuned).learning_rate == 1e-3
    proc = subprocess.run([sys.executable, '-m', 'viewformer_tpu_torch', 'train', 'transformer',
                           '--help'], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and '--codebook-model' in proc.stdout


def test_refusals(dataset, tmp_path):
    """The policies that keep activations are not ported (train_transformer
    takes no remat_policy, the CLI only 'full'); without a card the default
    device raises (no fallback to the CPU); dropout_impl='rng' raises."""
    config = to_port(TINY)
    with pytest.raises(TypeError, match='remat_policy'):
        ttt.train_transformer(config, dataset, str(tmp_path / 'a'), remat_policy='attn',
                              device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ttt.train_transformer(config, dataset, str(tmp_path / 'b'))
    with pytest.raises(ValueError, match='rng'):
        ttt.train_transformer(config, dataset, str(tmp_path / 'c'), dropout_impl='rng',
                              device='cpu')
    with pytest.raises(SystemExit):
        cli.main(['train', 'transformer', '--dataset', dataset, '--codebook-model', 'x',
                  '--job-dir', str(tmp_path / 'd'), '--remat-policy', 'attn'])
