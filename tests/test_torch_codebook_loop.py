"""The port's codebook training entry point (train_codebook and `python -m
viewformer_tpu_torch dataset generate | train codebook | generate-codes`) on
the CPU at test_train_codebook's TINY config: against the JAX package's
train_codebook from the same initial weights and dataset, a kill and resume
with gradient accumulation that is bit-equal to the uninterrupted run, and
the three commands end to end."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_config import to_port
from test_torch_train_loop import _records, _steps
from test_train_codebook import TINY
from viewformer_tpu.data import generate_dataset_from_loader
from viewformer_tpu.data.loaders import build
from viewformer_tpu.models import lpips as jlpips
from viewformer_tpu.train import codebook as jcb
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.config import load_config
from viewformer_tpu_torch.data.dataset import get_dataset_info
from viewformer_tpu_torch.models import load_model
from viewformer_tpu_torch.models import lpips as tlpips
from viewformer_tpu_torch.train import codebook as tcb
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

# f32 on the CPU: the train metrics of 4 steps agree to ~2e-5 relative. The
# validation runs after updates, in which Adam moves each element whose
# gradient is within the f32 noise of 0 by up to lr, differently in the two
# packages (test_torch_codebook.py leaves those elements out of its parameter
# comparison): they move the validation metrics by ~1e-3 relative.
LOSS_TOL = 1e-4
VAL_TOL = 5e-3


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """colors at 16 px: train 4 sequences of 4 frames (4 batches of 4 an
    epoch), test 2 sequences of 4."""
    root = str(tmp_path_factory.mktemp('colors'))
    for split, n in (('train', 4), ('test', 2)):
        loader = build('colors', split=split, num_sequences=n, sequence_size=4, image_size=16)
        generate_dataset_from_loader(loader, split, os.path.join(root, 'colors'),
                                     max_sequences_per_shard=2, progress=False)
    return root


@pytest.fixture
def no_lpips_weights(tmp_path, monkeypatch):
    paths = [str(tmp_path / 'lpips_vgg.npz')]
    monkeypatch.setattr(tlpips, '_WEIGHT_PATHS', paths)
    monkeypatch.setattr(jlpips, '_WEIGHT_PATHS', paths)
    jlpips.load_lpips.cache_clear()
    yield
    jlpips.load_lpips.cache_clear()


def test_loop_matches_jax(dataset, tmp_path, monkeypatch, no_lpips_weights):
    """JAX's train_codebook and the port's at TINY with perceptual weight 1
    and no LPIPS weights (the term dropped, p_loss NaN in both), f32, 4
    steps in epochs of 3 (1 + 4 // 2) and 1, the port starting from JAX's
    initial weights: the same metric records (train metrics within
    LOSS_TOL, validation within VAL_TOL), the same checkpoint steps and data
    cursors."""
    config = dataclasses.replace(TINY, perceptual_weight=1.0)
    kwargs = dict(total_steps=4, epochs=2, batch_size=4, use_bf16=False, progress=False,
                  log_every=1, num_val_batches=1)
    initial = {}

    def capture_init(config, rng, optimizer, dtype=jnp.float32, remat=False):
        # JAX's init_codebook_state with its model.init under jit: the same
        # keys draw the same weights, without its eager init's ~15 s of
        # op-by-op compiles on the CPU
        model = jcb.create_codebook_model(config, dtype, remat=remat)
        params_rng, quantizer_rng = jax.random.split(rng)
        dummy = jnp.zeros((1, config.image_size, config.image_size, config.in_channels),
                          jnp.float32)
        variables = jax.jit(lambda a, b: model.init({'params': a, 'quantizer': b}, dummy,
                                                    training=False))(params_rng, quantizer_rng)
        initial.update(jax.device_get(variables))
        return model, jcb.CodebookTrainState(variables['params'], variables['quantizer'],
                                             optimizer.init(variables['params']),
                                             jnp.zeros((), jnp.int32))

    monkeypatch.setattr(jcb, 'init_codebook_state', capture_init)
    jcb.train_codebook(config, dataset, str(tmp_path / 'jax'), **kwargs)
    port_init = tcb.init_codebook_state

    def jax_weights(*args, **kw):
        model, state = port_init(*args, **kw)
        model.load_state_dict(state_dict_from_jax(model, initial))
        return model, state

    monkeypatch.setattr(tcb, 'init_codebook_state', jax_weights)
    model, state = tcb.train_codebook(to_port(config), dataset, str(tmp_path / 'port'),
                                      device='cpu', **kwargs)
    assert state.step == 4 and model.quantizer.counter.item() == 4
    expected, port = _records(str(tmp_path / 'jax')), _records(str(tmp_path / 'port'))
    assert sorted(port) == sorted(expected) == [(1, 'train'), (2, 'train'), (3, 'train'),
                                                 (3, 'val'), (4, 'train'), (4, 'val')]
    for key, record in expected.items():
        assert set(port[key]) == set(record), key
        tol = VAL_TOL if key[1] == 'val' else LOSS_TOL
        for name, value in record.items():
            if name != 'time':
                np.testing.assert_allclose(port[key][name], value, rtol=tol, atol=tol,
                                           err_msg=f'{key} {name}')
    assert math.isnan(port[1, 'train']['train/p_loss'])
    for sub in ('last', 'best'):
        assert _steps(str(tmp_path / 'port' / sub)) == _steps(str(tmp_path / 'jax' / sub)), sub
    for name in sorted(f for f in os.listdir(tmp_path / 'jax') if f.startswith('aux-')):
        with open(tmp_path / 'jax' / name) as a, open(tmp_path / 'port' / name) as b:
            assert json.load(a) == json.load(b), name


class Killed(Exception):
    pass


RESUME_KWARGS = dict(total_steps=6, epochs=2, batch_size=4, accumulate_grad_batches=2,
                     checkpoint_every=3, log_every=1, use_bf16=False, progress=False,
                     device='cpu', profile_batch=0)


def test_kill_and_resume_is_bit_equal(dataset, tmp_path, monkeypatch):
    """With accumulate_grad_batches=2, a run killed before its 4th call
    resumes from the step-3 save (taken between the two halves of an
    update, so the running mean of the gradients is saved) and ends with
    the uninterrupted run's parameters, EMA state and losses, bit for
    bit. The uninterrupted run traces steps 1 and 2 (profile_batch=1)."""
    config = to_port(TINY)
    model, state = tcb.train_codebook(config, dataset, str(tmp_path / 'a'),
                                      **dict(RESUME_KWARGS, profile_batch=1))
    assert state.step == 6
    assert os.listdir(tmp_path / 'a' / 'profile') == ['trace-step2.json']
    make = tcb.make_codebook_train_step

    def killable(*args):
        step = make(*args)

        def run(state, batch):
            if state.step == 3:
                raise Killed
            return step(state, batch)
        return run

    job = str(tmp_path / 'b')
    with monkeypatch.context() as patch:
        patch.setattr(tcb, 'make_codebook_train_step', killable)
        with pytest.raises(Killed):
            tcb.train_codebook(config, dataset, job, **RESUME_KWARGS)
    assert _steps(os.path.join(job, 'last')) == [3]
    saved = torch.load(os.path.join(job, 'last', '3.pt'), weights_only=False)
    assert saved['mini_step'] == 1 and saved['acc_grads'][0].abs().max() > 0
    resumed, resumed_state = tcb.train_codebook(config, dataset, job, **RESUME_KWARGS)
    assert resumed_state.step == 6
    for name, value in model.state_dict().items():
        assert torch.equal(resumed.state_dict()[name], value), name
    expected, port = _records(str(tmp_path / 'a')), _records(job)
    for step in range(4, 7):
        for name, value in expected[step, 'train'].items():
            if name != 'time':
                assert port[step, 'train'][name] == value, (step, name)


def test_cli_pipeline(tmp_path, no_lpips_weights):
    """`dataset generate` (colors, --loader-<param> passthrough), `train
    codebook` and `generate-codes` at --device cpu: the image dataset, a
    codebook job dir that load_model reads, and a token dataset with
    token_image_size."""
    images, job, codes = (str(tmp_path / name) for name in ('images', 'job', 'codes'))
    cli.main(['dataset', 'generate', '--loader', 'colors', '--loader-num-sequences', '3',
              '--loader-sequence-size=4', '--image-size', '16', '--output',
              os.path.join(images, 'colors'), '--max-sequences-per-shard', '2'])
    info = get_dataset_info(images)
    assert info['splits'] == ['test', 'train'] and info['frame_size'] == 16
    assert info['train_size'] == 2 and info['train_num_images'] == 12
    cli.main(['train', 'codebook', '--dataset', images, '--job-dir', job, '--device', 'cpu',
              '--fp32', '--total-steps', '2', '--epochs', '1', '--batch-size', '4',
              '--ch', '32', '--num-res-blocks', '1', '--n-embed', '16', '--embed-dim', '8',
              '--image-size', '16', '--learning-rate', '1e-3', '--log-every', '1'])
    config = load_config(job)
    assert (config.ch, config.n_embed, config.image_size) == (32, 16, 16)
    assert _steps(os.path.join(job, 'last')) == [2]
    records = _records(job)
    assert math.isnan(records[2, 'train']['train/p_loss'])
    assert np.isfinite(records[2, 'val']['val/psnr'])
    assert load_model(job, device='cpu').quantizer.counter.item() == 2
    cli.main(['generate-codes', '--dataset', images, '--output', codes, '--model', job,
              '--device', 'cpu', '--fp32', '--batch-size', '5', '--split', 'train'])
    info = get_dataset_info(codes)
    assert info['token_image_size'] == 16 // config.stride
    assert info['features'] == ['codes', 'cameras']
    assert sorted(f for f in os.listdir(codes) if f.endswith('.tfrecord')) == [
        'colors-train-000001-of-000002.tfrecord', 'colors-train-000002-of-000002.tfrecord']
