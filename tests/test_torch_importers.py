"""The port's reference-checkpoint importers, load_model of released
checkpoint dirs, pull_checkpoint and `model info`, against the JAX package.

The importers must give, bit for bit, what the JAX package's importers give
passed through state_dict_from_jax, and raise on a tensor left over on either
side. The torch oracle of tests/test_vqgan.py writes the reference's VQ-GAN
names; the Keras MIGT variables are random arrays in the reference's names,
in the raw object-graph key form that resolve_keras_object_paths takes.
"""
import dataclasses
import io
import json
import os
import socket
import tarfile

import numpy as np
import pytest
import torch

from test_importers import TINY as MIGT_TINY
from test_torch_config import to_port
from test_vqgan import _build_torch_vqgan
from viewformer_tpu.config import VQGANConfig
from viewformer_tpu.utils import convert as jconvert
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.config import save_config
from viewformer_tpu_torch.models import AutoModel, load_model
from viewformer_tpu_torch.utils import convert as tconvert
from viewformer_tpu_torch.utils import pull_checkpoint

# tests/test_vqgan.py's parity config (GroupNorm(32) needs 32 | channels)
VQGAN_TINY = VQGANConfig(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                         z_channels=32, embed_dim=8, n_embed=16, image_size=16)
# the pre-quant latents of the port against the torch oracle, both f32: the
# bound the JAX package's README states for its own import
ENCODE_TOL = 5e-4
# the logits of the port's MIGT against JAX's, both f32 from the same
# imported weights, as tests/test_torch_train.py compares them
LOGITS_TOL = 2e-5


def _reference_vqgan(seed=0):
    """(torch oracle, its state_dict in the reference's names, with the
    Lightning wrapper and the perceptual-loss tensors of a released
    checkpoint)."""
    model = _build_torch_vqgan(VQGAN_TINY, seed=seed)
    for module in model.modules():
        if isinstance(module, torch.nn.GroupNorm):
            module.num_groups = 32
    sd = model.state_dict_reference_names()
    sd['quantize.counter'] = torch.tensor(7)  # int64, as torch saves it
    released = {'state_dict': {**sd, 'perceptual_loss.net.lin0.weight': torch.ones(1, 3, 1, 1),
                               'loss.logvar': torch.zeros(())},
                'epoch': 3, 'hyper_parameters': {}}
    return model, sd, released


def _port_model(config):
    return AutoModel.from_config(config, device='cpu', generator=torch.Generator().manual_seed(0))


def _assert_same_state(actual, expected):
    assert list(actual) == list(expected)
    for key, value in expected.items():
        assert actual[key].dtype == value.dtype, key
        assert torch.equal(actual[key], value), key


def _keras_variables(config, seed=0, pos_ori=False, raw=True):
    """Random MIGT variables in the reference's Keras names; raw: keys as
    save_weights writes them (model/.../.ATTRIBUTES/VARIABLE_VALUE), with
    optimizer and save_counter entries."""
    rng = np.random.RandomState(seed)
    d = config.d_model
    names = {'wte/weight': (config.n_embeddings + 2, d), 'wpe/embeddings': (256, d)}

    def mlp(prefix, n_in, inner, n_out):
        names.update({f'{prefix}/c_fc/weight': (n_in, inner), f'{prefix}/c_fc/bias': (1, inner),
                      f'{prefix}/c_proj/weight': (inner, n_out),
                      f'{prefix}/c_proj/bias': (1, n_out)})

    mlp('pose_embedding', 7, 2 * d, d)
    mlp('pose_criterion/pose_classifier', d, 2 * d, 7)
    for i in range(config.n_layer):
        for ln in ('ln_1', 'ln_2'):
            names.update({f'h/{i}/{ln}/gamma': (d,), f'h/{i}/{ln}/beta': (d,)})
        names.update({f'h/{i}/attn/c_attn/weight': (d, 3 * d), f'h/{i}/attn/c_attn/bias': (1, 3 * d),
                      f'h/{i}/attn/c_proj/weight': (d, d), f'h/{i}/attn/c_proj/bias': (1, d)})
        mlp(f'h/{i}/mlp', d, 4 * d, d)
    names.update({'ln_f/gamma': (d,), 'ln_f/beta': (d,)})
    if pos_ori:
        names['pose_loss_weighting_criterion/pos_ori_weights'] = (1, 2)
    variables = {name: rng.randn(*shape).astype(np.float32) for name, shape in names.items()}
    if not raw:
        return {name.replace('h/', 'h.', 1) if name.startswith('h/') else name: value
                for name, value in variables.items()}
    variables = {f'model/{name}/.ATTRIBUTES/VARIABLE_VALUE': value
                 for name, value in variables.items()}
    variables['optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE'] = np.int64(10)
    variables['optimizer/learning_rate/.ATTRIBUTES/VARIABLE_VALUE'] = np.float32(1e-4)
    variables['save_counter/.ATTRIBUTES/VARIABLE_VALUE'] = np.int64(1)
    return variables


def _migt_config(pos_ori):
    return dataclasses.replace(MIGT_TINY, use_dynamic_pose_loss=pos_ori)


@pytest.mark.parametrize('wrapped', [False, True], ids=['flat', 'lightning'])
def test_vqgan_import_equals_jax(wrapped):
    _, sd, released = _reference_vqgan()
    source = released if wrapped else sd
    config = to_port(VQGAN_TINY)
    expected = tconvert.state_dict_from_jax(
        _port_model(config), jconvert.import_vqgan_from_torch(source, VQGAN_TINY))
    actual = tconvert.import_vqgan_from_torch(source, config)
    _assert_same_state(actual, expected)
    assert actual['quantizer.counter'].dtype == torch.int32
    assert 'encoder.down_0_downsample.conv.weight' in actual
    assert 'decoder.up_1_upsample.conv.weight' in actual


def test_vqgan_import_matches_torch_oracle():
    oracle, sd, _ = _reference_vqgan(seed=1)
    model = _port_model(to_port(VQGAN_TINY))
    model.load_state_dict(tconvert.import_vqgan_from_torch(sd, to_port(VQGAN_TINY)))
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        expected = oracle.quant_conv(oracle.encoder(torch.from_numpy(x).permute(0, 3, 1, 2)))
        actual = model._latents(torch.from_numpy(x))
    np.testing.assert_allclose(actual.numpy(), expected.permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=ENCODE_TOL)


@pytest.mark.parametrize('pos_ori', [False, True], ids=['plain', 'pos_ori_weights'])
def test_migt_import_equals_jax(pos_ori):
    config = _migt_config(pos_ori)
    raw = _keras_variables(config, pos_ori=pos_ori)
    expected = tconvert.state_dict_from_jax(
        _port_model(to_port(config)),
        jconvert.import_migt_from_tf(jconvert.resolve_keras_object_paths(raw), config))
    resolved = tconvert.resolve_keras_object_paths(raw)
    assert not any(k.startswith(('optimizer', 'save_counter')) for k in resolved)
    assert resolved.keys() == jconvert.resolve_keras_object_paths(raw).keys()
    actual = tconvert.import_migt_from_tf(resolved, to_port(config))
    _assert_same_state(actual, expected)
    assert ('pos_ori_weights' in actual) == pos_ori
    flat = _keras_variables(config, pos_ori=pos_ori, raw=False)
    np.testing.assert_array_equal(actual['h.1.attn.c_attn.weight'].numpy(),
                                  flat['h.1/attn/c_attn/weight'].T)
    np.testing.assert_array_equal(actual['h.0.ln_2.weight'].numpy(), flat['h.0/ln_2/gamma'])


def _vqgan_case(change):
    _, sd, _ = _reference_vqgan()
    change(sd)
    return lambda: tconvert.import_vqgan_from_torch(sd, to_port(VQGAN_TINY))


def _migt_case(change):
    variables = _keras_variables(MIGT_TINY, raw=False)
    change(variables)
    return lambda: tconvert.import_migt_from_tf(variables, to_port(MIGT_TINY))


STRICT_CASES = {
    'vqgan_extra': (_vqgan_case, lambda sd: sd.update({'encoder.extra.weight': torch.ones(1)}),
                    'encoder.extra.weight'),
    'vqgan_missing': (_vqgan_case, lambda sd: sd.pop('decoder.conv_out.bias'),
                      'decoder.conv_out.bias'),
    'vqgan_shape': (_vqgan_case, lambda sd: sd.update({'quant_conv.bias': torch.ones(3)}),
                    'quant_conv.bias'),
    'migt_extra': (_migt_case, lambda v: v.update({'h.2/ln_1/gamma': np.ones(32, np.float32)}),
                   'h.2/ln_1/gamma'),
    'migt_missing': (_migt_case, lambda v: v.pop('ln_f/beta'), 'ln_f.bias'),
    'migt_unexpected_pos_ori': (
        _migt_case, lambda v: v.update({'pose_loss_weighting_criterion/pos_ori_weights':
                                        np.zeros((1, 2), np.float32)}), 'pos_ori_weights'),
}


@pytest.mark.parametrize('case', sorted(STRICT_CASES))
def test_importers_are_strict(case):
    make, change, named = STRICT_CASES[case]
    with pytest.raises(KeyError, match=named.replace('.', r'\.')):
        make(change)()


def _write_codebook_dir(path, released):
    os.makedirs(path)
    save_config(to_port(VQGAN_TINY), path)
    torch.save(released, os.path.join(path, 'model.ckpt'))
    return path


def _write_transformer_dir(path, config):
    """A `*-transformer-tf`-layout dir: config.json and a Keras checkpoint
    (its .index stands for the bundle; the test reads it through a stand-in
    read_tf_checkpoint)."""
    os.makedirs(path)
    save_config(to_port(config), path)
    open(os.path.join(path, 'model.index'), 'wb').close()
    return path


def test_pull_checkpoint_and_load_model_of_released_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))

    def no_network(*args, **kwargs):
        raise AssertionError('pull_checkpoint opened a socket')
    monkeypatch.setattr(socket, 'socket', no_network)
    _, _, released = _reference_vqgan()
    src = _write_codebook_dir(str(tmp_path / 'src'), released)
    tar_path = tmp_path / 'tiny-codebook-th.tar.gz'
    with tarfile.open(tar_path, 'w:gz') as tf:
        for name in os.listdir(src):
            tf.add(os.path.join(src, name), arcname=name)
    cache = tmp_path / 'home' / '.cache' / 'viewformer'

    with pytest.raises(FileNotFoundError, match='download-model tiny-codebook-th --from-file'):
        load_model('tiny-codebook-th', device='cpu')
    path = pull_checkpoint('tiny-codebook-th', local_source=str(tar_path))
    assert path == str(cache / 'tiny-codebook-th')
    assert sorted(os.listdir(path)) == ['config.json', 'model.ckpt']
    assert pull_checkpoint('tiny-codebook-th') == path  # cached: no source needed
    expected = tconvert.import_vqgan_from_torch(released, to_port(VQGAN_TINY))
    model = load_model('tiny-codebook-th', device='cpu')
    _assert_same_state(model.state_dict(), expected)
    half = load_model(path, torch.bfloat16, device='cpu')
    assert half.quant_conv.weight.dtype == torch.bfloat16
    assert half.quantizer.embeddings.dtype == torch.float32

    # from a directory; the cached copy wins until override
    assert pull_checkpoint('dir-codebook-th', local_source=src) == str(cache / 'dir-codebook-th')
    with open(os.path.join(src, 'config.json'), 'w') as f:
        json.dump({**to_port(VQGAN_TINY).asdict(), 'n_embed': 32}, f)
    pull_checkpoint('dir-codebook-th', local_source=src)
    assert load_model('dir-codebook-th', device='cpu').config.n_embed == 16
    pull_checkpoint('dir-codebook-th', local_source=src, override=True)
    with pytest.raises(KeyError, match='quantizer.embeddings'):  # the config no longer fits
        load_model('dir-codebook-th', device='cpu')

    # a member that escapes the tarball is refused and leaves no cache entry
    evil = tmp_path / 'evil.tar.gz'
    with tarfile.open(evil, 'w:gz') as tf:
        info = tarfile.TarInfo('../escaped.txt')
        info.size = 3
        tf.addfile(info, io.BytesIO(b'bad'))
    with pytest.raises(tarfile.FilterError):
        pull_checkpoint('evil-codebook-th', local_source=str(evil))
    assert not (cache / 'evil-codebook-th').exists()
    assert not (cache / 'escaped.txt').exists()
    assert sorted(os.listdir(cache)) == ['dir-codebook-th', 'tiny-codebook-th']


def test_download_model_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    _, _, released = _reference_vqgan()
    src = _write_codebook_dir(str(tmp_path / 'src'), released)
    cli.main(['download-model', 'cli-codebook-th', '--from-file', src])
    path = str(tmp_path / 'home' / '.cache' / 'viewformer' / 'cli-codebook-th')
    assert capsys.readouterr().out.strip() == f'Installed at {path}'
    cli.main(['download-model', 'cli-codebook-th', '--from-file', src, '--override'])
    assert capsys.readouterr().out.strip() == f'Installed at {path}'
    with pytest.raises(FileNotFoundError, match='--from-file'):
        cli.main(['download-model', 'other-codebook-th'])


class _JaxModel:
    def __init__(self, config):
        self.config = config


@pytest.mark.parametrize('kind', ['codebook', 'transformer'])
def test_model_info_total_equals_jax(kind, tmp_path, monkeypatch, capsys):
    """The port's `model info` of a released-layout dir against JAX's
    model_info of the same imported variables (its load_model stood in for,
    so no JAX init runs)."""
    import viewformer_tpu.models as jmodels
    from viewformer_tpu.commands.model_info import model_info as jax_model_info

    if kind == 'codebook':
        _, _, released = _reference_vqgan()
        path = _write_codebook_dir(str(tmp_path / kind), released)
        config = VQGAN_TINY
        variables = jconvert.import_vqgan_from_torch(released, config)
    else:
        config = _migt_config(True)
        raw = _keras_variables(config, pos_ori=True)
        path = _write_transformer_dir(str(tmp_path / kind), config)
        monkeypatch.setattr(tconvert, 'read_tf_checkpoint',
                            lambda prefix: raw if prefix == os.path.join(path, 'model') else None)
        variables = jconvert.import_migt_from_tf(jconvert.resolve_keras_object_paths(raw), config)
    monkeypatch.setattr(jmodels, 'load_model', lambda checkpoint: (_JaxModel(config), variables))
    expected = jax_model_info(path)
    jax_out = capsys.readouterr().out
    cli.main(['model', 'info', '--model', path, '--device', 'cpu'])
    port_out = capsys.readouterr().out
    total = port_out.strip().splitlines()[-1]
    assert total == f'total: {expected:,} parameters' == jax_out.strip().splitlines()[-1]
    collections = [line for line in port_out.splitlines() if line.startswith('[')]
    assert collections == [line for line in jax_out.splitlines() if line.startswith('[')]
    assert expected == sum(t.numel() for t in load_model(path, device='cpu').state_dict().values())


@pytest.mark.tf_oracle
def test_tf_checkpoint_through_load_model(tmp_path):
    """A TF checkpoint written as tests/test_importers.py writes one, read
    with the port's functions (equal to JAX's import) and loaded by
    load_model from a dir with its config.json; the logits agree with JAX's
    MIGT under JAX's import within LOGITS_TOL."""
    tf = pytest.importorskip('tensorflow')
    import jax.numpy as jnp

    from viewformer_tpu.models.migt import MIGT as JaxMIGT

    config = MIGT_TINY
    d = config.d_model
    rng = np.random.RandomState(0)

    class Dense(tf.Module):
        def __init__(self, nin, nout):
            super().__init__()
            self.weight = tf.Variable(rng.randn(nin, nout).astype(np.float32))
            self.bias = tf.Variable(rng.randn(1, nout).astype(np.float32))

    class MLP(tf.Module):
        def __init__(self, nin, inner, nout):
            super().__init__()
            self.c_fc = Dense(nin, inner)
            self.c_proj = Dense(inner, nout)

    class LN(tf.Module):
        def __init__(self, n):
            super().__init__()
            self.gamma = tf.Variable(rng.randn(n).astype(np.float32))
            self.beta = tf.Variable(rng.randn(n).astype(np.float32))

    class Attn(tf.Module):
        def __init__(self):
            super().__init__()
            self.c_attn = Dense(d, 3 * d)
            self.c_proj = Dense(d, d)

    class Block(tf.Module):
        def __init__(self):
            super().__init__()
            self.ln_1, self.attn, self.ln_2, self.mlp = LN(d), Attn(), LN(d), MLP(d, 4 * d, d)

    class PoseCriterion(tf.Module):
        def __init__(self):
            super().__init__()
            self.pose_classifier = MLP(d, 2 * d, 7)

    class RefModel(tf.Module):
        def __init__(self):
            super().__init__()
            self.wte = tf.Module()
            self.wte.weight = tf.Variable(
                (0.1 * rng.randn(config.n_embeddings + 2, d)).astype(np.float32))
            self.wpe = tf.Variable((0.1 * rng.randn(256, d)).astype(np.float32))
            self.pose_embedding = MLP(7, 2 * d, d)
            self.pose_criterion = PoseCriterion()
            self.h = [Block() for _ in range(config.n_layer)]
            self.ln_f = LN(d)

    job = tmp_path / 'tiny-transformer-tf'
    job.mkdir()
    tf.train.Checkpoint(model=RefModel()).save(str(job / 'ckpt'))
    save_config(to_port(config), str(job))

    variables = tconvert.read_tf_checkpoint(str(job / 'ckpt-1'))
    assert '_CHECKPOINTABLE_OBJECT_GRAPH' in variables
    jvariables = jconvert.read_tf_checkpoint(str(job / 'ckpt-1'))
    jimported = jconvert.import_migt_from_tf(jconvert.resolve_keras_object_paths(jvariables),
                                             config)
    port = load_model(str(job), device='cpu')
    _assert_same_state(port.state_dict(),
                       tconvert.state_dict_from_jax(_port_model(to_port(config)), jimported))

    poses = rng.randn(1, 4, 7).astype(np.float32)
    poses[..., 3:] /= np.linalg.norm(poses[..., 3:], axis=-1, keepdims=True)
    tokens = rng.randint(0, 16, (1, 4, 2, 2))
    expected = JaxMIGT(config).apply({'params': jimported['params']}, jnp.asarray(poses[:, :3]),
                                     jnp.asarray(tokens))
    with torch.no_grad():
        out = port(torch.from_numpy(poses[:, :3]), torch.from_numpy(tokens))
    np.testing.assert_allclose(out['logits'].numpy(), np.asarray(expected['logits']),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
