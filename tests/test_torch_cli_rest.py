"""The port's `dataset shuffle`, `dataset visualize` and `visualize codebook`
(data/shuffle.py, commands/visualize*.py, utils/visualization.py) against the
JAX package's: the shuffler's output byte for byte, make_grid, the headless
--output PNGs on the CPU, the missing-matplotlib error, and JAX's flags."""
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from viewformer_tpu.commands.visualize_codebook import make_grid as jax_make_grid
from viewformer_tpu.data.shuffle import shuffle_dataset as jax_shuffle_dataset
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.commands import visualize, visualize_codebook
from viewformer_tpu_torch.config import VQGANConfig
from viewformer_tpu_torch.data import shuffle as tshuffle
from viewformer_tpu_torch.data import tfrecord as ttf
from viewformer_tpu_torch.data.dataset import generate_dataset_from_loader
from viewformer_tpu_torch.data.loaders import get_loader
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.train.checkpoint import CheckpointManager

CODEBOOK = VQGANConfig(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[],
                       z_channels=32, embed_dim=8, n_embed=16, image_size=32,
                       perceptual_weight=0.0)


@pytest.fixture(scope='module')
def colors(tmp_path_factory):
    """A colors image dataset of 16 px frames: 7 train sequences of 3 frames
    in shards of at most 2 sequences, 5 test sequences in shards of at most
    5 images (2 sequences), without the shards' .index sidecars (the
    shufflers build them)."""
    root = str(tmp_path_factory.mktemp('colors'))
    output = os.path.join(root, 'colors')
    for split, num, limits in (('train', 7, {'max_sequences_per_shard': 2}),
                               ('test', 5, {'max_images_per_shard': 5})):
        loader = get_loader('colors')(num_sequences=num, sequence_size=3, image_size=16,
                                      split=split)
        generate_dataset_from_loader(loader, split, output, progress=False, **limits)
    for name in os.listdir(root):
        if name.endswith('.index') and '-of-' in name:
            os.unlink(os.path.join(root, name))
    return root


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tensors here are tiny, and the CPU's thread
    pool only adds contention when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root):
    return sorted(os.listdir(root))


def _records(root, split):
    """Every record's bytes of a split, shard by shard."""
    names = sorted(n for n in _files(root) if n.endswith('.tfrecord') and f'-{split}-' in n)
    return [[record for record in ttf.read_records(os.path.join(root, n))] for n in names]


@pytest.fixture(scope='module')
def shuffled(colors, tmp_path_factory):
    """(source, the JAX package's output, the port's output) at seed 5, each
    shuffler on its own copy of the source."""
    root = str(tmp_path_factory.mktemp('shuffled'))
    outputs = []
    for name, shuffle in (('jax', jax_shuffle_dataset), ('port', tshuffle.shuffle_dataset)):
        source = os.path.join(root, f'{name}-source')
        shutil.copytree(colors, source)
        shuffle(source, os.path.join(root, name), seed=5, progress=False)
        outputs.append((source, os.path.join(root, name)))
    return outputs


def test_shuffle_writes_jax_bytes(shuffled):
    """The port's output equals the JAX package's file for file, byte for
    byte (info.json, shards, their .index sidecars, the global indices), and
    so do the .index sidecars both built in their sources."""
    (jax_source, jax_out), (port_source, port_out) = shuffled
    assert _files(port_out) == _files(jax_out)
    assert any(n.endswith('.index') and '-of-' in n for n in _files(port_out))
    for name in _files(jax_out):
        with open(os.path.join(jax_out, name), 'rb') as f, \
                open(os.path.join(port_out, name), 'rb') as g:
            assert f.read() == g.read(), name
    assert _files(port_source) == _files(jax_source)
    for name in _files(jax_source):
        with open(os.path.join(jax_source, name), 'rb') as f, \
                open(os.path.join(port_source, name), 'rb') as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize('split,per_shard', [('train', 2), ('test', 2)])
def test_shuffle_moves_records_whole(colors, shuffled, split, per_shard):
    """The records are the source's, undecoded, in another order; the shard
    limits hold; each output shard's .index lists 'offset length' from 0."""
    _, (_, out) = shuffled
    source, moved = _records(colors, split), _records(out, split)
    flat_source = [r for shard in source for r in shard]
    flat_moved = [r for shard in moved for r in shard]
    assert sorted(flat_moved) == sorted(flat_source) and flat_moved != flat_source
    assert all(len(shard) <= per_shard for shard in moved)
    for i, shard in enumerate(moved, 1):
        base = os.path.join(out, f'colors-{split}-{i:06d}-of-{len(source):06d}')
        spans = ttf.read_shard_index(base + '.index')
        assert spans == list(ttf.read_record_spans(base + '.tfrecord'))
        assert spans[0][0] == 0 and len(spans) == len(shard)


def test_shuffle_refuses_existing_output(colors, tmp_path):
    with pytest.raises(RuntimeError, match='already exists'):
        tshuffle.shuffle_dataset(colors, str(tmp_path), progress=False)


@pytest.mark.parametrize('n,columns,size', [(16, 8, 4), (5, 4, 3), (1, 8, 2)])
def test_make_grid_matches_jax(n, columns, size):
    images = np.random.RandomState(n).randint(0, 256, (n, size, size + 1, 3)).astype(np.uint8)
    np.testing.assert_array_equal(visualize_codebook.make_grid(images, columns),
                                  jax_make_grid(images, columns))


def test_dataset_visualize_writes_png(tmp_path):
    out = str(tmp_path / 'preview.png')
    cli.main(['dataset', 'visualize', '--loader', 'colors', '--loader-num-sequences', '3',
              '--loader-sequence-size', '4', '--loader-image-size', '32', '--output', out,
              '--max-sequences', '2'])
    assert np.asarray(Image.open(out)).ndim == 3


@pytest.fixture(scope='module')
def codebook_job(tmp_path_factory):
    """A tiny random-weight codebook saved as a port job dir."""
    path = str(tmp_path_factory.mktemp('codebook') / 'job')
    model = AutoModel.from_config(CODEBOOK, device='cpu',
                                  generator=torch.Generator().manual_seed(0))
    mgr = CheckpointManager(path, CODEBOOK)
    mgr.save(0, {'model': model.state_dict(), 'step': 0})
    mgr.close()
    return path


def test_visualize_codebook_writes_grid(codebook_job, tmp_path):
    """4 (frame, reconstruction) pairs: 8 tiles in one 8-wide row, the
    originals at even columns, each reconstruction that of the codebook."""
    out = str(tmp_path / 'grid.png')
    cli.main(['visualize', 'codebook', '--loader', 'colors', '--loader-num-sequences', '2',
              '--loader-sequence-size', '4', '--codebook-model', codebook_job, '--output', out,
              '--num-images', '4', '--fp32', '--device', 'cpu'])
    grid = np.asarray(Image.open(out))
    assert grid.shape == (32, 8 * 32, 3)
    frames = np.asarray(get_loader('colors')(num_sequences=2, sequence_size=4, image_size=32,
                                             split='test')[0]['frames'])
    from viewformer_tpu_torch.models import load_model
    expected = visualize_codebook.reconstruction_grid(
        load_model(codebook_job, torch.float32, 'cpu'), frames)
    np.testing.assert_array_equal(grid, expected)
    np.testing.assert_array_equal(grid[:, :32], frames[0])


def test_visualize_commands_say_matplotlib_is_missing(monkeypatch, codebook_job):
    """Without matplotlib, `dataset visualize` and `visualize codebook`
    without --output raise an ImportError that names it."""
    monkeypatch.setitem(__import__('sys').modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='dataset visualize draws with matplotlib'):
        visualize.visualize_dataset([], output='never.png')
    loader = get_loader('colors')(num_sequences=1, sequence_size=2, image_size=32, split='test')
    with pytest.raises(ImportError, match='visualize codebook without --output draws with '
                                          'matplotlib'):
        visualize_codebook.visualize_codebook(loader, codebook_job, num_images=2,
                                              use_bfloat16=False, device='cpu')


def test_commands_take_jax_flags(monkeypatch):
    """The three commands take the JAX package's flags (--loader-<param> for
    the loaders) and pass them on."""
    seen = {}
    monkeypatch.setattr(tshuffle, 'shuffle_dataset',
                        lambda *a, **kw: seen.setdefault('shuffle', (a, kw)))
    monkeypatch.setattr(visualize, 'visualize_dataset',
                        lambda *a, **kw: seen.setdefault('dataset', (a, kw)))
    monkeypatch.setattr(visualize_codebook, 'visualize_codebook',
                        lambda *a, **kw: seen.setdefault('codebook', (a, kw)))
    cli.main(['dataset', 'shuffle', '--dataset', 'IN', '--output', 'OUT', '--seed', '7'])
    cli.main(['dataset', 'visualize', '--loader', 'colors', '--image-size', '32',
              '--output', 'p.png', '--max-sequences', '3', '--loader-num-sequences=2'])
    cli.main(['visualize', 'codebook', '--loader', 'colors', '--codebook-model', 'CB',
              '--output', 'g.png', '--num-images', '8', '--loader-num-sequences', '2'])
    assert seen['shuffle'] == (('IN', 'OUT'), {'seed': 7})
    (loader,), kwargs = seen['dataset']
    assert kwargs == {'output': 'p.png', 'max_sequences': 3}
    assert len(loader) == 2 and loader.image_size == 32
    (build, checkpoint), kwargs = seen['codebook']
    assert checkpoint == 'CB' and len(build(32)) == 2
    assert kwargs == {'output': 'g.png', 'num_images': 8, 'use_bfloat16': True,
                      'device': 'cuda'}
