"""The port's generate-codes (viewformer_tpu_torch.commands.generate_codes)
against the JAX package's on the CPU in f32, from the same weights:
LatentCodeTransformer over sequences that cross batch boundaries, and
generate_codes writing byte-equal token datasets (with a padded tail batch,
and with a --shards restriction)."""
import os

import numpy as np
import pytest
import torch

import jax

from test_generate_codes import CCONFIG, _items
from test_torch_config import to_port
from test_torch_image_data import files
from test_torch_serve import save_port_job
from viewformer_tpu.commands import generate_codes as jgc
from viewformer_tpu.data import generate_dataset_from_loader
from viewformer_tpu.data.loaders import build
from viewformer_tpu.models.vqgan import VQGAN as JVQGAN
from viewformer_tpu_torch.commands import generate_codes as tgc
from viewformer_tpu_torch.data.pipeline import load_token_dataset
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.utils.convert import state_dict_from_jax


@pytest.fixture(scope='module')
def codebook(tmp_path_factory):
    """(JAX model, variables, port model) with the same random weights, and
    job dirs of both packages."""
    from viewformer_tpu.train.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp('codebook')
    model = JVQGAN(CCONFIG)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.device_get(jax.jit(lambda a, b: model.init(
        {'params': a, 'quantizer': b}, np.zeros((1, 16, 16, 3), np.float32),
        training=False))(k1, k2))
    mgr = CheckpointManager(str(root / 'jax'), CCONFIG)
    mgr.save(0, dict(variables))
    mgr.close()
    port = AutoModel.from_config(to_port(CCONFIG), device='cpu',
                                 generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax(port, variables))
    return {'model': model, 'variables': variables, 'port': port,
            'jax_job': str(root / 'jax'), 'port_job': save_port_job(root / 'port', port)}


def test_transformer_matches_jax(codebook):
    """Sequences of 5, 9, 2 and 4 frames in batches of 4: the same codes
    and cameras, a sequence at a time, as JAX's transformer."""
    items = _items(np.random.RandomState(0), [5, 9, 2, 4])
    expected = list(jgc.LatentCodeTransformer(codebook['model'], codebook['variables'],
                                              batch_size=4)('train', iter(items)))
    transformer = tgc.LatentCodeTransformer(codebook['port'], batch_size=4)
    got = list(transformer('train', iter(items)))
    assert len(got) == len(expected) == len(items)
    for a, b, item in zip(got, expected, items):
        np.testing.assert_array_equal(a['cameras'], item['cameras'])
        assert a['codes'].shape == (len(item['frames']), 8, 8)
        np.testing.assert_array_equal(a['codes'], np.asarray(b['codes']))
    assert transformer.output_features(['cameras', 'frames']) == ['codes', 'cameras']
    assert transformer.output_features(['cameras-gqn', 'frames']) == ['codes', 'cameras-gqn']


@pytest.fixture(scope='module')
def image_dataset(tmp_path_factory):
    """colors at 16 px: train 5 sequences of 6 frames (30 frames, so
    batches of 8 leave a tail of 6), test 2, one sequence a shard."""
    root = str(tmp_path_factory.mktemp('images'))
    for split, n in (('train', 5), ('test', 2)):
        loader = build('colors', split=split, num_sequences=n, sequence_size=6, image_size=16)
        generate_dataset_from_loader(loader, split, os.path.join(root, 'colors'),
                                     max_sequences_per_shard=1, progress=False)
    return root


@pytest.mark.parametrize('shards', [None, '2:4'])
def test_generate_codes_is_byte_equal(codebook, image_dataset, tmp_path, shards):
    """generate_codes of both packages, batch 8 (each shard's 6 frames are
    one padded batch), write the same files: info.json with
    token_image_size, the indexes and the code shards; the port's token
    dataset reads through load_token_dataset."""
    jgc.generate_codes(image_dataset, str(tmp_path / 'jax'), codebook['jax_job'],
                       shards=shards, batch_size=8, progress=False)
    tgc.generate_codes(image_dataset, str(tmp_path / 'port'), codebook['port_job'],
                       shards=shards, batch_size=8, progress=False, use_bfloat16=False,
                       device='cpu')
    port, expected = files(str(tmp_path / 'port')), files(str(tmp_path / 'jax'))
    assert sorted(port) == sorted(expected)
    assert len([n for n in port if n.endswith('.tfrecord')]) == (7 if shards is None else 3)
    for name, data in expected.items():
        assert port[name] == data, name
    if shards is None:
        loader = load_token_dataset(str(tmp_path / 'port'), 2, 3, 8, shuffle=False)
        poses, tokens = next(iter(loader))
        loader.close()
        assert poses.shape == (2, 3, 7) and tokens.shape == (2, 3, 8, 8)


def test_generate_codes_needs_a_card_by_default(codebook, image_dataset, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tgc.generate_codes(image_dataset, str(tmp_path / 'out'), codebook['port_job'])
