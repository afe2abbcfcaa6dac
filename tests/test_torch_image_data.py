"""The port's image-dataset layer against the JAX package's:
generate_dataset_from_loader and transform_dataset write byte-equal files,
load_image_dataset yields equal batches (uint8 and f32, shuffled or not,
resumed mid-epoch), and SplitIndices selects the same indices. JAX decodes
with Pillow here (VIEWFORMER_NATIVE_JPEG=0), as the port does."""
import os

import numpy as np
import pytest

from viewformer_tpu import utils as jutils
from viewformer_tpu.data import dataset as jds
from viewformer_tpu.data import loaders as jloaders
from viewformer_tpu.data import pipeline as jpipeline
from viewformer_tpu_torch import utils as tutils
from viewformer_tpu_torch.data import dataset as tds
from viewformer_tpu_torch.data import loaders as tloaders
from viewformer_tpu_torch.data import pipeline as tpipeline


def files(path):
    """{relative path: bytes} of every file under path."""
    out = {}
    for d, _, names in os.walk(path):
        for name in names:
            with open(os.path.join(d, name), 'rb') as f:
                out[os.path.relpath(os.path.join(d, name), path)] = f.read()
    return out


def generate(package, loaders, root, splits, **kwargs):
    ds = tds if package == 'port' else jds
    for split in splits:
        loader = loaders.build('colors', split=split, num_sequences=splits[split],
                               sequence_size=5, image_size=8)
        ds.generate_dataset_from_loader(loader, split, os.path.join(root, 'colors'),
                                        progress=False, **kwargs)
    return root


@pytest.mark.parametrize('kwargs', [
    dict(max_sequences_per_shard=2),
    dict(max_images_per_shard=7, shards='1:3'),
], ids=['sequences', 'images-shards'])
def test_generate_dataset_is_byte_equal(tmp_path, kwargs):
    """info.json, the sequence index and every shard (with its .index) of
    a colors dataset (train 7 and test 3 sequences of 5 frames, 8 px)."""
    splits = {'train': 7, 'test': 3}
    port = files(generate('port', tloaders, str(tmp_path / 'port'), splits, **kwargs))
    expected = files(generate('jax', jloaders, str(tmp_path / 'jax'), splits, **kwargs))
    assert sorted(port) == sorted(expected)
    assert 'info.json' in port and 'colors-train.index' in port
    for name, data in expected.items():
        assert port[name] == data, name


class Invert:
    """A transformer for transform_dataset: frames inverted, cameras doubled."""
    image_size = 8

    def output_features(self, features):
        return ['cameras', 'frames']

    def update_dataset_info(self, info):
        return dict(info, inverted=True)

    def __call__(self, split, dataset):
        for item in dataset:
            yield dict(frames=255 - item['frames'], cameras=2 * item['cameras'])


@pytest.mark.parametrize('shards', [None, '2:4'])
def test_transform_dataset_is_byte_equal(tmp_path, shards):
    source = generate('jax', jloaders, str(tmp_path / 'source'), {'train': 5, 'test': 3},
                      max_sequences_per_shard=1)
    for name, ds in (('port', tds), ('jax', jds)):
        ds.transform_dataset(source, str(tmp_path / name), Invert(), shards=shards,
                             progress=False)
    port, expected = files(str(tmp_path / 'port')), files(str(tmp_path / 'jax'))
    assert sorted(port) == sorted(expected)
    for name, data in expected.items():
        assert port[name] == data, name


@pytest.fixture(scope='module')
def image_dataset(tmp_path_factory):
    """A colors dataset of 1300 train frames (more than the 1000-frame
    shuffle buffer) in 7 shards, and 40 test frames."""
    return generate('jax', jloaders, str(tmp_path_factory.mktemp('images')),
                    {'train': 65, 'test': 8}, max_sequences_per_shard=10)


def _batches(loader, n):
    out = []
    try:
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
    finally:
        loader.close()
    return out


CASES = {
    'uint8-shuffled': dict(output_dtype='uint8'),
    'f32-shuffled': dict(output_dtype='float32', seed=3),
    'uint8-in-order': dict(output_dtype='uint8', shuffle=False, split='test', repeat=1),
    'f32-in-order-resumed': dict(output_dtype='float32', shuffle=False,
                                 start_state={'epoch': 1, 'batch': 5}),
    'uint8-shuffled-resumed': dict(output_dtype='uint8', start_state={'epoch': 0, 'batch': 7}),
    # the colors quality gate's codebook stage: batches of 32 at seed 42, as
    # train_codebook asks (45 of them cross the 1300-frame epoch)
    'gate-flags': dict(output_dtype='uint8', seed=42, batch_size=32),
}


@pytest.mark.parametrize('case', list(CASES))
def test_load_image_dataset_matches_jax(image_dataset, monkeypatch, case):
    """Batches of 64 across an epoch boundary (20 a 1300-frame epoch), or of
    32 at the quality gate's seed (45), equal to the JAX package's batch for
    batch, with the same cursors."""
    monkeypatch.setenv('VIEWFORMER_NATIVE_JPEG', '0')
    kwargs = dict(split='train', repeat=-1, seed=11)
    kwargs.update(CASES[case])
    n = 3 if kwargs.get('repeat') == 1 else 25
    batch_size = kwargs.pop('batch_size', 64 if n > 3 else 16)
    n = 45 if batch_size == 32 else n
    port = tpipeline.load_image_dataset(image_dataset, batch_size, 8, **kwargs)
    expected = jpipeline.load_image_dataset(image_dataset, batch_size, 8, **kwargs)
    got, want = _batches(port, n), _batches(expected, n)
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert port.state == expected.state


def test_load_image_dataset_refusals(image_dataset):
    with pytest.raises(ValueError, match='image size'):
        tpipeline.load_image_dataset(image_dataset, 4, 16)
    with pytest.raises(ValueError, match='output_dtype'):
        tpipeline.load_image_dataset(image_dataset, 4, 8, output_dtype='float16')


def test_load_image_dataset_reads_ahead_a_bounded_window(image_dataset, monkeypatch):
    """Over shards of endless records, the first batch comes out and the
    reader stops a few batches ahead of the consumer, instead of reading
    the whole epoch before the first batch (a stream read past 2000
    records a shard fails)."""
    payload = next(iter(tpipeline.read_records(
        os.path.join(image_dataset, 'colors-train-000001-of-000007.tfrecord'))))
    reads = []

    def endless_records(path):
        while True:
            reads.append(path)
            assert len(reads) < 2000 * 7, 'read the stream whole'
            yield payload

    monkeypatch.setattr(tpipeline, 'read_records', endless_records)
    loader = tpipeline.load_image_dataset(image_dataset, 4, 8, shuffle=False,
                                          output_dtype='uint8', buffer_size=2)
    got = _batches(loader, 1)
    assert len(got) == 1 and got[0].shape == (4, 8, 8, 3)
    # frames: the batch taken, 2 queued, 1 being filled, a window of 2
    # batches in decode, and the rest of the records they came from
    assert len(reads) * 5 <= 6 * 4 + 5 * tpipeline.INTERLEAVE_SHARDS


@pytest.mark.parametrize('spec', ['1:10:2,15', '3', '2:', ':4', '1,5:8,12:20:3'])
def test_split_indices_match_jax(spec):
    port, expected = tutils.SplitIndices(spec), jutils.SplitIndices(spec)
    assert str(port) == str(expected)
    assert [i in port for i in range(25)] == [i in expected for i in range(25)]
    assert port.left_limit() == expected.left_limit()
    for other in (range(1, 9), '0:30', [2, 3, 15]):
        assert str(port.restrict(other)) == str(expected.restrict(other))
    if not spec.endswith(':'):
        assert list(port) == list(expected)
    assert str(tutils.SplitIndices(range(2, 9, 3))) == str(jutils.SplitIndices(range(2, 9, 3)))
