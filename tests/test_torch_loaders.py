"""The port's loaders (viewformer_tpu_torch.data.loaders) against the JAX
package's: the colors loader item for item, the wrappers, and DatasetLoader
over a dataset that the JAX package's generate_dataset_from_loader wrote
(frames, cameras, chunks and seeded shuffles)."""
import numpy as np
import pytest

from viewformer_tpu.data import generate_dataset_from_loader
from viewformer_tpu.data import loaders as jloaders
from viewformer_tpu.data.loaders import _wrappers as jwrappers
from viewformer_tpu.data.loaders.colors import ColorsLoader as JaxColors
from viewformer_tpu_torch.data import loaders as tloaders
from viewformer_tpu_torch.data.dataset import read_dataset
from viewformer_tpu_torch.data.loaders import _wrappers as twrappers
from viewformer_tpu_torch.data.loaders.colors import ColorsLoader


def assert_same_items(actual, expected, n=None):
    assert len(actual) == len(expected)
    assert actual.num_images_per_sequence() == expected.num_images_per_sequence()
    for i in range(len(expected) if n is None else n):
        a, e = actual[i], expected[i]
        assert sorted(a) == sorted(e)
        for key in e:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(e[key]), err_msg=key)


@pytest.mark.parametrize('kwargs', [
    dict(split='test', num_sequences=3, sequence_size=4, image_size=32),
    dict(split='train', num_sequences=4, sequence_size=3, image_size=24, seed=7,
         shuffle=True),
    dict(split='test', num_sequences=4, sequence_size=5, image_size=32,
         shuffle_sequence_items=True),
])
def test_colors_matches_jax(kwargs):
    assert_same_items(tloaders.build('colors', **kwargs), jloaders.build('colors', **kwargs))


@pytest.mark.parametrize('wrap', ['fixed', 'resize_down', 'resize_up', 'items', 'sequences'])
def test_wrappers_match_jax(wrap):
    def make(w):
        inner = (ColorsLoader if w is twrappers else JaxColors)(
            'test', num_sequences=3, sequence_size=7, image_size=20)
        return {'fixed': lambda: w.FixedSequenceSizeLoader(inner, 3),
                'resize_down': lambda: w.ChangedImageSizeLoader(inner, 12),
                'resize_up': lambda: w.ChangedImageSizeLoader(inner, 32),
                'items': lambda: w.ShuffledLoader(inner, 5, shuffle_sequence_items=True),
                'sequences': lambda: w.ShuffledLoader(inner, 5, shuffle_sequences=True)}[wrap]()
    assert_same_items(make(twrappers), make(jwrappers))


def test_registry():
    """The JAX package's eight loader names, each built lazily from the port's
    own module (never from viewformer_tpu), with the same loader class
    names; get_loaders() holds all of them."""
    names = ['co3d', 'co3dv2', 'colors', 'dataset', 'interiornet', 'sevenscenes', 'shapenet',
             'sm7']
    assert tloaders.get_loader_names() == jloaders.get_loader_names() == names
    for name in names:
        loader_class = tloaders.get_loader(name).loader_class
        assert loader_class.__module__ == f'viewformer_tpu_torch.data.loaders.{name}'
        assert loader_class.__name__ == jloaders.get_loader(name).loader_class.__name__
    assert sorted(tloaders.get_loaders()) == names
    with pytest.raises(ValueError, match='Unknown loader'):
        tloaders.get_loader('bogus')


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """A colors dataset written by the JAX package: train sequences of 7
    frames at 32 px over two shards, JPEG frames."""
    root = tmp_path_factory.mktemp('loaders')
    for split, n in (('train', 5), ('test', 2)):
        loader = jloaders.build('colors', split=split, num_sequences=n, sequence_size=7,
                                image_size=32)
        generate_dataset_from_loader(loader, split, str(root / 'colors'),
                                     max_sequences_per_shard=3, progress=False)
    return str(root)


@pytest.mark.parametrize('kwargs', [
    dict(),
    dict(split='test'),
    dict(sequence_size=3),
    dict(sequence_size=3, shuffle=True, shuffle_buffer_size=4),
    dict(shuffle_sequence_items=True),
    dict(image_size=16),
])
def test_dataset_loader_matches_jax(dataset, kwargs):
    kwargs = dict(dict(path=dataset, split='train'), **kwargs)
    assert_same_items(tloaders.build('dataset', **kwargs), jloaders.build('dataset', **kwargs))


@pytest.mark.parametrize('seed', [3, 11])
def test_dataset_loader_seed(dataset, seed):
    """build('dataset', seed=...) passes the seed on; the JAX package's
    build passes it twice and raises TypeError, so its loader class is the
    oracle."""
    kwargs = dict(path=dataset, split='train', sequence_size=3, shuffle_buffer_size=4)
    port = tloaders.build('dataset', shuffle=True, seed=seed, **kwargs)
    with pytest.raises(TypeError, match='seed'):
        jloaders.build('dataset', shuffle=True, seed=seed, **kwargs)
    expected = jloaders.get_loader('dataset').loader_class(
        shuffle_sequences=True, shuffle_sequence_items=True, seed=seed, **kwargs)
    assert_same_items(port, expected)


def test_read_dataset_matches_jax(dataset):
    """The shard reader against the JAX package's: the decoded frames, the
    cameras, and the encoded frames with _decode_image=False."""
    from viewformer_tpu.data.dataset import read_dataset as jax_read_dataset

    items = list(read_dataset(dataset, 'train', shards=[2]))
    expected = list(jax_read_dataset(dataset, 'train', shards=[2]))
    assert len(items) == len(expected) == 2
    for item, ref in zip(items, expected):
        assert item['frames'].shape == (7, 32, 32, 3) and item['frames'].dtype == np.uint8
        np.testing.assert_array_equal(item['frames'], ref['frames'])
        np.testing.assert_array_equal(item['cameras'], ref['cameras'])
    raw = next(iter(read_dataset(dataset, 'test', _decode_image=False)))
    assert raw['frames'] == next(iter(jax_read_dataset(dataset, 'test', _decode_image=False)))[
        'frames']
