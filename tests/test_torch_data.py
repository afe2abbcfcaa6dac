"""The port's token-dataset layer (viewformer_tpu_torch.data) against the JAX
package's (viewformer_tpu.data): the TFRecord and Example bytes, shards read
across packages, and load_token_dataset batch for batch at the same seed
(tokens exact, poses within 1e-6: the port's pose augmentation is torch f32,
JAX's numpy f32), on datasets written by the JAX package's writer."""
import functools
import os
import threading
import time

import numpy as np
import pytest

from viewformer_tpu.data import dataset as jds
from viewformer_tpu.data import pipeline as jpipe
from viewformer_tpu.data import tfrecord as jtf
from viewformer_tpu.train import transformer as jtt
from viewformer_tpu_torch.data import dataset as tds
from viewformer_tpu_torch.data import pipeline as tpipe
from viewformer_tpu_torch.data import tfrecord as ttf
from viewformer_tpu_torch.train import transformer as ttt

POSE_TOL = 1e-6


def _sequences(rng, n, dims=7, token_image_size=2, frames=(9, 15)):
    out = []
    for _ in range(n):
        count = rng.randint(*frames)
        cameras = rng.randn(count, dims).astype(np.float32)
        if dims == 7:
            cameras[:, 3:] /= np.linalg.norm(cameras[:, 3:], axis=-1, keepdims=True)
        out.append({'cameras': cameras,
                    'codes': rng.randint(0, 16, (count, token_image_size, token_image_size))})
    return out


def _write(root, name, splits, seed, dims=7, writer=jds):
    """A token dataset at root/name in the JAX package's layout, through
    `writer`'s write_shard and write_dataset_info: {split: shard count},
    three environments a shard."""
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    features = ['cameras-gqn' if dims == 5 else 'cameras', 'codes']
    for split, size in splits.items():
        writer.write_dataset_info(os.path.join(path, 'info.json'), {
            'name': name, 'features': features, 'token_image_size': 2, 'frame_size': 8,
            f'{split}_size': size, 'splits': [split]})
        for shard in range(1, size + 1):
            base = os.path.join(path, f'{name}-{split}-{shard:06d}-of-{size:06d}')
            writer.write_shard(base, _sequences(rng, 3, dims), features)
    return path


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tokens'))
    return {'a': _write(root, 'a', {'train': 3, 'test': 1}, 0),
            'b': _write(root, 'b', {'train': 2, 'val': 1, 'test': 1}, 1),
            'gqn': _write(root, 'gqn', {'train': 2, 'test': 1}, 2, dims=5)}


def test_example_and_record_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    features = {'cameras': ('float', rng.randn(21).astype(np.float32)),
                'codes': ('int64', np.array([0, 1, 1023, 2 ** 40, -5], np.int64)),
                'frames': ('bytes', [b'\x01\x02', b'jpeg' * 50])}
    payload = ttf.encode_example(features)
    assert payload == jtf.encode_example(features)
    payloads = [payload, b'', b'x' * 300]
    for module, name in ((ttf, 'port'), (jtf, 'jax')):
        with module.RecordWriter(str(tmp_path / f'{name}.tfrecord')) as writer:
            for p in payloads:
                writer.write(p)
    assert (tmp_path / 'port.tfrecord').read_bytes() == (tmp_path / 'jax.tfrecord').read_bytes()
    assert list(ttf.read_records(str(tmp_path / 'jax.tfrecord'), verify_crc=True)) == payloads
    decoded = ttf.decode_example(payload)
    np.testing.assert_array_equal(decoded['cameras'], features['cameras'][1])
    np.testing.assert_array_equal(decoded['codes'], features['codes'][1])
    assert decoded['frames'] == features['frames'][1]
    ttf.build_shard_index(str(tmp_path / 'port.tfrecord'), str(tmp_path / 'port.index'))
    assert jtf.read_shard_index(str(tmp_path / 'port.index')) == \
        list(jtf.read_record_spans(str(tmp_path / 'jax.tfrecord')))


@pytest.mark.parametrize('dims', [7, 5])
def test_shards_read_across_packages(tmp_path, dims):
    """A dataset written by the port equals, file for file, the one the JAX
    package writes from the same sequences, and each reads the other's."""
    port = _write(str(tmp_path / 'port'), 'd', {'train': 2}, 3, dims, writer=tds)
    jax_path = _write(str(tmp_path / 'jax'), 'd', {'train': 2}, 3, dims, writer=jds)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_path))
    for name in os.listdir(port):
        with open(os.path.join(port, name), 'rb') as a, open(os.path.join(jax_path, name),
                                                              'rb') as b:
            assert a.read() == b.read(), name
    assert tds.get_dataset_info(port) == jds.get_dataset_info(jax_path)
    info = jds.get_dataset_info(port)
    shard = os.path.join(port, 'd-train-000001-of-000002.tfrecord')
    expected = list(jds.read_shards([shard], info, split='train'))
    for payload, item in zip(ttf.read_records(shard), expected):
        example = ttf.decode_example(payload)
        cameras = example['cameras'].reshape(-1, dims)
        if dims == 5:
            cameras = tds.fix_legacy_gqn_cameras(cameras)
        np.testing.assert_allclose(cameras, item['cameras'], atol=POSE_TOL)
        np.testing.assert_array_equal(example['codes'].reshape(-1, 2, 2), item['codes'])
    # frames too: JPEG for RGB, PNG for RGBA, NCHW taken as NHWC, bytes as they are
    rng = np.random.RandomState(4)
    sequences = [{'frames': rng.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8),
                  'cameras': rng.randn(3, 7)},
                 {'frames': rng.randint(0, 256, (2, 4, 8, 8)).astype(np.uint8),
                  'cameras': rng.randn(2, 7)},
                 {'frames': [b'\xff\xd8 not decoded', b'raw'], 'cameras': rng.randn(2, 7)}]
    for writer in (tds, jds):
        writer.write_shard(str(tmp_path / writer.__name__), sequences, ['cameras', 'frames'])
    for ext in ('.tfrecord', '.index'):
        with open(str(tmp_path / tds.__name__) + ext, 'rb') as a, \
                open(str(tmp_path / jds.__name__) + ext, 'rb') as b:
            assert a.read() == b.read(), ext


def _batches(loader, limit=1000):
    out = []
    try:
        for batch in loader:
            out.append(batch)
            if len(out) >= limit:
                break
    finally:
        loader.close()
    return out


CASES = {
    'simple augment, two epochs': dict(path='a', augment='simple', repeat=2, seed=3),
    'advanced augment': dict(path='a', augment='advanced', repeat=1, seed=5),
    'comma-joined datasets': dict(path='a,b', augment='relative', repeat=1, seed=7),
    'val-to-test fallback': dict(path='a,b', augment='relative', split='test', shuffle=False),
    'gqn cameras': dict(path='gqn', augment='no', repeat=1, seed=1),
    'max samples per environment': dict(path='a,b', augment=None, repeat=1, seed=2,
                                        max_samples_per_environment=1),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_load_token_dataset_matches_jax(datasets, case):
    kwargs = dict(CASES[case])
    path = ','.join(datasets[name] for name in kwargs.pop('path').split(','))
    augment = kwargs.pop('augment')
    batches = {}
    for name, module, process in (('jax', jpipe, jtt.process_batch),
                                  ('port', tpipe, ttt.process_batch)):
        transform = functools.partial(process, augment=augment) if augment else None
        batches[name] = _batches(module.load_token_dataset(
            path, 2, 4, 2, transform=transform, **kwargs))
    assert len(batches['port']) == len(batches['jax']) > 0
    for (poses, tokens), (jposes, jtokens) in zip(batches['port'], batches['jax']):
        assert poses.shape == jposes.shape and poses.dtype == np.float32
        np.testing.assert_allclose(poses, jposes, atol=POSE_TOL, rtol=0)
        np.testing.assert_array_equal(tokens, jtokens)
        assert tokens.dtype == jtokens.dtype


@pytest.mark.parametrize('consumed', [2, 7])
def test_mid_epoch_start_state_continues_the_order(datasets, consumed):
    """A loader started from the cursor of one that handed out `consumed`
    batches (mid-epoch, and past the first epoch's end) yields the rest of
    the uninterrupted order, augmentation draws included."""
    kwargs = dict(batch_size=2, sequence_size=4, token_image_size=2, split='train', repeat=3,
                  seed=11, transform=functools.partial(ttt.process_batch, augment='simple'))
    full = _batches(tpipe.load_token_dataset(datasets['a'], **kwargs))
    assert len(full) > consumed
    data = tpipe.load_token_dataset(datasets['a'], **kwargs)
    try:
        it = iter(data)
        for _ in range(consumed):
            next(it)
        state = dict(data.state)
    finally:
        data.close()
    assert state['batch'] > 0
    resumed = _batches(tpipe.load_token_dataset(datasets['a'], start_state=state, **kwargs))
    assert len(resumed) == len(full) - consumed
    for (pa, ta), (pb, tb) in zip(resumed, full[consumed:]):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ta, tb)


def test_prefetcher_close_unblocks_abandoned_producer():
    """Leaving the iteration early leaves the producer blocked in queue.put;
    close() drains until the thread exits, and the source generator's
    cleanup runs."""
    closed = threading.Event()

    def factory():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    pf = tpipe.Prefetcher(factory, buffer_size=1)
    try:
        it = iter(pf)
        assert next(it) == 0
        time.sleep(0.05)  # let the producer fill the queue and block in put
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert closed.wait(timeout=5)


def test_host_shards_split_by_rank():
    """Without a process group the reader is rank 0 of 1; with one, the
    shards split by rank as in JAX."""
    assert tpipe._host_info() == (0, 1)
    paths = [f's{i}' for i in range(5)]
    for host in range(2):
        assert (tpipe._select_host_shards(paths, host, 2)
                == jpipe._select_host_shards(paths, host, 2))
    assert tpipe._select_host_shards(paths[:1], 1, 2) == ['s0']
