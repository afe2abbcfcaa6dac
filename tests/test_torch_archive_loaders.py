"""The port's ArchiveStore, LazyArray, numpy camera helpers and the
sevenscenes, shapenet, co3dv2, co3d, interiornet and sm7 loaders against the
JAX package's, over synthetic files written under tmp_path: frames equal
byte for byte, cameras within 1e-6, the same lengths, sequence sizes and
extras (frames_files, sequence_id, depthmaps)."""
import gzip
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from test_co3d_stub import FAKE_SEQS, _write_fake_co3d
from test_evaluate_sevenscenes import _make_sevenscenes_fixture
from viewformer_tpu.data import archive as jarchive
from viewformer_tpu.data import loaders as jloaders
from viewformer_tpu.data.loaders import _wrappers as jwrappers
from viewformer_tpu.utils import geometry as jgeometry
from viewformer_tpu_torch.data import archive as tarchive
from viewformer_tpu_torch.data import loaders as tloaders
from viewformer_tpu_torch.data.loaders import _wrappers as twrappers
from viewformer_tpu_torch.utils import np_geometry

CAMERA_TOL = 1e-6


def assert_same_loader(actual, expected):
    """Item for item: frames byte-equal, cameras within CAMERA_TOL, every
    other entry equal."""
    assert len(actual) == len(expected)
    assert actual.num_images_per_sequence() == expected.num_images_per_sequence()
    for i in range(len(expected)):
        a, e = actual[i], expected[i]
        assert sorted(a) == sorted(e)
        for key in e:
            if key == 'cameras':
                assert np.asarray(a[key]).dtype == np.asarray(e[key]).dtype == np.float32
                np.testing.assert_allclose(np.asarray(a[key]), np.asarray(e[key]),
                                           rtol=0, atol=CAMERA_TOL)
            elif isinstance(e[key], (str, list)):
                assert a[key] == e[key], key
            else:
                av, ev = np.asarray(a[key]), np.asarray(e[key])
                assert av.dtype == ev.dtype, key
                np.testing.assert_array_equal(av, ev, err_msg=key)


def _png(array):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, 'PNG')
    return buf.getvalue()


def _random_rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return jgeometry.quaternion_to_rotation_matrix(q)


@pytest.mark.parametrize('prefix', ['', 'scene/', 'data/./'])
def test_archive_store_matches_jax(tmp_path, prefix):
    """ls, glob (fnmatch * crosses /), open, nested zips and the context's
    extraction, with the members under no prefix, the archive's name or a
    `/./` prefix."""
    inner = io.BytesIO()
    with zipfile.ZipFile(inner, 'w') as z:
        z.writestr('x.txt', 'inner')
    with zipfile.ZipFile(tmp_path / 'scene.zip', 'w') as z:
        z.writestr(prefix + 'a.txt', 'hello')
        z.writestr(prefix + 'sub/', '')
        z.writestr(prefix + 'sub/b.txt', 'world')
        z.writestr(prefix + 'nested.zip', inner.getvalue())
    (tmp_path / 'other.tar.gz').write_bytes(b'')
    results = {}
    for name, module in (('jax', jarchive), ('port', tarchive)):
        with module.ArchiveStore.with_context() as ctx:
            with module.ArchiveStore(str(tmp_path / 'scene')) as store:
                with store.open('sub/b.txt') as f:
                    text = f.read()
                extracted = os.path.exists(os.path.join(ctx.path, 'scene', 'sub', 'b.txt'))
                with module.ArchiveStore(store.open('nested.zip', 'rb')) as nested:
                    with nested.open('x.txt') as f:
                        nested_text = f.read()
                results[name] = (sorted(store.ls('')), store.ls('sub/'), sorted(store.glob('*.txt')),
                                 text, extracted, nested_text)
        results[name] += (module.ArchiveStore.list_archives(str(tmp_path)),)
        with pytest.raises(RuntimeError, match='Tar is not supported'):
            module.ArchiveStore(str(tmp_path / 'other')).__enter__()
        with pytest.raises(RuntimeError, match='File not found'):
            module.ArchiveStore(str(tmp_path / 'missing')).__enter__()
    assert results['port'] == results['jax']
    assert results['port'][0] == ['a.txt', 'nested.zip', 'sub']
    assert results['port'][2] == ['a.txt', 'sub/b.txt']
    assert results['port'][4] and results['port'][-1] == ['other', 'scene']


def test_lazy_array_matches_jax():
    calls = []

    def read(x):
        calls.append(x)
        return np.full((2, 3), x, np.int16)

    port, ref = twrappers.LazyArray([5, 6, 7], read), jwrappers.LazyArray([5, 6, 7], read)
    for index in (1, -1, slice(0, 2), slice(1, None), [2, 0]):
        np.testing.assert_array_equal(port[index], ref[index])
    assert port.shape == ref.shape == (3, 2, 3) and len(port) == 3
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))
    assert np.asarray(port, np.float32).dtype == np.float32
    calls.clear()
    taken = twrappers.ShuffledLoader._take(port, [2, 0])
    assert isinstance(taken, twrappers.LazyArray) and calls == []
    np.testing.assert_array_equal(np.asarray(taken), np.asarray(ref)[[2, 0]])


def test_np_geometry_matches_jax():
    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.float64):
        R = _random_rotations(rng, 64).astype(dtype)
        # also the branches where the trace is not positive
        R[:8] = np.diag([1.0, -1.0, -1.0]).astype(dtype)[None] @ R[:8]
        q = rng.randn(64, 4).astype(dtype)
        for name, args in (('rotation_matrix_to_quaternion', (R,)),
                           ('quaternion_normalize', (q,)),
                           ('quaternion_multiply', (q, q[::-1])),
                           ('quaternion_conjugate', (q,)),
                           ('quaternion_remove_sign', (q,)),
                           ('look_at_to_cameras', (q[:, :3], q[::-1, :3], q[:, 1:])),
                           ('quaternion_average', (q.reshape(4, 16, 4),))):
            actual = getattr(np_geometry, name)(*args)
            expected = getattr(jgeometry, name)(*args)
            assert actual.dtype == expected.dtype, name
            np.testing.assert_array_equal(actual, expected, err_msg=name)


@pytest.fixture(scope='module')
def scenes_path(tmp_path_factory):
    """The 7-Scenes fixture of test_evaluate_sevenscenes (chess: 24 train
    frames in seq-01, 3 test frames in seq-02, 32 px) written twice, so
    that each package extracts into its own directory."""
    root = tmp_path_factory.mktemp('7scenes_loader')
    for name in ('jax', 'port'):
        os.makedirs(root / name)
        _make_sevenscenes_fixture(str(root / name))
    return root


@pytest.mark.parametrize('kwargs', [dict(split='train'), dict(split='test'), dict(),
                                    dict(split='train', sequence_size=5, image_size=16)])
def test_sevenscenes_matches_jax(scenes_path, kwargs):
    kwargs = dict(scenes=['chess'], _load_file_paths=True, **kwargs)
    port = tloaders.build('sevenscenes', path=str(scenes_path / 'port'), **kwargs)
    expected = jloaders.build('sevenscenes', path=str(scenes_path / 'jax'), **kwargs)
    assert_same_loader(port, expected)
    if 'sequence_size' not in kwargs:
        inner = tloaders.get_loader('sevenscenes').loader_class(str(scenes_path / 'port'),
                                                                **kwargs)
        assert inner.get_intrinsics() == (640, 480, 585, 585, 320, 240)
        assert inner[0]['frames_files'][0] == f'seq-{1 if kwargs.get("split") != "test" else 2:02}/frame-000000'


def test_shapenet_matches_jax(tmp_path, monkeypatch):
    import viewformer_tpu.data.loaders.shapenet as jshapenet
    import viewformer_tpu_torch.data.loaders.shapenet as tshapenet

    rng = np.random.RandomState(1)
    for seq in ('seq0', 'seq1', '4cce557de0c31a0e70a43c2d978e502e'):
        seq_dir = tmp_path / 'cars_train' / seq
        (seq_dir / 'pose').mkdir(parents=True)
        (seq_dir / 'rgb').mkdir()
        R = _random_rotations(rng, 4)
        for i in range(4):
            pose = np.eye(4)
            pose[:3, :3], pose[:3, 3] = R[i], rng.randn(3)
            (seq_dir / 'pose' / f'{i:06d}.txt').write_text(
                ' '.join(str(v) for v in pose.reshape(-1)))
            Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(
                seq_dir / 'rgb' / f'{i:06d}.png')
    for module in (jshapenet, tshapenet):  # the published sizes, cut to the fixture
        monkeypatch.setitem(module._SEQ_SIZES, 'cars_train', (2, 4))
    for kwargs in (dict(), dict(sequences=['seq1', 'missing']), dict(sequence_size=2)):
        kwargs = dict(path=str(tmp_path), split='train', categories='cars', **kwargs)
        port, expected = tloaders.build('shapenet', **kwargs), jloaders.build('shapenet', **kwargs)
        assert_same_loader(port, expected)
        assert port[0]['sequence_id'] == ('seq1' if 'sequences' in kwargs else 'seq0')


@pytest.mark.parametrize('layout', ['set_lists.json', 'set_lists/'])
def test_co3dv2_matches_jax(tmp_path, layout):
    rng = np.random.RandomState(2)
    category = tmp_path / 'apple'
    (category / 'images').mkdir(parents=True)
    (category / 'masks').mkdir(parents=True)
    annotations, data_list = [], []
    for seq in ('seqA', 'seqB'):
        for fn in range(3):
            img_path, mask_path = f'apple/images/{seq}_{fn}.png', f'apple/masks/{seq}_{fn}.png'
            Image.fromarray(rng.randint(0, 255, (20, 20, 3), np.uint8)).save(tmp_path / img_path)
            Image.fromarray(rng.randint(0, 255, (20, 20), np.uint8)).save(tmp_path / mask_path)
            annotations.append({'sequence_name': seq, 'frame_number': fn,
                                'image': {'path': img_path}, 'mask': {'path': mask_path},
                                'viewpoint': {'R': _random_rotations(rng, 1)[0].tolist(),
                                              'T': rng.randn(3).tolist()}})
            data_list.append([seq, fn, img_path])
    with gzip.open(category / 'frame_annotations.jgz', 'wt') as f:
        json.dump(annotations, f)
    if layout == 'set_lists.json':
        (category / 'set_lists.json').write_text(json.dumps({'fewview_train': data_list}))
    else:
        (category / 'set_lists').mkdir()
        (category / 'set_lists' / 'set_lists_fewview_train.json').write_text(
            json.dumps({'train': data_list[:4], 'test': data_list[4:]}))
    kwargs = dict(path=str(tmp_path), split='train', categories=['apple'], image_size=16)
    port = tloaders.build('co3dv2', **kwargs)
    assert_same_loader(port, jloaders.build('co3dv2', **kwargs))
    frames = port[0]['frames']
    assert frames.shape[1:] == (16, 16, 4)
    assert (frames[..., :3][frames[..., 3] <= 127] == 0).all()


@pytest.fixture()
def fake_co3d(tmp_path, monkeypatch):
    """test_co3d_stub's stand-in for facebookresearch's co3d code, placed
    where both packages' co3d loaders look for it."""
    import viewformer_tpu.data.loaders.co3d as jco3d
    import viewformer_tpu_torch.data.loaders.co3d as tco3d

    root = tmp_path / 'co3d_code'
    _write_fake_co3d(root)
    for module in (jco3d, tco3d):
        monkeypatch.setattr(module, '_co3d_code_path', lambda: str(root))
    yield root
    for name in list(sys.modules):  # the stand-in's modules must not leak
        if name == 'dataset' or name.startswith(('dataset.', 'evaluation', 'eval_demo')):
            del sys.modules[name]


@pytest.mark.parametrize('split', ['test', 'train'])
def test_co3d_matches_jax(fake_co3d, split):
    kwargs = dict(path='/nonexistent', split=split, categories='apple')
    port = tloaders.build('co3d', **kwargs)
    assert_same_loader(port, jloaders.build('co3d', **kwargs))
    assert len(port) == len(FAKE_SEQS) and port[1]['sequence_id'] == 'seqB'


def test_co3d_never_downloads(tmp_path, monkeypatch):
    """Without the co3d code the port's loader raises and touches no network;
    its camera conversion equals JAX's."""
    import urllib.request

    import viewformer_tpu.data.loaders.co3d as jco3d
    import viewformer_tpu_torch.data.loaders.co3d as tco3d

    def no_network(*args, **kwargs):
        raise AssertionError('the co3d loader reached for the network')

    monkeypatch.setattr(urllib.request, 'urlopen', no_network)
    monkeypatch.setattr(tco3d, '_co3d_code_path', lambda: str(tmp_path / 'absent'))
    with pytest.raises(FileNotFoundError, match='not downloaded'):
        tloaders.build('co3d', path=str(tmp_path), split='test')
    rng = np.random.RandomState(3)
    m = np.tile(np.eye(4), (6, 1, 1))
    m[:, :3, :3], m[:, :3, 3] = _random_rotations(rng, 6), rng.randn(6, 3)
    for matrices in (m, m.astype(np.float32)):
        np.testing.assert_array_equal(tco3d.CO3DLoader.world_to_camera_to_cameras(matrices),
                                      jco3d.CO3DLoader.world_to_camera_to_cameras(matrices))


def _cam_render(rng, ids):
    """A cam0.render of poses (eye, look-at, up) for ids, each id's row twice
    (the parser keeps the first) and a comment line."""
    lines = ['# timestamp eye lookat up']
    for pose_id in ids:
        row = ' '.join(f'{v:.6f}' for v in np.concatenate(
            [rng.randn(3), rng.randn(3) + 3.0, [0.0, 0.0, 1.0]]))
        lines += [f'{pose_id} {row}', f'{pose_id} {row}']
    return '\n'.join(lines) + '\n'


@pytest.fixture(scope='module')
def interiornet_path(tmp_path_factory):
    """GroundTruth_HD1-HD6/ with one HD1 scene's poses, HD1/ with its frames
    (two trajectories of 5 frames), and HD7/ with four environments of 8
    frames (one of them on the ignored list, one frame of another corrupt)."""
    rng = np.random.RandomState(4)
    root = tmp_path_factory.mktemp('interiornet')
    for d in ('GroundTruth_HD1-HD6', 'HD1', 'HD7'):
        os.makedirs(root / d)
    with zipfile.ZipFile(root / 'GroundTruth_HD1-HD6' / 'scene1.zip', 'w') as gt, \
            zipfile.ZipFile(root / 'HD1' / 'scene1.zip', 'w') as hd:
        for postfix in ('1_1', '1_2'):
            ids = [str(1000 + 10 * k) for k in range(5)]
            gt.writestr(f'velocity_angular_{postfix}/', '')
            gt.writestr(f'velocity_angular_{postfix}/cam0.render', _cam_render(rng, ids))
            for pose_id in ids:
                hd.writestr(f'original_{postfix}/cam0/data/{pose_id}.png',
                            _png(rng.randint(0, 255, (8, 8, 3), np.uint8)))
    for env in ('envA', 'envB', 'envC', '3FO4K5I8T7KR'):
        with zipfile.ZipFile(root / 'HD7' / f'{env}.zip', 'w') as z:
            ids = [str(2000 + k) for k in range(8)]
            z.writestr('cam0.render', _cam_render(rng, ids))
            for k, pose_id in enumerate(ids):
                data = (b'not a png' if (env, k) == ('envB', 1)
                        else _png(rng.randint(0, 255, (8, 8, 3), np.uint8)))
                z.writestr(f'cam0/data/{pose_id}.png', data)
    return str(root)


@pytest.mark.parametrize('kwargs', [
    dict(split='test', parts='1,7', sequence_size=4, max_environments_per_scene=2),
    dict(split='train', parts='7', sequence_size=4, max_environments_per_scene=2),
    dict(split='test', parts='1', sequence_size=5, max_environments_per_scene=2,
         shuffle_sequence_items=True),
    dict(split='train', sequence_size=2, max_environments_per_scene=3, shuffle_sequences=True),
])
def test_interiornet_matches_jax(interiornet_path, kwargs, capsys):
    """HD1 (the first 3% of the files, so its one scene is the test split)
    and HD7; envB's corrupt frame is in the train split, read and resampled
    by both packages."""
    from viewformer_tpu.utils import SplitIndices as JaxSplitIndices
    from viewformer_tpu_torch.utils import SplitIndices

    kwargs = dict(path=interiornet_path, **kwargs)
    loaders = {}
    for name, registry, split_indices in (('port', tloaders, SplitIndices),
                                          ('jax', jloaders, JaxSplitIndices)):
        args = dict(kwargs)
        if 'parts' in args:
            args['parts'] = split_indices(args['parts'])
        loaders[name] = registry.build('interiornet', **args)
    assert len(loaders['port']) > 0
    assert_same_loader(loaders['port'], loaders['jax'])
    err = capsys.readouterr().err
    assert ('Invalid image file "cam0/data/2001.png"' in err) == (kwargs['split'] == 'train')
    inner = loaders['port']
    while not hasattr(inner, 'close'):
        inner = inner.inner
    inner.close()


def test_sm7_matches_jax(tmp_path):
    """A local mirror of the GQN test shards (legacy 5-d cameras), read in
    order and backwards; a remote path raises in the port."""
    from viewformer_tpu.data.dataset import write_shard

    rng = np.random.RandomState(5)
    base = tmp_path / 'shepard_metzler_7_parts' / 'test'
    base.mkdir(parents=True)
    for shard in (1, 2):
        sequences = [dict(frames=rng.randint(0, 255, (15, 64, 64, 3), np.uint8),
                          cameras=rng.randn(15, 5).astype(np.float32)) for _ in range(2)]
        write_shard(str(base / 'dummy'), sequences, ['frames', 'cameras-gqn'])
        os.rename(base / 'dummy.tfrecord', base / f'{shard:03d}-of-100.tfrecord')
    kwargs = dict(split='test', path=str(tmp_path / 'shepard_metzler_7_parts'))
    port, expected = tloaders.build('sm7', **kwargs), jloaders.build('sm7', **kwargs)
    assert len(port) == len(expected) == 200000
    assert port.num_images_per_sequence()[:3] == expected.num_images_per_sequence()[:3]
    port.shards, expected.shards = port.shards[:2], expected.shards[:2]
    for i in (0, 1, 3, 2):  # in order, then backwards (the iterator restarts)
        a, e = port[i], expected[i]
        assert sorted(a) == sorted(e) == ['cameras', 'frames']
        np.testing.assert_array_equal(a['frames'], e['frames'])
        np.testing.assert_allclose(a['cameras'], e['cameras'], rtol=0, atol=CAMERA_TOL)
        assert a['cameras'].shape == (15, 7)
    with pytest.raises(ValueError, match='local mirror'):
        tloaders.build('sm7', split='test')
