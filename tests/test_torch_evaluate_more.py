"""The port's `evaluate transformer-multictx-allimg` and `evaluate
generate-gqn-images` (viewformer_tpu_torch.evaluate.multictx_allimg,
generate_images) against the JAX package's on the CPU, over a colors image
dataset that the JAX package writes, with the same weights in f32: the same
results.json keys and values within 1e-4, the same stored files (images
within 1 level: a code's decode may round the other way); and both commands
of the port's CLI."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from test_torch_evaluate import assert_results_close, jobs, stored_files  # noqa: F401
from viewformer_tpu.data import generate_dataset_from_loader
from viewformer_tpu.data import loaders as jloaders
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.data import loaders as tloaders
from viewformer_tpu_torch.evaluate import generate_images as tgenerate
from viewformer_tpu_torch.evaluate import multictx_allimg as tallimg

PORT = dict(use_bfloat16=False, device='cpu')


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """A colors dataset of 32 px frames: 2 train and 2 test sequences of 5."""
    root = tmp_path_factory.mktemp('more')
    for split in ('train', 'test'):
        loader = jloaders.build('colors', split=split, num_sequences=2, sequence_size=5,
                                image_size=32)
        generate_dataset_from_loader(loader, split, str(root / 'colors'),
                                     max_sequences_per_shard=2, progress=False)
    return str(root)


def assert_same_images(actual_dir, expected_dir):
    files = stored_files(actual_dir)
    assert files == stored_files(expected_dir)
    for name in files:
        if name.endswith('.png'):
            actual = np.asarray(Image.open(os.path.join(actual_dir, name))).astype(int)
            expected = np.asarray(Image.open(os.path.join(expected_dir, name))).astype(int)
            assert actual.shape == expected.shape and np.abs(actual - expected).max() <= 1, name
    return files


def _allimg_against_jax(dataset, jobs, tmp_path, **kwargs):  # noqa: F811
    from viewformer_tpu.evaluate.multictx_allimg import evaluate_transformer_multictx_allimg

    results = {}
    for name, fn, loaders, extra in (
            ('jax', evaluate_transformer_multictx_allimg, jloaders, {}),
            ('port', tallimg.evaluate_transformer_multictx_allimg, tloaders, PORT)):
        prefix = 'jax-' if name == 'jax' else ''
        loader = loaders.build('dataset', path=dataset, split='test')
        job_dir = str(tmp_path / name)
        results[name] = fn(loader, jobs[prefix + 'transformer'], jobs[prefix + 'codebook'],
                           job_dir, progress=False, **kwargs, **extra)
        with open(os.path.join(job_dir, 'results.json')) as f:
            assert json.load(f) == json.loads(json.dumps(results[name]))
    n_context = len(kwargs.get('context_views', [0] * 4))
    assert list(results['port']) == [f'ctx{i:02d}' for i in range(1, n_context + 1)]
    assert_results_close(results['port'], results['jax'])
    files = assert_same_images(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert f'gen_images/000000/gen-{n_context:02d}/004.png' in files


@pytest.mark.parametrize('kwargs', [
    dict(context_views=[0, 2], num_eval_sequences=1),
    dict(context_views=[1], keep_last_frame=True, num_eval_sequences=2),
])
def test_allimg_matches_jax(dataset, jobs, tmp_path, kwargs):  # noqa: F811
    """With the context views given, with and without keep_last_frame."""
    _allimg_against_jax(dataset, jobs, tmp_path, **kwargs)


@pytest.mark.slow
def test_allimg_default_context_matches_jax(dataset, jobs, tmp_path):  # noqa: F811
    """The default context, a default_rng(42) sample of sequence_size - 1
    views a sequence, over 2 sequences (~60 s, mostly JAX's eager
    metrics; test_allimg_default_context runs the port alone)."""
    _allimg_against_jax(dataset, jobs, tmp_path, num_eval_sequences=2)


def test_allimg_default_context(dataset, jobs, tmp_path):  # noqa: F811
    """The port alone with the default context: each sequence's context is
    the next default_rng(42) draw of sequence_size - 1 of its 5 frames, as in
    the reference."""
    loader = tloaders.build('dataset', path=dataset, split='test')
    result = tallimg.evaluate_transformer_multictx_allimg(
        loader, jobs['transformer'], jobs['codebook'], str(tmp_path), num_eval_sequences=2,
        progress=False, **PORT)
    assert list(result) == ['ctx01', 'ctx02', 'ctx03', 'ctx04']
    for row in result.values():
        assert row['lpips'] is None and all(np.isfinite(v) for k, v in row.items()
                                            if k != 'lpips')
    rng = np.random.default_rng(42)
    for seq in ('000000', '000001'):
        views = [int(x) for x in rng.choice(5, (4,), replace=False)]
        assert sorted(os.listdir(tmp_path / 'gen_images' / seq / 'ctx')) == \
            [f'{i:02d}-{c:03d}.png' for i, c in enumerate(views)]
        assert len(os.listdir(tmp_path / 'gen_images' / seq / 'gen-04')) == 5


def test_run_with_batchsize():
    """Chunks of batch_size, the tail as it is (the TPU's pad to one compiled
    shape is not ported), outputs concatenated; None passes through."""
    seen = []

    def fn(a, b):
        seen.append(len(a))
        return a * 2, None

    a = np.arange(10, dtype=np.float32)
    out, none = tallimg.run_with_batchsize(fn, 4, a, a)
    assert seen == [4, 4, 2] and none is None
    np.testing.assert_array_equal(out, a * 2)
    single = tallimg.run_with_batchsize(lambda x: x + 1, 4, np.ones((3, 2)))
    np.testing.assert_array_equal(single, np.full((3, 2), 2.0))


def test_generate_gqn_images_matches_jax(dataset, jobs, tmp_path):  # noqa: F811
    from viewformer_tpu.evaluate.generate_images import generate_gqn_images

    generate_gqn_images(dataset, str(tmp_path / 'jax'), jobs['jax-transformer'],
                        jobs['jax-codebook'], num_eval_sequences=2, progress=False)
    tgenerate.generate_gqn_images(dataset, str(tmp_path / 'port'), jobs['transformer'],
                                  jobs['codebook'], num_eval_sequences=2, progress=False, **PORT)
    files = assert_same_images(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert files == sorted([f'{kind}{i}.png' for i in range(2) for kind in ('gen', 'gt')]
                           + [f'c{i}_{j}.png' for i in range(2) for j in range(3)])


@pytest.mark.parametrize('command', ['transformer-multictx-allimg', 'generate-gqn-images'])
def test_cli_evaluate_more(dataset, jobs, tmp_path, command, capsys):  # noqa: F811
    """`python -m viewformer_tpu_torch evaluate <command>` against the
    function it calls."""
    models = ['--transformer-model', jobs['transformer'], '--codebook-model', jobs['codebook'],
              '--job-dir', str(tmp_path / 'cli'), '--fp32', '--device', 'cpu']
    if command == 'generate-gqn-images':
        cli.main(['evaluate', command, '--dataset-path', dataset] + models)
        tgenerate.generate_gqn_images(dataset, str(tmp_path / 'fn'), jobs['transformer'],
                                      jobs['codebook'], progress=False, **PORT)
    else:
        cli.main(['evaluate', command, '--loader', 'dataset', '--loader-path', dataset,
                  '--context-views', '0,3', '--keep-last-frame', '--num-eval-sequences', '1']
                 + models)
        assert 'Results:' in capsys.readouterr().out
        loader = lambda size: tloaders.build('dataset', path=dataset, split='test',  # noqa: E731
                                             image_size=size)
        expected = tallimg.evaluate_transformer_multictx_allimg(
            loader, jobs['transformer'], jobs['codebook'], str(tmp_path / 'fn'),
            context_views=[0, 3], keep_last_frame=True, num_eval_sequences=1,
            progress=False, **PORT)
        with open(tmp_path / 'cli' / 'results.json') as f:
            assert json.load(f) == json.loads(json.dumps(expected))
    files = stored_files(str(tmp_path / 'cli'))
    assert files == stored_files(str(tmp_path / 'fn')) and files
    for name in files:
        if name.endswith('.png'):
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'cli' / name)),
                                          np.asarray(Image.open(tmp_path / 'fn' / name)))
