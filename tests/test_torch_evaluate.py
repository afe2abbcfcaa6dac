"""The port's evaluators (viewformer_tpu_torch.evaluate) against the JAX
package's on the CPU, with the same weights (f32): Evaluator and
MultiContextEvaluator on seeded arrays; evaluate_transformer,
evaluate_transformer_multictx and evaluate_codebook over the colors loader
(the same results.json keys, values within 1e-4, the same stored files);
and the three `evaluate` commands of the port's CLI."""
import json
import os

import numpy as np
import pytest

import jax

from test_serve import CCONFIG, TCONFIG
from test_torch_serve import jax_variables, port_model, save_port_job
from viewformer_tpu.data import loaders as jloaders
from viewformer_tpu.evaluate import evaluator as jevaluator
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.data import loaders as tloaders
from viewformer_tpu_torch.evaluate import evaluator as tevaluator

LOADER = dict(split='test', num_sequences=4, sequence_size=5)
TOL = 1e-4


def assert_results_close(actual, expected):
    assert list(actual) == list(expected)
    for key, value in expected.items():
        if isinstance(value, dict):
            assert_results_close(actual[key], value)
        elif value is None:
            assert actual[key] is None, key
        else:
            np.testing.assert_allclose(actual[key], value, rtol=TOL, atol=TOL, err_msg=key)


def stored_files(job_dir):
    return sorted(os.path.relpath(os.path.join(d, f), job_dir)
                  for d, _, files in os.walk(job_dir) for f in files)


@pytest.fixture(scope='module')
def jobs(tmp_path_factory):
    """The same random weights as job dirs of both packages."""
    from viewformer_tpu.models import load_model
    from viewformer_tpu.train.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp('evaluate')
    _, cvars, _, tvars = jax_variables()
    paths = {}
    for name, config, variables in (('codebook', CCONFIG, cvars), ('transformer', TCONFIG, tvars)):
        mgr = CheckpointManager(str(root / f'jax-{name}'), config)
        mgr.save(0, dict(variables))
        mgr.close()
        paths[f'jax-{name}'] = str(root / f'jax-{name}')
        _, variables = load_model(paths[f'jax-{name}'])
        paths[name] = save_port_job(root / name, port_model(config, variables))
    return paths


def _images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _cameras(seed, shape):
    cameras = np.random.RandomState(seed).randn(*shape, 7).astype(np.float32)
    cameras[..., 3:] /= np.linalg.norm(cameras[..., 3:], axis=-1, keepdims=True)
    return cameras


@pytest.mark.parametrize('image_size', [None, 24])
def test_evaluator_matches_jax(image_size):
    """Two batches: 32 px ground truth against 16 px generated images
    (bilinear upsampling) with cameras, then without cameras."""
    jev = jevaluator.Evaluator(image_size=image_size)
    tev = tevaluator.Evaluator(image_size=image_size, device='cpu')
    for ev in (jev, tev):
        ev.update_state(_cameras(0, (3,)), _cameras(1, (3,)), _images(2, (3, 32, 32, 3)),
                        _images(3, (3, 16, 16, 3)))
        ev.update_state(None, None, _images(4, (2, 32, 32, 3)), _images(5, (2, 32, 32, 3)))
    result = tev.result()
    assert result['lpips'] is None
    assert_results_close(result, jev.result())
    assert tev.get_progress_bar_info().keys() == jev.get_progress_bar_info().keys()


def test_multi_context_evaluator_matches_jax(capsys):
    jev = jevaluator.MultiContextEvaluator(4)
    tev = tevaluator.MultiContextEvaluator(4, device='cpu')
    for ev in (jev, tev):
        ev.update_state(_cameras(0, (2,)), _cameras(1, (2, 4)), _images(2, (2, 16, 16, 3)),
                        _images(3, (2, 4, 16, 16, 3)))
    result = tev.result()
    assert list(result) == ['ctx01', 'ctx02', 'ctx03']
    assert_results_close(result, jev.result())
    jevaluator.print_metrics(result)  # the same table of the same numbers
    expected = capsys.readouterr().out
    tevaluator.print_metrics(result)
    assert capsys.readouterr().out == expected


@pytest.mark.parametrize('kind', ['transformer', 'transformer-multictx', 'codebook'])
def test_evaluate_matches_jax(jobs, tmp_path, kind):
    """Over the colors loader's 4 test sequences of 5 frames at the
    codebook's 32 px, in batches of 3 (a full and a tail batch), storing
    3 samples with their context frames."""
    from viewformer_tpu.evaluate import codebook as jcodebook
    from viewformer_tpu.evaluate import multictx as jmultictx
    from viewformer_tpu.evaluate import transformer as jtransformer
    from viewformer_tpu_torch.evaluate import codebook as tcodebook
    from viewformer_tpu_torch.evaluate import multictx as tmultictx
    from viewformer_tpu_torch.evaluate import transformer as ttransformer

    results = {}
    for package, loaders, fn in (
            ('jax', jloaders, {'transformer': jtransformer.evaluate_transformer,
                               'transformer-multictx': jmultictx.evaluate_transformer_multictx,
                               'codebook': jcodebook.evaluate_codebook}[kind]),
            ('port', tloaders, {'transformer': ttransformer.evaluate_transformer,
                                'transformer-multictx': tmultictx.evaluate_transformer_multictx,
                                'codebook': tcodebook.evaluate_codebook}[kind])):
        loader = lambda size, loaders=loaders: loaders.build('colors', image_size=size, **LOADER)  # noqa: E731
        prefix = 'jax-' if package == 'jax' else ''
        kwargs = {} if package == 'jax' else dict(use_bfloat16=False, device='cpu')
        job_dir = str(tmp_path / package)
        if kind == 'codebook':
            result = fn(loader, jobs[prefix + 'codebook'], job_dir, batch_size=6,
                        num_eval_images=15, num_store_images=3, progress=False, **kwargs)
        else:
            result = fn(loader, jobs[prefix + 'transformer'], jobs[prefix + 'codebook'], job_dir,
                        batch_size=3, num_store_images=3, store_ctx=True, progress=False,
                        **kwargs)
        with open(os.path.join(job_dir, 'results.json')) as f:
            assert json.load(f) == json.loads(json.dumps(result))
        results[package] = result
    assert_results_close(results['port'], results['jax'])
    files = stored_files(str(tmp_path / 'port'))
    assert files == stored_files(str(tmp_path / 'jax'))
    assert len([f for f in files if f.endswith('.png')]) >= 6


@pytest.mark.parametrize('kind', ['transformer', 'transformer-multictx', 'codebook'])
def test_cli_evaluate(jobs, tmp_path, kind, capsys):
    """`python -m viewformer_tpu_torch evaluate <kind> --loader colors
    --loader-num-sequences 4 ...` against the function it calls."""
    from viewformer_tpu_torch.evaluate import codebook as tcodebook
    from viewformer_tpu_torch.evaluate import multictx as tmultictx
    from viewformer_tpu_torch.evaluate import transformer as ttransformer

    argv = ['evaluate', kind, '--loader', 'colors', '--loader-num-sequences', '4',
            '--loader-sequence-size=5', '--codebook-model', jobs['codebook'],
            '--job-dir', str(tmp_path / 'cli'), '--num-store-images', '1', '--batch-size', '2',
            '--fp32', '--device', 'cpu']
    if kind != 'codebook':
        argv += ['--transformer-model', jobs['transformer']]
    cli.main(argv)
    assert 'Results:' in capsys.readouterr().out
    with open(tmp_path / 'cli' / 'results.json') as f:
        result = json.load(f)

    loader = lambda size: tloaders.build('colors', image_size=size, **LOADER)  # noqa: E731
    kwargs = dict(num_store_images=1, batch_size=2, use_bfloat16=False, device='cpu',
                  progress=False)
    if kind == 'codebook':
        expected = tcodebook.evaluate_codebook(loader, jobs['codebook'], str(tmp_path / 'fn'),
                                               **kwargs)
    else:
        fn = (ttransformer.evaluate_transformer if kind == 'transformer'
              else tmultictx.evaluate_transformer_multictx)
        expected = fn(loader, jobs['transformer'], jobs['codebook'], str(tmp_path / 'fn'),
                      **kwargs)
    assert result == json.loads(json.dumps(expected))
    assert stored_files(str(tmp_path / 'cli')) == stored_files(str(tmp_path / 'fn'))


def test_cli_loader_arguments():
    rest, kwargs = cli._split_loader_args(
        ['evaluate', 'codebook', '--loader', 'dataset', '--loader-path=/data/x-y',
         '--loader-shuffle', 'true', '--loader-num-sequences', '4', '--loader-rate', '0.5',
         '--job-dir', 'j'])
    assert rest == ['evaluate', 'codebook', '--loader', 'dataset', '--job-dir', 'j']
    assert kwargs == {'path': '/data/x-y', 'shuffle': True, 'num_sequences': 4, 'rate': 0.5}
