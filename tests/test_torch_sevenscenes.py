"""The port's 7-Scenes evaluators (viewformer_tpu_torch.evaluate.sevenscenes,
sevenscenes_baseline, sevenscenes_multictx) against the JAX package's on the
CPU, over the synthetic scene of test_evaluate_sevenscenes with the same
weights in f32: the helpers exactly, the baselines within 1e-6, the
results.json files within 1e-4 and the same stored files; the three
commands of the port's CLI; and where the port resizes frames (on the
host: CUDA's bilinear uint8 resize rounds otherwise)."""
import json
import os

import numpy as np
import pytest
import torch

from test_evaluate_sevenscenes import _make_sevenscenes_fixture
from test_torch_evaluate import assert_results_close, jobs, stored_files  # noqa: F401
from viewformer_tpu.evaluate import sevenscenes as jsevenscenes
from viewformer_tpu.evaluate import sevenscenes_baseline as jbaseline
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.evaluate import sevenscenes as tsevenscenes
from viewformer_tpu_torch.evaluate import sevenscenes_baseline as tbaseline

# 4 context views + the query: the transformer of test_serve (sequence_size 5)
CONTEXT = dict(scenes=['chess'], num_context_views=4, image_size=32, progress=False)
PORT = dict(use_bfloat16=False, device='cpu')


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """The scene written once for each package (each extracts its members
    next to its own chess.zip), and an image match map."""
    root = tmp_path_factory.mktemp('7scenes')
    for name in ('jax', 'port'):
        os.makedirs(root / name)
        _make_sevenscenes_fixture(str(root / name))
    match_map = root / 'chess.matches.txt'
    match_map.write_text(''.join(f'seq-02/frame-{q:06d}.color.png seq-01/frame-{m:06d}.color.png\n'
                                 for q in range(3) for m in (q + 7, q + 3)))
    return {'jax': str(root / 'jax'), 'port': str(root / 'port'),
            'match_map': str(root / '{scene}.matches.txt')}


def test_generate_other_viewpoints_matches_jax():
    camera = np.random.RandomState(0).randn(6, 1, 7).astype(np.float32)
    actual = tsevenscenes.generate_other_viewpoints(camera, np.random.RandomState(3))
    expected = jsevenscenes.generate_other_viewpoints(camera, np.random.RandomState(3))
    assert actual.dtype == np.float32
    np.testing.assert_array_equal(actual, expected)


def test_compute_camera_distances_matches_jax():
    rng = np.random.RandomState(1)
    db, camera = rng.randn(30, 7).astype(np.float32), rng.randn(1, 7).astype(np.float32)
    np.testing.assert_array_equal(tsevenscenes.compute_camera_distances(db, camera),
                                  jsevenscenes.compute_camera_distances(db, camera))
    for position in (True, False):
        np.testing.assert_array_equal(tbaseline._camera_distances(db, camera, position),
                                      jbaseline._camera_distances(db, camera, position))


@pytest.mark.parametrize('image_size', [None, 16])
def test_scene_lookup_matches_jax(scenes, image_size):
    port = tsevenscenes.SceneLookup(scenes['port'], 'chess', image_size)
    expected = jsevenscenes.SceneLookup(scenes['jax'], 'chess', image_size)
    assert port.files == expected.files and len(port) == 24
    np.testing.assert_array_equal(port.cameras, expected.cameras)
    for name in (port.files[0], port.files[17]):
        (camera, frame), (ref_camera, ref_frame) = port[name], expected[name]
        np.testing.assert_array_equal(camera, ref_camera)
        np.testing.assert_array_equal(port.camera(name), ref_camera)
        assert frame.dtype == np.uint8 and frame.shape == (image_size or 32,) * 2 + (3,)
        np.testing.assert_array_equal(frame, ref_frame)


@pytest.mark.parametrize('baseline', ['mean', 'position_oracle', 'orientation_oracle'])
def test_baseline_matches_jax(scenes, tmp_path, baseline):
    """All three test frames, contexts from the match map's top 2 and the
    seeded sample; the results equal JAX's within 1e-6."""
    results = {}
    for name, module in (('jax', jbaseline), ('port', tbaseline)):
        job_dir = str(tmp_path / name)
        results[name] = module.evaluate_sevenscenes_baseline(
            scenes[name], job_dir, image_match_map=scenes['match_map'], scenes=['chess'],
            num_eval_sequences=3, top_n_matched_images=2, baseline=baseline, progress=False)
        with open(os.path.join(job_dir, 'chess', 'results.json')) as f:
            assert json.load(f) == json.loads(json.dumps(results[name]['chess']))
    assert list(results['port']['chess']) == ['loc-angle', 'loc-dist', 'loc-angle-med',
                                              'loc-dist-med']
    for key, value in results['jax']['chess'].items():
        np.testing.assert_allclose(results['port']['chess'][key], value, rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    assert stored_files(str(tmp_path / 'port')) == stored_files(str(tmp_path / 'jax'))


def _jax_jobs(jobs):  # noqa: F811
    return jobs['jax-transformer'], jobs['jax-codebook']


@pytest.mark.parametrize('procedure, kwargs', [
    ('standard', dict(batch_size=1, num_eval_sequences=3)),
    ('standard', dict(batch_size=2, num_eval_sequences=3, image_match_map=True,
                      top_n_matched_images=2)),
    ('generated_images', dict(num_eval_sequences=1, num_gen_ctx=2)),
    ('pose_refinement', dict(num_eval_sequences=1, num_gen_ctx=2)),
])
def test_evaluate_sevenscenes_matches_jax(scenes, jobs, tmp_path, procedure, kwargs):  # noqa: F811
    """evaluate_sevenscenes of both packages: the per-scene and the top-level
    results.json within 1e-4, the same stored files (2 samples)."""
    if kwargs.pop('image_match_map', False):
        kwargs['image_match_map'] = scenes['match_map']
    results = {}
    for name, fn, (transformer, codebook), extra in (
            ('jax', jsevenscenes.evaluate_sevenscenes, _jax_jobs(jobs), {}),
            ('port', tsevenscenes.evaluate_sevenscenes,
             (jobs['transformer'], jobs['codebook']), PORT)):
        job_dir = str(tmp_path / name)
        results[name] = fn(scenes[name], transformer, codebook, job_dir,
                           generation_procedure=procedure, num_store_images=2,
                           **CONTEXT, **kwargs, **extra)
        for path, expected in ((job_dir, results[name]),
                               (os.path.join(job_dir, 'chess'), results[name]['chess'])):
            with open(os.path.join(path, 'results.json')) as f:
                assert json.load(f) == json.loads(json.dumps(expected))
    assert results['port']['chess']['lpips'] is None
    assert_results_close(results['port'], results['jax'])
    files = stored_files(str(tmp_path / 'port'))
    assert files == stored_files(str(tmp_path / 'jax'))
    assert 'chess/00000000-gen.png' in files


def test_evaluate_sevenscenes_multictx_matches_jax(scenes, jobs, tmp_path):  # noqa: F811
    from viewformer_tpu.evaluate.sevenscenes_multictx import \
        evaluate_sevenscenes_multictx as jax_evaluate
    from viewformer_tpu_torch.evaluate.sevenscenes_multictx import \
        evaluate_sevenscenes_multictx

    results = {}
    for name, fn, (transformer, codebook), extra in (
            ('jax', jax_evaluate, _jax_jobs(jobs), {}),
            ('port', evaluate_sevenscenes_multictx, (jobs['transformer'], jobs['codebook']),
             PORT)):
        results[name] = fn(scenes[name], transformer, codebook, str(tmp_path / name),
                           num_eval_sequences=3, batch_size=2, num_store_images=2,
                           **CONTEXT, **extra)
    assert list(results['port']['chess']) == ['ctx01', 'ctx02', 'ctx03', 'ctx04']
    assert_results_close(results['port'], results['jax'])
    assert stored_files(str(tmp_path / 'port')) == stored_files(str(tmp_path / 'jax'))


@pytest.mark.parametrize('command', ['7scenes', '7scenes-baseline', '7scenes-multictx'])
def test_cli_sevenscenes(scenes, jobs, tmp_path, command, capsys):  # noqa: F811
    """`python -m viewformer_tpu_torch evaluate <command> --path ...` against
    the function it calls."""
    from viewformer_tpu_torch.evaluate.sevenscenes_multictx import \
        evaluate_sevenscenes_multictx

    argv = ['evaluate', command, '--path', scenes['port'], '--job-dir', str(tmp_path / 'cli'),
            '--scenes', 'chess', '--num-eval-sequences', '2']
    if command == '7scenes-baseline':
        argv += ['--baseline', 'mean']
        expected = tbaseline.evaluate_sevenscenes_baseline(
            scenes['port'], str(tmp_path / 'fn'), scenes=['chess'], num_eval_sequences=2,
            baseline='mean', progress=False)
    else:
        argv += ['--transformer-model', jobs['transformer'], '--codebook-model',
                 jobs['codebook'], '--num-context-views', '4', '--image-size', '32',
                 '--num-store-images', '1', '--batch-size', '2', '--fp32', '--device', 'cpu']
        fn = (tsevenscenes.evaluate_sevenscenes if command == '7scenes'
              else evaluate_sevenscenes_multictx)
        if command == '7scenes-multictx':
            argv.append('--no-store-ctx')
        expected = fn(scenes['port'], jobs['transformer'], jobs['codebook'],
                      str(tmp_path / 'fn'), batch_size=2, num_eval_sequences=2,
                      num_store_images=1, **CONTEXT, **PORT,
                      **({'store_ctx': False} if command == '7scenes-multictx' else {}))
    cli.main(argv)
    assert 'Results on chess:' in capsys.readouterr().out
    with open(tmp_path / 'cli' / 'results.json') as f:
        assert json.load(f) == json.loads(json.dumps(expected))
    assert stored_files(str(tmp_path / 'cli')) == stored_files(str(tmp_path / 'fn'))


def test_frames_are_resized_on_the_host(monkeypatch):
    """upload_frames and Evaluator resize on the CPU and copy the result to
    the device (here 'meta', which runs no kernel): CUDA's bilinear uint8
    resize differs from the CPU's by 1 in up to 2% of the bytes."""
    from viewformer_tpu_torch.evaluate import evaluator
    from viewformer_tpu_torch.ops import image

    seen = []
    resize = image.resize

    def recording_resize(images, *args, **kwargs):
        seen.append(images.device.type)
        return resize(images, *args, **kwargs)

    monkeypatch.setattr(image, 'resize', recording_resize)
    monkeypatch.setattr(evaluator, 'resize', recording_resize)
    frames = np.random.RandomState(0).randint(0, 256, (2, 3, 24, 20, 3)).astype(np.uint8)
    out = image.upload_frames(frames, 16, torch.device('meta'))
    assert seen == ['cpu'] and out.device.type == 'meta' and out.shape == (2, 3, 16, 16, 3)

    class Recorder:
        def update_state(self, gt_images, images):
            seen.append((gt_images.device.type, images.device.type, images.shape[1]))

    ev = evaluator.Evaluator(image_size=16, device='meta')
    ev._image_generation_metrics = [Recorder()]
    seen.clear()
    ev.update_with_image(frames[0], frames[1, :, :8, :8])
    assert seen == ['cpu', 'cpu', ('meta', 'meta', 16)]
