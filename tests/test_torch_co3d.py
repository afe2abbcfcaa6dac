"""The port's `evaluate co3d` and `evaluate co3dv2-challenge` against the JAX
package's, over the stubs of tests/test_co3d_stub.py (facebookresearch's
co3d code, lpips and CO3DSubmission are not available offline).

Against JAX, both packages' load_model and generate_batch_predictions are
replaced by one recorder, which returns deterministic images made from its
inputs: the frames and cameras handed to the model must be equal bit for
bit, the results files equal and the add_result arguments within
ADD_RESULT_TOL. Then the port alone runs both evaluators with real tiny
models on the CPU, through the CLI.
"""
import enum
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from test_co3d_stub import _FakeLpips, _FakeSubmission, _write_co3dv2_tree, _write_fake_co3d
from viewformer_tpu_torch import cli

# the resize before add_result runs in f32 on the host in both packages
ADD_RESULT_TOL = 1e-6


@pytest.fixture()
def fake_co3d(tmp_path, monkeypatch):
    """The co3d code stub where both packages' loaders look for it, an lpips
    stub and a co3d.challenge.co3d_submission stub whose submission records
    the arrays of each add_result."""
    import viewformer_tpu.data.loaders.co3d as jco3d
    import viewformer_tpu_torch.data.loaders.co3d as tco3d

    root = tmp_path / 'co3d_code'
    _write_fake_co3d(root)
    for module in (jco3d, tco3d):
        monkeypatch.setattr(module, '_co3d_code_path', lambda: str(root))
    lpips = types.ModuleType('lpips')
    lpips.LPIPS = _FakeLpips
    monkeypatch.setitem(sys.modules, 'lpips', lpips)

    class CO3DTask(enum.Enum):
        FEW_VIEW = 'few_view'

    class CO3DSequenceSet(enum.Enum):
        DEV = 'dev'
        TEST = 'test'

    class Submission(_FakeSubmission):
        def add_result(self, **kwargs):
            super().add_result(**kwargs)
            self.__dict__.setdefault('arrays', []).append(kwargs)

    submission = types.ModuleType('co3d.challenge.co3d_submission')
    submission.CO3DTask, submission.CO3DSequenceSet = CO3DTask, CO3DSequenceSet
    submission.CO3DSubmission = Submission
    monkeypatch.setitem(sys.modules, 'co3d', types.ModuleType('co3d'))
    monkeypatch.setitem(sys.modules, 'co3d.challenge', types.ModuleType('co3d.challenge'))
    monkeypatch.setitem(sys.modules, 'co3d.challenge.co3d_submission', submission)
    _write_co3dv2_tree(tmp_path / 'co3dv2')
    yield tmp_path
    for name in list(sys.modules):
        if name == 'dataset' or name.startswith(('dataset.', 'evaluation', 'eval_demo')):
            del sys.modules[name]


class _Recorder:
    """Stands in for both packages' models and generate_batch_predictions:
    records the frames and cameras of each call and returns uint8 images made
    from them."""

    def __init__(self, image_size):
        self.config = types.SimpleNamespace(image_size=image_size)
        self.calls = []

    def load_jax(self, checkpoint, *args, **kwargs):
        return self, None

    def load_port(self, checkpoint, *args, **kwargs):
        return self

    def predict(self, *args, **kwargs):
        images, cameras = (np.array(x) for x in args[-2:])
        self.calls.append((images, cameras))
        shift = (np.abs(cameras[:, -1]).sum(-1) * 40).astype(np.int64)[:, None, None, None]
        rows = 8 * np.arange(images.shape[2])[None, :, None, None]
        generated = (images[:, 0].astype(np.int64) * 3 + images[:, -1] + shift + rows) % 256
        return {'generated_images': generated.astype(np.uint8)}


def _run_both(monkeypatch, image_size, run_jax, run_port):
    import viewformer_tpu.evaluate.co3d as jco3d
    import viewformer_tpu.evaluate.co3dv2_challenge as jco3dv2
    import viewformer_tpu.models as jmodels
    import viewformer_tpu_torch.evaluate.co3d as tco3d
    import viewformer_tpu_torch.evaluate.co3dv2_challenge as tco3dv2
    import viewformer_tpu_torch.models as tmodels

    recorders = []
    for load, modules, run in (('load_jax', (jmodels, jco3d, jco3dv2), run_jax),
                               ('load_port', (tmodels, tco3d, tco3dv2), run_port)):
        recorder = _Recorder(image_size)
        monkeypatch.setattr(modules[0], 'load_model', getattr(recorder, load))
        for module in modules[1:]:
            monkeypatch.setattr(module, 'generate_batch_predictions', recorder.predict)
        recorders.append((recorder, run()))
    return recorders


def _assert_same_calls(jax_calls, port_calls):
    assert len(port_calls) == len(jax_calls) > 0
    for (jimages, jcameras), (pimages, pcameras) in zip(jax_calls, port_calls):
        assert pimages.dtype == jimages.dtype and pcameras.dtype == jcameras.dtype
        np.testing.assert_array_equal(pimages, jimages)
        np.testing.assert_array_equal(pcameras, jcameras)


def test_evaluate_co3d_matches_jax(fake_co3d, monkeypatch):
    from viewformer_tpu.evaluate.co3d import evaluate_co3d as jax_evaluate
    from viewformer_tpu_torch.evaluate.co3d import evaluate_co3d

    jobs = {name: str(fake_co3d / name) for name in ('jax', 'port')}
    (jax_rec, jax_result), (port_rec, port_result) = _run_both(
        monkeypatch, 32,
        lambda: jax_evaluate('/nonexistent', 't', 'c', jobs['jax'], progress=False),
        lambda: evaluate_co3d('/nonexistent', 't', 'c', jobs['port'], progress=False,
                              device='cpu'))
    _assert_same_calls(jax_rec.calls, port_rec.calls)
    assert len(port_rec.calls) == 2 * 2  # CO3D_CATEGORIES[:10] of the stub x 2 sequences
    assert port_rec.calls[0][0].shape == (1, 5, 32, 32, 3)
    assert port_result == jax_result and np.isfinite(port_result['test_known_all']['psnr'])
    for name in ('results-co3d.json', 'results.json'):
        with open(os.path.join(jobs['jax'], name)) as f, \
                open(os.path.join(jobs['port'], name)) as g:
            assert json.load(g) == json.load(f), name


def test_evaluate_co3dv2_challenge_matches_jax(fake_co3d, monkeypatch):
    from viewformer_tpu.evaluate.co3dv2_challenge import (
        evaluate_co3dv2_challenge as jax_evaluate)
    from viewformer_tpu_torch.evaluate.co3dv2_challenge import evaluate_co3dv2_challenge

    root = str(fake_co3d / 'co3dv2')
    (jax_rec, jax_sub), (port_rec, port_sub) = _run_both(
        monkeypatch, 32,
        lambda: jax_evaluate(root, 't', 'c', str(fake_co3d / 'jsub'), progress=False),
        lambda: evaluate_co3dv2_challenge(root, 't', 'c', str(fake_co3d / 'psub'),
                                          progress=False, device='cpu'))
    _assert_same_calls(jax_rec.calls, port_rec.calls)
    assert port_rec.calls[0][0].shape == (1, 5, 32, 32, 4)
    assert port_sub.results == jax_sub.results
    assert len(port_sub.arrays) == len(jax_sub.arrays) == 1
    for port, expected in zip(port_sub.arrays, jax_sub.arrays):
        assert sorted(port) == sorted(expected)
        for key, value in expected.items():
            if isinstance(value, np.ndarray):
                assert port[key].shape == value.shape and port[key].dtype == value.dtype, key
                np.testing.assert_allclose(port[key], value, rtol=0, atol=ADD_RESULT_TOL,
                                           err_msg=key)
            else:
                assert port[key] == value, key
    assert port_sub.arrays[0]['image'].shape == (3, 24, 20)
    assert set(np.unique(port_sub.arrays[0]['mask'])) == {0.0, 1.0}


def test_prediction_is_resized_on_the_host(monkeypatch):
    """resize_rgba takes a numpy image and resizes it with torch on the CPU,
    whatever device the models are on."""
    import torch.nn.functional as F

    from viewformer_tpu_torch.evaluate import co3dv2_challenge

    devices, original = [], F.interpolate

    def interpolate(x, *args, **kwargs):
        devices.append(x.device.type)
        return original(x, *args, **kwargs)
    monkeypatch.setattr(co3dv2_challenge.F, 'interpolate', interpolate)
    image = np.random.RandomState(0).rand(8, 8, 4).astype(np.float32)
    out = co3dv2_challenge.resize_rgba(image, (6, 5))
    assert devices == ['cpu'] and out.shape == (6, 5, 4) and out.dtype == np.float32


def _save(path, model):
    from viewformer_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(path, model.config)
    mgr.save(0, {'model': model.state_dict()})
    mgr.close()
    return path


def test_port_evaluators_with_tiny_models(fake_co3d):
    """Real tiny port models on the CPU through `evaluate co3d` and
    `evaluate co3dv2-challenge` on the command line."""
    from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig
    from viewformer_tpu_torch.models import AutoModel

    gen = torch.Generator().manual_seed(0)
    codebook = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], z_channels=32,
                    embed_dim=8, n_embed=16, image_size=32)
    jobs = {}
    for name, config in (
            ('t', MIGTConfig(n_embeddings=16, n_head=2, d_model=32, n_layer=1, dropout=0.0,
                             sequence_size=5, token_image_size=16, n_loss_skip=1,
                             localization_weight='1')),
            ('c', VQGANConfig(**codebook)),
            ('c4', VQGANConfig(**codebook, in_channels=4, out_ch=4))):
        jobs[name] = _save(str(fake_co3d / name),
                           AutoModel.from_config(config, device='cpu', generator=gen))
    flags = ['--transformer-model', jobs['t'], '--device', 'cpu', '--fp32']
    cli.main(['evaluate', 'co3d', '--path', '/nonexistent', '--codebook-model', jobs['c'],
              '--job-dir', str(fake_co3d / 'e1'), '--categories', 'apple', *flags])
    with open(fake_co3d / 'e1' / 'results.json') as f:
        result = json.load(f)
    assert list(result) == ['test_known_all'] and np.isfinite(result['test_known_all']['psnr'])
    with open(fake_co3d / 'e1' / 'results-co3d.json') as f:
        assert len(json.load(f)['multisequence']) == 1

    _FakeSubmission.instances.clear()
    cli.main(['evaluate', 'co3dv2-challenge', '--path', str(fake_co3d / 'co3dv2'),
              '--codebook-model', jobs['c4'], '--job-dir', str(fake_co3d / 'e2'), *flags])
    (submission,) = _FakeSubmission.instances
    assert submission.results == [('apple', 'fewview_dev', 'seqA', 0, (3, 24, 20))]
    assert np.isfinite(submission.arrays[0]['image']).all()


@pytest.mark.parametrize('evaluator', ['co3d', 'co3dv2_challenge'])
def test_evaluators_default_to_the_card(evaluator):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    import importlib

    module = importlib.import_module(f'viewformer_tpu_torch.evaluate.{evaluator}')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        getattr(module, f'evaluate_{evaluator}')('/nonexistent', 't', 'c', progress=False)
