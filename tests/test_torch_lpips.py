"""The port's LPIPS (viewformer_tpu_torch.models.lpips) against the JAX
package's _lpips_forward with random weights in the npz layout, load_lpips
with and without an npz at the searched paths, and LPIPSMetric and the
Evaluator once weights load."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viewformer_tpu.models import lpips as jlpips
from viewformer_tpu.utils import metrics as jmetrics
from viewformer_tpu_torch.evaluate.evaluator import Evaluator
from viewformer_tpu_torch.models import lpips as tlpips
from viewformer_tpu_torch.utils import metrics as tmetrics

# f32 convolutions in another order over 13 layers: ~1e-6 relative.
TOL = 1e-5


def _params(seed=0):
    return tlpips.random_lpips_params(torch.Generator().manual_seed(seed))


def _images(seed, shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize('shape', [(3, 32, 32, 3), (2, 2, 16, 24, 3)])
def test_lpips_matches_jax(shape):
    """LPIPS(img0, img1) over [..., H, W, 3] against _lpips_forward on the
    flattened batch, within TOL relative; a pair of equal images is 0."""
    params = _params()
    img0, img1 = _images(1, shape), _images(2, shape)
    expected = np.asarray(jax.jit(jlpips._lpips_forward)(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(img0.reshape((-1,) + shape[-3:])),
        jnp.asarray(img1.reshape((-1,) + shape[-3:])))).reshape(shape[:-3])
    model = tlpips.LPIPS(params)
    with torch.no_grad():
        out = model(torch.from_numpy(img0), torch.from_numpy(img1))
        same = model(torch.from_numpy(img0), torch.from_numpy(img0))
    assert out.shape == shape[:-3] and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, rtol=TOL)
    assert (expected > 0).all() and torch.equal(same, torch.zeros(shape[:-3]))
    assert not list(model.parameters())  # buffers: no optimizer sees them


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """Random weights as lpips_vgg.npz at the second searched path of both
    packages (the first does not exist); JAX's cached loader is cleared
    before and after."""
    path = tmp_path / 'lpips_vgg.npz'
    np.savez(path, **_params(3))
    paths = [str(tmp_path / 'absent.npz'), str(path)]
    monkeypatch.setattr(tlpips, '_WEIGHT_PATHS', paths)
    monkeypatch.setattr(jlpips, '_WEIGHT_PATHS', paths)
    jlpips.load_lpips.cache_clear()
    yield path
    jlpips.load_lpips.cache_clear()


def test_load_lpips_reads_the_npz(weights):
    model = tlpips.load_lpips('vgg')
    assert isinstance(model, tlpips.LPIPS)
    img0, img1 = _images(4, (2, 16, 16, 3)), _images(5, (2, 16, 16, 3))
    with torch.no_grad():
        out = model(torch.from_numpy(img0), torch.from_numpy(img1)).numpy()
    np.testing.assert_allclose(out, np.asarray(jlpips.load_lpips('vgg')(img0, img1)), rtol=TOL)
    assert tlpips.load_lpips('alex') is None


def test_load_lpips_without_weights_warns_once(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tlpips, '_WEIGHT_PATHS', [str(tmp_path / 'lpips_vgg.npz')])
    tlpips._warn_unavailable.cache_clear()
    assert tlpips.load_lpips('vgg') is None and tlpips.load_lpips('vgg') is None
    assert capsys.readouterr().err.count('WARNING: LPIPS(vgg)') == 1


def test_lpips_metric_with_weights(weights):
    """LPIPSMetric gives JAX's value on uint8 images; the Evaluator then
    reports lpips as a number."""
    rng = np.random.RandomState(6)
    gt = rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    im = rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    metric, expected = tmetrics.LPIPSMetric('vgg', name='lpips'), jmetrics.LPIPSMetric('vgg')
    assert metric.available and expected.available
    metric.update_state(gt, im)
    expected.update_state(gt, im)
    np.testing.assert_allclose(metric.result(), expected.result(), rtol=TOL)
    evaluator = Evaluator(device='cpu')
    evaluator.update_with_image(gt, im)
    np.testing.assert_allclose(evaluator.result()['lpips'], expected.result(), rtol=TOL)
