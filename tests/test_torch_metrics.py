"""The port's metrics (viewformer_tpu_torch.utils.metrics) and quaternion
helpers (utils.geometry) against the JAX package's, on seeded images and
cameras, within 1e-5 relative."""
import numpy as np
import pytest
import torch

from viewformer_tpu.utils import geometry as jgeometry
from viewformer_tpu.utils import metrics as jmetrics
from viewformer_tpu_torch.models import lpips as tlpips
from viewformer_tpu_torch.utils import geometry as tgeometry
from viewformer_tpu_torch.utils import metrics as tmetrics

RTOL = 1e-5


def _images(seed, shape=(3, 2, 24, 20, 3)):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, shape).astype(np.uint8)


def _cameras(seed, n=16):
    rng = np.random.RandomState(seed)
    cameras = rng.randn(n, 7).astype(np.float32)
    cameras[:, 3:] /= np.linalg.norm(cameras[:, 3:], axis=-1, keepdims=True)
    return cameras


def _float(images):
    return images.astype(np.float32) / 255.0


@pytest.mark.parametrize('name', ['psnr', 'ssim', 'image_rmse'])
def test_image_functions_match_jax(name):
    gt, im = _float(_images(0)), _float(_images(1))
    im[0, 0] = gt[0, 0]  # one identical pair: PSNR inf, SSIM 1
    expected = np.asarray(getattr(jmetrics, name)(gt, im))
    actual = getattr(tmetrics, name)(torch.from_numpy(gt), torch.from_numpy(im)).numpy()
    assert actual.shape == expected.shape == (3, 2)
    np.testing.assert_allclose(actual, expected, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize('name', ['camera_position_error', 'camera_orientation_error'])
def test_camera_errors_match_jax(name):
    x1, x2 = _cameras(2), _cameras(3)
    x2[0] = x1[0]  # zero error
    x2[1, 3:] = -x1[1, 3:]  # the same rotation with the other sign
    expected = np.asarray(getattr(jmetrics, name)(x1, x2))
    actual = getattr(tmetrics, name)(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(actual, expected, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize('cls', ['PSNRMetric', 'SSIMMetric', 'ImageRMSE', 'MeanSquaredError',
                                 'MeanAbsoluteError'])
def test_streaming_image_metrics_match_jax(cls):
    """Two uint8 batches into each streaming metric."""
    jm, tm = getattr(jmetrics, cls)(), getattr(tmetrics, cls)()
    for seed in (4, 6):
        gt, im = _images(seed), _images(seed + 1)
        jm.update_state(gt, im)
        tm.update_state(gt, im)
    np.testing.assert_allclose(tm.result(), jm.result(), rtol=RTOL)


@pytest.mark.parametrize('cls', ['CameraPositionError', 'CameraOrientationError',
                                 'CameraPositionMedian', 'CameraOrientationMedian'])
def test_streaming_camera_metrics_match_jax(cls):
    jm, tm = getattr(jmetrics, cls)(), getattr(tmetrics, cls)()
    for seed in (8, 10, 12):  # 16 + 16 + 16 values: an even count for the median
        x1, x2 = _cameras(seed), _cameras(seed + 1)
        jm.update_state(x1, x2)
        tm.update_state(x1, x2)
    np.testing.assert_allclose(tm.result(), jm.result(), rtol=RTOL)


@pytest.mark.parametrize('allow_nan', [False, True])
def test_mean_and_median(allow_nan):
    values = [np.array([1.0, np.nan, 3.0]), np.array([4.0, 7.0])]
    weights = [np.array([1.0, 2.0, 0.5]), None]
    jm, tm = jmetrics.Mean('m', allow_nan=allow_nan), tmetrics.Mean('m', allow_nan=allow_nan)
    jmed, tmed = jmetrics.Median('m'), tmetrics.Median('m')
    assert tm.result() == jm.result() == 0.0 and tmed.result() == jmed.result() == 0.0
    for v, w in zip(values, weights):
        jm.update_state(v, w)
        tm.update_state(torch.from_numpy(v), w)
        jmed.update_state(v[~np.isnan(v)])
        tmed.update_state(v[~np.isnan(v)])
    np.testing.assert_equal(tm.result(), jm.result())  # nan without allow_nan
    assert np.isnan(tm.result()) != allow_nan
    assert tmed.result() == jmed.result() == 3.5
    tmed.update_state([10.0])
    jmed.update_state([10.0])
    assert tmed.result() == jmed.result() == 4.0


def test_lpips_is_loud_and_null(capsys, tmp_path, monkeypatch):
    """Without weights at any of the searched paths: null, one warning."""
    monkeypatch.setattr(tlpips, '_WEIGHT_PATHS', [str(tmp_path / 'lpips_vgg.npz')])
    tlpips._warn_unavailable.cache_clear()
    metric = tmetrics.LPIPSMetric('vgg', name='lpips')
    tmetrics.LPIPSMetric('vgg', name='lpips')
    assert not metric.available and metric.name == 'lpips'
    assert capsys.readouterr().err.count('WARNING: LPIPS(vgg)') == 1
    metric.update_state(_images(0), _images(1))
    assert metric.result() == 0.0


def test_quaternion_helpers_match_jax():
    """The geometry helpers the port gained, against the JAX package's numpy
    versions."""
    rng = np.random.RandomState(5)
    q = rng.randn(12, 4).astype(np.float32)
    q[0] = [0.0, 1.0, 0.0, 0.0]  # trace < 0 cases of the matrix conversion
    q[1] = [0.0, 0.0, 1.0, 0.0]
    q[2] = [0.0, 0.0, 0.0, 1.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tq = torch.from_numpy(q)
    matrices = jgeometry.quaternion_to_rotation_matrix(q)
    np.testing.assert_allclose(tgeometry.quaternion_to_rotation_matrix(tq).numpy(), matrices,
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tgeometry.rotation_matrix_to_quaternion(torch.from_numpy(matrices)).numpy(),
        jgeometry.rotation_matrix_to_quaternion(matrices), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tgeometry.quaternion_to_euler(tq).numpy(),
                               jgeometry.quaternion_to_euler(q), rtol=RTOL, atol=1e-6)
    pose = np.concatenate([rng.randn(12, 3).astype(np.float32), q], -1)
    np.testing.assert_allclose(tgeometry.cameras_to_pose_euler(torch.from_numpy(pose)).numpy(),
                               jgeometry.cameras_to_pose_euler(pose), rtol=RTOL, atol=1e-6)
    position, look_at = rng.randn(12, 3).astype(np.float32), rng.randn(12, 3).astype(np.float32)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(
        tgeometry.look_at_to_cameras(torch.from_numpy(position), torch.from_numpy(look_at),
                                     torch.from_numpy(up)).numpy(),
        jgeometry.look_at_to_cameras(position, look_at, up), rtol=RTOL, atol=1e-5)
    # the eigenvector mean is defined up to sign
    group = q[:4] + 0.05 * rng.randn(4, 4).astype(np.float32)
    expected = jgeometry.quaternion_average(group[None])[0]
    actual = tgeometry.quaternion_average(torch.from_numpy(group[None]))[0].numpy()
    np.testing.assert_allclose(actual * np.sign(actual @ expected), expected, atol=1e-5)
