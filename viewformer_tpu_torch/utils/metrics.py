"""Image and camera metrics: functions on tensors and streaming host
accumulators (port of viewformer_tpu/utils/metrics.py).

PSNR, the scikit-image SSIM (7x7 window, sample covariance), RMSE, the camera
position error (L2) and orientation error (2 asin |vec(q1 q2*)|) run in f32
on the device their tensors lie on. Mean and Median accumulate on the host
in float64, like the JAX package's. The metric classes take numpy arrays or
tensors; uint8 images are scaled to [0, 1].
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry


def psnr(gt_images, images, max_val=1.0):
    """PSNR over [..., H, W, C] float images in [0, max_val] -> [...]."""
    mse = ((gt_images.float() - images.float()) ** 2).mean((-3, -2, -1))
    return 10.0 * torch.log10((max_val ** 2) / mse)


def _uniform_filter(x, win_size):
    """Depthwise VALID uniform filter over NCHW f32 (TF32 is off for the
    package, so the products are full f32, as the reference's HIGHEST)."""
    c = x.shape[1]
    kernel = torch.full((c, 1, win_size, win_size), 1.0 / win_size ** 2,
                        dtype=x.dtype, device=x.device)
    return F.conv2d(x, kernel, groups=c)


def ssim(X, Y, K1=0.01, K2=0.03, win_size=7, data_range=1.0, use_sample_covariance=True):
    """Structural similarity over [..., H, W, C] float images -> [...]
    (the scikit-image algorithm)."""
    batch_shape = X.shape[:-3]
    Xf = X.float().reshape((-1,) + tuple(X.shape[-3:])).permute(0, 3, 1, 2)
    Yf = Y.float().reshape((-1,) + tuple(Y.shape[-3:])).permute(0, 3, 1, 2)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1) if use_sample_covariance else 1.0

    ux = _uniform_filter(Xf, win_size)
    uy = _uniform_filter(Yf, win_size)
    uxx = _uniform_filter(Xf * Xf, win_size)
    uyy = _uniform_filter(Yf * Yf, win_size)
    uxy = _uniform_filter(Xf * Yf, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    return S.mean((-3, -2, -1)).reshape(batch_shape)


def image_rmse(gt_images, images):
    """RMSE on the 0..255 scale over [..., H, W, C] float images in [0, 1]."""
    return torch.sqrt((((gt_images.float() - images.float()) * 255.0) ** 2).mean((-3, -2, -1)))


def camera_position_error(x1, x2):
    """L2 distance between the positions of cameras [..., 7] -> [...]."""
    return torch.linalg.vector_norm(x1[..., :3] - x2[..., :3], dim=-1)


def camera_orientation_error(x1, x2):
    """Angle between the cameras' rotations, 2 asin |vec(q1 q2*)| (stable
    near zero rotation) -> [...]."""
    q1 = geometry.quaternion_normalize(x1[..., 3:])
    q2 = geometry.quaternion_normalize(x2[..., 3:])
    diff = geometry.quaternion_multiply(q1, geometry.quaternion_conjugate(q2))
    return 2.0 * torch.asin(torch.linalg.vector_norm(diff[..., 1:], dim=-1).clamp(0.0, 1.0))


def _host(values):
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values, np.float64).reshape(-1)


class Mean:
    def __init__(self, name, allow_nan=False):
        self.name = name
        self.allow_nan = allow_nan
        self.reset_states()

    def reset_states(self):
        self._total = 0.0
        self._count = 0.0

    def update_state(self, values, sample_weight=None):
        values = _host(values)
        if sample_weight is None:
            sample_weight = np.ones_like(values)
        else:
            sample_weight = np.asarray(sample_weight, np.float64).reshape(-1) * np.ones_like(values)
        if self.allow_nan:
            nan = np.isnan(values)
            values = np.where(nan, 0.0, values)
            sample_weight = sample_weight * (1.0 - nan.astype(np.float64))
        self._total += float((values * sample_weight).sum())
        self._count += float(sample_weight.sum())

    def result(self):
        if self._count == 0:
            return 0.0
        return self._total / self._count


class Median:
    def __init__(self, name):
        self.name = name
        self.reset_states()

    def reset_states(self):
        self._store = []

    def update_state(self, values):
        self._store.append(_host(values))

    def result(self):
        if not self._store:
            return 0.0
        vals = np.sort(np.concatenate(self._store))
        n = len(vals)
        if n % 2 == 1:
            return float(vals[(n - 1) // 2])
        return float(0.5 * (vals[n // 2 - 1] + vals[n // 2]))


def _cameras(x):
    return x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))


def _to_float(images):
    """uint8 [0, 255] -> f32 [0, 1]; float images pass through as f32. numpy
    arrays become CPU tensors; tensors stay where they are."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images.float()


class CameraPositionError(Mean):
    def __init__(self, name='pose_pos_err', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, x1, x2):
        super().update_state(camera_position_error(_cameras(x1), _cameras(x2)))


class CameraOrientationError(Mean):
    def __init__(self, name='pose_ori_err', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, x1, x2):
        super().update_state(camera_orientation_error(_cameras(x1), _cameras(x2)))


class CameraPositionMedian(Median):
    def __init__(self, name='pose_pos_median'):
        super().__init__(name)

    def update_state(self, x1, x2):
        super().update_state(camera_position_error(_cameras(x1), _cameras(x2)))


class CameraOrientationMedian(Median):
    def __init__(self, name='pose_ori_median'):
        super().__init__(name)

    def update_state(self, x1, x2):
        super().update_state(camera_orientation_error(_cameras(x1), _cameras(x2)))


class PSNRMetric(Mean):
    def __init__(self, name='psnr', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, gt_images, images):
        super().update_state(psnr(_to_float(gt_images), _to_float(images)))


class SSIMMetric(Mean):
    def __init__(self, name='ssim', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, gt_images, images):
        super().update_state(ssim(_to_float(gt_images), _to_float(images)))


class ImageRMSE(Mean):
    def __init__(self, name='rmse', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, gt_images, images):
        super().update_state(image_rmse(_to_float(gt_images), _to_float(images)))


class MeanSquaredError(Mean):
    def __init__(self, name='mse', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, gt_images, images):
        super().update_state(((_to_float(gt_images) - _to_float(images)) ** 2).mean((-3, -2, -1)))


class MeanAbsoluteError(Mean):
    def __init__(self, name='mae', **kwargs):
        super().__init__(name, **kwargs)

    def update_state(self, gt_images, images):
        super().update_state((_to_float(gt_images) - _to_float(images)).abs().mean((-3, -2, -1)))


class LPIPSMetric(Mean):
    """LPIPS(VGG) of images in [0, 1] (or uint8), through models.lpips on the
    device of the images. `available` is False when load_lpips finds no
    weights (it warns once a process): the metric then records nothing and
    an evaluator reports it as null, as the JAX package does."""

    def __init__(self, net='vgg', name=None):
        super().__init__(name or f'lpips-{net}')
        from ..models.lpips import load_lpips
        self._lpips = load_lpips(net)
        self.available = self._lpips is not None

    def update_state(self, gt_images, images):
        if self._lpips is None:
            return
        gt, im = _to_float(gt_images) * 2 - 1, _to_float(images) * 2 - 1
        with torch.no_grad():
            super().update_state(self._lpips.to(gt.device)(gt, im))
