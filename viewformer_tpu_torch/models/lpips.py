"""LPIPS perceptual distance with the VGG16 trunk (port of
viewformer_tpu/models/lpips.py).

The VGG16 feature convolutions (3x3, pad 1, ReLU) of _VGG_SLICES, a 2x2 max
pool between blocks; after each block's last ReLU the features of both
images are normalised over channels, x / (sqrt(sum x^2) + 1e-10), and their
squared difference, weighted per channel by the linear heads, is summed over
channels and averaged over the positions. The parameters are the JAX
package's npz layout (conv{i}_w HWIO, conv{i}_b, lin{i}_w), turned into
OIHW buffers here. Convolutions run in f32.

The calibrated weights are not in the repository: load_lpips returns None,
with one warning a process, until an npz is at one of _WEIGHT_PATHS. The
converter from the `lpips` package (convert_lpips_weights_from_torch) is not
ported: neither the `lpips` nor the `torchvision` package is installed.
"""
import functools
import os
import sys

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_WEIGHT_PATHS = [
    os.path.expanduser('~/.cache/viewformer_tpu/lpips_vgg.npz'),
    os.path.join(os.path.dirname(__file__), '..', '..', 'weights', 'lpips_vgg.npz'),
]

# VGG16's feature blocks: (input channels, output channels, convolutions).
_VGG_SLICES = [(3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3)]
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)


def random_lpips_params(generator=None):
    """LPIPS parameters in the npz layout, drawn from `generator`: He-normal
    conv kernels (HWIO), zero biases, uniform [0, 1) heads. Not calibrated:
    for tests and for exercising the path without the real weights."""
    params, index = {}, 0
    for block, (c_in, c_out, n_convs) in enumerate(_VGG_SLICES):
        for i in range(n_convs):
            fan_in = 9 * (c_in if i == 0 else c_out)
            params[f'conv{index}_w'] = (torch.randn(3, 3, c_in if i == 0 else c_out, c_out,
                                                    generator=generator)
                                        * (2.0 / fan_in) ** 0.5).numpy()
            params[f'conv{index}_b'] = np.zeros(c_out, np.float32)
            index += 1
        params[f'lin{block}_w'] = torch.rand(c_out, generator=generator).numpy()
    return params


def _normalize_tensor(x, eps=1e-10):
    return x / (torch.sqrt((x ** 2).sum(1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS(img0, img1): images [..., H, W, 3] in [-1, 1] -> distances [...]
    (f32). `params`: a dict of arrays in the npz layout. The weights are
    buffers, so no optimizer sees them; move the module with .to(device)."""

    def __init__(self, params):
        super().__init__()
        n_convs = sum(n for _, _, n in _VGG_SLICES)
        for i in range(n_convs):
            self.register_buffer(f'conv{i}_w', torch.as_tensor(
                np.asarray(params[f'conv{i}_w'], np.float32)).permute(3, 2, 0, 1).contiguous())
            self.register_buffer(f'conv{i}_b', torch.as_tensor(
                np.asarray(params[f'conv{i}_b'], np.float32)))
        for block in range(len(_VGG_SLICES)):
            self.register_buffer(f'lin{block}_w', torch.as_tensor(
                np.asarray(params[f'lin{block}_w'], np.float32)).reshape(-1))
        self.register_buffer('shift', torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer('scale', torch.tensor(_SCALE).reshape(1, 3, 1, 1))

    def forward(self, img0, img1):
        batch_shape = img0.shape[:-3]
        x0, x1 = (((img.reshape((-1,) + tuple(img.shape[-3:])).float().permute(0, 3, 1, 2))
                   - self.shift) / self.scale for img in (img0, img1))
        total, index = 0.0, 0
        for block, (_, _, n_convs) in enumerate(_VGG_SLICES):
            for _ in range(n_convs):
                w, b = getattr(self, f'conv{index}_w'), getattr(self, f'conv{index}_b')
                x0 = F.relu(F.conv2d(x0, w, b, padding=1))
                x1 = F.relu(F.conv2d(x1, w, b, padding=1))
                index += 1
            diff = (_normalize_tensor(x0) - _normalize_tensor(x1)) ** 2
            lin_w = getattr(self, f'lin{block}_w').reshape(1, -1, 1, 1)
            total = total + (diff * lin_w).sum(1).mean((-2, -1))
            if block < len(_VGG_SLICES) - 1:
                x0, x1 = F.max_pool2d(x0, 2), F.max_pool2d(x1, 2)
        return total.reshape(batch_shape)


@functools.lru_cache(maxsize=None)
def _warn_unavailable(net):
    print(f'WARNING: LPIPS({net}) calibration weights are unavailable (searched '
          f'{_WEIGHT_PATHS}). The perceptual loss term and the lpips metric will be '
          'reported as NaN/null: training dynamics and results.json DIVERGE from the '
          'reference until weights are provided (convert them with the JAX package\'s '
          'models.lpips.convert_lpips_weights_from_torch on a machine with the lpips '
          'package and copy the npz to one of the paths above).', file=sys.stderr)


def load_lpips(net='vgg'):
    """An LPIPS module (on the CPU) from the first npz of _WEIGHT_PATHS, or
    None when there is none (with one loud warning a process: the
    reference always trains with the perceptual term and reports lpips).
    Only net='vgg' exists; any other gives None."""
    if net != 'vgg':
        return None
    for path in _WEIGHT_PATHS:
        if os.path.exists(path):
            with np.load(path) as data:
                return LPIPS({k: data[k] for k in data.files})
    _warn_unavailable(net)
    return None
