"""Streaming evaluators of image and camera metrics (port of
viewformer_tpu/evaluate/evaluator.py): the same metrics, names and
results.json keys. The image metrics run on `device`: the card unless the
caller asks for the CPU."""
from collections import OrderedDict

import numpy as np
import torch

from ..ops.image import resize
from ..utils import metrics as M
from ..utils.device import resolve_device


def _host(images):
    """numpy or a tensor -> a CPU tensor."""
    if isinstance(images, torch.Tensor):
        return images.cpu()
    return torch.from_numpy(np.ascontiguousarray(images))


class Evaluator:
    def __init__(self, image_size=None, device='cuda'):
        self.image_size = image_size
        self.device = resolve_device(device)
        self._localization_metrics = [
            M.CameraOrientationError('loc-angle'),
            M.CameraPositionError('loc-dist'),
            M.CameraOrientationMedian('loc-angle-med'),
            M.CameraPositionMedian('loc-dist-med')]
        # lpips is reported as null when its weights are absent
        # (utils/metrics.LPIPSMetric)
        self._image_generation_metrics = [
            M.MeanSquaredError('mse'),
            M.ImageRMSE('rmse'),
            M.MeanAbsoluteError('mae'),
            M.PSNRMetric('psnr'),
            M.LPIPSMetric('vgg', name='lpips'),
            M.SSIMMetric('ssim')]

    def update_with_image(self, ground_truth_images, generated_images):
        # resized on the host, as the reference: CUDA's bilinear uint8 resize
        # rounds otherwise (ops/image.upload_frames)
        ground_truth_images = _host(ground_truth_images)
        generated_images = _host(generated_images)
        image_size = self.image_size
        if image_size is None:
            image_size = max(ground_truth_images.shape[-2], generated_images.shape[-2])
        ground_truth_images = resize(ground_truth_images, image_size).to(self.device)
        if generated_images.shape[-2] != image_size:
            # generated images are resized bilinearly, also when upsampled
            generated_images = resize(generated_images, image_size, 'bilinear')
        generated_images = generated_images.to(self.device)
        for metric in self._image_generation_metrics:
            metric.update_state(ground_truth_images, generated_images)

    def update_with_camera(self, ground_truth_cameras, generated_cameras):
        for metric in self._localization_metrics:
            metric.update_state(np.asarray(generated_cameras), np.asarray(ground_truth_cameras))

    def update_state(self, ground_truth_cameras, generated_cameras,
                     ground_truth_images, generated_images):
        self.update_with_image(ground_truth_images, generated_images)
        if generated_cameras is not None:
            self.update_with_camera(ground_truth_cameras, generated_cameras)

    def get_progress_bar_info(self):
        info = OrderedDict()
        for m in self._image_generation_metrics:
            if m.name == 'psnr':
                info['img_psnr'] = float(m.result())
            if m.name == 'lpips' and getattr(m, 'available', True):
                info['img_lpips'] = float(m.result())
        for m in self._localization_metrics:
            if m.name == 'loc-dist':
                info['cam_loc'] = float(m.result())
            if m.name == 'loc-angle':
                info['cam_ang'] = float(m.result())
        return info

    def result(self):
        return OrderedDict(
            (m.name, None if not getattr(m, 'available', True) else float(m.result()))
            for m in self._localization_metrics + self._image_generation_metrics)


class MultiContextEvaluator:
    """One Evaluator per context size 1 .. sequence_size - 1."""

    def __init__(self, sequence_size, image_size=None, device='cuda'):
        self.sequence_size = sequence_size
        self._evaluators = [Evaluator(image_size=image_size, device=device)
                            for _ in range(sequence_size - 1)]

    def update_state(self, ground_truth_cameras, generated_cameras,
                     ground_truth_images, generated_images):
        """generated_images [B, S, H, W, C] and generated_cameras [B, S, 7]:
        position i was generated from i context frames; position 0 (none)
        is skipped."""
        for i in range(1, generated_images.shape[1]):
            gen_cam = generated_cameras[:, i] if generated_cameras is not None else None
            self._evaluators[i - 1].update_state(
                ground_truth_cameras, gen_cam, ground_truth_images, generated_images[:, i])

    def get_progress_bar_info(self):
        return self._evaluators[-1].get_progress_bar_info()

    def result(self):
        return OrderedDict((f'ctx{i + 1:02d}', ev.result())
                           for i, ev in enumerate(self._evaluators))


def print_metrics(metrics, precision=4):
    """An ASCII table of the metrics, one row per context size."""
    yheader = list(metrics.keys())
    xheader = list(next(iter(metrics.values())).keys())
    fmt = f'{{0:.{precision}f}}'

    def cell(v):
        return 'n/a' if v is None else fmt.format(v)

    rows = [[ctx] + [cell(metrics[ctx][m]) for m in xheader] for ctx in yheader]
    widths = [max(len(r[j]) for r in rows + [[''] + xheader]) for j in range(len(rows[0]))]
    header = '  '.join(h.rjust(w) for h, w in zip([''] + xheader, widths))
    print(' ' + header)
    print(' ' + '  '.join('-' * w for w in widths))
    for row in rows:
        cells = [row[0].ljust(widths[0])] + [c.rjust(w) for c, w in zip(row[1:], widths[1:])]
        print(' ' + '  '.join(cells))
