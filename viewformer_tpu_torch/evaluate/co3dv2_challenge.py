"""`evaluate co3dv2-challenge`: an official CO3Dv2 few-view submission of the
port's predictions (port of viewformer_tpu/evaluate/co3dv2_challenge.py).

Walks the eval batches of co3d.challenge.co3d_submission.CO3DSubmission
(facebookresearch's co3d package), predicts each batch's target view from
its other frames, resizes the RGBA prediction to the ground-truth depth's
resolution on the host, splits it into the image and a 0/1 mask and adds
them to the submission. The frame annotations are read directly (the
loader's jgz reader); the codebook takes RGBA frames (in_channels 4).
"""
import gzip
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.loaders.co3dv2 import CO3Dv2Loader, _Frame
from ..utils.device import resolve_device
from .transformer import generate_batch_predictions, load_models


def evaluate_co3dv2_challenge(dataset_root, transformer_checkpoint, codebook_checkpoint,
                              output='co3d_submission', split='dev', categories=None,
                              progress=True, use_bfloat16=True, device='cuda'):
    """The few-view task's submission for the `split` sequence set ('dev' or
    'test') of `categories` (default all), written under `output`; returns
    the CO3DSubmission. Runs on `device`: the card unless the caller asks
    for the CPU."""
    from tqdm import tqdm

    device = resolve_device(device)
    try:
        from co3d.challenge.co3d_submission import (CO3DSequenceSet, CO3DSubmission,
                                                    CO3DTask)
    except ImportError as e:
        raise ImportError(
            'The co3d package is required for the CO3Dv2 challenge submission '
            '(install the facebookresearch/co3d repository).') from e

    transformer, codebook = load_models(transformer_checkpoint, codebook_checkpoint,
                                        use_bfloat16, device)
    submission = CO3DSubmission(task=CO3DTask.FEW_VIEW,
                                sequence_set=getattr(CO3DSequenceSet, split.upper()),
                                output_folder=output, dataset_root=dataset_root)
    eval_batches_map = submission.get_eval_batches_map()

    loader = CO3Dv2Loader.__new__(CO3Dv2Loader)
    loader.path = dataset_root
    loader.image_size = codebook.config.image_size

    def load_raw_image(image_path):
        from PIL import Image
        with Image.open(os.path.join(dataset_root, image_path)) as img:
            return np.asarray(img)

    def make_batch(data):
        images = [loader._load_image(x.image_path) for x in data]
        masks = [loader._load_image(x.mask_path) for x in data]
        frames = np.stack([loader._process_rgb_image(img, m)
                           for img, m in zip(images, masks)], 0)
        cameras = np.stack([loader.world_to_camera_matrix_to_cameras(x.R, x.T)
                            for x in data], 0)
        depths = [load_raw_image(x.depth_path) for x in data]
        return dict(cameras=cameras, frames=frames, depths=depths)

    def predict_new_view(batch):
        images = batch['frames']
        cameras = batch['cameras'].astype(np.float32)
        # CO3D eval batches put the target first; the prediction takes it last
        images = np.concatenate((images[1:], images[:1]), 0)[None]
        cameras = np.concatenate((cameras[1:], cameras[:1]), 0)[None]
        preds = generate_batch_predictions(transformer, codebook, images, cameras)
        return preds['generated_images'].astype(np.float32) / 255.0

    bar = tqdm(total=sum(map(len, eval_batches_map.values()))) if progress else None
    for (category, subset_name), eval_batches in eval_batches_map.items():
        if categories is not None and category not in categories:
            continue
        with gzip.open(os.path.join(dataset_root, category, 'frame_annotations.jgz'),
                       'rt') as f:
            frames = [_Frame(raw) for raw in json.load(f)]
        frame_map = {(frame.sequence_name, frame.frame_number): frame for frame in frames}

        for eval_batch in eval_batches:
            sequence_name, frame_number = eval_batch[0][:2]
            batch = make_batch([frame_map[(x, y)] for x, y, _ in eval_batch])
            depth = np.asarray(batch['depths'][-1])[None]
            height, width = depth.shape[1:3]
            resized = resize_rgba(predict_new_view(batch)[-1], (int(height), int(width)))
            image, mask = resized[..., :3], resized[..., 3:]
            mask = (mask > 0.5).astype(image.dtype)
            submission.add_result(category=category, subset_name=subset_name,
                                  sequence_name=sequence_name, frame_number=frame_number,
                                  image=np.moveaxis(image, -1, 0),
                                  mask=np.moveaxis(mask, -1, 0),
                                  depth=depth)
            if bar is not None:
                bar.update()
    return submission


def resize_rgba(image, hw):
    """Bilinear (align_corners=False) resize of a float [H, W, 4] numpy image
    to hw, clamped to [0, 1]. It runs on the CPU, as in the JAX package:
    CUDA's bilinear rounds otherwise."""
    th = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    th = F.interpolate(th, hw, mode='bilinear', align_corners=False)
    return th.clamp_(0, 1)[0].permute(1, 2, 0).numpy()
