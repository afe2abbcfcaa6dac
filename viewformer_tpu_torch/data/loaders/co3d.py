"""The CO3D v1 loader (port of viewformer_tpu/data/loaders/co3d.py), over
facebookresearch's co3d code at commit _CO3D_COMMIT: train through
dataset_zoo('co3d_multisequence'), val and test through Co3dDataset on the
test_known and test_unseen subsets. Frames are masked to the foreground;
cameras turn PyTorch3D's world-to-view matrices into the 7-vector (inverted,
the first two rows negated, the rotation as a quaternion).

The co3d code must be placed under `~/.cache/viewformer/co3d` by hand (it
imports pytorch3d, which must be installed): the loader never downloads
it, and raises when it is absent.
"""
import copy
import os
import sys
from functools import lru_cache, partial
from itertools import accumulate, groupby

import numpy as np
import torch
from torch.utils.data.dataset import ConcatDataset

from ...utils.np_geometry import quaternion_normalize, rotation_matrix_to_quaternion
from .co3dv2 import CO3D_CATEGORIES

_CO3D_COMMIT = 'd4895dd3976b1c6afb9e9221c047f67c678eaf08'


def _co3d_code_path():
    return os.path.expanduser('~/.cache/viewformer/co3d')


def _require_co3d():
    path = _co3d_code_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f'The co3d loader needs facebookresearch/co3d at commit {_CO3D_COMMIT} under '
            f'{path} (it is not downloaded): place the checkout there by hand')
    return path


class _co3d_code:
    """The co3d code importable inside the context."""

    def __enter__(self):
        sys.path.insert(0, _co3d_code_path())
        return self

    def __exit__(self, *args):
        sys.path.remove(_co3d_code_path())


def _co3d_val_dataset(DATASET_CONFIGS, Co3dDataset, path, category, unseen=False):
    params = {
        **copy.deepcopy(DATASET_CONFIGS['default']),
        'frame_annotations_file': os.path.join(path, category, 'frame_annotations.jgz'),
        'sequence_annotations_file': os.path.join(path, category, 'sequence_annotations.jgz'),
        'subset_lists_file': os.path.join(path, category, 'set_lists.json'),
        'dataset_root': path,
        'limit_to': -1,
        'limit_sequences_to': -1,
        'n_frames_per_sequence': -1,
        'subsets': ['test_unseen' if unseen else 'test_known'],
        'load_point_clouds': False,
        'mask_images': False,
        'mask_depths': False,
        'pick_sequence': [],
    }
    return Co3dDataset(**params)


class CO3DLoader:
    """The sequences of `split` ('train', 'val' or 'test') of `categories`
    (default all of CO3D_CATEGORIES): frames uint8 [N, H, W, 3], cameras,
    depthmaps [N, H, W, 1] and the sequence_id."""

    def __init__(self, path, split=None, categories=None, mask_images=True, seed=None):
        assert split in ('test', 'train', 'val')
        _require_co3d()
        self.categories = categories if categories is not None else CO3D_CATEGORIES
        if isinstance(self.categories, str):
            self.categories = [self.categories]
        self.split = split
        self.path = path
        self.mask_images = mask_images

    @staticmethod
    def world_to_camera_to_cameras(cam_to_world):
        world_to_cam = np.linalg.inv(cam_to_world)
        # PyTorch3D: z to screen, y up, x left; ours: z to screen, y down, x right
        world_to_cam[..., :2, :] *= -1
        R = world_to_cam[..., :-1, :-1]
        position = world_to_cam[..., :-1, -1]
        quaternion = quaternion_normalize(rotation_matrix_to_quaternion(R))
        return np.concatenate([position, quaternion], -1).astype(np.float32)

    @lru_cache()
    def _dataset(self):
        with _co3d_code():
            if self.split == 'train':
                from dataset.dataset_zoo import dataset_zoo
                return ConcatDataset([
                    dataset_zoo('co3d_multisequence', self.path, category=c)[self.split]
                    for c in self.categories])
            from dataset.co3d_dataset import Co3dDataset
            from dataset.dataset_zoo import DATASET_CONFIGS
            make = partial(_co3d_val_dataset, DATASET_CONFIGS=DATASET_CONFIGS,
                           Co3dDataset=Co3dDataset)
            return ConcatDataset([make(path=self.path, category=c,
                                       unseen=self.split == 'test')
                                  for c in self.categories])

    def __len__(self):
        return len(self.num_images_per_sequence())

    @lru_cache()
    def num_images_per_sequence(self):
        return [sum(1 for _ in group) for _, group in groupby(
            (x for d in self._dataset().datasets for x in d.frame_annots),
            key=lambda x: x['frame_annotation'].sequence_name)]

    @lru_cache()
    def _cum_images_per_sequence(self):
        return [0] + list(accumulate(self.num_images_per_sequence()[:-1]))

    def get_intrinsics(self):
        return (800, 800, 400, 400, 400, 400)

    def _process_rgb_image(self, frame_data):
        if self.mask_images:
            mask_fg = (frame_data.fg_probability >= 0.5).type_as(frame_data.image_rgb)
            return mask_fg * frame_data.image_rgb
        return frame_data.image_rgb

    def __getitem__(self, i):
        start = self._cum_images_per_sequence()[i]
        seq_len = self.num_images_per_sequence()[i]
        data = [self._dataset()[j] for j in range(start, start + seq_len)]
        images = torch.stack([self._process_rgb_image(x) for x in data], 0) \
            .permute(0, 2, 3, 1).numpy()
        images = (images * 255.0).astype(np.uint8)
        depthmaps = torch.stack([x.depth_map * (x.fg_probability > 0.5).float()
                                 for x in data], 0).permute(0, 2, 3, 1).numpy()
        matrices = torch.cat([x.camera.get_world_to_view_transform().get_matrix()
                              .permute(0, 2, 1) for x in data], 0).numpy()
        cameras = self.world_to_camera_to_cameras(matrices)
        return dict(cameras=cameras, frames=images, depthmaps=depthmaps,
                    sequence_id=data[0].sequence_name)
