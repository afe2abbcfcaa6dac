"""The InteriorNet loader (port of viewformer_tpu/data/loaders/interiornet.py).

`<path>/HD1` .. `HD7` hold one zip an environment; `parts` (SplitIndices,
default '7') picks them. An HD7 environment is 20 frames with their poses in
`cam0.render`; an HD1-6 scene is 3000 frames, its poses in
`GroundTruth_HD1-HD6/<scene>.zip` (`velocity_angular_<id>/cam0.render`),
cut into environments of sequence_size frames. A pose row (eye, look-at,
up) is taken to the camera axes by (y, -z, -x). The first 3% of each part's
files are the test split. A frame that fails to decode is replaced once by
another of the environment's. _IGNORED_FILES is kept so the splits stay the
reference's.
"""
import math
import os
import random
import re
import sys

import numpy as np

from ...utils import SplitIndices
from ...utils.np_geometry import look_at_to_cameras
from ..archive import ArchiveStore
from ._wrappers import ShuffledLoader

_IGNORED_FILES = [
    '3FO4K5I8T7KR', '3FO4K3GYULI6', '3FO4K35GPEA7', '3FO4K6XVLSCH',
    '3FO4K33RY528', '3FO4JXJX64SU', '3FO4K5LPQL51', '3FO4K6YTSO3Y',
    '3FO4K6WXLP01',
]


class _InteriorNetLoader:
    _custom_shuffle = True

    def __init__(self, path, sequence_size=None, max_environments_per_scene=-1,
                 seed=42, parts=None, shuffle_sequence_items=None,
                 shuffle_sequences=False, split=None):
        if parts is None:
            parts = SplitIndices('7')
        dataset_parts = parts.restrict(SplitIndices(range(1, 8)))
        assert max_environments_per_scene
        assert not shuffle_sequences
        assert split in ('train', 'test')
        self.images_per_environment = sequence_size or 20
        self.max_environments_per_scene = max_environments_per_scene
        self.shuffle_environment = shuffle_sequence_items

        self._images_per_scene = (3000, 20)
        self._environment_per_scene = tuple(
            min(max_environments_per_scene, x // self.images_per_environment)
            if max_environments_per_scene > 0
            else x // self.images_per_environment for x in self._images_per_scene)

        assert os.path.exists(os.path.join(path, 'GroundTruth_HD1-HD6')), \
            'Not a valid dataset, missing GroundTruth_HD1-HD6 folder'
        self._environment_files = []
        self._hd16_len = 0
        self._hd7_len = 0
        for i in sorted(dataset_parts):
            part_dir = os.path.join(path, f'HD{i}')
            assert os.path.exists(part_dir), f'Not a valid dataset, missing HD{i} folder'
            part_files = sorted(os.path.join(part_dir, x)
                                for x in ArchiveStore.list_archives(part_dir)
                                if x not in _IGNORED_FILES)
            if split is not None:
                num_test = int(math.ceil(len(part_files) * 0.03))
                part_files = part_files[:num_test] if split == 'test' else part_files[num_test:]
            self._environment_files.extend(part_files)
            if i < 7:
                self._hd16_len += len(part_files)
            else:
                self._hd7_len += len(part_files)
        self._ctx = None

    def get_intrinsics(self):
        return (640, 480, 600, 600, 320, 240)

    def __len__(self):
        hd16_size, hd7_size = self._environment_per_scene
        return self._hd16_len * hd16_size + self._hd7_len * hd7_size

    def num_images_per_sequence(self):
        return [self.images_per_environment] * len(self)

    @staticmethod
    def _rotate_system(pos):
        x, y, z = np.moveaxis(pos, -1, 0)
        return np.stack((y, -z, -x), -1)

    def _convert_poses(self, poses):
        # (eye[3], lookAt[3], up[3]) rows -> 7-d cameras
        eye = self._rotate_system(poses[..., 0:3])
        lookat = self._rotate_system(poses[..., 3:6])
        up = self._rotate_system(poses[..., 6:9])
        return look_at_to_cameras(eye, lookat, up)

    @staticmethod
    def _parse_cam(file):
        last_id = None
        for line in file:
            vals = line.rstrip('\n\r').split()
            if vals and vals[0].isnumeric():
                if last_id != vals[0]:
                    yield vals[0], np.array([float(x) for x in vals[1:]], np.float32)
                last_id = vals[0]

    def _ensure_context(self):
        if self._ctx is None:
            self._ctx = ArchiveStore.with_context().__enter__()

    def close(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None

    def __getitem__(self, i):
        from PIL import Image

        self._ensure_context()
        hd16_size, hd7_size = self._environment_per_scene
        if i >= self._hd16_len * hd16_size:
            env_i = (i - self._hd16_len * hd16_size) // hd7_size + self._hd16_len
            i = (i - self._hd16_len * hd16_size) % hd7_size
            is_hd16 = False
        else:
            env_i, i = divmod(i, hd16_size)
            is_hd16 = True
        fname = self._environment_files[env_i]
        images, cameras, data = [], [], []
        with ArchiveStore(fname) as archive:
            if is_hd16:
                par_dir, archive_name = os.path.split(fname)
                gt_path = os.path.join(os.path.dirname(par_dir),
                                       'GroundTruth_HD1-HD6', archive_name)
                with ArchiveStore(gt_path) as gt_archive:
                    matches = [re.match(r'^.*(\d+_\d+)$', x) for x in gt_archive.ls('')]
                    postfixes = [m.group(1) for m in matches if m is not None]
                    for postfix in postfixes:
                        subdir = f'original_{postfix}/'
                        with gt_archive.open(f'velocity_angular_{postfix}/cam0.render') as f:
                            for pose_id, pose in self._parse_cam(f):
                                data.append((subdir, pose_id, pose))
            else:
                with archive.open('cam0.render') as f:
                    for pose_id, pose in self._parse_cam(f):
                        data.append(('', pose_id, pose))

            rng = random.Random(env_i)
            if self.shuffle_environment:
                rng.shuffle(data)
            rng.seed(i)
            num_resamples = 0

            def try_add(j):
                nonlocal num_resamples
                subdir, pose_id, pose = data[j]
                try:
                    with archive.open(f'{subdir}cam0/data/{pose_id}.png', 'rb') as f:
                        image = np.array(Image.open(f).convert('RGB'))
                    images.append(image)
                    cameras.append(pose)
                except Exception:
                    print(f'Invalid image file "{subdir}cam0/data/{pose_id}.png" '
                          f'in archive {fname}', file=sys.stderr)
                    if num_resamples >= 1:
                        raise
                    num_resamples += 1
                    try_add(rng.randrange(0, len(data)))

            for j in range(i * self.images_per_environment,
                           (i + 1) * self.images_per_environment):
                try_add(j)

        cameras = self._convert_poses(np.stack(cameras, 0))
        return dict(cameras=cameras.astype(np.float32), frames=np.stack(images, 0))


class InteriorNetLoader(_InteriorNetLoader):
    def __new__(cls, *args, shuffle_sequences=None, **kwargs):
        loader = _InteriorNetLoader(*args, **kwargs)
        if shuffle_sequences:
            loader = ShuffledLoader(loader, kwargs.get('seed', 42), shuffle_sequences=True)
        return loader

    def __init__(self, *args, **kwargs):
        raise NotImplementedError()
