"""The 7-Scenes loader (port of viewformer_tpu/data/loaders/sevenscenes.py).

A scene is `<path>/<scene>.zip` holding TrainSplit.txt and TestSplit.txt
(lines `sequenceN`) and one `seq-NN.zip` a sequence, with
`frame-NNNNNN.color.png` and `frame-NNNNNN.pose.txt` (a 4x4 camera-to-world
matrix) a frame. A sequence is one item: its cameras (position and
quaternion) and its frames, decoded with Pillow when indexed.
"""
import os
from collections import OrderedDict
from functools import lru_cache

import numpy as np

from ...utils.np_geometry import quaternion_normalize, rotation_matrix_to_quaternion
from ..archive import ArchiveStore
from ._wrappers import LazyArray

ALL_SCENES = ['chess', 'fire', 'heads', 'office', 'pumpkin', 'redkitchen', 'stairs']


class SevenScenesLoader:
    """The sequences of `split` ('train', 'test' or None for both) of
    `scenes` (default all seven). _load_file_paths adds each item's
    `frames_files`, `seq-NN/frame-NNNNNN` a frame."""

    def __init__(self, path, split=None, scenes=None, seed=None, _load_file_paths=False):
        if scenes is None:
            scenes = ALL_SCENES
        self.scenes = scenes
        self.split = split
        self.path = path
        self._load_file_paths = _load_file_paths
        self._metadata_cache = {}
        for scene in scenes:
            assert os.path.exists(os.path.join(path, f'{scene}.zip')), \
                f'Not a valid dataset, missing {scene}.zip file'

    @lru_cache()
    def get_seqs(self):
        splits = [self.split] if self.split is not None else ['train', 'test']
        scene_seqs = OrderedDict()
        for scene in self.scenes:
            with ArchiveStore(os.path.join(self.path, scene)) as archive:
                seqs = []
                for split in splits:
                    with archive.open(f'{split.title()}Split.txt') as f:
                        for line in f:
                            line = line.rstrip('\n\r')
                            if line and line.startswith('sequence'):
                                seqs.append(int(line[len('sequence'):]))
            scene_seqs[scene] = seqs
        return scene_seqs

    @lru_cache()
    def num_images_per_sequence(self):
        return [len(self._read_sequence(scene, seq)[0])
                for scene, seqs in self.get_seqs().items() for seq in seqs]

    def __len__(self):
        return sum(map(len, self.get_seqs().values()))

    @staticmethod
    def camera_to_world_matrices_to_cameras(cam_to_world):
        position = cam_to_world[..., :-1, -1]
        R = cam_to_world[..., :-1, :-1]
        quaternion = quaternion_normalize(rotation_matrix_to_quaternion(R))
        return np.concatenate([position, quaternion], -1).astype(np.float32)

    def get_intrinsics(self):
        """(width, height, fx, fy, cx, cy) of the Kinect frames."""
        return (640, 480, 585, 585, 320, 240)

    def _read_sequence(self, scene, seq):
        """(frame names, camera-to-world matrices [N, 4, 4], the open of the
        sequence's archive), read once a sequence."""
        key = (scene, seq)
        if key not in self._metadata_cache:
            sup_archive = ArchiveStore(os.path.join(self.path, scene)).__enter__()
            archive = ArchiveStore(sup_archive.open(f'seq-{seq:02}.zip', 'r')).__enter__()
            seq_items = sorted(set(x[:x.index('.')] for x in archive.ls('')
                                   if '.' in x and 'thumbs' not in x.lower()))
            matrices = []
            for framename in seq_items:
                mat = np.zeros((4, 4), np.float32)
                with archive.open(f'{framename}.pose.txt') as f:
                    for r, line in enumerate(f):
                        for c, val in enumerate(line.strip('\r\n').split()):
                            mat[r, c] = float(val)
                matrices.append(mat)
            self._metadata_cache[key] = (seq_items, np.stack(matrices, 0), archive.open)
        return self._metadata_cache[key]

    def __getitem__(self, i):
        from PIL import Image

        for scene, seqs in self.get_seqs().items():
            if i < len(seqs):
                break
            i -= len(seqs)
        else:
            raise IndexError(i)
        seq = seqs[i]
        seq_items, matrices, _open = self._read_sequence(scene, seq)

        def decode(name):
            with _open(f'{name}.color.png', 'rb') as f:
                return np.array(Image.open(f).convert('RGB'))

        output = dict(cameras=self.camera_to_world_matrices_to_cameras(matrices),
                      frames=LazyArray(seq_items, decode))
        if self._load_file_paths:
            output['frames_files'] = [f'seq-{seq:02}/{x}' for x in seq_items]
        return output
