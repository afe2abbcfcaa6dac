"""The ShapeNet-SRN loader (port of viewformer_tpu/data/loaders/shapenet.py).

`<path>/<category>_<split>/<sequence>/pose/NNNNNN.txt` (a 4x4
camera-to-world matrix) and `rgb/NNNNNN.png` a frame, for the categories
cars and chairs. The sequence counts and lengths are the published
dataset's (_SEQ_SIZES), less the sequences with missing files or invalid
poses (_BLACKLIST). Cameras and frames are read when indexed.
"""
import os
from collections import defaultdict
from functools import lru_cache, partial

import numpy as np

from ...utils.np_geometry import quaternion_normalize, rotation_matrix_to_quaternion
from ._wrappers import LazyArray

ALL_CATEGORIES = ['cars', 'chairs']

_BLACKLIST = defaultdict(set)
_BLACKLIST['cars_train'] = {'4cce557de0c31a0e70a43c2d978e502e'}
_BLACKLIST['chairs_train'] = {
    # missing files
    '18e5d3054fba58bf6e30a0dcfb43d654', '2a197b179994b877f63e8e405d49b8ce',
    '2be29f8ad81e2742eaf14273fa406ffc', '2cb0ac27f1cdb3f0b2db0181fdb9f615',
    '3d5053323021b1babbaf011bdbf27c0e', '4a671498c6e96238bf8db636a3460ee5',
    '4a89aad97f4c503068d1b9a1d97e2846', '738188ae01887d2349bb1cbbf9a4206',
    '8b552c23c064b96179368d1198f406e7', '9505568d7a277c7bdd7092ed47061a36',
    '9d0043b17b97ac694925bc492489de9c', 'b46361e53253c07b6fa2cfca412075ea',
    'b88d8b5e5fbee4fa8336a02debb9923b', 'c41fe0605cfe70571c25d54737ed5c8e',
    'cadf69f5353039e8593ebeeedbff73b', 'chairs_2.0_train',
    'd323e6d19dc58526f2c0effc06a15c11', 'e94befd51c02533b17b431cae0dd70ed',
    # invalid poses
    '8f13ac6499dfcc83f381af8194aa4242', '7f8fc2fdc88e4ca1152b86a40777b4c',
    '49d6f3affe205cc4b04cb542e2c50eb4', 'cbe006da89cca7ffd6bab114dd47e3f',
    '47d13a704da37b588fda227abcbd8611', '59c89dc89cf0d34e597976c675750537',
    '2d08a64e4a257e007135fc51795b4038', '752edd549ca958252b4875f731f71cd',
    'd5b9579151041cbd9b9f2eb77f5e247e',
}

_SEQ_SIZES = {
    'cars_train': (2151 - 1, 250),
    'cars_test': (704, 251),
    'chairs_train': (4613 - 27, 200),
    'chairs_test': (1317, 251),
}


class ShapenetLoader:
    def __init__(self, path, split, categories=None, seed=None, sequences=None):
        assert split in ('test', 'train')
        self.categories = categories if categories is not None else ALL_CATEGORIES
        if isinstance(self.categories, str):
            self.categories = [self.categories]
        self.split = split
        self.path = path
        self.sequences = sequences
        if len(self.categories) == 1:
            _, self.sequence_size = _SEQ_SIZES[f'{self.categories[0]}_{self.split}']

    def num_images_per_sequence(self):
        if self.sequences is not None:
            return sum(([_SEQ_SIZES[f'{c}_{self.split}'][-1]] * len(self._get_seqs(c))
                        for c in self.categories), [])
        return sum(([ln] * num for num, ln in
                    (_SEQ_SIZES[f'{c}_{self.split}'] for c in self.categories)), [])

    def __len__(self):
        if self.sequences is not None:
            return sum(len(self._get_seqs(c)) for c in self.categories)
        return sum(num for num, _ln in (_SEQ_SIZES[f'{c}_{self.split}']
                                        for c in self.categories))

    @staticmethod
    def camera_to_world_matrices_to_cameras(cam_to_world):
        position = cam_to_world[..., :-1, -1]
        R = cam_to_world[..., :-1, :-1]
        quaternion = quaternion_normalize(rotation_matrix_to_quaternion(R))
        return np.concatenate([position, quaternion], -1).astype(np.float32)

    @lru_cache()
    def _get_seqs(self, category):
        xs = os.listdir(os.path.join(self.path, f'{category}_{self.split}'))
        if self.sequences is not None:
            available = set(xs)
            return [x for x in self.sequences if x in available]
        return sorted(x for x in xs if x not in _BLACKLIST[f'{category}_{self.split}'])

    def read_camera(self, category, seq_name, i):
        with open(os.path.join(self.path, f'{category}_{self.split}', seq_name,
                               'pose', f'{i:06d}.txt')) as f:
            mat = np.array(list(map(float, f.read().strip().split())), np.float32)
        return self.camera_to_world_matrices_to_cameras(mat.reshape(4, 4))

    def read_image(self, category, seq_name, i):
        from PIL import Image
        return np.array(Image.open(os.path.join(
            self.path, f'{category}_{self.split}', seq_name, 'rgb',
            f'{i:06d}.png')).convert('RGB'))

    def __getitem__(self, i):
        for cat in self.categories:
            num, ln = _SEQ_SIZES[f'{cat}_{self.split}']
            if self.sequences is not None:
                num = len(self._get_seqs(cat))
            if i < num:
                break
            i -= num
        else:
            raise IndexError(i)
        seq_name = self._get_seqs(cat)[i]
        indices = list(range(ln))
        return dict(
            cameras=LazyArray(indices, partial(self.read_camera, cat, seq_name)),
            frames=LazyArray(indices, partial(self.read_image, cat, seq_name)),
            sequence_id=seq_name)
