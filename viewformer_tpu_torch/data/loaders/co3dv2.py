"""The CO3D v2 loader (port of viewformer_tpu/data/loaders/co3dv2.py).

Reads `<path>/<category>/frame_annotations.jgz` (gzip'd JSON) and the
category's set list (`set_lists.json`, or `set_lists/set_lists_<set>.json`)
directly, with no code of the co3d project. Frames are RGBA at image_size:
the RGB zeroed where the mask is at most 127, the mask as the fourth
channel. Cameras turn PyTorch3D's viewpoint (a right-multiplied R, y up and
x left) into the 7-vector (y down, x right).
"""
import gzip
import json
import os
from functools import lru_cache
from itertools import accumulate, groupby

import numpy as np

from ...utils.np_geometry import quaternion_normalize, rotation_matrix_to_quaternion

CO3D_CATEGORIES = list(reversed([
    "baseballbat", "banana", "bicycle", "microwave", "tv",
    "cellphone", "toilet", "hairdryer", "couch", "kite", "pizza",
    "umbrella", "wineglass", "laptop",
    "hotdog", "stopsign", "frisbee", "baseballglove",
    "cup", "parkingmeter", "backpack", "toyplane", "toybus",
    "handbag", "chair", "keyboard", "car", "motorcycle",
    "carrot", "bottle", "sandwich", "remote", "bowl", "skateboard",
    "toaster", "mouse", "toytrain", "book", "toytruck",
    "orange", "broccoli", "plant", "teddybear",
    "suitcase", "bench", "ball", "cake",
    "vase", "hydrant", "apple", "donut",
]))


class _Frame:
    """The fields of one frame annotation that the loader reads."""

    __slots__ = ('sequence_name', 'frame_number', 'image_path', 'mask_path',
                 'depth_path', 'R', 'T')

    def __init__(self, data):
        self.sequence_name = data['sequence_name']
        self.frame_number = data['frame_number']
        self.image_path = data['image']['path']
        self.mask_path = data['mask']['path']
        self.depth_path = (data.get('depth') or {}).get('path')
        viewpoint = data.get('viewpoint') or {}
        self.R = np.asarray(viewpoint.get('R', np.eye(3)), np.float64)
        self.T = np.asarray(viewpoint.get('T', np.zeros(3)), np.float64)


class CO3Dv2Loader:
    _custom_resize = True

    def __init__(self, path, split=None, categories=None, sequence_set='fewview_train',
                 image_size=None, seed=None):
        assert split in ('test', 'train', 'val')
        assert image_size is not None
        self.categories = categories if categories is not None else CO3D_CATEGORIES
        if isinstance(self.categories, str):
            self.categories = [self.categories]
        self.split = split
        self.path = path
        self.sequence_set = sequence_set
        self.image_size = image_size

    @staticmethod
    def world_to_camera_matrix_to_cameras(R, position):
        """A PyTorch3D viewpoint (R, T) -> the camera 7-vector."""
        R = np.array(R, np.float64)
        position = np.array(position, np.float64)
        R[:2, :] *= -1
        position[:2] *= -1
        quaternion = quaternion_normalize(rotation_matrix_to_quaternion(R))
        return np.concatenate([position, quaternion], -1).astype(np.float32)

    @lru_cache()
    def _dataset(self):
        frames = []
        for i, category in enumerate(self.categories):
            jgz = os.path.join(self.path, category, 'frame_annotations.jgz')
            with gzip.open(jgz, 'rt') as f:
                annotations = json.load(f)
            frame_map = {(x['sequence_name'], x['frame_number']): x for x in annotations}
            json_path = os.path.join(self.path, category, 'set_lists.json')
            if os.path.exists(json_path):
                with open(json_path) as f:
                    data_list = json.load(f)[self.sequence_set]
            else:
                json_path = os.path.join(self.path, category, 'set_lists',
                                         f'set_lists_{self.sequence_set}.json')
                with open(json_path) as f:
                    data_list = json.load(f)[self.split]
            for seq_name, frame_num, _path in data_list:
                frames.append(_Frame(frame_map[(seq_name, frame_num)]))
        return frames

    def __len__(self):
        return len(self.num_images_per_sequence())

    @lru_cache()
    def num_images_per_sequence(self):
        return [sum(1 for _ in group) for _, group in
                groupby(self._dataset(), key=lambda x: x.sequence_name)]

    @lru_cache()
    def _cum_images_per_sequence(self):
        return [0] + list(accumulate(self.num_images_per_sequence()[:-1]))

    def get_intrinsics(self):
        return (800, 800, 400, 400, 400, 400)

    def _load_image(self, image_path):
        from PIL import Image
        with Image.open(os.path.join(self.path, image_path)) as img:
            return np.asarray(img.resize((self.image_size, self.image_size)))

    @staticmethod
    def _process_rgb_image(image, mask):
        mask_fg = mask > 127
        image_rgb_masked = np.where(mask_fg[..., None], image, np.zeros_like(image))
        return np.concatenate([image_rgb_masked, mask[..., None]], -1)

    def __getitem__(self, i):
        start = self._cum_images_per_sequence()[i]
        seq_len = self.num_images_per_sequence()[i]
        data = self._dataset()[start:start + seq_len]
        images = [self._load_image(x.image_path) for x in data]
        masks = [self._load_image(x.mask_path) for x in data]
        frames = np.stack([self._process_rgb_image(img, m) for img, m in zip(images, masks)], 0)
        cameras = np.stack([self.world_to_camera_matrix_to_cameras(x.R, x.T) for x in data], 0)
        return dict(cameras=cameras, frames=frames, sequence_id=data[0].sequence_name)
