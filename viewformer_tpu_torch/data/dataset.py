"""Dataset storage: info.json, shard names, the legacy GQN camera fix, the
shard writer (cameras and codes) and the shard reader (cameras, codes and
frames), the port's own copy of viewformer_tpu/data/dataset.py without the
dataset generators. The layout is the JAX package's, so a dataset written
by either package reads in the other:

  <dir>/info.json
  <dir>/<name>-<split>-NNNNNN-of-MMMMMM.tfrecord   (+ .index sidecar)
"""
import json
import math
import os

import numpy as np
import torch

from ..ops.image import decode_image
from ..utils import geometry
from . import tfrecord


def get_dataset_info(path):
    with open(os.path.join(path, 'info.json')) as f:
        return json.load(f)


def write_dataset_info(path, dataset_info):
    """Merge `dataset_info` into the info.json at `path`; raises when a key
    already there would change (except 'splits', which is the union)."""
    info = {}
    if os.path.exists(path):
        with open(path) as f:
            info = json.load(f)
    orig_info = dict(info)
    info.update(dataset_info)
    for key, val in orig_info.items():
        if info[key] != val and key != 'splits':
            raise RuntimeError(
                'Cannot override dataset because dataset config is different:\n'
                f'{json.dumps(orig_info, sort_keys=True)}\n!=\n{json.dumps(info, sort_keys=True)}')
    info['splits'] = sorted(set(dataset_info.get('splits', [])) | set(orig_info.get('splits', [])))
    with open(path, 'w') as f:
        json.dump(info, f, sort_keys=True)


def get_shard_filename(path, split, shard_id, size):
    return f'{path}-{split}-{shard_id:06d}-of-{size:06d}.tfrecord'


def fix_legacy_gqn_cameras(poses, position_multiplier=1.0):
    """Legacy 5-d GQN cameras (x, y, z, yaw, pitch) [..., 5] -> 7-d poses
    (numpy f32): the axes remapped, yaw and pitch as a quaternion."""
    x, y, z, yaw, pitch = torch.from_numpy(np.asarray(poses, np.float32)).unbind(-1)
    xyz = position_multiplier * torch.stack([y, -z, -x], -1)
    quat = geometry.quaternion_multiply(geometry.make_quaternion_y(math.pi - yaw),
                                        geometry.make_quaternion_x(pitch))
    return torch.cat((xyz, quat), -1).numpy()


def write_shard(path, data, features):
    """Write one shard `<path>.tfrecord` (and its `.index`) from an iterable
    of per-sequence dicts: cameras [N, 7] (or [N, 5] under 'cameras-gqn'),
    codes [N, h, w]. Writes `<path>.tfrecord.tmp`, then renames it. Frames
    are not written: encoding images is not ported yet."""
    if 'frames' in features:
        raise NotImplementedError('writing frames needs the image codec, which is not ported')
    tmp_path = f'{path}.tfrecord.tmp'
    with tfrecord.RecordWriter(tmp_path) as writer:
        for sequence in data:
            example_features = {}
            if 'cameras' in features or 'cameras-gqn' in features:
                cameras = np.asarray(sequence['cameras'], np.float32)
                example_features['cameras'] = ('float', cameras.reshape(-1))
            if 'codes' in features:
                codes = np.asarray(sequence['codes'], np.int64)
                example_features['codes'] = ('int64', codes.reshape(-1))
            writer.write(tfrecord.encode_example(example_features))
    tfrecord.build_shard_index(tmp_path, f'{path}.index')
    os.replace(tmp_path, f'{path}.tfrecord')


def read_shards(shard_paths, info, image_size=None, features=None, _decode_image=True):
    """Yield one dict a sequence from shard files: cameras [N, 7] f32 (legacy
    5-d GQN cameras converted), codes [N, h, w] int64, frames [N, H, W, C]
    uint8 (decoded with Pillow; with _decode_image=False, the encoded
    bytes)."""
    if features is None:
        features = info.get('features', ['cameras', 'frames'])
    if image_size is not None and info['frame_size'] != image_size:
        raise ValueError(f'Dataset has a different image size: {info["frame_size"]} != '
                         f'{image_size}')
    token_image_size = info.get('token_image_size')
    for shard_path in shard_paths:
        for payload in tfrecord.read_records(shard_path):
            example = tfrecord.decode_example(payload)
            output = {}
            if 'cameras' in features or 'cameras-gqn' in features:
                poses_num_dim = 5 if 'cameras-gqn' in features else 7
                poses = np.asarray(example['cameras'], np.float32).reshape(-1, poses_num_dim)
                if poses_num_dim == 5:
                    poses = fix_legacy_gqn_cameras(poses)
                output['cameras'] = poses
            if 'codes' in features:
                output['codes'] = np.asarray(example['codes'], np.int64).reshape(
                    -1, token_image_size, token_image_size)
            if 'frames' in features or 'images' in features:
                if _decode_image:
                    output['frames'] = np.stack([decode_image(x) for x in example['frames']], 0)
                else:
                    output['frames'] = example['frames']
            yield output


def read_dataset(dataset_path, split, shards=None, **kwargs):
    """read_shards over every shard of a split (or the 1-based `shards`)."""
    info = get_dataset_info(dataset_path)
    name, size = info['name'], info[f'{split}_size']
    if shards is None:
        shards = list(range(1, size + 1))
    else:
        shards = [i for i in shards if 1 <= i <= size]
    paths = [os.path.join(dataset_path, f'{name}-{split}-{i:06d}-of-{size:06d}.tfrecord')
             for i in shards]
    return read_shards(paths, info, **kwargs)
