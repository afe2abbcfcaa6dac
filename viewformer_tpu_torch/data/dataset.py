"""Dataset storage: info.json, shard names, the legacy GQN camera fix, the
shard writer and reader (frames, cameras and codes), and the dataset
generators (generate_dataset_from_loader, transform_dataset): the port's own
copy of viewformer_tpu/data/dataset.py. The layout and the bytes are the JAX
package's, so a dataset written by either package reads in the other:

  <dir>/info.json
  <dir>/<name>-<split>-NNNNNN-of-MMMMMM.tfrecord   (+ .index sidecar)
  <dir>/<name>-<split>.index                        (the sequence index)
"""
import collections
import json
import math
import os
import shutil

import numpy as np
import torch

from ..ops.image import decode_image, encode_image
from ..parallel import distributed
from ..utils import SplitIndices, geometry
from . import tfrecord


def get_dataset_info(path):
    with open(os.path.join(path, 'info.json')) as f:
        return json.load(f)


def write_dataset_info(path, dataset_info, allow_incompatible_config=False):
    """Merge `dataset_info` into the info.json at `path`; unless
    allow_incompatible_config, raises when a key already there would change
    (except 'splits', which is the union)."""
    info = {}
    if os.path.exists(path):
        with open(path) as f:
            info = json.load(f)
    orig_info = dict(info)
    info.update(dataset_info)
    for key, val in orig_info.items():
        if not allow_incompatible_config and info[key] != val and key != 'splits':
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
    codes [N, h, w], frames (uint8 [N, H, W, C], NCHW accepted, encoded by
    encode_image; or a list of already encoded bytes). Writes
    `<path>.tfrecord.tmp`, then renames it."""
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
            if 'frames' in features:
                frames = sequence['frames']
                if isinstance(frames, (list, tuple)) and frames and isinstance(frames[0], bytes):
                    encoded = list(frames)
                else:
                    frames = np.asarray(frames)
                    if (frames.ndim > 1 and frames.shape[-3] in (3, 4)
                            and frames.shape[-1] not in (3, 4)):
                        frames = np.moveaxis(frames, -3, -1)  # NCHW -> NHWC
                    encoded = [encode_image(frame) for frame in frames]
                example_features['frames'] = ('bytes', encoded)
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


def _get_shard_map(num_images_per_sequence, max_images_per_shard, max_sequences_per_shard):
    """Greedy packing of sequences into shards: a shard closes once it holds
    max_images_per_shard images or max_sequences_per_shard sequences.
    Returns [(sequences, images, first sequence)] a shard."""
    shards = []
    current_imgs, current_seqs, offset = 0, 0, 0
    for num_img in num_images_per_sequence:
        current_imgs += num_img
        current_seqs += 1
        if ((max_images_per_shard is not None and current_imgs >= max_images_per_shard)
                or (max_sequences_per_shard is not None
                    and current_seqs >= max_sequences_per_shard)):
            shards.append((current_seqs, current_imgs, offset))
            offset += current_seqs
            current_imgs, current_seqs = 0, 0
    if current_seqs > 0:
        shards.append((current_seqs, current_imgs, offset))
    return shards


def build_index(path, num_images_per_sequence, shard_seqs):
    """The split's sequence index: a line '<shard id> <images>' a sequence."""
    with open(path, 'w') as f:
        for shard_id, (seqs, _images, offset) in enumerate(shard_seqs):
            for seq_id in range(offset, seqs + offset):
                f.write(f'{shard_id + 1:06d} {num_images_per_sequence[seq_id]}\n')


def generate_dataset_from_loader(loader, split, output_path, max_images_per_shard=None,
                                 max_sequences_per_shard=None, shards=None,
                                 allow_incompatible_config=False, progress=True):
    """Write split `split` of a sequence loader as shards of output_path (a
    directory and the dataset's name, <dir>/<name>), with info.json and the
    sequence index (written by the process that writes shard 1). shards: a
    SplitIndices (or its string) of the 1-based shards to write, for several
    processes. The features are the loader's keys, with 5-d cameras as
    'cameras-gqn'. Returns the split's info."""
    if max_images_per_shard is None and max_sequences_per_shard is None:
        raise ValueError('give max_images_per_shard or max_sequences_per_shard')
    num_images_per_sequence = loader.num_images_per_sequence()
    shard_seqs = _get_shard_map(num_images_per_sequence, max_images_per_shard,
                                max_sequences_per_shard)

    first_batch = loader[0]
    features = list(first_batch.keys())
    if 'cameras' in first_batch and np.asarray(first_batch['cameras']).shape[-1] == 5:
        features.remove('cameras')
        features.append('cameras-gqn')

    num_all_shards = len(shard_seqs)
    frames = np.asarray(first_batch['frames'])
    dataset_info = {
        'frame_size': frames.shape[-2],
        'num_image_channels': frames.shape[-1],
        'features': features,
        f'{split}_sequence_size': getattr(loader, 'sequence_size', None),
        f'{split}_size': num_all_shards,
        'splits': [split],
        f'{split}_max_images_per_shard': max_images_per_shard,
        f'{split}_max_sequences_per_shard': max_sequences_per_shard,
        f'{split}_num_images': sum(x[1] for x in shard_seqs),
        f'{split}_num_sequences': sum(x[0] for x in shard_seqs),
        'format': 'tf',
    }
    if dataset_info['num_image_channels'] not in (3, 4):
        raise ValueError(f'frames have {dataset_info["num_image_channels"]} channels, not 3 or 4')
    if len({x[0] for x in shard_seqs}) <= 1:
        dataset_info[f'{split}_num_sequences_per_shard'] = shard_seqs[0][0]
    if len({x[1] for x in shard_seqs}) <= 1:
        dataset_info[f'{split}_num_images_per_shard'] = shard_seqs[0][1]
    dataset_dir, dataset_info['name'] = os.path.split(output_path)
    os.makedirs(dataset_dir or '.', exist_ok=True)

    if shards is None:
        shard_ids = list(range(1, num_all_shards + 1))
    else:
        shard_ids = list(SplitIndices(shards).restrict(SplitIndices(range(1, num_all_shards + 1))))
    if 1 in shard_ids:
        write_dataset_info(os.path.join(dataset_dir or '.', 'info.json'), dataset_info,
                           allow_incompatible_config=allow_incompatible_config)
        build_index(f'{output_path}-{split}.index', num_images_per_sequence, shard_seqs)

    for shard_id in shard_ids:
        num_seqs, _num_img, seq_offset = shard_seqs[shard_id - 1]
        sequences = (loader[seq_offset + i] for i in range(num_seqs))
        if progress:
            from tqdm import tqdm
            sequences = tqdm(sequences, total=num_seqs,
                             desc=f'generating shard [{shard_id}/{num_all_shards}]')
        shard_path = f'{output_path}-{split}-{shard_id:06d}-of-{num_all_shards:06d}'
        write_shard(shard_path, sequences, features)
    return dataset_info


def transform_dataset(dataset_path, output_path, transformer, shards=None, splits=None,
                      progress=True):
    """Map every shard of a dataset through `transformer` into the dataset
    directory output_path, shard for shard, with the same names and index.

    transformer: .output_features(features) -> the new features,
    .update_dataset_info(info) -> the new info (optional), and
    transformer(split, sequences) -> the new sequences (dicts), lazily;
    its `image_size`, where it has one, is checked against the dataset's.
    shards: a SplitIndices (or its string) of the 1-based shards to map;
    info.json and the indexes are written where shard 1 is. In a process
    group (parallel/distributed.py) only rank 0 writes; the other ranks
    run the transformer over the same shards and drop what it yields."""
    lead = distributed.rank() == 0
    old_info = get_dataset_info(dataset_path)
    new_info = dict(old_info)
    new_info['features'] = transformer.output_features(old_info.get('features'))
    new_info['format'] = 'tf'
    if hasattr(transformer, 'update_dataset_info'):
        new_info = transformer.update_dataset_info(new_info)

    splits = splits if splits is not None else old_info.get('splits', ['test', 'train'])
    shard_restriction = None if shards is None else SplitIndices(shards)
    if lead:
        os.makedirs(output_path, exist_ok=True)
        if shards is None or 1 in shard_restriction:
            write_dataset_info(os.path.join(output_path, 'info.json'), new_info,
                               allow_incompatible_config=True)

    name = old_info['name']
    for split in splits:
        size = old_info[f'{split}_size']
        if shard_restriction is not None:
            shard_list = list(SplitIndices(range(1, size + 1)).restrict(shard_restriction))
        else:
            shard_list = list(range(1, size + 1))
        if lead and 1 in shard_list:
            src_index = os.path.join(dataset_path, f'{name}-{split}.index')
            if os.path.exists(src_index):
                shutil.copy(src_index, os.path.join(output_path, f'{name}-{split}.index'))
        iterator = shard_list
        if progress and lead:
            from tqdm import tqdm
            iterator = tqdm(shard_list, desc=f'generating {split}')
        for shard_id in iterator:
            dataset = read_dataset(dataset_path, split, shards=[shard_id],
                                   image_size=getattr(transformer, 'image_size', None))
            sequences = transformer(split, dataset)
            if not lead:
                collections.deque(sequences, maxlen=0)
                continue
            base = os.path.join(output_path, f'{name}-{split}-{shard_id:06d}-of-{size:06d}')
            write_shard(base, sequences, features=new_info['features'])
