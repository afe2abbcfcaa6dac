"""`dataset shuffle`: permute a dataset's sequences across its shards
byte-wise (the port's own copy of viewformer_tpu/data/shuffle.py).

A record moves from its shard to its new one through the shards' `.index`
sidecars (built where missing): it is read at its offset and written as it
is, never decoded. Each split's sequences are shuffled with Python's
`random.Random` of a seed derived from the split's name, then packed into
output shards under the input's shard limits (`<split>_max_images_per_shard`,
`<split>_max_sequences_per_shard` of info.json). Two fixes of the JAX
package over the reference are kept: each output shard's `.index` holds only
`offset length` lines, and its offsets start at 0.
"""
import json
import os
import shutil
from functools import reduce
from random import Random

from . import tfrecord


def _load_global_index(path, name, split):
    """[(source shard, sequence length)] of the split's global index file,
    in order."""
    entries = []
    with open(os.path.join(path, f'{name}-{split}.index')) as f:
        for line in f:
            line = line.strip()
            if line:
                shard, seq_len = line.split()
                entries.append((int(shard.lstrip('0') or '0'), int(seq_len)))
    return entries


def _assign_shards(entries, max_images, max_sequences):
    """The 1-based output shard of each (.., .., sequence length) entry: a
    shard closes once it holds max_sequences sequences or max_images
    frames."""
    assignments = []
    shard, images, sequences = 1, 0, 0
    for _, _, seq_len in entries:
        assignments.append(shard)
        images += seq_len
        sequences += 1
        if ((max_sequences is not None and sequences >= max_sequences)
                or (max_images is not None and images >= max_images)):
            shard, images, sequences = shard + 1, 0, 0
    return assignments


def _shuffle_split(path, output_path, dataset_info, split, seed, progress=True):
    name = dataset_info['name']
    size = dataset_info[f'{split}_size']
    shard_indices = {}

    def shard_base(root, idx):
        return os.path.join(root, f'{name}-{split}-{idx:06d}-of-{size:06d}')

    def shard_index(idx):
        if idx not in shard_indices:
            base = shard_base(path, idx)
            if not os.path.exists(f'{base}.index'):
                tfrecord.build_shard_index(f'{base}.tfrecord', f'{base}.index')
            shard_indices[idx] = tfrecord.read_shard_index(f'{base}.index')
        return shard_indices[idx]

    # (source shard, position in it, sequence length), in the global order
    entries, counters = [], {}
    for shard_id, seq_len in _load_global_index(path, name, split):
        local_id = counters.get(shard_id, 0)
        counters[shard_id] = local_id + 1
        entries.append((shard_id, local_id, seq_len))
    Random(seed).shuffle(entries)
    assignments = _assign_shards(entries, dataset_info.get(f'{split}_max_images_per_shard'),
                                 dataset_info.get(f'{split}_max_sequences_per_shard'))
    num_out_shards = assignments[-1] if assignments else 0

    items = zip(assignments, entries)
    if progress:
        from tqdm import tqdm
        items = tqdm(list(items), desc=f'shuffling {split}')
    out = out_index = None
    current, offset = None, 0
    with open(os.path.join(output_path, f'{name}-{split}.index'), 'w') as global_index:
        try:
            for out_shard, (src_shard, local_id, seq_len) in items:
                if out_shard != current:
                    if out is not None:
                        out.close()
                        out_index.close()
                    base = shard_base(output_path, out_shard)
                    out = open(f'{base}.tfrecord', 'wb')
                    out_index = open(f'{base}.index', 'w')
                    current, offset = out_shard, 0
                start, length = shard_index(src_shard)[local_id]
                with open(shard_base(path, src_shard) + '.tfrecord', 'rb') as src:
                    src.seek(start)
                    out.write(src.read(length))
                out_index.write(f'{offset} {length}\n')
                global_index.write(f'{out_shard:06d} {seq_len}\n')
                offset += length
        finally:
            if out is not None:
                out.close()
                out_index.close()

    if num_out_shards != size:
        dataset_info[f'{split}_size'] = num_out_shards
        with open(os.path.join(output_path, 'info.json'), 'w') as f:
            json.dump(dataset_info, f, sort_keys=True)


def shuffle_dataset(path, output_path, seed=42, progress=True):
    """Write the dataset at `path` to the new directory `output_path` with
    every split's sequences in a seeded random order (module docstring):
    info.json, the shards, their `.index` sidecars and each split's global
    index. Raises if output_path exists."""
    if os.path.exists(output_path):
        raise RuntimeError(f'Output path {output_path} already exists')
    os.makedirs(output_path, exist_ok=True)
    shutil.copy(os.path.join(path, 'info.json'), os.path.join(output_path, 'info.json'))
    with open(os.path.join(path, 'info.json')) as f:
        dataset_info = json.load(f)
    for split in dataset_info['splits']:
        local_seed = seed ^ (reduce(lambda a, x: a * ord(x), split, 1) % 31)
        _shuffle_split(path, output_path, dataset_info, split, local_seed, progress=progress)
