"""The Shepard-Metzler-7 loader (port of viewformer_tpu/data/loaders/sm7.py):
DeepMind's GQN shards of 15 frames at 64 px a sequence, with the legacy 5-d
GQN cameras turned into 7-vectors, read in order from a local mirror of
`shepard_metzler_7_parts` (`path`). The port reads local files only: the
default `gs://gqn-dataset/...` path raises.
"""
from ..dataset import read_shards


class SM7Loader:
    """The sequences of `split` in shard order, read through one iterator
    (indexing backwards restarts it). Shuffling and other sequence sizes
    are refused."""

    _custom_shuffle = True

    @property
    def dataset_info(self):
        return {
            'name': 'sh',
            'max_num_views': 15,
            'frame_size': 64,
            'features': ['frames', 'cameras-gqn'],
            'format': 'tf',
            'splits': ['test', 'train'],
            'train_sequence_size': 15,
            'test_sequence_size': 15,
            'environments_per_shard': 2000,
            'train_num_sequences': 806400,
            'test_num_sequences': 200000,
        }

    def __init__(self, split='train', shuffle_sequences=None, sequence_size=None,
                 shuffle_sequence_items=None, path=None, **kwargs):
        assert split in self.dataset_info['splits']
        assert not shuffle_sequences, 'Dataset does not support shuffling'
        assert not shuffle_sequence_items, 'Dataset does not support shuffling'
        assert sequence_size is None or sequence_size == self.dataset_info['train_sequence_size'], \
            'Sequence size cannot be changed'
        self._iterator_cache = None
        self.split = split
        self.sequence_size = self.dataset_info[f'{split}_sequence_size']
        base = path or 'gs://gqn-dataset/shepard_metzler_7_parts'
        if '://' in base:
            raise ValueError(f'The sm7 loader reads a local mirror only, not {base}: pass '
                             'path=<directory of shepard_metzler_7_parts>')
        if split == 'train':
            self.shards = [f'{base}/train/{i:03d}-of-900.tfrecord' for i in range(1, 901)]
        else:
            self.shards = [f'{base}/test/{i:03d}-of-100.tfrecord' for i in range(1, 101)]

    def num_images_per_sequence(self):
        return [self.sequence_size] * len(self)

    def __len__(self):
        return self.dataset_info[f'{self.split}_num_sequences']

    def _iterate(self):
        return read_shards(self.shards, self.dataset_info)

    def _get_batch(self, i):
        if self._iterator_cache is None or self._iterator_cache[0] > i:
            iterator = iter(self._iterate())
            self._iterator_cache = (0, iterator, next(iterator))
        idx, iterator, current = self._iterator_cache
        while idx < i:
            current = next(iterator)
            idx += 1
            self._iterator_cache = (idx, iterator, current)
        return current

    def __getitem__(self, i):
        return self._get_batch(i)
