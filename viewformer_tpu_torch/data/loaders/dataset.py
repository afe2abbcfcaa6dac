"""A generated dataset read back as a sequence loader (port of
viewformer_tpu/data/loaders/dataset.py), the loader behind `evaluate ...
--loader dataset`: in-sequence shuffling, fixed-size chunks and buffered
sequence shuffling, each deterministic in seed."""
from functools import lru_cache
from itertools import chain
from random import Random

from ...utils import batch_len, batch_slice
from ..dataset import get_dataset_info, read_dataset


class _Reiterable:
    def __init__(self, fn):
        self._fn = fn

    def __iter__(self):
        return iter(self._fn())


def get_sequence_shuffled_dataset(dataset, seed=42):
    def gen():
        rng = Random(seed)
        for data in dataset:
            permutation = list(range(batch_len(data)))
            rng.shuffle(permutation)
            yield batch_slice(data, permutation)
    return _Reiterable(gen)


def get_locally_shuffled_dataset(dataset, buffer_size, seed=42):
    def gen():
        rng = Random(seed)
        buffer = []
        for data in dataset:
            buffer.append(data)
            if len(buffer) >= buffer_size:
                idx = rng.randrange(len(buffer))
                buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                yield buffer.pop()
        rng.shuffle(buffer)
        yield from buffer
    return _Reiterable(gen)


def limit_sequence_size(dataset, sequence_size):
    def gen():
        for data in dataset:
            for i in range(batch_len(data) // sequence_size):
                yield batch_slice(data, slice(i * sequence_size, (i + 1) * sequence_size))
    return _Reiterable(gen)


class DatasetLoader:
    _custom_shuffle = True

    def __init__(self, path, split='train', shuffle_sequences=False, sequence_size=None,
                 shuffle_sequence_items=False, shuffle_buffer_size=10000, seed=42,
                 image_size=None, **kwargs):
        self.dataset_info = get_dataset_info(path)
        self.path = path
        self.split = split
        self.num_sequences = self.dataset_info.get(f'{split}_num_sequences')
        self.sequence_size = sequence_size
        self.shuffle_sequence_items = shuffle_sequence_items
        self.shuffle_buffer_size = shuffle_buffer_size
        read_kwargs = dict(kwargs)
        if image_size is not None:
            read_kwargs['image_size'] = image_size
        self.dataset = _Reiterable(lambda: read_dataset(path, split, **read_kwargs))
        if shuffle_sequence_items:
            self.dataset = get_sequence_shuffled_dataset(self.dataset, seed)
        if sequence_size is not None:
            self.dataset = limit_sequence_size(self.dataset, sequence_size)
            self.num_sequences = sum(x // sequence_size for x in self._raw_images_per_sequence())
        if shuffle_sequences:
            self.dataset = get_locally_shuffled_dataset(self.dataset, shuffle_buffer_size, seed)
        self._iterator_cache = None

    @lru_cache()
    def _raw_images_per_sequence(self):
        split_seq_size = self.dataset_info.get(f'{self.split}_sequence_size')
        if split_seq_size is not None:
            return [split_seq_size] * self.dataset_info[f'{self.split}_num_sequences']
        name = self.dataset_info['name']
        with open(f'{self.path}/{name}-{self.split}.index') as f:
            return [int(line.strip().split(' ')[-1]) for line in f if line.strip()]

    @lru_cache()
    def num_images_per_sequence(self):
        raw = self._raw_images_per_sequence()
        if self.sequence_size is None:
            return raw
        return list(chain(*([self.sequence_size] * (x // self.sequence_size) for x in raw)))

    def __len__(self):
        return len(self.num_images_per_sequence())

    def __getitem__(self, i):
        """The i-th sequence, read in order: an iterator over the dataset is
        kept and restarted only when i goes back."""
        if self._iterator_cache is None or self._iterator_cache[0] > i:
            iterator = iter(self.dataset)
            self._iterator_cache = (0, iterator, next(iterator))
        idx, iterator, current = self._iterator_cache
        while idx < i:
            current = next(iterator)
            idx += 1
            self._iterator_cache = (idx, iterator, current)
        return current
