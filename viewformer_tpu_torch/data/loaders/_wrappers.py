"""Loader wrappers: shuffling, fixed sequence size, image resize (port of
viewformer_tpu/data/loaders/_wrappers.py; its LazyArray comes with the
loaders that make one). A loader is a sequence-indexed mapping: loader[i] ->
{'cameras': [N, 7] float32, 'frames': [N, H, W, C] uint8, ...}, with
num_images_per_sequence() and __len__.
"""
import random
from functools import lru_cache

import numpy as np
import torch

from ...ops.image import resize
from ...utils import batch_len


class ChangedImageSizeLoader:
    def __init__(self, inner, image_size):
        self.inner = inner
        self.image_size = image_size

    @property
    def sequence_size(self):
        return getattr(self.inner, 'sequence_size', None)

    def num_images_per_sequence(self):
        return self.inner.num_images_per_sequence()

    def __getitem__(self, idx):
        item = self.inner[idx]
        if self.image_size is not None and 'frames' in item:
            frames = np.asarray(item['frames'])
            if frames.shape[-2] != self.image_size:
                item = dict(item)
                item['frames'] = resize(torch.from_numpy(frames), self.image_size).numpy()
        return item

    def __len__(self):
        return len(self.inner)


class FixedSequenceSizeLoader:
    """Splits variable-length sequences into chunks of sequence_size."""

    def __init__(self, inner, sequence_size):
        self.inner = inner
        self.sequence_size = sequence_size

    def __len__(self):
        return len(self.num_images_per_sequence())

    @lru_cache()
    def num_images_per_sequence(self):
        return sum(([self.sequence_size] * (x // self.sequence_size)
                    for x in self.inner.num_images_per_sequence()), [])

    @lru_cache()
    def _offset_map(self):
        return [(inner_i, i * self.sequence_size)
                for inner_i, x in enumerate(self.inner.num_images_per_sequence())
                for i in range(x // self.sequence_size)]

    @lru_cache(maxsize=1)
    def _get_inner(self, idx):
        return self.inner[idx]

    def __getitem__(self, idx):
        inner_idx, offset = self._offset_map()[idx]
        item = self._get_inner(inner_idx)
        return {k: v[offset:offset + self.sequence_size] if not isinstance(v, str) else v
                for k, v in item.items()}


class ShuffledLoader:
    """Shuffles the sequences, or the items within each sequence,
    deterministically in seed."""

    def __init__(self, inner, seed=42, shuffle_sequence_items=False, shuffle_sequences=False):
        self.inner = inner
        self.seed = seed
        self.shuffle_sequences = shuffle_sequences
        self.shuffle_sequence_items = shuffle_sequence_items
        if hasattr(inner, 'sequence_size'):
            self.sequence_size = inner.sequence_size

    @lru_cache()
    def _sequence_indices(self):
        indices = list(range(len(self)))
        if self.shuffle_sequences:
            random.Random(self.seed).shuffle(indices)
        return indices

    def __len__(self):
        return len(self.inner)

    def num_images_per_sequence(self):
        inner_sizes = self.inner.num_images_per_sequence()
        if self.shuffle_sequences:
            return [inner_sizes[x] for x in self._sequence_indices()]
        return inner_sizes

    @staticmethod
    def _take(items, indices):
        if isinstance(items, str):
            return items
        if isinstance(items, np.ndarray):
            return items[indices]
        return [items[x] for x in indices]

    def __getitem__(self, idx):
        if self.shuffle_sequences:
            idx = self._sequence_indices()[idx]
        batch = self.inner[idx]
        if self.shuffle_sequence_items:
            indices = list(range(batch_len(batch)))
            random.Random(self.seed * len(self) + idx).shuffle(indices)
            batch = {k: self._take(v, indices) for k, v in batch.items()}
        return batch
