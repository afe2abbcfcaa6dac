"""The training readers: load_image_dataset (frames, for the codebook) and
load_token_dataset (cameras and codes, for the transformer), the port's own
copies of viewformer_tpu/data/pipeline.py's, with the same seeds, so they
yield the JAX package's batches in the JAX package's order.

Numpy iterator pipelines: per-process shard assignment, round-robin
interleaves (records across shards; for tokens also sequence chunks across
open environments), a local shuffle buffer, a thread pool that decodes
frames with Pillow, and a background prefetch thread that hands ready numpy
batches to the train loop, with a resume cursor.
"""
import collections
import inspect
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.image import decode_image
from .dataset import fix_legacy_gqn_cameras, get_dataset_info
from .tfrecord import decode_example, read_records


def _host_info():
    """(rank, world size) of this process: torch.distributed's when a process
    group is initialised, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def _shard_paths(path, split):
    info = get_dataset_info(path)
    name, size = info['name'], info[f'{split}_size']
    return info, [os.path.join(path, f'{name}-{split}-{i:06d}-of-{size:06d}.tfrecord')
                  for i in range(1, size + 1)]


def _select_host_shards(paths, host_id, num_hosts):
    """Rank-modulo shard assignment; with fewer shards than processes each
    process takes one shard, shared."""
    if num_hosts <= 1:
        return list(paths)
    if len(paths) < num_hosts:
        return [paths[host_id % len(paths)]]
    return [p for i, p in enumerate(paths) if i % num_hosts == host_id]


def _interleave(factories, cycle_length):
    """Round-robin (block_length=1) interleave over lazily opened streams, as
    tf.data's interleave: up to `cycle_length` streams are open at once, one
    item is drawn from each in turn, and an exhausted slot is refilled from
    the next factory. `factories` is any iterable of zero-argument callables
    returning iterables; it may itself be lazy."""
    factories = iter(factories)
    active = []

    def refill():
        while len(active) < cycle_length:
            try:
                factory = next(factories)
            except StopIteration:
                return
            active.append(iter(factory()))

    refill()
    idx = 0
    while active:
        if idx >= len(active):
            idx = 0
        try:
            item = next(active[idx])
        except StopIteration:
            active.pop(idx)
            refill()
            continue
        yield item
        idx += 1


# Shard-level interleave width (a fixed small fan-in keeps the order seeded)
# and environment-level width (the reference's cycle_length=8).
INTERLEAVE_SHARDS = 4
INTERLEAVE_ENVIRONMENTS = 8
DECODE_THREADS = 8


def _local_shuffle(iterator, buffer_size, rng):
    buffer = []
    for item in iterator:
        buffer.append(item)
        if len(buffer) >= buffer_size:
            idx = rng.randrange(len(buffer))
            buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
            yield buffer.pop()
    rng.shuffle(buffer)
    yield from buffer


class Prefetcher:
    """Background-thread prefetch into a bounded queue (host batches are
    made while the device step runs).

    With track_state=True the wrapped iterator yields (state, batch) pairs;
    `.state` then holds the resume cursor of the batch most recently handed
    to the consumer (batches still waiting in the queue are made again on
    resume), to pass back as the loader's `start_state`."""

    _DONE = object()

    def __init__(self, iterator_factory, buffer_size=2, track_state=False):
        self._factory = iterator_factory
        self._queue = queue.Queue(maxsize=buffer_size)
        self._thread = None
        self._stop = threading.Event()
        self._track_state = track_state
        self.state = None

    def _run(self):
        try:
            for item in self._factory():
                if self._stop.is_set():
                    return
                self._queue.put(item)
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is self._DONE:
                return
            if self._track_state:
                self.state, item = item
            yield item

    def close(self):
        """Stop the producer even if the consumer left early: it may be
        blocked in queue.put, so drain the queue until it sees the stop flag
        and exits."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get(timeout=0.1)
            except queue.Empty:
                pass


def _ordered_map(pool, fn, items, window):
    """pool.map(fn, items) with at most `window` calls submitted ahead of the
    one yielded, so a long stream is neither read nor held whole."""
    pending = collections.deque()
    for item in items:
        pending.append(pool.submit(fn, item))
        if len(pending) >= window:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


def _resumable_epochs(epoch_iterator, repeat, start_state):
    """Per-epoch iterators -> a factory of one (state, batch) stream with an
    {'epoch', 'batch'} resume cursor. Resuming replays the cursor's epoch
    from its seeded start and drops its first `batch` batches: the
    uninterrupted order, since each epoch's rngs depend on (seed, epoch)
    only. repeat: None one epoch, -1 forever, else that many epochs."""
    start_epoch = int(start_state['epoch']) if start_state else 0
    start_batch = int(start_state['batch']) if start_state else 0

    def iterator():
        epoch, skip = start_epoch, start_batch
        while True:
            for i, batch in enumerate(epoch_iterator(epoch)):
                if i < skip:
                    continue
                yield {'epoch': epoch, 'batch': i + 1}, batch
            skip = 0
            epoch += 1
            if repeat is None or (repeat > 0 and epoch >= repeat):
                return

    return iterator


def load_image_dataset(path, batch_size, image_size, split='train', repeat=None, shuffle=True,
                       seed=0, start_state=None, output_dtype='float32', buffer_size=2):
    """A Prefetcher of frame batches [batch_size, H, W, C] for codebook
    training: f32 in [-1, 1], or with output_dtype='uint8' the raw bytes
    (the train step maps them to [-1, 1] on the device). Frames whose
    channel count is not the dataset's are skipped.

    Each epoch reads this process's shards (in a seeded order when
    shuffling), interleaves their records INTERLEAVE_SHARDS at a time,
    shuffles the frames in a 1000-frame buffer and decodes them on
    DECODE_THREADS threads, at most two batches of frames ahead of the
    batch being filled. repeat: None one epoch, -1 forever, else that many
    epochs. start_state: a Prefetcher.state cursor to resume from;
    buffer_size: batches made ahead."""
    if output_dtype not in ('float32', 'uint8'):
        raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
    info, paths = _shard_paths(path, split)
    if info['frame_size'] != image_size:
        raise ValueError(f'Dataset has a different image size: {info["frame_size"]} != '
                         f'{image_size}')
    host_id, num_hosts = _host_info()
    paths = _select_host_shards(paths, host_id, num_hosts)
    channels = info.get('num_image_channels', 3)

    def epoch_iterator(epoch):
        rng = random.Random((seed * 2654435761 + epoch) & 0xFFFFFFFF)
        epoch_paths = list(paths)
        if shuffle:
            rng.shuffle(epoch_paths)

        def shard_stream(shard):
            return lambda: (decode_example(payload)['frames'] for payload in read_records(shard))

        def raw_frames():
            for frame_list in _interleave(map(shard_stream, epoch_paths), INTERLEAVE_SHARDS):
                yield from frame_list

        frames = raw_frames()
        if shuffle:
            frames = _local_shuffle(frames, 1000, rng)
        pool = ThreadPoolExecutor(DECODE_THREADS)
        try:
            batch = []
            for img in _ordered_map(pool, decode_image, frames, 2 * batch_size):
                if img.shape[-1] != channels:
                    continue
                batch.append(img)
                if len(batch) == batch_size:
                    if output_dtype == 'uint8':
                        yield np.stack(batch, 0)
                    else:
                        yield np.stack(batch, 0).astype(np.float32) / 255.0 * 2.0 - 1.0
                    batch = []
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    return Prefetcher(_resumable_epochs(epoch_iterator, repeat, start_state),
                      buffer_size=buffer_size, track_state=True)


def load_token_dataset(path, batch_size, sequence_size, token_image_size,
                       split='train', repeat=None, max_samples_per_environment=-1,
                       transform=None, shuffle=True, seed=0, start_state=None,
                       buffer_size=2):
    """A Prefetcher of (poses [B, S, 7] f32, tokens [B, S, h, w] int64)
    numpy batches for transformer training.

    path: a dataset directory, or several joined by commas (mixed). A split
    other than 'train' reads 'val' where the dataset has it, else 'test'.
    Each environment's frames are shuffled and cut into `sequence_size`
    chunks (the remainder dropped), at most max_samples_per_environment of
    them (-1: all). transform(cameras, tokens, split=..., [rng=...]) maps
    each sample; a transform that takes `rng` gets the epoch's seeded
    np.random.RandomState, so pose augmentation stays seeded across a
    resume. start_state: a Prefetcher.state cursor to resume from."""
    all_paths = []
    poses_num_dim = None
    for dpath in path.split(','):
        info = get_dataset_info(dpath)
        dims = 5 if 'cameras-gqn' in info.get('features', []) else 7
        if poses_num_dim is None:
            poses_num_dim = dims
        elif dims != poses_num_dim:
            raise ValueError('Cannot mix gqn and non-gqn datasets')
        if split == 'train':
            actual_split = 'train'
        else:
            actual_split = 'val' if 'val' in info.get('splits', []) else 'test'
        _, paths = _shard_paths(dpath, actual_split)
        all_paths.extend(paths)

    host_id, num_hosts = _host_info()
    all_paths = _select_host_shards(all_paths, host_id, num_hosts)

    transform_accepts_rng = False
    if transform is not None:
        try:
            transform_accepts_rng = 'rng' in inspect.signature(transform).parameters
        except (TypeError, ValueError):
            pass

    def epoch_iterator(epoch):
        rng = random.Random((seed * 2654435761 + epoch) & 0xFFFFFFFF)
        np_rng = np.random.RandomState((seed * 97 + epoch) & 0x7FFFFFFF)
        epoch_paths = list(all_paths)
        if shuffle:
            rng.shuffle(epoch_paths)

        def environment_samples(example):
            poses = np.asarray(example['cameras'], np.float32).reshape(-1, poses_num_dim)
            if poses_num_dim == 5:
                poses = fix_legacy_gqn_cameras(poses)
            tokens = np.asarray(example['codes'], np.int64).reshape(
                -1, token_image_size, token_image_size)
            n = len(poses)
            if shuffle:
                perm = np_rng.permutation(n)
                poses, tokens = poses[perm], tokens[perm]
            count = 0
            for i in range(n // sequence_size):
                if 0 <= max_samples_per_environment <= count:
                    break
                sl = slice(i * sequence_size, (i + 1) * sequence_size)
                sample = (poses[sl], tokens[sl])
                if transform is not None:
                    sample = (transform(*sample, split=split, rng=np_rng)
                              if transform_accepts_rng
                              else transform(*sample, split=split))
                yield sample
                count += 1

        def shard_stream(shard):
            return lambda: (decode_example(payload) for payload in read_records(shard))

        def samples():
            environments = _interleave(map(shard_stream, epoch_paths), INTERLEAVE_SHARDS)
            env_factories = ((lambda example=example: environment_samples(example))
                             for example in environments)
            yield from _interleave(env_factories, INTERLEAVE_ENVIRONMENTS)

        stream = samples()
        if shuffle:
            stream = _local_shuffle(stream, 1000, rng)

        batch = []
        for sample in stream:
            batch.append(sample)
            if len(batch) == batch_size:
                yield (np.stack([b[0] for b in batch], 0),
                       np.stack([b[1] for b in batch], 0))
                batch = []

    return Prefetcher(_resumable_epochs(epoch_iterator, repeat, start_state),
                      buffer_size=buffer_size, track_state=True)
