"""generate-codes: encode an image dataset into a code (token) dataset (port
of viewformer_tpu/commands/generate_codes.py).

Walks every shard (data.dataset.transform_dataset), encodes the frames with
the codebook and writes 'codes' and 'cameras' shards with the same names,
setting token_image_size in info.json. Frames are flattened across
sequences into batches of a fixed size (the tail padded with zeros), so the
encoder sees one shape whatever the sequence lengths. One batch is in
flight: batch i + 1 is dispatched before batch i's codes are read, which
come back through a pinned host buffer and a CUDA event on the card.

Under torchrun (parallel/distributed.py) every rank reads the same frames
and encodes its batch_size / W rows of each batch; the codes of all ranks
are gathered on the device, and rank 0 alone writes the shards, info.json
and the indexes (transform_dataset).
"""
import numpy as np
import torch

from ..data.dataset import transform_dataset
from ..models import load_model
from ..parallel import distributed
from ..ops.image import ensure_wire_images, normalize_images


class LatentCodeTransformer:
    """transform_dataset's transformer: sequences of frames -> sequences of
    codes [N, h, w] with their cameras, through `model` (a VQGAN) on the
    device its weights are on. batch_size is global: each of W ranks
    encodes batch_size / W rows of a batch, so W must divide it."""

    def __init__(self, model, batch_size=None):
        self.model = model
        self.image_size = model.config.image_size
        self.batch_size = batch_size or model.config.batch_size
        self.device = model.quant_conv.weight.device
        world = distributed.world_size()
        if self.batch_size % world:
            raise ValueError(f'batch {self.batch_size} not divisible by data axis {world}')

    def output_features(self, features):
        if features is not None and 'cameras-gqn' in features:
            return ['codes', 'cameras-gqn']
        return ['codes', 'cameras']

    def update_dataset_info(self, dataset_info):
        dataset_info['token_image_size'] = self.image_size // self.model.config.stride
        return dataset_info

    def _dispatch(self, frames):
        """frames [n, H, W, C] (n <= batch_size; uint8, or float in
        [0, 255]) -> (codes in flight, n): padded to batch_size, this
        rank's rows encoded, every rank's codes gathered, and on the card
        copied into pinned host memory behind an event, without waiting for
        it."""
        x = ensure_wire_images(frames)
        n = len(x)
        if n < self.batch_size:
            x = np.concatenate([x, np.zeros((self.batch_size - n,) + x.shape[1:], x.dtype)], 0)
        x = x[distributed.batch_rows(self.batch_size)]
        with torch.inference_mode():
            _quant, codes = self.model.encode(
                normalize_images(torch.from_numpy(x).to(self.device)))
            codes = distributed.gather_tensor_rows(codes)
        if self.device.type != 'cuda':
            return codes, None, n
        host = torch.empty(codes.shape, dtype=codes.dtype, pin_memory=True)
        host.copy_(codes, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, n

    @staticmethod
    def _fetch(inflight):
        codes, done, n = inflight
        if done is not None:
            done.synchronize()
        return codes.numpy()[:n]

    def __call__(self, split, dataset):
        pending = []  # (cameras, number of frames) of sequences not yet written
        frame_buffer = []
        code_chunks = []
        inflight = None

        def submit(frames):
            """Dispatch `frames`; return the previous batch's codes (or None)."""
            nonlocal inflight
            new = self._dispatch(frames)
            done = self._fetch(inflight) if inflight is not None else None
            inflight = new
            return done

        def flush_ready():
            available = sum(len(c) for c in code_chunks)
            while pending and pending[0][1] <= available:
                cameras, n = pending.pop(0)
                out, need = [], n
                while need > 0:
                    chunk = code_chunks[0]
                    take = min(need, len(chunk))
                    out.append(chunk[:take])
                    if take == len(chunk):
                        code_chunks.pop(0)
                    else:
                        code_chunks[0] = chunk[take:]
                    need -= take
                available -= n
                yield dict(cameras=cameras, codes=np.concatenate(out, 0))

        for item in dataset:
            frames = np.asarray(item['frames'])[..., :self.model.config.in_channels]
            pending.append((np.asarray(item['cameras']), len(frames)))
            frame_buffer.extend(frames)
            while len(frame_buffer) >= self.batch_size:
                batch = np.stack(frame_buffer[:self.batch_size], 0)
                frame_buffer = frame_buffer[self.batch_size:]
                done = submit(batch)
                if done is not None:
                    code_chunks.append(done)
                    yield from flush_ready()
        if frame_buffer:
            done = submit(np.stack(frame_buffer, 0))
            if done is not None:
                code_chunks.append(done)
                yield from flush_ready()
        if inflight is not None:
            code_chunks.append(self._fetch(inflight))
            yield from flush_ready()
        if pending:
            raise RuntimeError('frames and codes out of step: sequences left without codes')


def generate_codes(dataset, output, model, shards=None, batch_size=None, splits=None,
                   progress=True, use_bfloat16=True, device='cuda'):
    """CLI `generate-codes`: the code dataset of image dataset `dataset` in
    directory `output`, through the codebook of job dir `model` (bf16
    unless use_bfloat16=False) on `device`: the card unless the caller asks
    for the CPU. batch_size: frames an encode (default the codebook's
    batch_size; under torchrun the global batch, which the ranks must
    divide); shards: a SplitIndices (or its string) of the 1-based shards;
    splits: default the dataset's. Under torchrun only rank 0 writes."""
    codebook = load_model(model, torch.bfloat16 if use_bfloat16 else torch.float32, device)
    transformer = LatentCodeTransformer(codebook, batch_size=batch_size)
    transform_dataset(dataset, output, transformer, splits=splits, shards=shards,
                      progress=progress)
