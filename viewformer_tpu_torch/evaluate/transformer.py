"""Single-context novel-view synthesis and localization (port of
viewformer_tpu/evaluate/transformer.py): the serving main path, and the
evaluator over a loader, evaluate_transformer (`python -m
viewformer_tpu_torch evaluate transformer`).

One request: S-1 context frames with their cameras plus the query frame's
camera (and its frame, for localization) -> the query frame as uint8 pixels
and its regressed camera. Stages: encode all frames -> prefill the cache with
the S-1 context frames -> generate the query frame's codes -> decode ->
localize. The JAX package pads the context with an inert frame for the TPU's
tiles; the port prefills the S-1 frames directly (block-causal attention
makes the outputs identical).
"""
import json
import os

import numpy as np
import torch

from ..models import migt_incremental as inc
from ..ops.image import normalize_images, upload_frames
from ..utils import geometry


def to_relative_cameras(cameras):
    """Canonicalize a camera sequence [..., T, 7] to its first frame. Returns
    (relative cameras, the first camera [..., 1, 7])."""
    xyz, quaternion = cameras[..., :3], cameras[..., 3:]
    transform_xyz = xyz[..., :1, :]
    transform_quaternion = quaternion[..., :1, :]
    rotation_inverse = geometry.quaternion_conjugate(transform_quaternion)
    xyz = geometry.quaternion_rotate(xyz - transform_xyz,
                                     rotation_inverse.expand(xyz.shape[:-1] + (4,)))
    quaternion = geometry.quaternion_multiply(rotation_inverse, quaternion)
    return (torch.cat((xyz, quaternion), -1),
            torch.cat((transform_xyz, transform_quaternion), -1))


def from_relative_cameras(cameras, transform):
    """Inverse of to_relative_cameras."""
    transform_xyz, transform_quaternion = transform[..., :3], transform[..., 3:]
    xyz, quaternion = cameras[..., :3], cameras[..., 3:]
    quaternion = geometry.quaternion_multiply(transform_quaternion, quaternion)
    xyz = geometry.quaternion_rotate(xyz, transform_quaternion.expand(xyz.shape[:-1] + (4,)))
    return torch.cat((xyz + transform_xyz, quaternion), -1)


def normalize_cameras(cameras):
    xyz, quaternion = cameras[..., :3], cameras[..., 3:]
    quaternion = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quaternion))
    return torch.cat((xyz, quaternion), -1)


def _mark(timings, stage):
    if timings is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        timings.append((stage, event))


def make_generate_batch_predictions(transformer, codebook):
    """-> predict(images [B, S, H, W, C] uint8 (or f32 in [-1, 1]), cameras
    [B, S, 7], timings=None) -> dict of tensors on the models' device.

    timings: a list to which each stage appends (name, CUDA event) as it is
    enqueued, after a ('start', event) entry; for timing on the card only."""
    use_localization = transformer.use_localization
    relative = transformer.config.augment_poses == 'relative'

    @torch.inference_mode()
    def predict(images, cameras, timings=None):
        _mark(timings, 'start')
        images = normalize_images(images)
        B, S = images.shape[:2]
        ground_truth_cameras = cameras[:, -1]
        transform = None
        if relative:
            cameras, transform = to_relative_cameras(cameras)
        cameras = normalize_cameras(cameras)

        _quant, codes = codebook.encode(images.reshape((B * S,) + tuple(images.shape[2:])))
        codes = codes.reshape((B, S) + tuple(codes.shape[1:]))
        _mark(timings, 'encode')

        cache = inc.prefill_cache(transformer, codes[:, :-1], cameras[:, :-1])
        _mark(timings, 'prefill')

        generated_codes = inc.generate_frame(transformer, cache, cameras[:, -1]).argmax(-1)
        _mark(timings, 'generate')

        generated_images = codebook.decode_code(generated_codes).clamp(-1, 1)
        generated_images = ((generated_images / 2 + 0.5) * 255.0 + 0.5).to(torch.uint8)
        _mark(timings, 'decode')

        generated_cameras = None
        if use_localization:
            pred = inc.localize_frame(transformer, cache, codes[:, -1])      # [B, L, 7]
            generated_cameras = transformer.reduce_cameras(pred[:, None])   # [B, 1, 7]
            if relative:
                generated_cameras = from_relative_cameras(generated_cameras, transform)
            generated_cameras = generated_cameras[:, -1]
            _mark(timings, 'localize')

        return dict(generated_images=generated_images, generated_codes=generated_codes,
                    generated_cameras=generated_cameras,
                    ground_truth_cameras=ground_truth_cameras)

    return predict


def generate_batch_predictions(transformer, codebook, images, cameras, timings=None):
    """Host-facing wrapper: frames [B, S, H, W, C] (uint8, or float in
    [0, 255]) and cameras [B, S, 7] as numpy -> numpy prediction dict. Runs
    on the device the models are on."""
    device = transformer.wte.weight.device
    frames = upload_frames(images, codebook.config.image_size, device)
    cameras = torch.as_tensor(np.asarray(cameras, np.float32), device=device)
    out = make_generate_batch_predictions(transformer, codebook)(frames, cameras, timings)
    return host_predictions(out, images)


def host_predictions(out, images):
    """A prediction dict of tensors as numpy, with the query frames of
    `images` [B, S, H, W, C] as ground_truth_images."""
    result = {key: None if value is None else value.cpu().numpy() for key, value in out.items()}
    result['ground_truth_images'] = np.asarray(images)[:, -1]
    return result


def _png(path, image):
    from PIL import Image

    Image.fromarray(np.asarray(image)).save(path, 'PNG')


def build_store_predictions(job_dir, limit=100):
    """-> store(ground_truth_cameras, generated_cameras, ground_truth_images,
    generated_images, postfix='', ctx=None), which writes the first `limit`
    samples (all with -1) as {i:08d}-gen.png, -gt.png, -gen.cam.npy,
    -gt.cam.npy and the context frames under {i:08d}-ctx/. PNGs are written
    with Pillow, imported only when a sample is stored."""
    os.makedirs(job_dir, exist_ok=True)
    counter = {'i': 0}

    def store(ground_truth_cameras, generated_cameras, ground_truth_images,
              generated_images, postfix='', ctx=None):
        for bi in range(len(ground_truth_images)):
            i = counter['i']
            if limit != -1 and i >= limit:
                return
            _png(os.path.join(job_dir, f'{i:08d}-gen{postfix}.png'), generated_images[bi])
            _png(os.path.join(job_dir, f'{i:08d}-gt{postfix}.png'), ground_truth_images[bi])
            if generated_cameras is not None:
                np.save(os.path.join(job_dir, f'{i:08d}-gen{postfix}.cam.npy'),
                        np.asarray(generated_cameras[bi]))
            np.save(os.path.join(job_dir, f'{i:08d}-gt{postfix}.cam.npy'),
                    np.asarray(ground_truth_cameras[bi]))
            if ctx is not None:
                ctx_dir = os.path.join(job_dir, f'{i:08d}-ctx{postfix}')
                os.makedirs(ctx_dir, exist_ok=True)
                for j, ctx_img in enumerate(np.asarray(ctx[bi])):
                    _png(os.path.join(ctx_dir, f'{j:02d}.png'), ctx_img)
            counter['i'] += 1
    return store


def _batched_loader_iterator(loader, sequence_size, batch_size, num_sequences=None):
    """Batches (frames [b, S, H, W, C], cameras [b, S, 7] f32) of the
    loader's first num_sequences sequences (all by default), each cut to
    sequence_size frames; shorter sequences are skipped, the last batch may
    be smaller."""
    total = num_sequences if num_sequences is not None else len(loader)
    batch_frames, batch_cameras = [], []
    for idx in range(total):
        item = loader[idx]
        frames = np.asarray(item['frames'])[:sequence_size]
        cameras = np.asarray(item['cameras'])[:sequence_size]
        if len(frames) < sequence_size:
            continue
        batch_frames.append(frames)
        batch_cameras.append(cameras)
        if len(batch_frames) == batch_size:
            yield np.stack(batch_frames), np.stack(batch_cameras).astype(np.float32)
            batch_frames, batch_cameras = [], []
    if batch_frames:
        yield np.stack(batch_frames), np.stack(batch_cameras).astype(np.float32)


def load_models(transformer_checkpoint, codebook_checkpoint, use_bfloat16, device,
                pose_multiplier=None):
    """(transformer, codebook) of two job dirs of the port, in bf16 (the
    card's kernels take bf16; the f32 islands stay f32) or f32."""
    from ..models import load_model

    dtype = torch.bfloat16 if use_bfloat16 else torch.float32
    overrides = {} if pose_multiplier is None else {'pose_multiplier': pose_multiplier}
    return (load_model(transformer_checkpoint, dtype, device, **overrides),
            load_model(codebook_checkpoint, dtype, device))


def write_results(job_dir, result, indent=4):
    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, 'results.json'), 'w') as f:
        json.dump(result, f, indent=indent)


def print_progress(batch, evaluator):
    print(f'batch {batch}: ' + ' '.join(f'{k}={v:.4f}' for k, v in
                                        evaluator.get_progress_bar_info().items()), flush=True)


def print_results(result):
    print('Results:')
    for m, val in result.items():
        print(f'    {m}: ' + ('n/a' if val is None else f'{val:.6f}'))


def evaluate_transformer(loader, transformer_checkpoint, codebook_checkpoint, job_dir,
                         batch_size=1, num_eval_sequences=None, pose_multiplier=None,
                         sequence_size=None, num_store_images=100, store_ctx=False,
                         image_size=None, progress=True, use_bfloat16=True, device='cuda'):
    """Novel-view synthesis and localization metrics of a transformer and a
    codebook (port job dirs) over a loader (or a callable image_size ->
    loader): each sequence's last frame generated from the others. Writes
    results.json and the first num_store_images samples to job_dir, prints
    the results and returns them. Runs on `device`: the card unless the
    caller asks for the CPU."""
    from .evaluator import Evaluator

    transformer, codebook = load_models(transformer_checkpoint, codebook_checkpoint,
                                        use_bfloat16, device, pose_multiplier)
    if sequence_size is None:
        sequence_size = transformer.config.sequence_size
    if callable(loader) and not hasattr(loader, '__getitem__'):
        loader = loader(codebook.config.image_size)

    store_predictions = build_store_predictions(job_dir, num_store_images)
    evaluator = Evaluator(image_size=image_size, device=device)
    batches = _batched_loader_iterator(loader, sequence_size, batch_size, num_eval_sequences)
    for i, (frames, cameras) in enumerate(batches, 1):
        prediction = generate_batch_predictions(transformer, codebook, frames, cameras)
        prediction.pop('generated_codes')
        evaluator.update_state(**prediction)
        if store_ctx:
            prediction['ctx'] = frames[:, :-1]
        store_predictions(**prediction)
        if progress:
            print_progress(i, evaluator)
    result = evaluator.result()
    write_results(job_dir, result)
    print_results(result)
    return result
