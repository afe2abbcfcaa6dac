"""Single-context novel-view synthesis and localization (port of
viewformer_tpu/evaluate/transformer.py, the serving main path).

One request: S-1 context frames with their cameras plus the query frame's
camera (and its frame, for localization) -> the query frame as uint8 pixels
and its regressed camera. Stages: encode all frames -> prefill the cache with
the S-1 context frames -> generate the query frame's codes -> decode ->
localize. The JAX package pads the context with an inert frame for the TPU's
tiles; the port prefills the S-1 frames directly (block-causal attention
makes the outputs identical).
"""
import numpy as np
import torch

from ..models import migt_incremental as inc
from ..ops.image import normalize_images, resize
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
    images = np.asarray(images)
    frames = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    frames = resize(frames.reshape((-1,) + tuple(frames.shape[2:])), codebook.config.image_size)
    frames = frames.reshape(tuple(images.shape[:2]) + tuple(frames.shape[1:]))
    if frames.dtype != torch.uint8:
        frames = frames.float() / 255.0 * 2.0 - 1.0
    cameras = torch.as_tensor(np.asarray(cameras, np.float32), device=device)
    out = make_generate_batch_predictions(transformer, codebook)(frames, cameras, timings)
    result = {key: None if value is None else value.cpu().numpy() for key, value in out.items()}
    result['ground_truth_images'] = images[:, -1]
    return result
