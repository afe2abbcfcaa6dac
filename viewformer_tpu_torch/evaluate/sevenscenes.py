"""`evaluate 7scenes`: camera localization and view synthesis on 7-Scenes
(port of viewformer_tpu/evaluate/sevenscenes.py).

A query is one test frame; its context is num_context_views train frames of
its scene: the top_n_matched_images of an image match map, then a seeded
random sample (random.Random(42), per scene, in query order). Procedures:

  standard          one generate_batch_predictions call (prefill, then the
                    cache form of B2), batch_size queries at a time;
  generated_images  localize the query, render num_gen_ctx views around the
                    estimate, put them in place of the last context frames,
                    then render and localize again (four one-shot
                    MIGT.forward calls of one stream);
  pose_refinement   localize the query (one forward), take the train frames
                    nearest to the estimate as the context, then run the
                    standard procedure on it.

Frames are resized on the host (the loaders' ChangedImageSizeLoader); the
models run on `device`, the card unless the caller asks for the CPU, in
bf16 by default. The host geometry and the RNGs are the reference's, so
with the same weights in f32 the results.json files equal the JAX
package's.
"""
import os
import random
from collections import defaultdict

import numpy as np
import torch

from ..data.loaders._wrappers import ChangedImageSizeLoader, FixedSequenceSizeLoader
from ..data.loaders.sevenscenes import ALL_SCENES, SevenScenesLoader
from ..ops.image import normalize_images, upload_frames
from ..utils import np_geometry
from .evaluator import Evaluator
from .transformer import (build_store_predictions, from_relative_cameras,
                          generate_batch_predictions, normalize_cameras, to_relative_cameras,
                          write_results)


def generate_other_viewpoints(camera, rng):
    """Random viewpoints near camera [..., 7]: a position offset of at most
    1 (m) and a rotation of at most 0.3 rad, drawn from the numpy
    RandomState rng."""
    max_offset, max_rad_offset = 1.0, 0.3
    shape3 = camera[..., :3].shape
    pos_offset = rng.uniform(-1, 1, shape3).astype(np.float32)
    pos_offset /= np.linalg.norm(pos_offset, axis=-1, keepdims=True) + 1e-12
    axis = rng.uniform(-1, 1, shape3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True) + 1e-12
    pos_offset *= rng.uniform(0, max_offset, camera[..., :1].shape).astype(np.float32)
    angle = rng.uniform(0, max_rad_offset, camera[..., :1].shape).astype(np.float32)
    quaternion_rot = np.concatenate((np.cos(angle / 2), np.sin(angle / 2) * axis), -1)
    xyz, quaternion = camera[..., :3], camera[..., 3:]
    new_quat = np_geometry.quaternion_normalize(
        np_geometry.quaternion_multiply(quaternion_rot, quaternion))
    return np.concatenate((pos_offset + xyz, new_quat), -1).astype(np.float32)


def compute_camera_distances(db_cameras, camera):
    """0.3 times the position distance plus the rotation angle, from each of
    db_cameras [N, 7] to camera [..., 7]."""
    pos = np.linalg.norm(db_cameras[..., :3] - camera[..., :3], axis=-1)
    x1 = np_geometry.quaternion_normalize(db_cameras[..., 3:])
    x2 = np_geometry.quaternion_normalize(camera[..., 3:])
    diff = np_geometry.quaternion_multiply(x1, np.broadcast_to(
        np_geometry.quaternion_conjugate(x2), x1.shape))
    quat = 2 * np.arcsin(np.clip(np.linalg.norm(diff[..., 1:], axis=-1), 0, 1))
    return pos * 0.3 + quat


class SceneLookup:
    """Every train frame of a scene, by file name (`seq-NN/frame-NNNNNN.color.png`):
    lookup[name] -> (camera, frame); `cameras` [N, 7] and `files` in loader
    order. With image_size the frames are decoded and resized (on the host)
    here; without, when looked up."""

    def __init__(self, path, scene, image_size=None):
        loader = SevenScenesLoader(path=path, split='train', scenes=[scene],
                                   _load_file_paths=True)
        if image_size is not None:
            loader = ChangedImageSizeLoader(loader, image_size)
        cameras, self.files, self.image_loaders = [], [], []
        for idx in range(len(loader)):
            batch = loader[idx]
            cameras.append(np.asarray(batch['cameras']))
            self.files.extend(x + '.color.png' for x in batch['frames_files'])
            frames = batch['frames']
            for i in range(len(batch['cameras'])):
                self.image_loaders.append((frames, i))
        self.cameras = np.concatenate(cameras, 0)
        self._lookup = {x: i for i, x in enumerate(self.files)}

    def camera(self, name):
        """The camera of a frame, without decoding the frame."""
        return self.cameras[self._lookup[name]]

    def __getitem__(self, name):
        idx = self._lookup[name]
        frames, i = self.image_loaders[idx]
        return self.cameras[idx], np.asarray(frames[i])

    def __len__(self):
        return len(self.files)


def load_image_match_map(path):
    """{query file: [matched train files, best first]} of a text file of
    `query match` lines."""
    top_map = defaultdict(list)
    with open(path) as f:
        for line in f:
            fr, to = line.strip('\n\r').split()
            top_map[fr].append(to)
    return top_map


def _device(model):
    return next(model.parameters()).device


def _encode_codes(codebook, images):
    """Frames [B, S, H, W, C] (numpy) -> codes [B, S, h, w] on the
    codebook's device."""
    frames = normalize_images(upload_frames(images, codebook.config.image_size,
                                            _device(codebook)))
    B, S = frames.shape[:2]
    _, codes = codebook.encode(frames.reshape((B * S,) + tuple(frames.shape[2:])))
    return codes.reshape((B, S) + tuple(codes.shape[1:]))


def _localize(transformer, codes, cameras):
    """The camera [B, 1, 7] that one forward over frames `codes` [B, T, ...]
    with the T - 1 `cameras` regresses for the last frame."""
    out = transformer(cameras, codes)
    return transformer.reduce_cameras(out['pose_prediction'][:, -1:])


def _prepare_cameras(transformer, cameras):
    """(host cameras [B, S, 7] f32, device cameras made relative to the first
    frame and normalized, the transform or None)."""
    cameras = np.asarray(cameras, np.float32)
    device_cameras = torch.from_numpy(cameras).to(_device(transformer))
    transform = None
    if transformer.config.augment_poses == 'relative':
        device_cameras, transform = to_relative_cameras(device_cameras)
    return cameras, normalize_cameras(device_cameras), transform


def _masked(transformer, codes):
    """codes with the last frame's replaced by the mask token."""
    return torch.cat([codes[:, :-1], torch.full_like(codes[:, :1], transformer.mask_token)], 1)


@torch.inference_mode()
def generate_batch_predictions_using_generated_images(transformer, codebook, images, cameras,
                                                      num_gen_ctx=5, seed=0):
    """The generated_images procedure for one query: frames [1, S, H, W, C]
    and cameras [1, S, 7] (numpy) -> numpy prediction dict."""
    rng = np.random.RandomState(seed)
    cameras, device_cameras, transform = _prepare_cameras(transformer, cameras)
    ground_truth_cameras = cameras[:, -1]
    device = device_cameras.device
    codes = _encode_codes(codebook, images)

    generated_cameras = _localize(transformer, codes, device_cameras[:, :-1])
    # num_gen_ctx views around the estimate
    around = np.tile(generated_cameras[:, -1:].float().cpu().numpy(), (num_gen_ctx, 1, 1))
    new_cameras = normalize_cameras(torch.from_numpy(
        generate_other_viewpoints(around, rng)).to(device))
    out = transformer(torch.cat((device_cameras[:, :-1].expand(num_gen_ctx, -1, -1),
                                 new_cameras), 1),
                      _masked(transformer, codes).expand(num_gen_ctx, -1, -1, -1))
    new_codes = out['logits'].argmax(-1)[:, -1]

    codes = torch.cat((codes[:, :-num_gen_ctx], new_codes[None]), 1)
    device_cameras = torch.cat((device_cameras[:, :-num_gen_ctx],
                                new_cameras.reshape(1, num_gen_ctx, -1)), 1)

    # render and localize again with the generated views in the context
    out = transformer(device_cameras, _masked(transformer, codes))
    generated_images = codebook.decode_code(out['logits'].argmax(-1)[:, -1])
    generated_images = ((generated_images.clamp(-1, 1) / 2 + 0.5) * 255.0 + 0.5).to(torch.uint8)

    generated_cameras = _localize(transformer, codes, device_cameras[:, :-1])
    if transform is not None:
        generated_cameras = from_relative_cameras(generated_cameras, transform)
    return dict(ground_truth_images=np.asarray(images)[:, -1],
                generated_images=generated_images.cpu().numpy(),
                ground_truth_cameras=ground_truth_cameras,
                generated_cameras=generated_cameras[:, -1].float().cpu().numpy())


def generate_batch_predictions_using_pose_refinement(scene_lookup, transformer, codebook,
                                                     images, cameras, num_gen_ctx=9, seed=0,
                                                     num_context_views=19):
    """The pose_refinement procedure for one query: frames [1, S, H, W, C]
    and cameras [1, S, 7] (numpy) -> numpy prediction dict."""
    rng = random.Random(seed)
    cameras, device_cameras, transform = _prepare_cameras(transformer, cameras)
    gt_cameras, gt_frames = cameras[:, -1], np.asarray(images)[:, -1]
    with torch.inference_mode():
        generated_cameras = _localize(transformer, _encode_codes(codebook, images),
                                      device_cameras[:, :-1])
        if transform is not None:
            generated_cameras = from_relative_cameras(generated_cameras, transform)
    generated_cameras = generated_cameras.float().cpu().numpy()

    distances = compute_camera_distances(scene_lookup.cameras, generated_cameras[:, 0, :])
    top_files = np.argsort(distances)[:num_gen_ctx]
    files = [scene_lookup.files[x] for x in top_files]
    files += rng.sample(scene_lookup.files, num_context_views - len(files))
    ctx_cameras, ctx_frames = tuple(np.stack(y, 0) for y in
                                    zip(*(scene_lookup[x] for x in files)))
    new_cameras = np.concatenate((ctx_cameras, gt_cameras), 0)[None]
    new_frames = np.concatenate((ctx_frames, gt_frames), 0)[None]
    prediction = generate_batch_predictions(transformer, codebook, new_frames, new_cameras)
    prediction.pop('generated_codes')
    return prediction


def _print_scene(scene, result):
    print(f'Results on {scene}:')
    for m, val in result.items():
        print(f'    {m}: ' + ('n/a' if val is None else f'{val:.6f}'))


def evaluate_sevenscenes(path, transformer_checkpoint, codebook_checkpoint, job_dir,
                         batch_size=1, image_match_map=None, scenes=None,
                         sequence_size=None, num_eval_sequences=None,
                         num_store_images=100, top_n_matched_images=0, num_gen_ctx=0,
                         generation_procedure='standard', pose_multiplier=None,
                         num_context_views=19, image_size=128, progress=True,
                         use_bfloat16=True, device='cuda'):
    """Localization and view-synthesis metrics on each scene's test frames
    (`python -m viewformer_tpu_torch evaluate 7scenes`). transformer_checkpoint
    and image_match_map may hold `{scene}`. Writes <job_dir>/<scene>/results.json,
    the first num_store_images samples of each scene and
    <job_dir>/results.json, and returns {scene: results}. sequence_size is
    accepted and unused, as in the reference; a context has
    num_context_views frames. Runs on `device`: the card unless the caller
    asks for the CPU."""
    from ..models import load_model

    if scenes is None:
        scenes = ALL_SCENES
    if top_n_matched_images > 0:
        assert image_match_map is not None
    dtype = torch.bfloat16 if use_bfloat16 else torch.float32
    overrides = {} if pose_multiplier is None else {'pose_multiplier': pose_multiplier}

    codebook = load_model(codebook_checkpoint, dtype, device)
    all_results = {}
    transformer = loaded_checkpoint = None
    for scene in scenes:
        top_match_map = None
        if image_match_map is not None:
            top_match_map = load_image_match_map(image_match_map.format(scene=scene))
        scene_lookup = SceneLookup(path, scene, image_size)
        checkpoint = transformer_checkpoint.format(scene=scene)
        if transformer is None or checkpoint != loaded_checkpoint:
            transformer = load_model(checkpoint, dtype, device, **overrides)
            loaded_checkpoint = checkpoint

        rng = random.Random(42)

        def build_batch(batch):
            gt_frames = np.asarray(batch['frames'])
            gt_cameras = np.asarray(batch['cameras'])
            ctx = []
            if top_match_map is not None:
                ctx = top_match_map[batch['frames_files'][0] + '.color.png'][:top_n_matched_images]
            ctx = list(ctx) + rng.sample(scene_lookup.files, num_context_views - len(ctx))
            ctx_cameras, ctx_frames = tuple(np.stack(y, 0) for y in
                                            zip(*(scene_lookup[x] for x in ctx)))
            cameras = np.concatenate((ctx_cameras, gt_cameras), 0)[None]
            frames = np.concatenate((ctx_frames, gt_frames), 0)[None]
            return cameras.astype(np.float32), frames

        store = build_store_predictions(os.path.join(job_dir, scene), num_store_images)
        evaluator = Evaluator(image_size=image_size, device=device)
        test_loader = SevenScenesLoader(path=path, split='test', scenes=[scene],
                                        _load_file_paths=True)
        test_loader = ChangedImageSizeLoader(FixedSequenceSizeLoader(test_loader, 1), image_size)
        indices = list(range(len(test_loader)))
        if num_eval_sequences is not None and num_eval_sequences > 0:
            indices = random.Random(42).sample(indices, min(len(indices), num_eval_sequences))
        else:
            random.Random(42).shuffle(indices)

        def evaluate(prediction, done):
            evaluator.update_state(**prediction)
            store(**prediction)
            if progress:
                print(f'{scene}: {done} of {len(indices)} queries: ' + ' '.join(
                    f'{k}={v:.4f}' for k, v in evaluator.get_progress_bar_info().items()),
                    flush=True)

        buf_cameras, buf_frames = [], []
        for done, index in enumerate(indices, 1):
            cameras, frames = build_batch(test_loader[index])
            if generation_procedure == 'standard':
                # queries are independent: batch_size of them in one call
                buf_cameras.append(cameras)
                buf_frames.append(frames)
                if len(buf_cameras) == batch_size or done == len(indices):
                    prediction = generate_batch_predictions(
                        transformer, codebook, np.concatenate(buf_frames, 0),
                        np.concatenate(buf_cameras, 0))
                    prediction.pop('generated_codes')
                    buf_cameras.clear()
                    buf_frames.clear()
                    evaluate(prediction, done)
            elif generation_procedure == 'generated_images':
                evaluate(generate_batch_predictions_using_generated_images(
                    transformer, codebook, frames, cameras, num_gen_ctx=num_gen_ctx), done)
            elif generation_procedure == 'pose_refinement':
                evaluate(generate_batch_predictions_using_pose_refinement(
                    scene_lookup, transformer, codebook, frames, cameras,
                    num_gen_ctx=num_gen_ctx, num_context_views=num_context_views), done)
            else:
                raise ValueError(generation_procedure)
        result = evaluator.result()
        all_results[scene] = result
        _print_scene(scene, result)
        write_results(os.path.join(job_dir, scene), result, indent=None)
    write_results(job_dir, all_results, indent=None)
    return all_results
