"""`evaluate transformer-multictx`: every context size in one forward pass
(port of viewformer_tpu/evaluate/multictx.py). The generation stream gets
the query camera at every position, so position t's prediction uses exactly
t context frames; the localization stream gets the query frame's codes at
every position. One one-shot MIGT.forward a batch: kernel B1 for stream 0
and B2's one-shot form over the S = 2 side streams, a strong check of the
branch masks.
"""
import os

import numpy as np
import torch

from ..ops.image import normalize_images, upload_frames
from .evaluator import MultiContextEvaluator, print_metrics
from .transformer import (_batched_loader_iterator, from_relative_cameras, host_predictions,
                          load_models, normalize_cameras, print_progress, to_relative_cameras,
                          write_results)


def make_generate_batch_predictions(transformer, codebook):
    """-> predict(images [B, S, H, W, C] uint8 (or f32 in [-1, 1]), cameras
    [B, S, 7]) -> dict of tensors: generated_images [B, S, H, W, C] uint8
    and generated_cameras [B, S, 7] (position t from t context frames)."""
    use_localization = transformer.use_localization
    relative = transformer.config.augment_poses == 'relative'

    @torch.inference_mode()
    def predict(images, cameras):
        images = normalize_images(images)
        B, S = images.shape[:2]
        ground_truth_cameras = cameras[:, -1]
        transform = None
        if relative:
            cameras, transform = to_relative_cameras(cameras)
        cameras = normalize_cameras(cameras)

        _quant, codes = codebook.encode(images.reshape((B * S,) + tuple(images.shape[2:])))
        grid = tuple(codes.shape[1:])
        codes = codes.reshape((B, S) + grid)

        # the query frame leaves the context stream
        input_ids = torch.cat([codes[:, :-1],
                               torch.full_like(codes[:, :1], transformer.mask_token)], 1)
        context_cameras = torch.cat([cameras[:, :-1], torch.zeros_like(cameras[:, :1])], 1)
        # the query camera and codes at every position
        query_cameras = cameras[:, -1:].expand(B, S, 7)
        query_tokens = codes[:, -1:].expand((B, S) + grid)
        out = transformer(context_cameras, input_ids,
                          localization_tokens=query_tokens if use_localization else None,
                          output_poses=query_cameras)

        generated_codes = out['logits'].argmax(-1)  # [B, S, h, w]
        generated_images = codebook.decode_code(generated_codes.reshape((B * S,) + grid))
        generated_images = ((generated_images.clamp(-1, 1) / 2 + 0.5) * 255.0 + 0.5).to(torch.uint8)
        generated_images = generated_images.reshape((B, S) + tuple(generated_images.shape[1:]))

        generated_cameras = None
        if use_localization:
            generated_cameras = transformer.reduce_cameras(out['pose_prediction'])
            if relative:
                generated_cameras = from_relative_cameras(generated_cameras, transform)
        return dict(generated_images=generated_images, generated_cameras=generated_cameras,
                    ground_truth_cameras=ground_truth_cameras)

    return predict


def generate_batch_predictions(transformer, codebook, images, cameras):
    """Host-facing wrapper: frames [B, S, H, W, C] (uint8, or float in
    [0, 255]) and cameras [B, S, 7] as numpy -> numpy prediction dict. Runs
    on the device the models are on."""
    device = transformer.wte.weight.device
    frames = upload_frames(images, codebook.config.image_size, device)
    cameras = torch.as_tensor(np.asarray(cameras, np.float32), device=device)
    out = make_generate_batch_predictions(transformer, codebook)(frames, cameras)
    return host_predictions(out, images)


def build_store_predictions(job_dir, limit=100):
    """-> store(...) writing, for the first `limit` samples, {i:08d}-gt.png
    and .cam.npy, one {i:08d}-gen@{t:02d}.png (and .cam.npy) a context size
    t, and the context frames under {i:08d}-ctx/ (PNGs with Pillow)."""
    from .transformer import _png

    os.makedirs(job_dir, exist_ok=True)
    counter = {'i': 0}

    def store(ground_truth_cameras, generated_cameras, ground_truth_images,
              generated_images, postfix='', ctx=None):
        for bi in range(len(ground_truth_images)):
            i = counter['i']
            if limit != -1 and i >= limit:
                return
            _png(os.path.join(job_dir, f'{i:08d}-gt{postfix}.png'), ground_truth_images[bi])
            np.save(os.path.join(job_dir, f'{i:08d}-gt{postfix}.cam.npy'),
                    np.asarray(ground_truth_cameras[bi]))
            for ctx_size in range(len(generated_images[bi])):
                _png(os.path.join(job_dir, f'{i:08d}-gen@{ctx_size:02d}{postfix}.png'),
                     generated_images[bi][ctx_size])
                if generated_cameras is not None:
                    np.save(os.path.join(job_dir, f'{i:08d}-gen@{ctx_size:02d}{postfix}.cam.npy'),
                            np.asarray(generated_cameras[bi][ctx_size]))
            if ctx is not None:
                ctx_dir = os.path.join(job_dir, f'{i:08d}-ctx{postfix}')
                os.makedirs(ctx_dir, exist_ok=True)
                for j, ctx_img in enumerate(np.asarray(ctx[bi])):
                    _png(os.path.join(ctx_dir, f'{j:02d}.png'), ctx_img)
            counter['i'] += 1
    return store


def evaluate_transformer_multictx(loader, transformer_checkpoint, codebook_checkpoint, job_dir,
                                  batch_size=1, num_eval_sequences=None, pose_multiplier=None,
                                  sequence_size=None, num_store_images=100, store_ctx=False,
                                  image_size=None, progress=True, use_bfloat16=True,
                                  device='cuda'):
    """The metrics of every context size 1 .. sequence_size - 1 (results.json
    keys ctx01, ctx02, ...), as evaluate_transformer otherwise."""
    transformer, codebook = load_models(transformer_checkpoint, codebook_checkpoint,
                                        use_bfloat16, device, pose_multiplier)
    if sequence_size is None:
        sequence_size = transformer.config.sequence_size
    if callable(loader) and not hasattr(loader, '__getitem__'):
        loader = loader(codebook.config.image_size)

    store = build_store_predictions(job_dir, num_store_images)
    evaluator = MultiContextEvaluator(sequence_size, image_size=image_size, device=device)
    batches = _batched_loader_iterator(loader, sequence_size, batch_size, num_eval_sequences)
    for i, (frames, cameras) in enumerate(batches, 1):
        prediction = generate_batch_predictions(transformer, codebook, frames, cameras)
        evaluator.update_state(**prediction)
        if store_ctx:
            prediction['ctx'] = frames[:, :-1]
        store(**prediction)
        if progress:
            print_progress(i, evaluator)
    result = evaluator.result()
    write_results(job_dir, result, indent=None)
    print('Results:')
    print_metrics(result)
    return result
