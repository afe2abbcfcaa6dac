"""`evaluate 7scenes-multictx`: the metrics of every context size on 7-Scenes
(port of viewformer_tpu/evaluate/sevenscenes_multictx.py): a query is one
test frame with num_context_views train frames of its scene, sampled by
random.Random(42) per scene, through evaluate/multictx.py's one-shot pass
(B1 and B2's one-shot form), batch_size queries at a time.
"""
import os
import random

import numpy as np
import torch

from ..data.loaders._wrappers import ChangedImageSizeLoader, FixedSequenceSizeLoader
from ..data.loaders.sevenscenes import ALL_SCENES, SevenScenesLoader
from .evaluator import MultiContextEvaluator, print_metrics
from .multictx import build_store_predictions, generate_batch_predictions
from .sevenscenes import SceneLookup
from .transformer import print_progress, write_results


def evaluate_sevenscenes_multictx(path, transformer_checkpoint, codebook_checkpoint, job_dir,
                                  batch_size=1, scenes=None, num_eval_sequences=100,
                                  store_ctx=True, num_store_images=100, num_context_views=19,
                                  image_size=128, progress=True, use_bfloat16=True,
                                  device='cuda'):
    """`python -m viewformer_tpu_torch evaluate 7scenes-multictx`: results.json
    keys ctx01 .. ctx<num_context_views> for each scene, as
    evaluate_sevenscenes otherwise. Runs on `device`: the card unless the
    caller asks for the CPU."""
    from ..models import load_model

    if scenes is None:
        scenes = ALL_SCENES
    dtype = torch.bfloat16 if use_bfloat16 else torch.float32
    codebook = load_model(codebook_checkpoint, dtype, device)
    all_results = {}
    transformer = loaded = None
    for scene in scenes:
        scene_lookup = SceneLookup(path, scene, image_size)
        checkpoint = transformer_checkpoint.format(scene=scene)
        if transformer is None or checkpoint != loaded:
            transformer = load_model(checkpoint, dtype, device)
            loaded = checkpoint
        rng = random.Random(42)

        def build_batch(batch):
            ctx = rng.sample(scene_lookup.files, num_context_views)
            ctx_cameras, ctx_frames = tuple(np.stack(y, 0) for y in
                                            zip(*(scene_lookup[x] for x in ctx)))
            cameras = np.concatenate((ctx_cameras, np.asarray(batch['cameras'])), 0)[None]
            frames = np.concatenate((ctx_frames, np.asarray(batch['frames'])), 0)[None]
            return cameras.astype(np.float32), frames

        store = build_store_predictions(os.path.join(job_dir, scene), num_store_images)
        evaluator = MultiContextEvaluator(num_context_views + 1, image_size=image_size,
                                          device=device)
        test_loader = ChangedImageSizeLoader(FixedSequenceSizeLoader(
            SevenScenesLoader(path=path, split='test', scenes=[scene],
                              _load_file_paths=True), 1), image_size)
        indices = random.Random(42).sample(
            list(range(len(test_loader))), min(len(test_loader), num_eval_sequences))
        # queries are independent: batch_size of them in one pass
        buf_cameras, buf_frames, batches = [], [], 0
        for done, index in enumerate(indices, 1):
            cameras, frames = build_batch(test_loader[index])
            buf_cameras.append(cameras)
            buf_frames.append(frames)
            if len(buf_cameras) == batch_size or done == len(indices):
                frames = np.concatenate(buf_frames, 0)
                prediction = generate_batch_predictions(transformer, codebook, frames,
                                                        np.concatenate(buf_cameras, 0))
                evaluator.update_state(**prediction)
                if store_ctx:
                    prediction['ctx'] = frames[:, :-1]
                store(**prediction)
                buf_cameras.clear()
                buf_frames.clear()
                batches += 1
                if progress:
                    print_progress(batches, evaluator)
        result = evaluator.result()
        all_results[scene] = result
        print(f'Results on {scene}:')
        print_metrics(result)
        write_results(os.path.join(job_dir, scene), result, indent=None)
    write_results(job_dir, all_results, indent=None)
    return all_results
