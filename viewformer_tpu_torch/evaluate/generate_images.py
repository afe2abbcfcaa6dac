"""`evaluate generate-gqn-images`: renders of a dataset's test sequences from
three context frames each (port of viewformer_tpu/evaluate/generate_images.py).
"""
import os

import numpy as np

from .transformer import _png, generate_batch_predictions, load_models


def generate_gqn_images(dataset_path, job_dir, transformer_checkpoint, codebook_checkpoint,
                        num_eval_sequences=5, progress=True, use_bfloat16=True, device='cuda'):
    """For each of the first num_eval_sequences test sequences of the image
    dataset at dataset_path, frames 0-2 as context and the last frame as
    query: writes gen<i>.png (the render), gt<i>.png and c<i>_<j>.png (the
    context frames) to job_dir. Runs on `device`: the card unless the
    caller asks for the CPU."""
    from ..data.loaders import build

    transformer, codebook = load_models(transformer_checkpoint, codebook_checkpoint,
                                        use_bfloat16, device)
    loader = build('dataset', path=dataset_path, split='test',
                   image_size=codebook.config.image_size)
    os.makedirs(job_dir, exist_ok=True)
    total = min(num_eval_sequences, len(loader))
    for i in range(total):
        item = loader[i]
        frames = np.asarray(item['frames'])
        cameras = np.asarray(item['cameras'], np.float32)
        frames = np.concatenate((frames[:3], frames[-1:]), 0)[None]
        cameras = np.concatenate((cameras[:3], cameras[-1:]), 0)[None]
        prediction = generate_batch_predictions(transformer, codebook, frames, cameras)
        _png(os.path.join(job_dir, f'gen{i}.png'), prediction['generated_images'][0])
        _png(os.path.join(job_dir, f'gt{i}.png'), prediction['ground_truth_images'][0])
        for j, img in enumerate(frames[0, :-1]):
            _png(os.path.join(job_dir, f'c{i}_{j}.png'), img)
        if progress:
            print(f'generated {i + 1} of {total}', flush=True)
