"""`evaluate codebook`: reconstruction metrics of the VQ-GAN over single
frames, encode then decode_code (port of
viewformer_tpu/evaluate/codebook.py). No attention kernel runs."""
import numpy as np
import torch

from ..ops.image import normalize_images, upload_frames
from .evaluator import Evaluator
from .transformer import (build_store_predictions, print_progress, print_results,
                          write_results)


def generate_batch_predictions(codebook, images):
    """Frames [N, H, W, C] (uint8, or float in [0, 255]) as numpy -> dict of
    ground_truth_images (resized to the codebook's size) and
    generated_images, uint8 numpy. Runs on the device the codebook is on."""
    frames = upload_frames(images, codebook.config.image_size, codebook.quant_conv.weight.device)
    with torch.inference_mode():
        _quant, codes = codebook.encode(normalize_images(frames))
        generated = codebook.decode_code(codes).clamp(-1, 1)
        generated = ((generated / 2 + 0.5) * 255.0 + 0.5).to(torch.uint8)
    return dict(ground_truth_images=frames.cpu().numpy(), generated_images=generated.cpu().numpy(),
                ground_truth_cameras=None, generated_cameras=None)


def evaluate_codebook(loader, codebook_checkpoint, job_dir, batch_size=64, num_eval_images=None,
                      num_store_images=100, image_size=None, progress=True, use_bfloat16=True,
                      device='cuda'):
    """Image metrics of a codebook (a port job dir) over the frames of a
    loader (or a callable image_size -> loader), in batches of batch_size
    frames. Writes results.json (no loc- keys) and the first
    num_store_images samples to job_dir, prints the results and returns
    them. Runs on `device`: the card unless the caller asks for the CPU."""
    from ..models import load_model

    codebook = load_model(codebook_checkpoint, torch.bfloat16 if use_bfloat16 else torch.float32,
                          device)
    if callable(loader) and not hasattr(loader, '__getitem__'):
        loader = loader(codebook.config.image_size)
    evaluator = Evaluator(image_size=image_size, device=device)
    store = build_store_predictions(job_dir, num_store_images)

    def frame_batches():
        buffer = []
        count = 0
        for idx in range(len(loader)):
            for frame in np.asarray(loader[idx]['frames']):
                if num_eval_images is not None and count >= num_eval_images:
                    if buffer:
                        yield np.stack(buffer)
                    return
                buffer.append(frame)
                count += 1
                if len(buffer) == batch_size:
                    yield np.stack(buffer)
                    buffer = []
        if buffer:
            yield np.stack(buffer)

    for i, frames in enumerate(frame_batches(), 1):
        prediction = generate_batch_predictions(codebook, frames)
        evaluator.update_with_image(prediction['ground_truth_images'],
                                    prediction['generated_images'])
        store(ground_truth_cameras=np.zeros((len(frames), 7), np.float32),
              generated_cameras=None,
              ground_truth_images=prediction['ground_truth_images'],
              generated_images=prediction['generated_images'])
        if progress:
            print_progress(i, evaluator)
    result = {k: v for k, v in evaluator.result().items() if not k.startswith('loc-')}
    write_results(job_dir, result)
    print_results(result)
    return result
