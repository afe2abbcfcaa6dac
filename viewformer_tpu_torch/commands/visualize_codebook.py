"""`visualize codebook`: frames beside their reconstructions through a
codebook (the port of viewformer_tpu/commands/visualize_codebook.py).

The reconstruction is evaluate/codebook.generate_batch_predictions: encode,
nearest codes, decode, on the device the codebook is loaded to (the card
unless the caller asks for the CPU). With --output the (original,
reconstruction) pairs are written as one grid PNG through Pillow; without
it, the interactive viewer (with a display) or a matplotlib figure, which
need matplotlib."""
import os

import numpy as np
import torch


def make_grid(images, columns=8):
    """uint8 [N, H, W, C] -> one [rows*H, columns*W, C] grid image, row by
    row, the last row padded with black."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    rows = (n + columns - 1) // columns
    grid = np.zeros((rows * h, columns * w, c), np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, columns)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    return grid


def reconstruction_grid(codebook, frames):
    """The grid of (frame, reconstruction) pairs of uint8 frames [N, H, W, C]
    through `codebook` (a VQGAN), 8 tiles a row."""
    from ..evaluate.codebook import generate_batch_predictions
    prediction = generate_batch_predictions(codebook, frames)
    pairs = np.stack([prediction['ground_truth_images'], prediction['generated_images']], 1)
    return make_grid(pairs.reshape((-1,) + pairs.shape[2:]), columns=8)


def visualize_codebook(loader, codebook_checkpoint, output=None, num_images=16,
                       use_bfloat16=True, device='cuda'):
    """Reconstruct the first num_images frames of `loader` (or of
    loader(image_size), a callable) through the codebook job dir or released
    name codebook_checkpoint. With `output`, write the grid PNG there and
    return the path; else show it. use_bfloat16: the codebook's weights in
    bf16 (the evaluators' default) or f32."""
    from ..models import load_model
    codebook = load_model(codebook_checkpoint, torch.bfloat16 if use_bfloat16 else torch.float32,
                          device)
    if callable(loader) and not hasattr(loader, '__getitem__'):
        loader = loader(codebook.config.image_size)

    frames = []
    for idx in range(len(loader)):
        frames.extend(np.asarray(loader[idx]['frames']))
        if len(frames) >= num_images:
            break
    grid = reconstruction_grid(codebook, np.stack(frames[:num_images], 0))

    if output is not None:
        from PIL import Image
        Image.fromarray(grid).save(output)
        print(f'Wrote reconstruction grid to {output}')
        return output

    from ..utils.visualization import require_matplotlib
    matplotlib = require_matplotlib('visualize codebook without --output')
    if os.environ.get('DISPLAY'):
        from ..evaluate.codebook import generate_batch_predictions
        from ..utils.visualization import InteractiveViewer, render_reconstruction_pair

        def reconstruct(frames):
            return generate_batch_predictions(codebook, frames)['generated_images']
        return InteractiveViewer(loader, render_reconstruction_pair(reconstruct),
                                 title='codebook').show()
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    plt.figure(figsize=(12, 12))
    plt.imshow(grid)
    plt.axis('off')
    plt.title('original (left) vs reconstruction (right)')
    plt.show()
    return grid
