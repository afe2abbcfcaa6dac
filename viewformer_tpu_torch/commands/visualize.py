"""`dataset visualize`: a browser of a loader's sequences with their camera
positions (the port of viewformer_tpu/commands/visualize.py). With a
display and no --output, the interactive viewer; otherwise one PNG of the
first sequences (frames and camera scatter), drawn with matplotlib's Agg
backend. Needs matplotlib either way."""
import os

import numpy as np

from ..utils.visualization import require_matplotlib


def visualize_dataset(loader, output=None, max_sequences=4):
    """Show, or write to `output` (default dataset_preview.png when there is
    no display), the first max_sequences sequences of `loader`. Returns the
    path written, or the viewer."""
    matplotlib = require_matplotlib('dataset visualize')
    if output is None and os.environ.get('DISPLAY'):
        from ..utils.visualization import InteractiveViewer, render_sequence_with_poses
        return InteractiveViewer(loader, render_sequence_with_poses, title='dataset').show()
    matplotlib.use('Agg')
    output = output or 'dataset_preview.png'
    import matplotlib.pyplot as plt

    from .visualize_codebook import make_grid
    n = min(len(loader), max_sequences)
    fig, axes = plt.subplots(n, 2, figsize=(10, 4 * n), squeeze=False)
    for i in range(n):
        item = loader[i]
        frames = np.asarray(item['frames'])
        cameras = np.asarray(item['cameras'])
        axes[i][0].imshow(make_grid(frames[:8], columns=4))
        axes[i][0].set_title(f'sequence {i}')
        axes[i][0].axis('off')
        axes[i][1].scatter(cameras[:, 0], cameras[:, 2], c=range(len(cameras)))
        axes[i][1].set_title('camera positions (x, z)')
    fig.tight_layout()
    fig.savefig(output, dpi=100)
    plt.close(fig)
    print(f'Wrote dataset preview to {output}')
    return output
