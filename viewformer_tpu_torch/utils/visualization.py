"""The interactive matplotlib browser of `dataset visualize` and `visualize
codebook` (the port's own copy of viewformer_tpu/utils/visualization.py).

A small keyboard-navigated viewer: left/right arrows (or j/k, p/n) page
through the items of an indexable dataset, q closes. Headless runs write
PNGs instead (commands/visualize*.py, --output). Drawing needs matplotlib,
which the port does not require elsewhere: `require_matplotlib` raises an
ImportError that says so where it is missing.
"""
import numpy as np


def require_matplotlib(command):
    """Import and return matplotlib; an ImportError naming `command` when it
    is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f'{command} draws with matplotlib, which is not installed; '
                          'install matplotlib to use it') from e
    return matplotlib


class InteractiveViewer:
    """Pages a render callback over an indexable dataset.

    render(fig, axes, item, index) draws one item; the viewer owns the
    figure, the key bindings and the index."""

    def __init__(self, dataset, render, rows=1, cols=2, title=None):
        self.dataset = dataset
        self.render = render
        self.rows = rows
        self.cols = cols
        self.title = title
        self.index = 0

    def _draw(self):
        for ax in np.asarray(self.axes).ravel():
            ax.clear()
        item = self.dataset[self.index]
        self.render(self.fig, self.axes, item, self.index)
        suffix = f' [{self.index + 1}/{len(self.dataset)}]'
        self.fig.suptitle((self.title or '') + suffix)
        self.fig.canvas.draw_idle()

    def _on_key(self, event):
        if event.key in ('right', 'k', 'n'):
            self.index = (self.index + 1) % len(self.dataset)
        elif event.key in ('left', 'j', 'p'):
            self.index = (self.index - 1) % len(self.dataset)
        elif event.key == 'q':
            import matplotlib.pyplot as plt
            plt.close(self.fig)
            return
        else:
            return
        self._draw()

    def show(self):
        require_matplotlib('the interactive viewer')
        import matplotlib.pyplot as plt
        self.fig, self.axes = plt.subplots(self.rows, self.cols,
                                           figsize=(5 * self.cols, 5 * self.rows),
                                           squeeze=False)
        self.fig.canvas.mpl_connect('key_press_event', self._on_key)
        self._draw()
        plt.show()
        return self


def render_sequence_with_poses(fig, axes, item, index):
    """Render callback of `dataset visualize`: the frames as a grid and the
    cameras' (x, z) positions."""
    from ..commands.visualize_codebook import make_grid
    frames = np.asarray(item['frames'])
    cameras = np.asarray(item['cameras'])
    axes[0][0].imshow(make_grid(frames[:16], columns=4))
    axes[0][0].set_title('frames')
    axes[0][0].axis('off')
    scatter = axes[0][1].scatter(cameras[:, 0], cameras[:, 2], c=range(len(cameras)))
    axes[0][1].set_title('camera positions (x, z)')
    axes[0][1].set_aspect('equal', adjustable='datalim')
    return scatter


def render_reconstruction_pair(reconstruct):
    """Render-callback factory of `visualize codebook`: a sequence's first
    frame and reconstruct(frames)[0], side by side."""
    def render(fig, axes, item, index):
        frames = np.asarray(item['frames'])[:1]
        recon = reconstruct(frames)
        axes[0][0].imshow(frames[0])
        axes[0][0].set_title('original')
        axes[0][0].axis('off')
        axes[0][1].imshow(np.asarray(recon)[0])
        axes[0][1].set_title('reconstruction')
        axes[0][1].axis('off')
    return render
