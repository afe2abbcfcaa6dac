"""Model registry and checkpoint loading (port of
viewformer_tpu/models/__init__.py). load_model reads the port's own job dirs
(torch.save checkpoints) and the reference's released checkpoints (a torch
VQ-GAN `*.ckpt`/`*.pth`, a Keras MIGT `*.index`), by path or by released
name from ~/.cache/viewformer. Orbax job dirs of the JAX package need jax:
convert JAX variables with utils/convert.state_dict_from_jax instead."""
import glob
import os

import torch

from ..config import MIGTConfig, VQGANConfig, load_config
from ..utils.device import resolve_device


class AutoModel:
    """config (viewformer_tpu_torch.config) -> nn.Module with weights drawn
    from `generator` (the JAX package's initialisers), in `dtype` (islands
    kept f32), on `device`: the card unless the caller asks for the CPU."""

    @staticmethod
    def from_config(config, dtype=torch.float32, device='cuda', generator=None):
        device = resolve_device(device)
        if isinstance(config, VQGANConfig):
            from .vqgan import VQGAN
            model = VQGAN(config, dtype=dtype, generator=generator)
        elif isinstance(config, MIGTConfig):
            from .migt import MIGT
            model = MIGT(config, dtype=dtype, generator=generator)
        else:
            raise ValueError(f'No model registered for config {type(config).__name__}')
        return model.to(device).eval()


def _resolve_checkpoint_path(checkpoint):
    """An existing path as it is; a bare name (no '/') is a released
    checkpoint installed in the cache (utils.pull_checkpoint)."""
    if os.path.exists(checkpoint):
        return checkpoint
    if '/' not in checkpoint:
        from ..utils import pull_checkpoint
        return pull_checkpoint(checkpoint)
    raise FileNotFoundError(f'Checkpoint not found: {checkpoint}')


def _load_state(path, config, model):
    """The state_dict for `model` (of `config`) of the checkpoint under
    `path`, in the JAX package's order of formats."""
    # 1) the port's own job dirs
    if os.path.isdir(os.path.join(path, 'last')) or os.path.isdir(os.path.join(path, 'best')):
        from ..train.checkpoint import restore_checkpoint
        state, _ = restore_checkpoint(path, prefer='best')
        if state is None:
            raise FileNotFoundError(f'No committed checkpoint under {path}')
        return state['model']
    # 2) reference torch codebook checkpoints (model.ckpt, last.ckpt, *.pth)
    torch_checkpoints = sorted(glob.glob(os.path.join(path, '*.ckpt')) +
                               glob.glob(os.path.join(path, '*.pth')))
    if torch_checkpoints and isinstance(config, VQGANConfig):
        from ..utils.convert import import_vqgan_from_torch, load_torch_checkpoint
        return import_vqgan_from_torch(load_torch_checkpoint(torch_checkpoints[-1]), config,
                                       model)
    # 3) reference TF transformer checkpoints (Keras save_weights)
    tf_indexes = sorted(glob.glob(os.path.join(path, '*.index')))
    if tf_indexes and isinstance(config, MIGTConfig):
        from ..utils.convert import (import_migt_from_tf, read_tf_checkpoint,
                                     resolve_keras_object_paths)
        variables = read_tf_checkpoint(tf_indexes[-1][:-len('.index')])
        return import_migt_from_tf(resolve_keras_object_paths(variables), config, model)
    raise FileNotFoundError(f'No loadable checkpoint found under {path}')


def load_model(checkpoint, dtype=torch.float32, device='cuda', **config_overrides):
    """The model of `checkpoint`: a path, or the name of a released
    checkpoint installed in ~/.cache/viewformer (download-model --from-file).
    Its config.json (with `config_overrides` set on it, e.g.
    pose_multiplier) gives the model; the weights come from, in this order,
    a port job dir (best/ or else last/: the 'model' entry of the saved
    state), a reference torch VQ-GAN checkpoint (*.ckpt, *.pth) or a
    reference Keras MIGT checkpoint (*.index; needs tensorflow). Returns an
    MIGT or a VQGAN in `dtype` on `device`, in eval mode. In bf16 the f32
    islands stay f32 (MIGT's pose MLP and pose head, the VQ-GAN's codebook
    and code search)."""
    device = resolve_device(device)
    path = _resolve_checkpoint_path(checkpoint)
    config = load_config(path)
    for key, value in config_overrides.items():
        if not hasattr(config, key):
            raise ValueError(f'{type(config).__name__} has no field {key!r}')
        setattr(config, key, value)
    # the initial weights are overwritten: a fixed generator keeps torch's
    # global one untouched
    model = AutoModel.from_config(config, dtype, device, torch.Generator().manual_seed(0))
    model.load_state_dict(_load_state(path, config, model))
    return model
