"""Model registry and checkpoint loading (port of
viewformer_tpu/models/__init__.py). load_model reads the port's own job dirs
(torch.save checkpoints). Orbax job dirs of the JAX package need jax: convert
JAX variables with utils/convert.state_dict_from_jax instead."""
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


def load_model(job_dir, dtype=torch.float32, device='cuda', **config_overrides):
    """The model of a job dir written by the port's CheckpointManager
    (train_transformer, train_codebook): config.json (with `config_overrides` set on it, e.g. pose_multiplier),
    then the weights of best/ or else last/ (the 'model' entry of the saved
    state), as an MIGT or a VQGAN in `dtype` on `device`, in eval mode. In
    bf16 the f32 islands stay f32 (MIGT's pose MLP and pose head, the
    VQ-GAN's codebook and code search)."""
    if not any(os.path.isdir(os.path.join(job_dir, d)) for d in ('best', 'last')):
        raise FileNotFoundError(f'No checkpoint (best/ or last/) under {job_dir}')
    from ..train.checkpoint import restore_checkpoint
    config = load_config(job_dir)
    for key, value in config_overrides.items():
        if not hasattr(config, key):
            raise ValueError(f'{type(config).__name__} has no field {key!r}')
        setattr(config, key, value)
    # the initial weights are overwritten: a fixed generator keeps torch's
    # global one untouched
    model = AutoModel.from_config(config, dtype, device, torch.Generator().manual_seed(0))
    state, _ = restore_checkpoint(job_dir, prefer='best')
    if state is None:
        raise FileNotFoundError(f'No committed checkpoint under {job_dir}')
    model.load_state_dict(state['model'])
    return model
