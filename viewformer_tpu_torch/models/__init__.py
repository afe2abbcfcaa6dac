"""Model registry (port of viewformer_tpu/models/__init__.py). Loading an
orbax checkpoint needs jax and is not ported: convert JAX variables with
utils/convert.state_dict_from_jax instead."""
import torch

from ..config import MIGTConfig, VQGANConfig
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
