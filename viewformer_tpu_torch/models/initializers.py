"""The JAX package's weight initialisers, drawn from an explicit torch.Generator.

The numbers differ from jax.random's for the same seed; the distributions
are the same."""
import math

import torch


def truncated_normal_(tensor, std, generator=None):
    """flax.linen.initializers.truncated_normal(std): a standard normal cut
    to [-2, 2], times std."""
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def lecun_normal_(weight, generator=None):
    """Flax's default kernel init, lecun_normal: variance_scaling(1, 'fan_in',
    'truncated_normal'). fan_in is everything but the output dimension."""
    fan_in = weight[0].numel()
    # 0.8796... is the std of a standard normal truncated to [-2, 2]
    return truncated_normal_(weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
