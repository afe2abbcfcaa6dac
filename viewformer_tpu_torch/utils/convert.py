"""Weight bridge: JAX variables (nested dicts of numpy arrays) -> the port's
state_dict. Imports no jax: the caller hands over `jax.device_get(variables)`.

Port names follow the JAX names. The conversions:
  Conv kernel HWIO -> Conv2d weight OIHW;   Dense kernel [in, out] -> Linear weight [out, in];
  norm scale -> weight (GroupNorm under its GroupNorm_0 scope);
  Embed embedding -> weight;   h_<i> -> h.<i>;
  the 'quantizer' collection (codebook [D, N] and its EMA state) as it is.
Strict both ways: every JAX leaf is consumed and every port parameter and
buffer is filled, or it raises and names the leftovers.
"""
import numpy as np
import torch
import torch.nn as nn

from ..models.vqgan import GroupNorm32


def _flatten(tree, prefix=()):
    flat = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):  # dict or flax FrozenDict
            flat.update(_flatten(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = np.asarray(value)
    return flat


def _jax_leaf(module, leaf):
    """(JAX leaf name, array converter) of one port parameter or buffer."""
    if isinstance(module, nn.Conv2d) and leaf == 'weight':
        return 'kernel', lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear) and leaf == 'weight':
        return 'kernel', lambda a: a.T
    if isinstance(module, (nn.LayerNorm, GroupNorm32)) and leaf == 'weight':
        return 'scale', None
    if isinstance(module, nn.Embedding) and leaf == 'weight':
        return 'embedding', None
    return leaf, None


def state_dict_from_jax(model, variables):
    """Map JAX `variables` ({'params': ..., and for the VQ-GAN 'quantizer':
    ...}) onto `model`'s parameters and buffers. Returns a state_dict for
    model.load_state_dict."""
    flat = _flatten(variables)
    state, missing = {}, []
    for name, module in model.named_modules():
        own = list(module.named_parameters(recurse=False)) + \
            list(module.named_buffers(recurse=False))
        for leaf, _ in own:
            key = f'{name}.{leaf}' if name else leaf
            scope = _merge_list_indices(name)
            collection = 'quantizer' if scope[:1] == ('quantizer',) else 'params'
            if collection == 'quantizer':
                scope = scope[1:]
            if isinstance(module, GroupNorm32):
                scope = scope + ('GroupNorm_0',)
            jax_leaf, convert = _jax_leaf(module, leaf)
            path = (collection,) + scope + (jax_leaf,)
            if path not in flat:
                missing.append(f'{key} <- {"/".join(path)}')
                continue
            array = flat.pop(path)
            if convert is not None:
                array = convert(array)
            state[key] = torch.tensor(array)
    if missing or flat:
        raise KeyError('JAX variables and the port model disagree: '
                       f'port entries with no JAX leaf: {missing}; '
                       f'JAX leaves not consumed: {["/".join(p) for p in flat]}')
    return state


def _merge_list_indices(name):
    """'h.3.attn.c_attn' -> ('h_3', 'attn', 'c_attn'): a ModuleList index
    joins its list's name, as Flax names list members."""
    parts = []
    for part in name.split('.') if name else ():
        if part.isdigit() and parts:
            parts[-1] = f'{parts[-1]}_{part}'
        else:
            parts.append(part)
    return tuple(parts)
