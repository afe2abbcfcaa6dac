"""Weight bridges into the port's state_dicts. Imports no jax.

state_dict_from_jax: JAX variables (nested dicts of numpy arrays; the caller
hands over `jax.device_get(variables)`). jax_initial_state: the VQ-GAN's or
the MIGT's initial state as the JAX package draws it for a seed, with no
jax. Port
names follow the JAX names. The conversions:
  Conv kernel HWIO -> Conv2d weight OIHW;   Dense kernel [in, out] -> Linear weight [out, in];
  norm scale -> weight (GroupNorm under its GroupNorm_0 scope);
  Embed embedding -> weight;   h_<i> -> h.<i>;
  the 'quantizer' collection (codebook [D, N] and its EMA state) as it is.

The reference importers (port of viewformer_tpu/utils/convert.py):
  import_vqgan_from_torch  the released `*-codebook-th` Lightning checkpoints
                           (the reference's torch names) -> the port's VQGAN;
  import_migt_from_tf      the released `*-transformer-tf` Keras checkpoints
                           (read by read_tf_checkpoint, which needs
                           tensorflow, and resolve_keras_object_paths)
                           -> the port's MIGT.

All are strict both ways: every source tensor is consumed and every port
parameter and buffer is filled with a tensor of its shape, or they raise a
KeyError that names the leftovers.
"""
import re

import numpy as np
import torch
import torch.nn as nn

from ..config import VQGANConfig
from ..models.migt import MIGT
from ..models.vqgan import VQGAN, GroupNorm32
from . import jax_random


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


def _entries(model):
    """(port key, module, leaf name, tensor) of each parameter and buffer."""
    for name, module in model.named_modules():
        own = list(module.named_parameters(recurse=False)) + \
            list(module.named_buffers(recurse=False))
        for leaf, tensor in own:
            yield (f'{name}.{leaf}' if name else leaf), name, module, leaf, tensor


def jax_leaves(model):
    """(port key, JAX path (collection, *scope, leaf), converter from the JAX
    array, tensor) of each of `model`'s parameters and buffers: the
    collection is 'quantizer' for the VQ-GAN's codebook state, else
    'params'."""
    for key, name, module, leaf, tensor in _entries(model):
        scope = _merge_list_indices(name)
        collection = 'quantizer' if scope[:1] == ('quantizer',) else 'params'
        if collection == 'quantizer':
            scope = scope[1:]
        if isinstance(module, GroupNorm32):
            scope = scope + ('GroupNorm_0',)
        jax_leaf, convert = _jax_leaf(module, leaf)
        yield key, (collection,) + scope + (jax_leaf,), convert, tensor


def state_dict_from_jax(model, variables):
    """Map JAX `variables` ({'params': ..., and for the VQ-GAN 'quantizer':
    ...}) onto `model`'s parameters and buffers. Returns a state_dict for
    model.load_state_dict."""
    flat = _flatten(variables)
    state, missing = {}, []
    for key, path, convert, _ in jax_leaves(model):
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


def jax_initial_state(model, seed, device=None):
    """The initial state of `model`, a VQGAN or a MIGT, as the JAX package
    draws it from jax.random.PRNGKey(seed) (viewformer_tpu/train/
    codebook.py and transformer.py init_transformer_state), carried as
    state_dict_from_jax carries JAX variables: a state_dict for `model`,
    on `device` (default: the model's). Drawn on the host with
    utils/jax_random.py (no jax), leaf by leaf, each from its scope's first
    key of its stream (flax's variable keys).

    VQ-GAN: the root key splits into the 'params' and 'quantizer' streams.
    Each Conv kernel is lecun_normal in JAX's HWIO layout; biases are zeros
    and GroupNorm scales ones. The codebook is uniform in +-sqrt(3) from
    the root scope's first 'quantizer' key; its EMA buffers and counter are
    zeros.

    MIGT: the root key is the 'params' stream. Dense kernels ([in, out]),
    wte's embedding and wpe are truncated_normal(0.02); biases are zeros,
    LayerNorm scales ones, pos_ori_weights [0, -3]."""
    if device is None:
        device = next(model.parameters()).device
    if isinstance(model, VQGAN):
        params_rng, quantizer_rng = jax_random.split(jax_random.prng_key(seed))
    else:
        params_rng, quantizer_rng = jax_random.prng_key(seed), None
    limit = np.sqrt(np.float32(3.0))
    state = {}
    for key, path, convert, tensor in jax_leaves(model):
        collection, *scope, leaf = path
        if collection == 'quantizer' and leaf == 'embeddings':
            array = jax_random.uniform(jax_random.variable_key(quantizer_rng, (), 1),
                                       tensor.shape, -limit, limit)
        elif collection == 'params' and leaf == 'kernel' and tensor.ndim == 4:
            out_ch, in_ch, kh, kw = tensor.shape
            array = convert(jax_random.lecun_normal(
                jax_random.variable_key(params_rng, scope, 1), (kh, kw, in_ch, out_ch)))
        elif leaf in ('kernel', 'embedding', 'wpe'):
            # flax's truncated_normal(0.02): the draw times f32 0.02
            shape = tensor.shape[::-1] if leaf == 'kernel' else tensor.shape
            array = jax_random.truncated_normal(
                jax_random.variable_key(params_rng, scope, 1), -2.0, 2.0, shape)
            array *= np.float32(0.02)
            array = convert(array) if convert is not None else array
        elif leaf == 'pos_ori_weights':
            array = np.array([0.0, -3.0], np.float32)
        elif leaf == 'scale':
            array = np.ones(tensor.shape, np.float32)
        elif leaf in ('bias', 'ema_cluster_size_hidden', 'ema_dw_hidden', 'counter'):
            array = np.zeros(tensor.shape, np.float32)
        else:
            raise KeyError(f'no JAX initialiser for {key} <- {"/".join(path)}')
        state[key] = torch.tensor(array, dtype=tensor.dtype, device=device)
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


def _target(config, model):
    """`model`, or else the port model of `config` on the meta device (its
    names and shapes, with no storage; the first use of the meta device
    imports much of torch, seconds on a cold disk)."""
    if model is not None:
        return model
    with torch.device('meta'):
        return VQGAN(config) if isinstance(config, VQGANConfig) else MIGT(config)


def _tensor(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(value))


def _check_strict(state, sources, unconsumed, target, kind):
    """Raise unless `state` fills every entry of the port model `target` with
    its shape and no source tensor is left over. sources: port key -> the
    source name it came from."""
    expected = {key: tensor for key, _, _, _, tensor in _entries(target)}
    missing = sorted(set(expected) - set(state))
    unconsumed = sorted(set(unconsumed) | {sources[k] for k in set(state) - set(expected)})
    shapes = [f'{sources[k]} {tuple(state[k].shape)} -> {k} {tuple(expected[k].shape)}'
              for k in sorted(set(state) & set(expected))
              if state[k].shape != expected[k].shape]
    if missing or unconsumed or shapes:
        raise KeyError(f'The {kind} checkpoint and the port model disagree: '
                       f'port entries not filled: {missing}; '
                       f'checkpoint tensors not consumed: {unconsumed}; '
                       f'shapes that differ: {shapes}')
    return {key: state[key] for key in expected}


# the reference's torch names -> the port's: a tower's level list and its
# mid stage become one stage name, as in the JAX package's importer
_VQGAN_RENAMES = (
    (re.compile(r'^(encoder|decoder)\.(down|up)\.(\d+)\.(block|attn)\.(\d+)\.'), r'\1.\2_\3_\4_\5.'),
    (re.compile(r'^(encoder\.down|decoder\.up)\.(\d+)\.(downsample|upsample)\.'), r'\1_\2_\3.'),
    (re.compile(r'^(encoder|decoder)\.mid\.'), r'\1.mid_'),
    (re.compile(r'^quantize\.'), 'quantizer.'),
)
_QUANTIZER_DTYPES = {'quantizer.embeddings': torch.float32,
                     'quantizer.ema_cluster_size_hidden': torch.float32,
                     'quantizer.ema_dw_hidden': torch.float32,
                     'quantizer.counter': torch.int32}


def import_vqgan_from_torch(state_dict, config, model=None):
    """A reference torch VQ-GAN state_dict (a Lightning checkpoint dict with
    'state_dict', or the flat state_dict; its perceptual_loss.* and loss.*
    tensors are dropped) -> the state_dict of the port's VQGAN(config), or
    of `model` when given (a VQGAN of that config). Torch conv weights are
    OIHW already; the codebook state is cast to f32 and the counter to
    int32."""
    if 'state_dict' in state_dict and not hasattr(state_dict['state_dict'], 'shape'):
        state_dict = state_dict['state_dict']
    state, sources = {}, {}
    unconsumed = []
    for source, value in state_dict.items():
        if source.startswith(('perceptual_loss.', 'loss.')):
            continue
        key = source
        for pattern, replacement in _VQGAN_RENAMES:
            key = pattern.sub(replacement, key)
        if key in state:
            unconsumed.append(source)
            continue
        tensor = _tensor(value)
        if key in _QUANTIZER_DTYPES:
            tensor = tensor.to(_QUANTIZER_DTYPES[key])
        state[key], sources[key] = tensor, source
    return _check_strict(state, sources, unconsumed, _target(config, model), 'torch VQ-GAN')


def load_torch_checkpoint(path):
    """A torch .pth/.ckpt file, read onto the CPU (a Lightning checkpoint
    holds objects besides tensors, hence weights_only=False)."""
    return torch.load(path, map_location='cpu', weights_only=False)


# ---------------------------------------------------------------------------
# MIGT (transformer) importer: reference Keras save_weights checkpoints
# ---------------------------------------------------------------------------

def read_tf_checkpoint(prefix):
    """All variables of the TF checkpoint at `prefix` as {name: np.array},
    through tensorflow's checkpoint reader. tensorflow is imported here only:
    nothing else of the port needs it."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError('reading a TF checkpoint (a released *-transformer-tf model) needs '
                          'the tensorflow package, which is not installed') from e
    reader = tf.train.load_checkpoint(prefix)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}


def resolve_keras_object_paths(variables):
    """Normalize TF object-graph checkpoint keys to attribute paths.

    Keras `save_weights` stores keys like
    `model/h/0/attn/c_attn/weight/.ATTRIBUTES/VARIABLE_VALUE` (or
    `layer_with_weights-N/...`). This resolves them to the reference attribute
    naming used by import_migt_from_tf ('h.0/attn/c_attn/weight') via the
    serialized object graph when tensorflow can parse it, else by splitting
    the keys. The optimizer slots, save_counter and keras_api entries are
    dropped."""
    keys = list(variables)
    if not any('.ATTRIBUTES' in k or k == '_CHECKPOINTABLE_OBJECT_GRAPH' for k in keys):
        return variables  # already flat names

    graph_key = '_CHECKPOINTABLE_OBJECT_GRAPH'
    resolved = {}
    paths_by_key = None
    if graph_key in variables:
        try:
            from tensorflow.core.protobuf.trackable_object_graph_pb2 import (
                TrackableObjectGraph)
            graph = TrackableObjectGraph()
            graph.ParseFromString(bytes(variables[graph_key]))
            paths_by_key = {}

            def walk(node_id, path, seen):
                if node_id in seen:
                    return
                seen = seen | {node_id}
                node = graph.nodes[node_id]
                for attr in node.attributes:
                    paths_by_key[attr.checkpoint_key] = path
                for child in node.children:
                    name = child.local_name
                    walk(child.node_id, path + [name], seen)

            walk(0, [], frozenset())
        except Exception:
            paths_by_key = None

    for key, value in variables.items():
        if key == graph_key:
            continue
        if paths_by_key is not None and key in paths_by_key:
            parts = [p for p in paths_by_key[key]
                     if p not in ('model',)]
        else:
            parts = [p for p in key.split('/')
                     if p not in ('.ATTRIBUTES', 'VARIABLE_VALUE', 'model')]
        # drop optimizer slots
        if parts and parts[0] in ('optimizer', 'save_counter', 'keras_api'):
            continue
        # 'h/0/...' -> 'h.0/...'
        if len(parts) >= 2 and parts[0] == 'h' and parts[1].isdigit():
            parts = [f'h.{parts[1]}'] + parts[2:]
        resolved['/'.join(parts)] = value
    return resolved


def _keras_sources(name, module, leaf):
    """(candidate Keras names, converter) of one port entry: a Conv1D's
    weight [in, out] becomes Linear.weight [out, in] and its [1, out] bias is
    flattened; LayerNorm's gamma/beta become weight/bias; wpe may be stored
    as wpe/embeddings or wpe; the dynamic pose-loss weights live under their
    criterion."""
    parts = []
    for part in name.split('.') if name else ():
        if part.isdigit() and parts == ['h']:
            parts = [f'h.{part}']
        else:
            parts.append(part)
    prefix = '/'.join(parts)
    if isinstance(module, nn.Linear):
        if leaf == 'weight':
            return [f'{prefix}/weight'], lambda a: a.T
        return [f'{prefix}/bias'], lambda a: a.reshape(-1)
    if isinstance(module, nn.LayerNorm):
        return [f'{prefix}/{"gamma" if leaf == "weight" else "beta"}'], None
    if isinstance(module, nn.Embedding):
        return [f'{prefix}/{leaf}'], None
    if leaf == 'wpe':
        return ['wpe/embeddings', 'wpe'], None
    if leaf == 'pos_ori_weights':
        return (['pose_loss_weighting_criterion/pos_ori_weights'],
                lambda a: a.reshape(2).astype(np.float32))
    return [f'{prefix}/{leaf}' if prefix else leaf], None


def import_migt_from_tf(variables, config, model=None):
    """Reference Keras MIGT checkpoint variables (names resolved to attribute
    paths by resolve_keras_object_paths: 'wte/weight', 'wpe', 'h.0/ln_1/gamma',
    'h.0/attn/c_attn/weight', 'pose_criterion/pose_classifier/c_fc/bias', ...)
    -> the state_dict of the port's MIGT(config), or of `model` when given
    (an MIGT of that config). wpe stays the static 256 rows;
    pos_ori_weights is taken when the model has it (use_dynamic_pose_loss)."""
    target = _target(config, model)
    state, sources, left = {}, {}, set(variables)
    for key, name, module, leaf, _ in _entries(target):
        candidates, convert = _keras_sources(name, module, leaf)
        source = next((c for c in candidates if c in variables), None)
        if source is None:
            continue
        left.discard(source)
        array = np.asarray(variables[source])
        state[key], sources[key] = _tensor(array if convert is None else convert(array)), source
    return _check_strict(state, sources, left, target, 'TF transformer')
