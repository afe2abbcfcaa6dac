"""Tensor-parallel layouts of MIGT over the mesh's `model` axis: the port's
counterpart of viewformer_tpu/parallel/sharding.py (_migt_spec,
migt_param_shardings, shard_transformer_state).

The layouts are the JAX package's Megatron ones, on the port's names and
its nn.Linear weights ([out, in]):

  attn.c_attn, mlp.c_fc    column-parallel: rank m of M holds the m-th
                           block of the output rows of the weight and of
                           the bias; c_attn's rows are three chunks
                           (v, q, k), and rank m holds the m-th block of
                           each, that is heads m*H/M .. (m+1)*H/M - 1
  attn.c_proj, mlp.c_proj  row-parallel: the m-th block of the weight's
                           input columns; the bias replicated
  everything else          replicated (embeddings, norms, pose MLPs)

JAX replicates a tensor whose dimension the axis does not divide and then
runs its dense attention; the port has no dense path on the card, so it
raises instead. The model reads its local width from the weights' shapes
(models/migt.py): a column-parallel product runs on the local rows and a
row-parallel one all_reduces its partial sums over `model` before the
bias.

A saved job dir always holds the one-process layout: unshard_* gather the
shards over the model group, shard_* slice them again, so a job trained on
M ranks loads in one process and resumes on any mesh.
"""
import re

from . import mesh as mesh_lib

_COLUMN = re.compile(r'(^|\.)(attn\.c_attn|mlp\.c_fc)\.(weight|bias)$')
_ROW = re.compile(r'(^|\.)(attn\.c_proj|mlp\.c_proj)\.weight$')


def param_layout(name):
    """'column', 'row' or 'replicated' for a MIGT parameter name."""
    if _COLUMN.search(name):
        return 'column'
    if _ROW.search(name):
        return 'row'
    return 'replicated'


def check_divides(config, size):
    """Raise unless `size` model ranks divide the heads and the MLP width."""
    if config.n_head % size or (4 * config.d_model) % size:
        raise ValueError(f'the model axis of {size} ranks does not divide n_head '
                         f'{config.n_head} and 4 * d_model {4 * config.d_model}: the port '
                         'shards only whole heads and has no replicated fallback')


def _chunks(name):
    """The column-parallel chunks of the output rows: 3 for c_attn."""
    return 3 if '.attn.c_attn.' in f'.{name}' else 1


def shard_tensor(name, tensor, index, size):
    """Rank `index` of `size`'s block of the one-process tensor `name`."""
    layout = param_layout(name)
    if layout == 'replicated' or size == 1:
        return tensor
    if layout == 'row':
        return tensor.chunk(size, -1)[index].contiguous()
    parts = _chunks(name)
    rows = tensor.reshape((parts, -1) + tuple(tensor.shape[1:]))
    return rows.chunk(size, 1)[index].reshape((-1,) + tuple(tensor.shape[1:])).contiguous()


def unshard_tensor(name, tensor, mesh):
    """The one-process tensor `name` from every model rank's block (an
    all_gather over the model group; every rank of it calls)."""
    layout = param_layout(name)
    if layout == 'replicated' or mesh.size('model') == 1:
        return tensor
    if layout == 'row':
        return mesh_lib.all_gather(tensor, mesh, 'model', -1)
    parts = _chunks(name)
    rows = tensor.reshape((parts, -1) + tuple(tensor.shape[1:]))
    full = mesh_lib.all_gather(rows, mesh, 'model', 1)
    return full.reshape((-1,) + tuple(tensor.shape[1:]))


def shard_state_dict(state_dict, index, size):
    """A one-process MIGT state_dict -> the layout of model rank `index` of
    `size`."""
    return {name: shard_tensor(name, t, index, size) for name, t in state_dict.items()}


def unshard_state_dict(state_dict, mesh):
    """This rank's MIGT state_dict -> the one-process layout, gathered over
    the model group."""
    return {name: unshard_tensor(name, t, mesh) for name, t in state_dict.items()}


def _optimizer_names(model, optimizer):
    """The parameter name of each index of optimizer.state_dict()."""
    names = {id(p): name for name, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group['params']]


def _map_moments(names, optimizer_state, fn):
    """optimizer_state (a state_dict of the model's optimizer; names from
    _optimizer_names) with each of Adam's moments of parameter `name`
    replaced by fn(name, moment)."""
    state = {index: {key: fn(names[index], value) if key in ('exp_avg', 'exp_avg_sq')
                     else value for key, value in entry.items()}
             for index, entry in optimizer_state['state'].items()}
    return {**optimizer_state, 'state': state}


def unshard_train_state(model, optimizer, mesh):
    """{'model': state_dict, 'optimizer': state_dict} in the one-process
    layout: the parameters and Adam's moments gathered over the model
    group (every rank calls)."""
    if mesh.size('model') == 1:
        return {'model': model.state_dict(), 'optimizer': optimizer.state_dict()}
    names = _optimizer_names(model, optimizer)
    return {'model': unshard_state_dict(model.state_dict(), mesh),
            'optimizer': _map_moments(names, optimizer.state_dict(),
                                      lambda name, t: unshard_tensor(name, t, mesh))}


def shard_transformer_state(model, state, mesh):
    """Shard an MIGT and its TransformerTrainState over the mesh's model
    axis, in place: each column- or row-parallel parameter keeps its
    Parameter object (so the optimizer holds it still) with this rank's
    block as its data, and Adam's moments that exist are re-placed the same
    way (a resumed state keeps its moments). Raises unless the model axis
    divides n_head and 4 * d_model. Returns (model, state)."""
    size, index = mesh.size('model'), mesh.index('model')
    if size == 1:
        return model, state
    check_divides(model.config, size)
    for name, p in model.named_parameters():
        if param_layout(name) == 'replicated':
            continue
        p.data = shard_tensor(name, p.data, index, size)
        moments = state.optimizer.state.get(p, {})
        for key in ('exp_avg', 'exp_avg_sq'):
            if key in moments:
                moments[key] = shard_tensor(name, moments[key], index, size)
    return model, state


def sharded_parameters(model, mesh):
    """The model's parameters that are split over `model` ranks."""
    if mesh.size('model') == 1:
        return []
    return [p for name, p in model.named_parameters() if param_layout(name) != 'replicated']
