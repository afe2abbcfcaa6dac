"""The device mesh over a torch.distributed world: the port's counterpart of
viewformer_tpu/parallel/mesh.py's (data, seq, model) mesh.

  data   the batch split by rows (parallel/distributed.py);
  seq    context parallelism: MIGT's residual streams split by frames
         (models/migt.py); the attention gathers every frame;
  model  tensor parallelism: Megatron layouts of the blocks' Linear layers
         (parallel/sharding.py); a rank holds n_head / M heads.

The ranks are ordered as the JAX package reshapes its devices: rank =
(data * S + seq) * M + model. `create_mesh` makes every process group the
mesh needs (each axis, and each model index's (data, seq) group, over
which gradients are averaged) and makes the mesh the process's current one
(`current_mesh`), as the JAX trainers enter `with mesh:`. Without a
`create_mesh` since the process group was joined, the current mesh is the
data-only mesh over the world (D = world size, S = M = 1), and without a
process group the 1x1x1 mesh.

The autograd collectives the model runs: `copy_to_model` (identity forward,
all_reduce over `model` backward) before a column-parallel product,
`reduce_from_model` (all_reduce forward, identity backward) after a
row-parallel one, and `gather_frames` (all_gather over `seq` forward,
reduce-scatter backward). A collective over an axis of size 1 is the
identity.
"""
import torch
import torch.distributed as dist

def _initialized():
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """This rank's place in a (data, seq, model) grid of the world and the
    process groups of its axes. shape and coords: {axis: size} and {axis:
    this rank's index}; a group is None where its size is 1."""

    def __init__(self, shape, rank, groups, world):
        self.shape = dict(shape)
        S, M = self.shape['seq'], self.shape['model']
        self.coords = {'data': rank // (S * M), 'seq': rank // M % S, 'model': rank % M}
        self.groups = groups
        self._world = world

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return self.coords[axis]

    def group(self, axis):
        """The process group of `axis` ('data', 'seq', 'model', or
        'data_seq': the ranks of this rank's model index), None when its
        size is 1."""
        return self.groups.get(axis)

    def group_size(self, axis):
        if axis == 'data_seq':
            return self.shape['data'] * self.shape['seq']
        return self.shape[axis]


_current = None
_default = None


def _live_world():
    return dist.group.WORLD if _initialized() else None


def _data_only_mesh():
    world = dist.get_world_size() if _initialized() else 1
    rank = dist.get_rank() if _initialized() else 0
    groups = {}
    if world > 1:
        groups = {'data': dist.group.WORLD, 'data_seq': dist.group.WORLD}
    return Mesh({'data': world, 'seq': 1, 'model': 1}, rank, groups, _live_world())


def current_mesh():
    """The mesh of the last create_mesh in this process group, else the
    data-only mesh over the world (1x1x1 without a process group)."""
    global _current, _default
    world = _live_world()
    if _current is not None and _current._world is world:
        return _current
    if _default is None or _default._world is not world:
        _default = _data_only_mesh()
    return _default


def create_mesh(data_parallelism=None, model_parallelism=1, *, seq_parallelism=1):
    """The (data, seq, model) mesh over the process group's world (the
    1x1x1 mesh without one), made the current mesh. data_parallelism
    defaults to what the other two leave of the world; the three must
    multiply to the world size. Every rank makes the same calls, so every
    rank makes every group, in one order."""
    global _current
    n = dist.get_world_size() if _initialized() else 1
    if data_parallelism is None:
        data_parallelism = n // (model_parallelism * seq_parallelism)
    D, S, M = data_parallelism, seq_parallelism, model_parallelism
    if D * S * M != n or min(D, S, M) < 1:
        raise ValueError(f'{D}x{S}x{M} != {n} devices')
    rank = dist.get_rank() if _initialized() else 0
    grid = torch.arange(n).reshape(D, S, M)
    members = {
        'data': [grid[:, s, m] for s in range(S) for m in range(M)],
        'seq': [grid[d, :, m] for d in range(D) for m in range(M)],
        'model': [grid[d, s, :] for d in range(D) for s in range(S)],
        'data_seq': [grid[:, :, m].flatten() for m in range(M)],
    }
    groups, made = {}, {}
    for axis, lists in members.items():
        for ranks in lists:
            ranks = tuple(ranks.tolist())
            if len(ranks) == 1:
                continue
            if ranks not in made:  # ('data_seq' is 'data' when S = 1)
                made[ranks] = (dist.group.WORLD if len(ranks) == n
                               else dist.new_group(list(ranks)))
            if rank in ranks:
                groups[axis] = made[ranks]
    _current = Mesh({'data': D, 'seq': S, 'model': M}, rank, groups, _live_world())
    return _current


def all_reduce(x, mesh, axis):
    """Sum x over `axis` ('model', 'seq', 'data' or 'data_seq'), in place;
    returns x."""
    if mesh.group_size(axis) > 1:
        dist.all_reduce(x, group=mesh.group(axis))
    return x


def all_gather(x, mesh, axis, dim):
    """Every rank's x of `axis`, concatenated on `dim` in the axis's order."""
    if mesh.group_size(axis) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.group_size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim)


def reduce_scatter(x, mesh, axis, dim):
    """x summed over `axis`, this rank's equal block of `dim`."""
    n = mesh.group_size(axis)
    if n == 1:
        return x
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=mesh.group(axis))
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh, 'model'), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh, 'model')

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, 'seq', dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, 'seq', ctx.dim), None, None


def copy_to_model(x, mesh):
    """The input of a column-parallel product: x forward, its gradient
    summed over `model` backward (Megatron's f)."""
    return x if mesh.size('model') == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    """The partial sums of a row-parallel product summed over `model`
    forward, the gradient as it is backward (Megatron's g)."""
    return x if mesh.size('model') == 1 else _ReduceFromModel.apply(x, mesh)


def gather_frames(x, mesh, dim):
    """Every `seq` rank's frames of x, concatenated on `dim` (all_gather);
    backward, the gradient summed over `seq` and this rank's frames kept
    (reduce-scatter)."""
    return x if mesh.size('seq') == 1 else _GatherFrames.apply(x, mesh, dim)
