"""Data parallel over torch.distributed: the port's counterpart of the
`data` axis of viewformer_tpu/parallel/mesh.py (parameters replicated, the
batch split by rows), the parallel mode of inference and, with the `seq`
and `model` axes of parallel/mesh.py beside it, of training.

Launch with torchrun, one process per card:

    torchrun --nproc_per_node=N -m viewformer_tpu_torch train transformer ...
    torchrun --nproc_per_node=N -m viewformer_tpu_torch generate-codes ...
    torchrun --nproc_per_node=N -m viewformer_tpu_torch evaluate transformer ...

`initialize_distributed` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group: NCCL for
CUDA devices, gloo for the CPU. Without that environment nothing is
initialized, and every helper here acts as in one process: rank 0 of 1, the
reductions return their input.

The helpers that stand for the data axis read it from the current mesh
(parallel/mesh.current_mesh; the data-only mesh over the world unless
create_mesh made another): a train step on data index r of D takes rows
r*B..(r+1)*B-1 of a global batch of D*B rows (`shard_rows`), averages the
gradients over its (data, seq) group (`average_gradients`; the ranks of
one `model` index, which hold the same shards) and the metrics over the
data group (`all_reduce_mean`), so that the replicas take the same update:
the update of the global batch. The helpers run their collectives whenever
a process group is initialized, also at world size 1.

Inference (generate-codes and the evaluators) reads the same batches on
every rank. Each rank computes its `batch_rows` of a batch, and
`gather_rows` (host arrays, to rank 0 only) or `gather_tensor_rows`
(tensors, on every rank) brings every rank's rows back in global order;
rank 0 alone writes what comes of them.
A batch that the ranks do not divide runs whole on rank 0 while the others
skip it, as the JAX package dispatches such a batch to one device
(viewformer_tpu/evaluate/transformer.py:203-218).
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import current_mesh


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if is_initialized() else 0


def world_size():
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if is_initialized() else 1


def initialize_distributed(device='cuda'):
    """Join torchrun's process group, once, and return the device this
    process runs on: cuda:LOCAL_RANK (made the current CUDA device) for a
    CUDA `device`, else `device`. Without torchrun's RANK and WORLD_SIZE in
    the environment, joins nothing and returns resolve_device(device)."""
    device = resolve_device(device)
    if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
        return device
    if device.type == 'cuda':
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(device)
    if not is_initialized():
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                                rank=int(os.environ['RANK']),
                                world_size=int(os.environ['WORLD_SIZE']))
    return device


def data_index():
    """This rank's index on the current mesh's data axis, and the axis's
    size."""
    mesh = current_mesh()
    return mesh.index('data'), mesh.size('data')


def local_batch_size(batch_size):
    """Rows of a global batch of batch_size that each data index takes;
    raises unless the data axis divides it."""
    _, n_data = data_index()
    if batch_size % n_data:
        raise ValueError(f'the batch of {batch_size} rows does not split over {n_data} ranks')
    return batch_size // n_data


def shard_rows(x):
    """This rank's rows of x, a global batch on its leading dimension: the
    data index's of equal blocks, one a data index."""
    n = local_batch_size(x.shape[0])
    index, _ = data_index()
    return x[index * n:(index + 1) * n]


def batch_rows(batch_size):
    """The slice of a batch of batch_size rows that this rank computes in
    inference: the data index's of equal blocks when the data axis divides
    the batch; otherwise every row on data index 0 and none elsewhere."""
    index, n_data = data_index()
    if batch_size % n_data == 0:
        n = batch_size // n_data
        return slice(index * n, (index + 1) * n)
    return slice(0, batch_size if index == 0 else 0)


def gather_rows(rows):
    """Every rank's rows, concatenated in rank order, on rank 0 (None on
    the other ranks, which send theirs and receive nothing); `rows` itself
    without a process group. rows: this rank's numpy array, or a dict of
    them (a None value stays None), or None where the rank computed no row
    of the batch (batch_rows)."""
    if not is_initialized():
        return rows
    gathered = [None] * world_size() if rank() == 0 else None
    dist.gather_object(rows, gathered, dst=0)
    if rank() != 0:
        return None
    parts = [part for part in gathered if part is not None]
    if not isinstance(parts[0], dict):
        return np.concatenate(parts)
    return {key: None if value is None else np.concatenate([part[key] for part in parts])
            for key, value in parts[0].items()}


def map_rows(fn, *arrays):
    """fn(*rows) on this rank's batch_rows of `arrays` (one batch on their
    leading dimension), gathered back (gather_rows): fn's output for the
    whole batch on rank 0, None on the other ranks."""
    rows = batch_rows(len(arrays[0]))
    return gather_rows(fn(*(a[rows] for a in arrays)) if rows.stop > rows.start else None)


def gather_tensor_rows(x):
    """Every rank's x (tensors of one shape, on this rank's device) stacked
    on the leading dimension in rank order; x itself without a process
    group."""
    if not is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def all_reduce_sum(tensor):
    """Sum `tensor` over the ranks, in place; returns it."""
    if is_initialized():
        dist.all_reduce(tensor)
    return tensor


def all_reduce_mean(tensors):
    """{key: 0-d tensor} -> the same keys, each averaged over the data
    axis (the `seq` and `model` ranks of a data index hold the same
    values), in one collective."""
    if not is_initialized() or not tensors:
        return tensors
    keys = list(tensors)
    device = (torch.device('cuda', torch.cuda.current_device())
              if dist.get_backend() == 'nccl' else torch.device('cpu'))
    stacked = torch.stack([torch.as_tensor(tensors[key], dtype=torch.float32, device=device)
                           for key in keys])
    mesh = current_mesh()
    if mesh.size('data') > 1:
        dist.all_reduce(stacked, group=mesh.group('data'))
        stacked /= mesh.size('data')
    return dict(zip(keys, stacked.unbind(0)))


def average_gradients(parameters):
    """Average the parameters' gradients over this rank's (data, seq) group
    of the current mesh (the ranks that hold the same `model` shards; the
    world on a data-only mesh), in place: one bucket a dtype, one
    all_reduce each. Every rank of the group must hold gradients of the
    same parameters."""
    if not is_initialized():
        return
    mesh = current_mesh()
    n = mesh.group_size('data_seq')
    buckets = {}
    for p in parameters:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        if n > 1:
            dist.all_reduce(flat, group=mesh.group('data_seq'))
        flat /= n
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def gather_lists(values):
    """{key: [numbers]} of each data index -> {key: every data index's
    numbers, in order}, gathered over the data group (the `seq` and `model`
    ranks of a data index hold the same numbers); `values` itself without a
    process group. The ranks may hold lists of different lengths (a
    validation split that runs out earlier on one rank's shards)."""
    if not is_initialized():
        return values
    mesh = current_mesh()
    if mesh.size('data') == 1:
        return values
    gathered = [None] * mesh.size('data')
    dist.all_gather_object(gathered, values, group=mesh.group('data'))
    merged = {}
    for rank_values in gathered:
        for key, v in rank_values.items():
            merged.setdefault(key, []).extend(v)
    return merged


def barrier():
    if is_initialized():
        dist.barrier()
