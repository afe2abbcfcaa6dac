"""Data-parallel training over torch.distributed: the port's counterpart of
the `data` axis of viewformer_tpu/parallel/mesh.py, the JAX package's only
parallel mode in training (parameters replicated, the batch split by rows).

Launch with torchrun, one process per card:

    torchrun --nproc_per_node=N -m viewformer_tpu_torch train transformer ...

`initialize_distributed` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group: NCCL for
CUDA devices, gloo for the CPU. Without that environment nothing is
initialized, and every helper here acts as in one process: rank 0 of 1, the
reductions return their input.

A train step on rank r of W takes rows r*B..(r+1)*B-1 of a global batch of
W*B rows (`shard_rows`), and averages the gradients (`average_gradients`)
and the metrics (`all_reduce_mean`) over the ranks, so that the replicas
take the same update: the update of the global batch. The helpers run their
collectives whenever a process group is initialized, also at world size 1.
"""
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


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


def local_batch_size(batch_size):
    """Rows of a global batch of batch_size that each rank takes; raises
    unless the ranks divide it."""
    world = world_size()
    if batch_size % world:
        raise ValueError(f'the batch of {batch_size} rows does not split over {world} ranks')
    return batch_size // world


def shard_rows(x):
    """This rank's rows of x, a global batch on its leading dimension: the
    rank-th of world_size() equal blocks."""
    n = local_batch_size(x.shape[0])
    return x[rank() * n:(rank() + 1) * n]


def all_reduce_sum(tensor):
    """Sum `tensor` over the ranks, in place; returns it."""
    if is_initialized():
        dist.all_reduce(tensor)
    return tensor


def all_reduce_mean(tensors):
    """{key: 0-d tensor} -> the same keys, each averaged over the ranks, in
    one collective."""
    if not is_initialized() or not tensors:
        return tensors
    keys = list(tensors)
    device = (torch.device('cuda', torch.cuda.current_device())
              if dist.get_backend() == 'nccl' else torch.device('cpu'))
    stacked = torch.stack([torch.as_tensor(tensors[key], dtype=torch.float32, device=device)
                           for key in keys])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return dict(zip(keys, stacked.unbind(0)))


def average_gradients(parameters):
    """Average the parameters' gradients over the ranks, in place: one
    bucket a dtype, one all_reduce each. Every rank must hold gradients of
    the same parameters."""
    if not is_initialized():
        return
    buckets = {}
    for p in parameters:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p.grad)
    world = world_size()
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def gather_lists(values):
    """{key: [numbers]} of each rank -> {key: every rank's numbers, in rank
    order}; `values` itself without a process group. The ranks may hold
    lists of different lengths (a validation split that runs out earlier on
    one rank's shards)."""
    if not is_initialized():
        return values
    gathered = [None] * world_size()
    dist.all_gather_object(gathered, values)
    merged = {}
    for rank_values in gathered:
        for key, v in rank_values.items():
            merged.setdefault(key, []).extend(v)
    return merged


def barrier():
    if is_initialized():
        dist.barrier()
