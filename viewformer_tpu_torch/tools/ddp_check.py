#!/usr/bin/env python3
"""Checks data-parallel training (parallel/distributed.py) on N cards, or
on N gloo CPU processes with a tiny config, against one process. Run it
under torchrun from the root of a checkout:

    python3 -m torch.distributed.run --nproc_per_node=4 \
        viewformer_tpu_torch/tools/ddp_check.py [cpu]

1. Before joining the process group, each rank takes 2 dropout-0 train
   steps (MIGTConfig(), the global batch of chip_smoke.TRAIN_B sequences of
   20 frames, bf16 on its card) alone: the one-process reference.
2. Joined (NCCL; gloo with `cpu`), each rank takes the same 2 steps on its
   rows: the losses within chip_smoke.TRAIN_LOSS_TOL and the parameter
   updates' cosine (chip_smoke.compared's tensors) at least
   chip_smoke.UPDATE_COSINE against the reference, and the replicas equal
   bit for bit.
3. train_transformer at the default dropout 0.1 for LOOP_STEPS steps over
   chip_smoke's token dataset: first on rank 0 alone before joining, then
   on every rank (batch/N rows each); the replicas equal bit for bit, the
   job dir restores the final parameters. The logged step times of both
   runs are printed.

Rank 0 prints each rank's JSON record, writes them to
chiprun_out/ddp<N>[_cpu].json and the line `ok` (exit 0) or `FAILED`
(exit 1).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from viewformer_tpu_torch.config import MIGTConfig  # noqa: E402
from viewformer_tpu_torch.parallel import distributed  # noqa: E402
from viewformer_tpu_torch.train import transformer as ttt  # noqa: E402
from viewformer_tpu_torch.train.checkpoint import restore_checkpoint  # noqa: E402

LOOP_STEPS = 4


def setup(cpu):
    """(config, global batch rows, dtype, device) of this rank."""
    if cpu:
        torch.set_num_threads(1)
        config = MIGTConfig(d_model=64, n_head=4, n_layer=2, sequence_size=4, n_loss_skip=1)
        cs.S = config.sequence_size
        return config, 8, torch.float32, torch.device('cpu')
    device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
    torch.cuda.set_device(device)
    return MIGTConfig(), cs.TRAIN_B, torch.bfloat16, device


def steps(config, batch, dtype, device, n=2):
    """n train steps from generator seed 0, step i's seeds from seed i:
    (losses, host seconds a step, parameters, their change)."""
    model, state = ttt.init_transformer_state(config, torch.Generator().manual_seed(0), dtype,
                                              device, warmup_steps=1)
    step = ttt.make_transformer_train_step(model, config)
    initial = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, times = [], []
    for i in range(n):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, torch.Generator().manual_seed(i))
        losses.append(metrics['loss'].item())  # waits for the step
        times.append(time.perf_counter() - t0)
    moved = {k: p.detach() - initial[k] for k, p in model.named_parameters()}
    return losses, times, {k: p.detach().clone() for k, p in model.named_parameters()}, moved


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def replicas_equal(tensors):
    """True when every rank holds these tensors bit for bit."""
    flat = torch.cat([t.detach().flatten().float() for t in tensors])
    low, high = flat.clone(), flat.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    return bool(torch.equal(low, high))


def logged_times(job):
    return [r['time'] for r in cs.read_metrics(job).values() if 'train/loss' in r]


def main():
    cpu = sys.argv[1:] == ['cpu']
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    config, rows, dtype, device = setup(cpu)
    out = {'rank': rank, 'world': world, 'device': str(device)}
    if not cpu:
        out['card'] = subprocess.run(
            ['nvidia-smi', f'--id={device.index}', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True, check=True).stdout.strip()

    # before joining: the one-process reference, and rank 0's plain loop
    no_dropout = dataclasses.replace(config, dropout=0.0)
    batch = cs.train_batch(rows, seed=400, device=device)
    ref_losses, ref_times, ref_params, ref_moved = steps(no_dropout, batch, dtype, device)
    tmp = tempfile.mkdtemp(prefix='ddp_check_') if rank == 0 else None

    def loop(job):
        model, _ = ttt.train_transformer(
            config, os.path.join(tmp, 'tokens'), job, total_steps=LOOP_STEPS, epochs=1,
            batch_size=rows, progress=False, log_every=1, profile_batch=0,
            device='cpu' if cpu else 'cuda')
        return model

    if rank == 0:
        cs.write_token_dataset(os.path.join(tmp, 'tokens'))
        loop(os.path.join(tmp, 'plain'))
        out['loop_plain'] = logged_times(os.path.join(tmp, 'plain'))

    distributed.initialize_distributed('cpu' if cpu else 'cuda')
    joined = distributed.world_size() == world and distributed.rank() == rank
    shared = [tmp]
    dist.broadcast_object_list(shared, src=0)
    tmp = shared[0]
    shard = tuple(distributed.shard_rows(x) for x in batch)
    losses, times, params, moved = steps(no_dropout, shard, dtype, device)
    out['step'] = {
        'reference_losses': ref_losses, 'losses': losses, 'reference_step_s': ref_times,
        'step_s': times,
        'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        'max_abs_param_diff': max((params[k].float() - ref_params[k].float()).abs().max().item()
                                  for k in params),
        'update_cosine': {k: cosine(moved[k], ref_moved[k])
                          for k in cs.compared(config.n_layer)},
        'replicas_equal': replicas_equal(params.values())}
    del params, ref_params, moved, ref_moved

    job = os.path.join(tmp, 'ddp')
    model = loop(job)
    out['loop'] = {'replicas_equal': replicas_equal(model.parameters())}
    if rank == 0:
        restored, step = restore_checkpoint(job, prefer='last')
        out['loop'].update(
            restored_step=step, times=logged_times(job), files=sorted(os.listdir(job)),
            restored_equal=all(torch.equal(restored['model'][k], v.detach().cpu())
                               for k, v in model.state_dict().items()))
    results = [None] * world
    dist.all_gather_object(results, out)
    dist.destroy_process_group()
    if rank != 0:
        return
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', f'ddp{world}{"_cpu" if cpu else ""}.json'),
              'w') as f:
        json.dump(results, f, indent=1)
    for r in results:
        print(json.dumps(r))
    ok = (joined and results[0]['loop']['restored_equal']
          and all(r['step']['replicas_equal'] and r['loop']['replicas_equal']
                  and r['step']['loss_rel_err'] <= cs.TRAIN_LOSS_TOL
                  and min(r['step']['update_cosine'].values()) >= cs.UPDATE_COSINE
                  for r in results))
    print('ok' if ok else 'FAILED')
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
