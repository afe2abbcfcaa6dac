#!/usr/bin/env python3
"""Time and profile the transformer's train step on the card, with the
non-attention hash dropout as the kernel (viewformer::hash_dropout, the
default) and as its plain int64 twin (ops/dropout.plain_placed_hash_dropout,
what the sites ran before the kernel).

    python -m viewformer_tpu_torch.tools.step_profile [--batch 10 64]
        [--dropout 0.1] [--out step_profile.json]

For each batch size and each form (the kernel only at dropout 0, where no
site hashes): MIGTConfig() (12 layers, d 768, 20 frames, remat) at the
given dropout, f32 parameters and bf16 compute, random weights from
generator seed 0 and seeded random token batches; two warm-up
steps, then the host seconds of each of STEPS steps (each ends in a
synchronize), then torch.profiler (CUDA activity) over 3 steps: the device's
busy share (the kernels' summed time over the window's host seconds), the
kernels launched a step and the top kernels by device time. Batch 10 is the
colors quality gate's transformer stage; 64 is MIGTConfig()'s recipe. Prints
one JSON line a run, with the card's name and power limit, and writes them
all to --out. Runs only on a card.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import MIGTConfig
from ..models import migt
from ..ops.dropout import plain_placed_hash_dropout
from ..train.transformer import (init_transformer_state, make_transformer_train_step,
                                 process_batch)

FRAMES = 20
STEPS = 5  # timed steps a run


def token_batch(n, seed, token_size=8, n_codes=1024):
    """n sequences of FRAMES frames: random codes and cameras through
    process_batch(augment='relative'), on the card."""
    rng = np.random.RandomState(seed)
    cameras, tokens = [], []
    for _ in range(n):
        quaternion = rng.randn(FRAMES, 4)
        quaternion /= np.linalg.norm(quaternion, axis=-1, keepdims=True)
        c, t = process_batch(np.concatenate([rng.randn(FRAMES, 3), quaternion], -1),
                             rng.randint(0, n_codes, (FRAMES, token_size, token_size)),
                             'relative', 'train')
        cameras.append(c)
        tokens.append(t)
    return (torch.from_numpy(np.stack(cameras)).cuda(), torch.from_numpy(np.stack(tokens)).cuda())


def profile_steps(step, state, batches):
    """(state, busy share, kernels a step, top kernels) of len(batches)
    steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch, torch.Generator().manual_seed(100 + i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return (state, busy / wall, sum(e.count for e in kernels) / len(batches),
            [{'kernel': e.key[:120], 'ms_per_step': e.self_device_time_total / 1e3 / len(batches),
              'calls_per_step': e.count / len(batches)} for e in top])


def run(batch_size, dropout, form):
    config = dataclasses.replace(MIGTConfig(), dropout=dropout)
    saved = migt.placed_hash_dropout
    if form == 'plain':
        migt.placed_hash_dropout = plain_placed_hash_dropout
    try:
        model, state = init_transformer_state(config, torch.Generator().manual_seed(0),
                                              torch.bfloat16, 'cuda')
        step = make_transformer_train_step(model, config)
        batches = [token_batch(batch_size, seed) for seed in range(STEPS + 5)]
        for i in range(2):
            state, _ = step(state, batches[i], torch.Generator().manual_seed(i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for i, batch in enumerate(batches[2:2 + STEPS], 2):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, torch.Generator().manual_seed(i))
            loss = metrics['loss'].item()  # waits for the step
            step_s.append(time.perf_counter() - t0)
        _, busy, kernels, top = profile_steps(step, state, batches[-3:])
        return {'batch': batch_size, 'dropout': dropout, 'dropout_form': form,
                'step_s': step_s, 'step_s_median': statistics.median(step_s),
                'tokens_per_s': batch_size * FRAMES * 64 / statistics.median(step_s),
                'loss': loss, 'max_memory_allocated_gb': torch.cuda.max_memory_allocated() / 1e9,
                'device_busy_share': busy, 'kernels_per_step': kernels, 'top_kernels': top}
    finally:
        migt.placed_hash_dropout = saved
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, nargs='+', default=[10, 64])
    ap.add_argument('--dropout', type=float, default=0.1)
    ap.add_argument('--out', default='step_profile.json')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('step_profile: no CUDA device; it runs only on a card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    records = []
    for batch_size in args.batch:
        for form in ('kernel', 'plain') if args.dropout > 0 else ('kernel',):
            record = dict(run(batch_size, args.dropout, form), card=card)
            records.append(record)
            print(json.dumps(record), flush=True)
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
