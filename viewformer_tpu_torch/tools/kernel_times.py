#!/usr/bin/env python3
"""Times the eight attention kernels and the VQ-GAN inference of one checkout
of the port on one CUDA device, at the main paths' shapes, and prints one
JSON line.

    python3 viewformer_tpu_torch/tools/kernel_times.py [--root DIR] [--n 20]

--root is the checkout whose viewformer_tpu_torch is imported (default: the
one holding this script), so that two trees can be timed in turns in one
process sequence on one card (parent, change, change, parent). Each kernel
is timed as chip_smoke.py times it: the median of n single-call CUDA-event
timings after 3 warm-up calls, the wrapper's host time included. Shapes
(B=32 serving, B=64 training, H=12, T=20, L=dh=64, S=2 branches): B1 at
[384, 1216, 64] (serving prefill) and [768, 1280, 64] with the log-sum-exp;
B2's cache form over a 20-frame cache at n=19 and its one-shot form at
q [1536, 1280, 64] with the log-sum-exp; B3 and B6 at [768, 1280, 64]; B4
and B8 at the one-shot shape; B5 and B7 as B1 and B2 training, rate 0.1.
The VQ-GAN is VQGANConfig() with random weights (torch.Generator seed 0) in
bf16, as serving loads it: encode of 640 frames (a serving request's
context) and of 32 frames (a session's observe), decode of 32 frames (a
one-view render).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

WORDS, RATE, L = (0x9E3779B9, 12345), 0.1, 64


def time_ms(fn, n):
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    parser.add_argument('--n', type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('kernel_times: no CUDA device')
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from viewformer_tpu_torch.ops import attention_cuda as ac

    ac.build()
    gen = torch.Generator(device='cuda').manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)  # noqa: E731
    BH, T = 64 * 12, 20
    serve = [rand(BH // 2, 19 * L, 64) for _ in range(3)]
    cache = (rand(BH // 2, L, 64), rand(BH // 2, 20 * L, 64), rand(BH // 2, 20 * L, 64),
             rand(BH // 2, L, 64), rand(BH // 2, L, 64))
    q, k, v, do = (rand(BH, T * L, 64) for _ in range(4))
    qb, kb, vb, dob = (rand(2 * BH, T * L, 64) for _ in range(4))
    out1, lse1 = ac.block_causal_attention_fwd(q, k, v, L, return_lse=True)
    out2, lse2 = ac.branch_attention_fwd(qb, k, v, kb, vb, L, 0, T, return_lse=True)
    out5, lse5 = ac.block_causal_attention_dropout_fwd(q, k, v, L, WORDS, RATE, return_lse=True)
    out7, lse7 = ac.branch_attention_dropout_fwd(qb, k, v, kb, vb, L, WORDS, RATE,
                                                 return_lse=True)
    cases = {
        'B1 serving': lambda: ac.block_causal_attention_fwd(*serve, L),
        'B1 training': lambda: ac.block_causal_attention_fwd(q, k, v, L, return_lse=True),
        'B2 cache form': lambda: ac.branch_attention_fwd(*cache, L, 19, 19),
        'B2 one-shot': lambda: ac.branch_attention_fwd(qb, k, v, kb, vb, L, 0, T,
                                                       return_lse=True),
        'B3': lambda: ac.block_causal_attention_bwd(q, k, v, out1, do, lse1, L),
        'B4': lambda: ac.branch_attention_bwd(qb, k, v, kb, vb, out2, dob, lse2, L),
        'B5': lambda: ac.block_causal_attention_dropout_fwd(q, k, v, L, WORDS, RATE,
                                                            return_lse=True),
        'B6': lambda: ac.block_causal_attention_dropout_bwd(q, k, v, out5, do, lse5, L, WORDS,
                                                            RATE),
        'B7': lambda: ac.branch_attention_dropout_fwd(qb, k, v, kb, vb, L, WORDS, RATE,
                                                      return_lse=True),
        'B8': lambda: ac.branch_attention_dropout_bwd(qb, k, v, kb, vb, out7, dob, lse7, L,
                                                      WORDS, RATE),
    }
    ms = {name: time_ms(fn, args.n) for name, fn in cases.items()}

    from viewformer_tpu_torch.config import VQGANConfig
    from viewformer_tpu_torch.models import AutoModel
    config = VQGANConfig()
    model = AutoModel.from_config(config, torch.bfloat16, 'cuda', torch.Generator().manual_seed(0))
    frames = torch.rand(640, config.image_size, config.image_size, 3, generator=gen,
                        device='cuda') * 2 - 1
    with torch.inference_mode():
        _, codes = model.encode(frames[:32])
        ms['VQ-GAN encode 640'] = time_ms(lambda: model.encode(frames), args.n)
        ms['VQ-GAN encode 32'] = time_ms(lambda: model.encode(frames[:32]), args.n)
        ms['VQ-GAN decode 32'] = time_ms(lambda: model.decode_code(codes), args.n)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({'root': root, 'card': card, 'ms': ms}), flush=True)


if __name__ == '__main__':
    main()
