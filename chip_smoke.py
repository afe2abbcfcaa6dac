#!/usr/bin/env python3
"""Smoke run of the PyTorch port (viewformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Refuses to run without a CUDA device. Phases, each printing a JSON line:
  1. the card's name and power limit; build the CUDA kernels from
     viewformer_tpu_torch/csrc (nvcc, sm_90a) and print the build time;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with CUDA-event times of both;
  3. the full-width serving path (VQGANConfig(), MIGTConfig(), seeded random
     weights, bf16) answers 3 requests of 32 sequences x 20 frames at 128 px
     through generate_batch_predictions; checks outputs and that every kernel
     of the path was launched the expected number of times;
  4. one sequence through the port on the card (bf16, kernels) and on the CPU
     (f32, plain versions) with the same weights; checks the generate logits.
Any failed check raises, so the exit code is not 0. The last line is
{"ok": true, "device": {...}}; the full record goes to chiprun_out/chip_smoke.json.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, S, SIZE = 32, 20, 128
N_REQUESTS = 3

# Phase 2: max|kernel - plain| / max|plain|, plain in f32 from the same bf16
# inputs. The kernel rounds its output to bf16 (relative 2^-8 = 3.9e-3) and,
# like the reference (attention_pallas.py:64-65), rounds the softmax weights
# to bf16 before the product with V; 1e-2 leaves room for both and is ~10x
# below what a wrong mask or a lost frame gives.
KERNEL_TOL = 1e-2
# Phase 4: max|logits_card - logits_cpu| / max|logits_cpu|. The card runs bf16
# weights and activations through 12 layers (each rounding 2^-8 relative, 24
# residual updates); this checks that the path is the same, not the kernels
# (phase 2 does that).
LOGITS_TOL = 5e-2


def check(condition, message):
    if not condition:
        raise RuntimeError(f'chip_smoke: {message}')


def emit(record, log):
    log.append(record)
    print(json.dumps(record), flush=True)


def time_ms(fn, n=20):
    """Median of n single-call CUDA-event timings, after 3 warm-up calls."""
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


def kernel_checks(ac, log):
    """Phase 2. Returns {kernel name: (max_abs_err, ms, plain_ms)}."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)  # noqa: E731
    BH, L, dh = B * 12, 64, 64
    cases = [
        ('block_causal_attention_fwd', 'prefill: T=19 context frames',
         ac.block_causal_attention_fwd, ac.block_causal_attention_plain,
         (rand(BH, 19 * L, dh), rand(BH, 19 * L, dh), rand(BH, 19 * L, dh)), (L,)),
        ('branch_attention_fwd', 'cache form: one query frame over a 20-frame cache, n=19',
         ac.branch_attention_fwd, ac.branch_attention_plain,
         (rand(BH, L, dh), rand(BH, 20 * L, dh), rand(BH, 20 * L, dh),
          rand(BH, L, dh), rand(BH, L, dh)), (L, 19, 19)),
        ('branch_attention_fwd', 'one-shot form: S=2 branches, T=20',
         ac.branch_attention_fwd, ac.branch_attention_plain,
         (rand(2 * BH, 20 * L, dh), rand(BH, 20 * L, dh), rand(BH, 20 * L, dh),
          rand(2 * BH, 20 * L, dh), rand(2 * BH, 20 * L, dh)), (L, 0, 20)),
    ]
    results = {}
    for name, form, kernel, plain, tensors, args in cases:
        out = kernel(*tensors, *args)
        torch.cuda.synchronize()
        ref = plain(*(t.float() for t in tensors), *args)
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = time_ms(lambda: kernel(*tensors, *args))
        plain_ms = time_ms(lambda: plain(*tensors, *args))
        emit({'phase': 'kernel', 'name': name, 'form': form,
              'shapes': [list(t.shape) for t in tensors], 'max_abs_err': err,
              'rel_err': rel, 'tol': KERNEL_TOL, 'ms': ms, 'plain_ms': plain_ms}, log)
        check(torch.isfinite(out).all().item(), f'{name} ({form}): non-finite output')
        check(rel <= KERNEL_TOL, f'{name} ({form}): rel err {rel} > {KERNEL_TOL}')
        # the first case of each kernel is the main path's shape
        if name not in results:
            results[name] = [err, ms, plain_ms]
        results[name][0] = max(results[name][0], err)
        del out, ref
    torch.cuda.empty_cache()
    return results


def make_requests(n, seed):
    rng = np.random.RandomState(seed)
    requests = []
    for _ in range(n):
        images = rng.randint(0, 256, (B, S, SIZE, SIZE, 3)).astype(np.uint8)
        quaternion = rng.randn(B, S, 4)
        quaternion /= np.linalg.norm(quaternion, axis=-1, keepdims=True)
        cameras = np.concatenate([rng.randn(B, S, 3), quaternion], -1).astype(np.float32)
        requests.append((images, cameras))
    return requests


def main_path(ac, models, log, card):
    """Phase 3. Returns the launch counts of the timed requests."""
    from viewformer_tpu_torch.evaluate.transformer import generate_batch_predictions

    transformer, codebook = models
    warm_images, warm_cameras = make_requests(1, seed=100)[0]
    generate_batch_predictions(transformer, codebook, warm_images, warm_cameras)
    requests = make_requests(N_REQUESTS, seed=1)
    torch.cuda.synchronize()

    ac.reset_launch_counts()
    stage_ms, request_s = {}, []
    for images, cameras in requests:
        timings = []
        t0 = time.perf_counter()
        out = generate_batch_predictions(transformer, codebook, images, cameras, timings)
        request_s.append(time.perf_counter() - t0)  # the numpy outputs were copied back
        for (_, prev), (stage, event) in zip(timings, timings[1:]):
            stage_ms.setdefault(stage, []).append(prev.elapsed_time(event))
        check(out['generated_images'].shape == (B, SIZE, SIZE, 3)
              and out['generated_images'].dtype == np.uint8, 'generated images shape/dtype')
        check(out['generated_cameras'].shape == (B, 7)
              and np.isfinite(out['generated_cameras']).all(), 'generated cameras')
        check(len(np.unique(out['generated_codes'])) > 1, 'all generated codes are equal')
    launches = {fn.__name__: fn.launches for fn in ac.KERNELS}

    expected = {'block_causal_attention_fwd': N_REQUESTS * 11,
                'branch_attention_fwd': N_REQUESTS * 24}
    stages = {stage: statistics.median(ms) for stage, ms in stage_ms.items()}
    emit({'phase': 'main_path', 'card': card, 'requests': N_REQUESTS,
          'batch': B, 'frames_per_sequence': S, 'image_size': SIZE,
          'stage_ms_median': stages, 'device_ms_per_request': sum(stages.values()),
          'request_s': request_s,
          'frames_per_s': B / statistics.median(request_s),
          'launches': launches, 'expected_launches': expected}, log)
    check(launches == expected, f'launch counts {launches} != {expected}')
    return launches


def card_vs_cpu(models, cpu_models, log):
    """Phase 4: one sequence, card (bf16, kernels) against CPU (f32, plain)."""
    from viewformer_tpu_torch.evaluate.transformer import (
        generate_batch_predictions, normalize_cameras, to_relative_cameras)
    from viewformer_tpu_torch.models import migt_incremental as inc
    from viewformer_tpu_torch.ops.image import normalize_images

    images, cameras = make_requests(1, seed=7)[0]
    images, cameras = images[:1], cameras[:1]

    @torch.inference_mode()
    def run(transformer, codebook, codes=None):
        device = transformer.wte.weight.device
        x = normalize_images(torch.from_numpy(images).to(device))
        cams = normalize_cameras(to_relative_cameras(torch.from_numpy(cameras).to(device))[0])
        _, own_codes = codebook.encode(x.reshape(S, SIZE, SIZE, 3))
        codes = own_codes.reshape(1, S, 8, 8) if codes is None else codes.to(device)
        cache = inc.prefill_cache(transformer, codes[:, :-1], cams[:, :-1])
        logits = inc.generate_frame(transformer, cache, cams[:, -1])
        return own_codes.cpu(), codes.cpu(), logits.float().cpu()

    cpu_codes, codes, cpu_logits = run(*cpu_models)
    card_codes, _, card_logits = run(*models, codes=codes)  # same codes into both towers
    rel = ((card_logits - cpu_logits).abs().max() / cpu_logits.abs().max()).item()
    card_out = generate_batch_predictions(*models, images, cameras)
    cpu_out = generate_batch_predictions(*cpu_models, images, cameras)
    emit({'phase': 'card_vs_cpu', 'logits_rel_err': rel, 'tol': LOGITS_TOL,
          'encode_code_agreement': (card_codes.reshape(-1) == cpu_codes.reshape(-1))
          .float().mean().item(),
          'generate_argmax_agreement': (card_logits.argmax(-1) == cpu_logits.argmax(-1))
          .float().mean().item(),
          'generated_code_agreement': float(
              (card_out['generated_codes'] == cpu_out['generated_codes']).mean()),
          'camera_max_abs_diff': float(
              np.abs(card_out['generated_cameras'] - cpu_out['generated_cameras']).max())},
         log)
    check(np.isfinite(card_logits.numpy()).all(), 'non-finite card logits')
    check(rel <= LOGITS_TOL, f'card logits differ from CPU by {rel} > {LOGITS_TOL}')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false; '
                         'this script runs only on a CUDA device')
    sys.path.insert(0, ROOT)
    from viewformer_tpu.config import MIGTConfig, VQGANConfig
    from viewformer_tpu_torch.models import AutoModel
    from viewformer_tpu_torch.ops import attention_cuda as ac

    log = []
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib_path = ac.build()
    build_s = time.perf_counter() - t0
    emit({'phase': 'build', 'card': card, 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'library': os.path.relpath(lib_path, ROOT),
          'seconds': build_s, 'ptxas': ac.build_log().splitlines()}, log)

    kernels = kernel_checks(ac, log)

    def build_models(dtype, device):
        gen = torch.Generator().manual_seed(0)
        return (AutoModel.from_config(MIGTConfig(), dtype, device, gen),
                AutoModel.from_config(VQGANConfig(), dtype, device, gen))

    models = build_models(torch.bfloat16, 'cuda')
    launches = main_path(ac, models, log, card)
    card_vs_cpu(models, build_models(torch.float32, 'cpu'), log)

    sources = {'block_causal_attention_fwd': 'viewformer_tpu/ops/attention_pallas.py:52',
               'branch_attention_fwd': 'viewformer_tpu/ops/attention_pallas.py:69'}
    summary = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': 'viewformer_tpu_torch/csrc/branching_attention.cu',
         'replaces': sources[name], 'launches': launches[name], 'max_abs_err': err,
         'ms': ms, 'plain_ms': plain_ms}
        for name, (err, ms, plain_ms) in kernels.items()]}
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump({'records': log, 'summary': summary}, f, indent=1)
    print(json.dumps(summary))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
