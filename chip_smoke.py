#!/usr/bin/env python3
"""Smoke run of the PyTorch port (viewformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Refuses to run without a CUDA device. Phases, each printing a JSON line:
  1. the card's name and power limit; build the CUDA kernels from
     viewformer_tpu_torch/csrc (one nvcc a source, in parallel, sm_90a),
     print the build time and check that ptxas reports no register spills;
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, with CUDA-event times of both, its bound (the least time
     of the card for its FLOPs and bytes, ops/attention_cost.py) and the
     time of torch's scaled_dot_product_attention computing the same
     function (library_ms, a yardstick the port never calls): the forward
     kernels B1/B2 at the serving shapes (B1 at odd T = 19; B2's cache form
     at n = 19, 0, 1 and 7; its one-shot form at S = 1 and 2 branches)
     and, with their log-sum-exp output, at the training shapes (B1 at even
     T = 20); the backward kernels B3/B4 at the training shapes; the
     dropout kernels B5-B8 at the training shapes (rate 0.1, fixed seed
     words), each backward kernel with the device time of its D pass and
     main kernel (torch.profiler); B1/B3 and B5/B6 also at T = 1 and 19
     (BH = 24), B2/B4 and B7/B8 at T = 1 and 19 with S = 1 and 2 branches
     (BH0 = 24), where their CTA plans have idle warpgroups and a lone last
     frame, each forward's output and log-sum-exp and then the gradients;
     then an exact probe of B5's and B7's dropout masks (B5/B7 in
     attention_fwd_sm90.cu, B6/B8 in attention_bwd_sm90.cu): with q = k = 0
     and V the identity on one key frame, the output's nonzeros are that
     frame's keep bits, held bit for bit against the plain twins' mask, at
     the training shapes and at T = 19 (B7 with S = 1 branch, whose q-tile
     is one frame); of B6's, through dV (key CTAs) and dQ (query CTAs); and
     of B8's, through dV0, dVb and dQ on both key sets;
  3. the full-width serving path (VQGANConfig(), MIGTConfig(), seeded random
     weights, bf16) answers 3 requests of 32 sequences x 20 frames at 128 px
     through generate_batch_predictions; checks outputs and that every kernel
     of the path was launched the expected number of times;
  4. one sequence through the port on the card (bf16, kernels) and on the CPU
     (f32, plain versions) with the same weights; checks the generate logits;
  5. the full-width training path (MIGTConfig(), the default recipe with
     dropout 0.1; f32 parameters, bf16 compute, per-block remat) takes a
     warm-up step and 5 timed steps at 64 sequences x 20 frames through
     process_batch and the train step; checks the losses and the exact
     launch counts of all eight kernels, and times one site of the
     non-attention dropout; then the same at dropout 0.0 for 2 steps;
  6. one train step at full width on 2 sequences on the card (bf16, kernels)
     and on the CPU (f32, plain versions) from the same weights, batch and
     dropout seeds; checks the loss and gradients, then that 3 steps move
     the parameters the same way: at dropout 0.0 with 12 layers, and at
     dropout 0.1 with 2 (the CPU's plain dropout twins hash every attention
     weight in int64, ~15x the time of the plain attention);
  7. the training entry point (train_loop): a token dataset written through
     the port's writer into a temporary directory (4 train shards of 8
     environments x 100 frames, one test shard of 8 x 160; 8x8 codes from
     1024, seeded cameras) and a random-weight VQGANConfig() codebook saved
     as a job dir; train_transformer(MIGTConfig(), ...) for 6 steps in 2
     epochs at B=64, S=20 with a save every 2 steps, validation with the
     codebook's PSNR; the same run stopped before its 5th step and resumed
     from its step-3 checkpoint. Checks finite losses, the exact launch
     counts of every train step and eval step, val/psnr, and the resumed
     losses against the uninterrupted run's; prints the loop's step time
     against phase 5's bare step, the reader's host time a batch, how long
     save() blocks the loop and the commit lag, and the peak memory;
  8. serving sessions and the evaluators (serve_and_evaluate): random-weight
     MIGTConfig() and VQGANConfig() saved as port job dirs and loaded by
     create_session (bf16, f32 islands) with 32 scenes and 20 frames of
     capacity: start on frames 0-18 of a phase-3 request and render camera
     19 (codes equal to generate_batch_predictions'); start on 0-17,
     observe 18 (logits within LOGITS_TOL of the first); render 4 cameras in
     one call (logits within LOGITS_TOL of one-view renders); localize
     frame 19 (within LOGITS_TOL of the one-shot camera, relative); exact
     launches of each call; then
     evaluate_transformer, evaluate_transformer_multictx (64 random
     sequences of 20 frames at 128 px, batches of 32) and evaluate_codebook
     (their 1280 frames, batches of 64) without storing images: the
     results.json keys of the JAX package, finite values but lpips (null),
     exact launches a batch; prints the session's CUDA-event times, seconds
     an evaluation batch and the peak memory;
  9. the codebook pipeline (codebook_pipeline), from images to a trained
     transformer with the port alone: a colors image dataset at 128 px
     written by generate_dataset_from_loader (32 train and 16 test
     sequences of 22 frames); train_codebook(VQGANConfig(): bf16 compute,
     f32 master weights, remat) at 352 images a step for 6 steps in 2
     epochs, with LPIPS from seeded random weights (not calibrated), one
     validation batch and a save at each epoch end: finite losses and
     perplexity, the EMA counter equal to the steps, the median gap between
     step ends, the bare step (CUDA events), images/s, peak memory and one
     step split by stage (CUDA events); 3 train steps of 2 frames on the
     card (bf16) and on the CPU (f32) from the same weights (loss, gradient
     and update cosines as phase 6, the EMA codebook within 5e-2);
     generate_codes at batch 352 (a padded tail batch), its codes equal to
     a direct encode of the same batches, frames/s and the device's share;
     train_transformer(MIGTConfig()) for 2 steps over the generated codes
     with the trained codebook, and one evaluate-codebook batch, with exact
     launches of B5-B8 (the codebook_pipeline path of the kernels line);
 10. the 7-Scenes and remaining evaluators (sevenscenes_and_more): first
     ops/image.resize of seeded uint8 frames (640x480 and 256 -> 128
     bilinear, 64 -> 128 nearest) on the card against the CPU, byte for
     byte (CUDA's bilinear rounds otherwise in up to 2% of the bytes), and
     upload_frames to the card, which must give the CPU's bytes; then
     random-weight MIGTConfig() and VQGANConfig() job dirs over a synthetic
     7-Scenes scene (chess.zip with nested seq-NN.zip; 200 train and 40 test
     frames of 640x480, seeded gradients and rigid poses):
     evaluate_sevenscenes 'standard' (32 queries, a batch of 32),
     'generated_images' (num_gen_ctx 5) and 'pose_refinement' (9) on 2
     queries each, the three baselines, evaluate_sevenscenes_multictx (a
     batch of 32), then transformer-multictx-allimg (2 colors sequences of
     20 frames, and one with keep_last_frame) and generate-gqn-images (3):
     the results.json keys of the JAX package, finite values but lpips
     (null), exact launches a batch, a query and a run; one standard query
     on the card (bf16) against the CPU (f32), logits within LOGITS_TOL;
     prints the SceneLookup build, the seconds of a batch and of a query
     with the device's busy share (torch.profiler), and the peak memory.
Any failed check raises, so the exit code is not 0. The last line is
{"ok": true, "device": {...}}; the full record goes to chiprun_out/chip_smoke.json.
"""
import contextlib
import copy
import dataclasses
import json
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, S, SIZE = 32, 20, 128
N_REQUESTS = 3
TRAIN_B, TRAIN_STEPS, TRAIN_STEPS_NO_DROPOUT = 64, 5, 2
COMPARE_B = 2  # phase 6: the CPU's f32 step at full width is the slow part
COMPARE_DROPOUT_LAYERS = 2  # phase 6 at dropout 0.1: every kernel, a sixth of the CPU time
RATE = 0.1  # MIGTConfig().dropout
WORDS = (0x9E3779B9, 12345)  # phase 2's dropout seed words

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
# Phase 2, backward: max|kernel - plain| / max|plain| of each gradient. Beside
# the bf16 output rounding, the kernels round dS and W to bf16 before the
# products (as the reference does, attention_pallas.py:171-179), one more
# rounding than the forward, and they take rowsum(dO * O) from the bf16
# output O where the plain twin takes rowsum(dP * W) in f32.
GRAD_TOL = 2e-2
# Phase 2: |lse_kernel - lse_plain|. The kernel sums the exponentials in
# another order; lse is O(10) (raw q.k scores), so 1e-3 is ~1e-4 relative.
LSE_TOL = 1e-3
# Phase 6: the card's loss within 5e-2 (relative) of the CPU's, and per
# tensor gradient cosine similarity >= 0.99: bf16 activations through 12
# layers against f32. After 3 steps (warmup_steps=1, so two updates) the
# parameter changes must point the same way: Adam's first updates are close
# to lr * sign(grad), so elements whose gradient lies within the bf16 noise
# may flip sign. On an H100 the gradient cosines were >= 0.9999 and the
# update cosines 0.9965-0.9985; 0.95 leaves room for that noise and still
# fails when a layer's gradient is lost or wrong.
TRAIN_LOSS_TOL = 5e-2
GRAD_COSINE = 0.99
UPDATE_COSINE = 0.95
# Phase 7: 6 steps in 2 epochs, a save every 2 steps (at 2 and 5, and the
# epoch ends 3 and 6); the second run stops before step 5 and resumes from
# step 3. The resumed steps run the same kernels on the same inputs, so
# their losses agree to f32 rounding; 1e-6 relative allows for a library
# kernel whose reduction order varies between runs.
LOOP_STEPS, LOOP_EPOCHS, LOOP_SAVE_EVERY, LOOP_KILL_AT = 6, 2, 2, 4
RESUME_TOL = 1e-6
# Phase 8: a session renders VIEWS cameras in one call; the evaluators run
# over EVAL_SEQUENCES random sequences (batches of B, the codebook's of
# CODEBOOK_BATCH frames); the session's calls are timed N_TIMED times, and
# observe N_OBSERVE times as its context grows from 19 frames.
VIEWS, EVAL_SEQUENCES, CODEBOOK_BATCH, N_TIMED, N_OBSERVE = 4, 64, 64, 10, 11
# Phase 8: the session's bf16 results against another bf16 path to the same
# function, relative to the largest magnitude, within LOGITS_TOL (as phase
# 4, it checks that the path is the same): a render of N views against
# one-view renders (the GEMMs run at 4x the rows, so cuBLAS may round
# otherwise and near-tied codes flip: in PR 9's first chip run 98.9-99.3% of
# the codes were equal); localize against the one-shot path's camera (the
# query frame is encoded in a batch of 32 frames, not of 640, which may flip
# a code of its 64). A view paired with another scene's cache, or a camera
# not mapped back through the session's transform, is off by O(1).
# Phase 9: a colors image dataset of CB_SEQUENCES sequences of CB_FRAMES
# frames at SIZE px, CB_SHARD sequences a shard (train shards of 440 and 264
# frames, so generate-codes pads a tail batch; test one batch of 352);
# train_codebook at VQGANConfig()'s batch of CB_BATCH images an update for
# CB_STEPS steps in CB_EPOCHS epochs; CB_COMPARE_STEPS card-vs-CPU steps of
# CB_COMPARE_B frames; the transformer for PIPE_STEPS steps of PIPE_TRAIN_B
# sequences on the generated codes (32 train sequences of 20 frames an
# epoch); one evaluate-codebook batch of CB_EVAL_IMAGES frames.
CB_SEQUENCES, CB_FRAMES, CB_SHARD = {'train': 32, 'test': 16}, 22, 20
CB_BATCH, CB_ACCUMULATE, CB_STEPS, CB_EPOCHS = 352, 1, 6, 2
CB_COMPARE_B, CB_COMPARE_STEPS = 2, 3
PIPE_TRAIN_B, PIPE_STEPS, CB_EVAL_IMAGES = 8, 2, 64
# Phase 9, card against CPU: as phase 6 (TRAIN_LOSS_TOL, GRAD_COSINE,
# UPDATE_COSINE). A latent near a tie may take another code in bf16 than in
# f32; at least CB_CODES_EQUAL of the codes must agree, and the EMA codebook
# columns that no differing code touches within EMA_TOL of the largest
# (an average of bf16 latents against one of f32 latents).
CB_CODES_EQUAL, EMA_TOL = 0.9, 5e-2
# Phase 10: a synthetic 7-Scenes scene of SEVEN_TRAIN train frames (two
# sequences) and SEVEN_TEST test frames of SEVEN_W x SEVEN_H; evaluate
# 7scenes (standard) and 7scenes-multictx over SEVEN_QUERIES queries in
# batches of B, the generated_images and pose_refinement procedures over
# SEVEN_SPECIAL queries each, the three baselines over every test frame;
# allimg over ALLIMG_SEQUENCES colors sequences of S frames (and one more
# with keep_last_frame), generate-gqn-images over GQN_SEQUENCES of them.
SEVEN_TRAIN, SEVEN_TEST, SEVEN_W, SEVEN_H = 200, 40, 640, 480
SEVEN_QUERIES, SEVEN_SPECIAL, ALLIMG_SEQUENCES, GQN_SEQUENCES = 32, 2, 2, 3


def compared(n_layer):
    return ('wte.weight', 'h.0.attn.c_attn.weight', f'h.{n_layer - 1}.mlp.c_fc.weight',
            'pose_criterion.pose_classifier.c_fc.weight',
            'pose_criterion.pose_classifier.c_proj.weight')


def check(condition, message):
    if not condition:
        raise RuntimeError(f'chip_smoke: {message}')


def emit(record, log):
    log.append(record)
    print(json.dumps(record), flush=True)


def time_ms(fn, n=20):
    """Median of n single-call CUDA-event timings, after 3 warm-up calls."""
    for _ in range(min(n, 3)):
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


def visible_frames(name, q, args, L):
    """(first_q_frame, n_old) of a branch kernel's call: the forward takes
    them as arguments, the others run the one-shot form."""
    return (args[1], args[2]) if name == 'branch_attention_fwd' else (0, q.shape[1] // L)


def work(name, tensors, args, L, lse=False):
    """(FLOPs, bytes, bound ms, bound by) of one call of kernel `name` on
    these inputs (viewformer_tpu_torch.ops.attention_cost)."""
    from viewformer_tpu_torch.ops import attention_cost as cost

    q = tensors[0]
    backward = name.endswith('_bwd')
    if name.startswith('block_causal'):
        flops, nbytes = cost.block_causal_cost(q.shape[0], q.shape[1] // L, L, q.shape[2],
                                               backward, lse)
    else:
        k0 = tensors[1]
        first, n_old = visible_frames(name, q, args, L)
        flops, nbytes = cost.branch_cost(q.shape[0], q.shape[1] // L, k0.shape[0],
                                         k0.shape[1] // L, L, q.shape[2], first, n_old,
                                         backward, lse)
    return (flops, nbytes) + cost.bound_ms(flops, nbytes)


def sdpa_operands(name, tensors, args, L):
    """q, k, v [N, 1, rows, dh] and the boolean frame mask (True: attend) with
    which one torch scaled_dot_product_attention call (scale 1) computes
    kernel `name`'s function: for a branch kernel, each branch's keys are its
    K0/V0 row followed by its own kb/vb rows."""
    q = tensors[0]
    if name.startswith('block_causal'):
        k, v = tensors[1:3]
        frames = torch.arange(q.shape[1], device=q.device) // L
        mask = frames[:, None] >= frames[None, :]
    else:
        k0, v0, kb, vb = tensors[1:5]
        first, n_old = visible_frames(name, q, args, L)
        q_frame = torch.arange(q.shape[1], device=q.device) // L
        k_frame = torch.arange(k0.shape[1], device=q.device) // L
        mask = torch.cat([k_frame[None, :] < torch.clamp(first + q_frame, max=n_old)[:, None],
                          q_frame[:, None] == q_frame[None, :]], 1)
        rep = q.shape[0] // k0.shape[0]
        k = torch.cat([k0.repeat(rep, 1, 1), kb], 1)
        v = torch.cat([v0.repeat(rep, 1, 1), vb], 1)
    return q[:, None], k[:, None], v[:, None], mask


def library_ms(name, tensors, args, L, n=10):
    """CUDA-event ms of torch's scaled_dot_product_attention computing kernel
    `name`'s function on the same inputs, operands prepared outside the
    timed window (with dropout_p = RATE for a dropout kernel); for a
    backward kernel, forward and backward less forward. A yardstick only:
    the port never calls it."""
    import torch.nn.functional as F

    q, k, v, mask = sdpa_operands(name, tensors, args, L)
    p = RATE if 'dropout' in name else 0.0

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p, scale=1.0)

    if not name.endswith('_bwd'):
        return time_ms(lambda: sdpa(q, k, v), n)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    dout = torch.randn_like(q)
    fwd = time_ms(lambda: sdpa(q, k, v), n)
    both = time_ms(lambda: torch.autograd.grad(sdpa(q, k, v), (q, k, v), dout), n)
    return both - fwd


def yardsticks(name, tensors, args, L, lse=False):
    """The bound and library keys of a kernel's record."""
    flops, nbytes, bound, bound_by = work(name, tensors, args, L, lse)
    return {'flops': flops, 'bytes': nbytes, 'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms(name, tensors, args, L)}


def forward_errors(kernel, plain, tensors, args):
    """Runs a forward kernel with its log-sum-exp and its plain twin in f32
    from the same bf16 inputs. Returns (out, lse, record): the record holds
    max_abs_err, rel_err (relative to the twin's max), lse_max_abs_err,
    their tolerances and finite (all outputs finite)."""
    out, lse = kernel(*tensors, *args, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = plain(*(t.float() for t in tensors), *args, return_lse=True)
    err = (out.float() - ref).abs().max().item()
    return out, lse, {'max_abs_err': err, 'rel_err': err / ref.abs().max().item(),
                      'tol': KERNEL_TOL, 'lse_max_abs_err': (lse - ref_lse).abs().max().item(),
                      'lse_tol': LSE_TOL, 'finite': torch.isfinite(out).all().item()}


def check_forward(name, form, errors):
    check(errors['finite'], f'{name} ({form}): non-finite output')
    check(errors['rel_err'] <= KERNEL_TOL,
          f'{name} ({form}): rel err {errors["rel_err"]} > {KERNEL_TOL}')
    check(errors['lse_max_abs_err'] <= LSE_TOL,
          f'{name} ({form}): lse err {errors["lse_max_abs_err"]} > {LSE_TOL}')


def kernel_checks(ac, log):
    """Phase 2. Returns {kernel name: record of its main-path shape}."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)  # noqa: E731
    BH, L, dh = B * 12, 64, 64

    def cache_form(n):  # one query frame over a 20-frame cache, n frames valid
        return ((rand(BH, L, dh), rand(BH, 20 * L, dh), rand(BH, 20 * L, dh),
                 rand(BH, L, dh), rand(BH, L, dh)), (L, n, n))

    def one_shot(S):
        return ((rand(S * BH, 20 * L, dh), rand(BH, 20 * L, dh), rand(BH, 20 * L, dh),
                 rand(S * BH, 20 * L, dh), rand(S * BH, 20 * L, dh)), (L, 0, 20))

    cases = [('block_causal_attention_fwd', 'prefill: T=19 context frames (odd T)',
              (rand(BH, 19 * L, dh), rand(BH, 19 * L, dh), rand(BH, 19 * L, dh)), (L,))]
    cases += [('branch_attention_fwd', f'cache form: one query frame over a 20-frame cache, '
               f'n={n}') + cache_form(n) for n in (19, 0, 1, 7, 18)]
    cases += [('branch_attention_fwd', f'one-shot form: S={S} branches, T=20') + one_shot(S)
              for S in (1, 2)]
    # phase 8: a session's render of N = 4 views (query rows N-major over
    # the B*H cache rows) and the multi-context evaluation's stream 0
    cases += [('branch_attention_fwd', 'cache form: N=4 views a scene over a 20-frame cache, '
               'n=19', (rand(4 * BH, L, dh), rand(BH, 20 * L, dh), rand(BH, 20 * L, dh),
                        rand(4 * BH, L, dh), rand(4 * BH, L, dh)), (L, 19, 19)),
              ('block_causal_attention_fwd', 'multi-context evaluation: T=20',
               (rand(BH, 20 * L, dh), rand(BH, 20 * L, dh), rand(BH, 20 * L, dh)), (L,))]
    results = {}
    for name, form, tensors, args in cases:
        kernel, plain = getattr(ac, name), getattr(ac, name.replace('_fwd', '_plain'))
        out, lse, errors = forward_errors(kernel, plain, tensors, args)
        del out, lse
        ms = time_ms(lambda: kernel(*tensors, *args))
        plain_ms = time_ms(lambda: plain(*tensors, *args))
        record = {'phase': 'kernel', 'name': name, 'form': form,
                  'shapes': [list(t.shape) for t in tensors], **errors, 'ms': ms,
                  'plain_ms': plain_ms}
        # the first case of each kernel is the serving path's shape
        main = name not in results
        if main:
            record.update(yardsticks(name, tensors, args, L))
        emit(record, log)
        check_forward(name, form, errors)
        if main:
            results[name] = record
        results[name]['max_abs_err'] = max(results[name]['max_abs_err'], errors['max_abs_err'])
    results.update(training_kernel_checks(ac, rand, log))
    block_causal_bwd_edges(ac, rand, results, log)
    branch_bwd_edges(ac, rand, results, log)
    dropout_probes(ac, log)
    return results


def training_kernel_checks(ac, rand, log):
    """Phase 2 at the training path's shapes (B=64, T=20, L=64, dh=64,
    H=12, S=2 branches): B1/B2 and B5/B7 (rate 0.1, seed words WORDS) with
    the log-sum-exp, then B3/B4 and B6/B8 from the same bf16 inputs (out and
    lse from the forward) against their plain twins in f32, with the device
    time of each of their two kernels. Returns {kernel name: record} for
    B3-B8."""
    BH, T, L = TRAIN_B * 12, 20, 64
    q, k, v, dout = (rand(BH, T * L, 64) for _ in range(4))
    qb, kb, vb, doutb = (rand(2 * BH, T * L, 64) for _ in range(4))
    drop = (L, WORDS, RATE)
    results = {}
    cases = [
        (ac.block_causal_attention_fwd, ac.block_causal_attention_plain, (q, k, v), (L,),
         ac.block_causal_attention_bwd, ac.block_causal_attention_bwd_plain, (dout,), (L,)),
        (ac.branch_attention_fwd, ac.branch_attention_plain, (qb, k, v, kb, vb), (L, 0, T),
         ac.branch_attention_bwd, ac.branch_attention_bwd_plain, (doutb,), (L,)),
        (ac.block_causal_attention_dropout_fwd, ac.block_causal_attention_dropout_plain,
         (q, k, v), drop, ac.block_causal_attention_dropout_bwd,
         ac.block_causal_attention_dropout_bwd_plain, (dout,), drop),
        (ac.branch_attention_dropout_fwd, ac.branch_attention_dropout_plain,
         (qb, k, v, kb, vb), drop, ac.branch_attention_dropout_bwd,
         ac.branch_attention_dropout_bwd_plain, (doutb,), drop),
    ]
    for fwd, fwd_plain, inputs, args, bwd, bwd_plain, grads, bwd_args in cases:
        name = fwd.__name__
        out, lse, errors = forward_errors(fwd, fwd_plain, inputs, args)
        ms = time_ms(lambda: fwd(*inputs, *args, return_lse=True))
        plain_ms = time_ms(lambda: fwd_plain(*inputs, *args, return_lse=True), n=5)
        record = {'phase': 'kernel', 'name': name, 'form': 'training: with log-sum-exp',
                  'shapes': [list(t.shape) for t in inputs], **errors, 'ms': ms,
                  'plain_ms': plain_ms, **yardsticks(name, inputs, args, L, lse=True)}
        emit(record, log)
        check_forward(name, 'training', errors)
        if 'dropout' in name:
            results[name] = record

        bwd_name = bwd.__name__
        kernel_grads = bwd(*inputs, out, *grads, lse, *bwd_args)
        torch.cuda.synchronize()
        plain_grads = bwd_plain(*(t.float() for t in inputs + grads), *bwd_args)
        errs = [(g.float() - p).abs().max().item() for g, p in zip(kernel_grads, plain_grads)]
        rels = [e / p.abs().max().item() for e, p in zip(errs, plain_grads)]
        finite = all(torch.isfinite(g).all().item() for g in kernel_grads)
        del kernel_grads, plain_grads
        torch.cuda.empty_cache()
        ms = time_ms(lambda: bwd(*inputs, out, *grads, lse, *bwd_args))
        plain_ms = time_ms(lambda: bwd_plain(*inputs, *grads, *bwd_args), n=5)
        record = {'phase': 'kernel', 'name': bwd_name, 'form': 'training backward',
                  'shapes': [list(t.shape) for t in inputs + grads], 'max_abs_err': errs,
                  'rel_err': rels, 'tol': GRAD_TOL, 'ms': ms, 'plain_ms': plain_ms,
                  **yardsticks(bwd_name, inputs, bwd_args, L)}
        # the D pass, then the main kernel
        record['device_ms_by_kernel'] = device_ms_by_kernel(
            lambda: bwd(*inputs, out, *grads, lse, *bwd_args))
        emit(record, log)
        check(finite, f'{bwd_name}: non-finite gradient')
        check(max(rels) <= GRAD_TOL, f'{bwd_name}: rel err {rels} > {GRAD_TOL}')
        results[bwd_name] = dict(record, max_abs_err=max(errs))
        del out, lse
        torch.cuda.empty_cache()
    return results


def device_ms_by_kernel(fn, n=5):
    """{CUDA kernel name: device ms a call} of the kernels fn launches, by
    torch.profiler over n calls after one warm-up: each kernel's total over
    the launches the profiler recorded, which may be fewer than n (it can
    drop a call's events), divided by their count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


def edge_forward(fwd, fwd_plain, tensors, args, form, results, log):
    """Phase 2: a forward kernel's output and log-sum-exp against its plain
    twin at a CTA plan's edge case; returns (out, lse) for the backward."""
    name = fwd.__name__
    out, lse, errors = forward_errors(fwd, fwd_plain, tensors, args)
    emit({'phase': 'kernel', 'name': name, 'form': form,
          'shapes': [list(t.shape) for t in tensors], **errors}, log)
    check_forward(name, form, errors)
    results[name]['max_abs_err'] = max(results[name]['max_abs_err'], errors['max_abs_err'])
    return out, lse


def block_causal_bwd_edges(ac, rand, results, log):
    """Phase 2: B1/B3 and B5/B6 against their plain twins where their CTA
    plans have their edge cases, at BH = 24: T = 1 (one CTA a row for B1/B5,
    one key and one query CTA for B3/B6, each with an idle warpgroup) and
    T = 19 (the last pair of frames has one); the forward's output and
    log-sum-exp, then the gradients."""
    BH, L = 24, 64
    for T in (1, 19):
        q, k, v, dout = (rand(BH, T * L, 64) for _ in range(4))
        for fwd, fwd_plain, bwd, plain, args in (
                (ac.block_causal_attention_fwd, ac.block_causal_attention_plain,
                 ac.block_causal_attention_bwd, ac.block_causal_attention_bwd_plain, (L,)),
                (ac.block_causal_attention_dropout_fwd, ac.block_causal_attention_dropout_plain,
                 ac.block_causal_attention_dropout_bwd,
                 ac.block_causal_attention_dropout_bwd_plain, (L, WORDS, RATE))):
            name = bwd.__name__
            out, lse = edge_forward(fwd, fwd_plain, (q, k, v), args,
                                    f'CTA plan edge: T={T}, BH={BH}', results, log)
            grads = bwd(q, k, v, out, dout, lse, *args)
            torch.cuda.synchronize()
            ref = plain(q.float(), k.float(), v.float(), dout.float(), *args)
            errs = [(g.float() - r).abs().max().item() for g, r in zip(grads, ref)]
            rels = [e / r.abs().max().item() for e, r in zip(errs, ref)]
            finite = all(torch.isfinite(g).all().item() for g in grads)
            emit({'phase': 'kernel', 'name': name, 'form': f'CTA plan edge: T={T}, BH={BH}',
                  'shapes': [list(q.shape)] * 4, 'max_abs_err': errs, 'rel_err': rels,
                  'tol': GRAD_TOL}, log)
            check(finite, f'{name} (T={T}): non-finite gradient')
            check(max(rels) <= GRAD_TOL, f'{name} (T={T}): rel err {rels} > {GRAD_TOL}')
            results[name]['max_abs_err'] = max(results[name]['max_abs_err'], max(errs))


def branch_bwd_edges(ac, rand, results, log):
    """Phase 2: B2/B4 and B7/B8 against their plain twins where their CTA
    plans have their edge cases, at BH0 = 24: T = 1 (no query sees a K0
    frame, so dK0 and dV0 must be exactly 0, written by key CTAs that stream
    nothing), T = 19 (the last pair of frames has one), each with S = 1
    branch (one consumer warpgroup a forward CTA; a key CTA streams one
    branch row) and S = 2; the forward's output and log-sum-exp, then the
    gradients."""
    BH0, L = 24, 64
    for T in (1, 19):
        for S in (1, 2):
            k0, v0 = rand(BH0, T * L, 64), rand(BH0, T * L, 64)
            q, kb, vb, dout = (rand(S * BH0, T * L, 64) for _ in range(4))
            for fwd, fwd_plain, bwd, plain, args in (
                    (ac.branch_attention_fwd, ac.branch_attention_plain,
                     ac.branch_attention_bwd, ac.branch_attention_bwd_plain, (L,)),
                    (ac.branch_attention_dropout_fwd, ac.branch_attention_dropout_plain,
                     ac.branch_attention_dropout_bwd, ac.branch_attention_dropout_bwd_plain,
                     (L, WORDS, RATE))):
                name = bwd.__name__
                fwd_args = (L, 0, T) if fwd is ac.branch_attention_fwd else args
                out, lse = edge_forward(fwd, fwd_plain, (q, k0, v0, kb, vb), fwd_args,
                                        f'CTA plan edge: T={T}, S={S}, BH0={BH0}', results, log)
                grads = bwd(q, k0, v0, kb, vb, out, dout, lse, *args)
                torch.cuda.synchronize()
                ref = plain(*(t.float() for t in (q, k0, v0, kb, vb, dout)), *args)
                errs = [(g.float() - r).abs().max().item() for g, r in zip(grads, ref)]
                # at T = 1 the plain dK0/dV0 are 0: their error is absolute
                rels = [e / (r.abs().max().item() or 1.0) for e, r in zip(errs, ref)]
                finite = all(torch.isfinite(g).all().item() for g in grads)
                emit({'phase': 'kernel', 'name': name,
                      'form': f'CTA plan edge: T={T}, S={S}, BH0={BH0}',
                      'shapes': [list(t.shape) for t in (q, k0, v0, kb, vb, dout)],
                      'max_abs_err': errs, 'rel_err': rels, 'tol': GRAD_TOL}, log)
                check(finite, f'{name} (T={T}, S={S}): non-finite gradient')
                check(max(rels) <= GRAD_TOL, f'{name} (T={T}, S={S}): rel err {rels} > {GRAD_TOL}')
                if T == 1:
                    check(not grads[1].any().item() and not grads[2].any().item(),
                          f'{name} (T=1, S={S}): dK0/dV0 are not 0')
                results[name]['max_abs_err'] = max(results[name]['max_abs_err'], max(errs))


def block_causal_bwd_mask_probe(ac, mask):
    """Phase 2: B6's dropout mask at the training shape, bit for bit against
    mask = hash_keep over bc_weight_index ([BH, query, key] bool), in both
    kinds of CTA. q = 0 makes every visited weight of a row equal, W > 0.
    Key CTAs, through dV = (W keep)^T dO: with dO the identity on the rows of
    query frame t (0 elsewhere), dV[key, i] = W keep(t*64 + i, key), so its
    nonzeros are the keep bits of frame t's queries over the key frames
    <= t (k = v = 0; out and lse from B5 on the same inputs). Query CTAs,
    through dQ = dS K: with K the identity on key frame f, V and dO 1 in
    column 0 (dP = 1) and out = 0 (D = 0), dQ[query, j] = W keep(query,
    f*64 + j) for the queries of frames >= f (lse as before: with q = 0 it
    does not depend on K or V). Every frame t and f. Returns the mismatched
    bits of each side."""
    BH, TL, L = mask.shape[0], mask.shape[1], 64
    T = TL // L
    zeros = lambda: torch.zeros(BH, TL, L, dtype=torch.bfloat16, device='cuda')  # noqa: E731
    frames = torch.arange(TL, device='cuda') // L
    q = zeros()
    out, lse = ac.block_causal_attention_dropout_fwd(q, q, q, L, WORDS, RATE, return_lse=True)
    bad_key = 0
    for t in range(T):
        _, _, dv = ac.block_causal_attention_dropout_bwd(q, q, q, out, frame_identity(BH, TL, t),
                                                         lse, L, WORDS, RATE)
        expected = mask[:, t * L:(t + 1) * L].transpose(1, 2) & (frames <= t)[None, :, None]
        bad_key += ((dv != 0) != expected).sum().item()
    column0 = zeros()
    column0[..., 0] = 1
    bad_query = 0
    for f in range(T):
        dq, _, _ = ac.block_causal_attention_dropout_bwd(q, frame_identity(BH, TL, f), column0, q,
                                                         column0, lse, L, WORDS, RATE)
        expected = mask[:, :, f * L:(f + 1) * L] & (frames >= f)[None, :, None]
        bad_query += ((dq != 0) != expected).sum().item()
    return {'key_ctas_dv': bad_key, 'query_ctas_dq': bad_query}


def branch_bwd_mask_probe(ac, mask, own, bh0):
    """Phase 2: B8's dropout mask, bit for bit against B7's index space:
    mask = hash_keep over branch_weight_indices' K0 keys ([G, query, key]
    bool) and own over its own-frame keys ([G, T, query, key]). q = k0 =
    kb = 0 makes every visible weight of a row equal, W > 0; out and lse
    come from B7 on the same inputs. dK0/dV0 sum over the S = G / bh0
    branches of a row, so dO is nonzero in one branch's rows at a time.
    Through dV0 = sum_s (W keep)_old^T dO and dVb = (W keep)_own^T dO: with
    dO the identity on the rows of frame t of branch s (0 elsewhere),
    dV0[r, key, i] = W keep(r + s*bh0, t*64 + i, key) over the K0 frames
    below t, and dVb on frame t of those rows holds the own-frame bits.
    Through dQ = dS_old K0 + dS_own Kb: with V and dO 1 in column 0
    (dP = 1) and out = 0 (D = 0), dS = W keep; K0 the identity on key frame
    f and kb = 0 give the bits of the queries of frames > f on frame f, and
    K0 = 0 with kb the identity on every frame the own-frame bits. Every
    branch, frame t and f. Returns the mismatched bits of each output."""
    G, TL, L = mask.shape[0], mask.shape[1], 64
    T, device = TL // L, mask.device
    zeros = lambda rows: torch.zeros(rows, TL, L, dtype=torch.bfloat16, device=device)  # noqa: E731
    eye = torch.eye(L, dtype=torch.bfloat16, device=device)
    frames = torch.arange(TL, device=device) // L
    own_t = own.transpose(2, 3)  # [G, T, key, query]

    q = zeros(G)
    k0 = zeros(bh0)
    out, lse = ac.branch_attention_dropout_fwd(q, k0, k0, q, q, L, WORDS, RATE, return_lse=True)
    bad = {'dv0': 0, 'dvb': 0, 'dq_k0': 0, 'dq_own': 0}
    for s in range(G // bh0):
        rows = slice(s * bh0, (s + 1) * bh0)
        for t in range(T):
            dout = zeros(G)
            dout[rows, t * L:(t + 1) * L] = eye
            _, _, dv0, _, dvb = ac.branch_attention_dropout_bwd(q, k0, k0, q, q, out, dout, lse, L,
                                                                WORDS, RATE)
            expected = mask[rows, t * L:(t + 1) * L].transpose(1, 2) & (frames < t)[None, :, None]
            bad['dv0'] += ((dv0 != 0) != expected).sum().item()
            expected = torch.zeros(G, TL, L, dtype=torch.bool, device=device)
            expected[rows, t * L:(t + 1) * L] = own_t[rows, t]
            bad['dvb'] += ((dvb != 0) != expected).sum().item()
    column0 = zeros(G)
    column0[..., 0] = 1
    v0 = zeros(bh0)
    v0[..., 0] = 1
    for f in range(T):
        k0 = zeros(bh0)
        k0[:, f * L:(f + 1) * L] = eye
        dq = ac.branch_attention_dropout_bwd(q, k0, v0, q, column0, q, column0, lse, L, WORDS,
                                             RATE)[0]
        expected = mask[:, :, f * L:(f + 1) * L] & (frames > f)[None, :, None]
        bad['dq_k0'] += ((dq != 0) != expected).sum().item()
    kb = eye.repeat(T, 1).expand(G, TL, L).contiguous()
    dq = ac.branch_attention_dropout_bwd(q, zeros(bh0), v0, kb, column0, q, column0, lse, L,
                                         WORDS, RATE)[0]
    bad['dq_own'] = ((dq.reshape(G, T, L, L) != 0) != own).sum().item()
    return bad


def twin_mask(rows, index):
    """The plain twins' bool keep mask of `rows` rows, index(ids) giving the
    weight indices of rows ids, in chunks of 16 rows."""
    from viewformer_tpu_torch.ops.dropout import hash_keep

    ids = torch.arange(rows, device='cuda')
    return torch.cat([hash_keep(WORDS, index(ids[i:i + 16]), RATE) != 0
                      for i in range(0, rows, 16)])


def frame_identity(rows, TL, f):
    """[rows, TL, 64] bf16: the identity on the rows of frame f, 0 elsewhere."""
    x = torch.zeros(rows, TL, 64, dtype=torch.bfloat16, device='cuda')
    x[:, f * 64:(f + 1) * 64] = torch.eye(64, dtype=torch.bfloat16, device='cuda')
    return x


def block_causal_fwd_probe(ac, BH, T):
    """B5's keep bits at [BH, T*64, 64], bit for bit against the twins' mask
    over bc_weight_index, through V the identity on each key frame in turn.
    Returns (mask [BH, TL, TL], mismatched bits)."""
    TL, L = T * 64, 64
    zeros = torch.zeros(BH, TL, L, dtype=torch.bfloat16, device='cuda')
    frames = torch.arange(TL, device='cuda') // L
    mask = twin_mask(BH, lambda ids: ac.bc_weight_index(ids, TL))
    bad = 0
    for f in range(T):
        out = ac.block_causal_attention_dropout_fwd(zeros, zeros, frame_identity(BH, TL, f), L,
                                                    WORDS, RATE)
        expected = mask[:, :, f * L:(f + 1) * L] & (frames >= f)[None, :, None]
        bad += ((out != 0) != expected).sum().item()
    return mask, bad


def branch_fwd_probe(ac, BH0, T, S):
    """B7's keep bits at G = S*BH0 branch rows of T*64 queries, bit for bit
    against the twins' mask over branch_weight_indices: on the K0 keys
    through V0 the identity on each K0 frame in turn, on the own keys
    through vb the identity on every frame. Returns (K0 mask [G, TL, TL],
    own mask [G, T, 64, 64], mismatched K0 bits, mismatched own bits)."""
    TL, L, G = T * 64, 64, S * BH0
    zeros = lambda rows: torch.zeros(rows, TL, L, dtype=torch.bfloat16, device='cuda')  # noqa: E731
    frames = torch.arange(TL, device='cuda') // L
    mask = twin_mask(G, lambda ids: ac.branch_weight_indices(ids, TL, L)[0])
    bad = 0
    for f in range(T):
        out = ac.branch_attention_dropout_fwd(zeros(G), zeros(BH0), frame_identity(BH0, TL, f),
                                              zeros(G), zeros(G), L, WORDS, RATE)
        expected = mask[:, :, f * L:(f + 1) * L] & (frames > f)[None, :, None]
        bad += ((out != 0) != expected).sum().item()
    own = twin_mask(G, lambda ids: ac.branch_weight_indices(ids, TL, L)[1])
    eye = torch.eye(L, dtype=torch.bfloat16, device='cuda')
    out = ac.branch_attention_dropout_fwd(zeros(G), zeros(BH0), zeros(BH0), zeros(G),
                                          eye.repeat(T, 1).expand(G, TL, L).contiguous(),
                                          L, WORDS, RATE)
    bad_own = ((out.reshape(G, T, L, L) != 0) != own).sum().item()
    return mask, own, bad, bad_own


def dropout_probes(ac, log):
    """Phase 2: the exact dropout masks of B5-B8. With q = k = 0 every
    visited weight is the same, so with V the identity on one key frame (0
    elsewhere) output column j is nonzero iff that frame's key j was kept:
    the output's nonzeros are the kernel's keep bits for that frame. Held
    bit for bit against the plain twins' mask (hash_keep over
    bc_weight_index / branch_weight_indices): B5 over every key frame and B7
    over every K0 frame and the own frames, at the training shapes and at
    T = 19 (B7 with S = 1 branch at BH0 = 24: one consumer warpgroup a CTA
    and the q-tile qb = 64, so the own frames' column offset is 0 and the
    row stride TL + 64); B6 against B5's mask (block_causal_bwd_mask_probe)
    and B8 against B7's (branch_bwd_mask_probe) at the training shapes."""
    BH, T = TRAIN_B * 12, 20
    TL = T * 64
    mismatches, kept = {}, {}
    mask, bad = block_causal_fwd_probe(ac, BH, T)
    mismatches['block_causal_attention_dropout_fwd'] = bad
    kept['block_causal_attention_dropout_fwd'] = mask.float().mean().item()
    bwd_bad = block_causal_bwd_mask_probe(ac, mask)
    emit({'phase': 'dropout_mask_probe_bwd', 'name': 'block_causal_attention_dropout_bwd',
          'rate': RATE, 'seed_words': WORDS, 'shape': [BH, TL, 64],
          'mismatched_bits': bwd_bad}, log)
    mismatches['block_causal_attention_dropout_bwd'] = sum(bwd_bad.values())
    del mask
    mismatches['block_causal_attention_dropout_fwd T=19, BH=24'] = \
        block_causal_fwd_probe(ac, 24, 19)[1]

    mask, own, bad, bad_own = branch_fwd_probe(ac, BH, T, 2)
    mismatches['branch_attention_dropout_fwd'] = bad + bad_own
    kept['branch_attention_dropout_fwd'] = mask.float().mean().item()
    bwd_bad = branch_bwd_mask_probe(ac, mask, own, BH)
    emit({'phase': 'dropout_mask_probe_bwd', 'name': 'branch_attention_dropout_bwd',
          'rate': RATE, 'seed_words': WORDS, 'shape': [2 * BH, TL, 64], 'bh0': BH,
          'mismatched_bits': bwd_bad}, log)
    mismatches['branch_attention_dropout_bwd'] = sum(bwd_bad.values())
    del mask, own
    _, _, edge_bad, edge_bad_own = branch_fwd_probe(ac, 24, 19, 1)
    mismatches['branch_attention_dropout_fwd T=19, S=1, BH0=24'] = edge_bad + edge_bad_own
    emit({'phase': 'dropout_mask_probe', 'rate': RATE, 'seed_words': WORDS,
          'shapes': {'block_causal': [BH, TL, 64], 'branch': [2 * BH, TL, 64],
                     'block_causal edge': [24, 19 * 64, 64], 'branch edge': [24, 19 * 64, 64]},
          'mismatched_bits': mismatches,
          'branch_own_frame_mismatched_bits': {'training': bad_own, 'edge': edge_bad_own},
          'kept_share_of_all_weights': kept}, log)
    for name, count in mismatches.items():
        check(count == 0, f'{name}: {count} dropout mask bits differ from the plain twin')
    torch.cuda.empty_cache()


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

    expected = {fn.__name__: 0 for fn in ac.KERNELS}
    expected.update(block_causal_attention_fwd=N_REQUESTS * 11,
                    branch_attention_fwd=N_REQUESTS * 24)
    stages = {stage: statistics.median(ms) for stage, ms in stage_ms.items()}
    emit({'phase': 'main_path', 'card': card, 'requests': N_REQUESTS,
          'batch': B, 'frames_per_sequence': S, 'image_size': SIZE,
          'stage_ms_median': stages, 'device_ms_per_request': sum(stages.values()),
          'request_s': request_s,
          'frames_per_s': B / statistics.median(request_s),
          'launches': launches, 'expected_launches': expected}, log)
    check(launches == expected, f'launch counts {launches} != {expected}')
    return launches


def card_vs_cpu(models, cpu_models, log, images=None, cameras=None, phase='card_vs_cpu'):
    """Phase 4: one sequence (a phase-3 request's, unless given: frames
    [1, S, SIZE, SIZE, 3] and cameras [1, S, 7]), card (bf16, kernels)
    against CPU (f32, plain)."""
    from viewformer_tpu_torch.evaluate.transformer import (
        generate_batch_predictions, normalize_cameras, to_relative_cameras)
    from viewformer_tpu_torch.models import migt_incremental as inc
    from viewformer_tpu_torch.ops.image import normalize_images

    if images is None:
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
    emit({'phase': phase, 'logits_rel_err': rel, 'tol': LOGITS_TOL,
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


def train_batch(n, seed, device):
    """n sequences of S frames: seeded random codes and cameras, each
    sequence through process_batch(augment='relative') as the data layer
    would."""
    from viewformer_tpu_torch.train.transformer import process_batch

    rng = np.random.RandomState(seed)
    cameras, tokens = [], []
    for _ in range(n):
        quaternion = rng.randn(S, 4)
        quaternion /= np.linalg.norm(quaternion, axis=-1, keepdims=True)
        c, t = process_batch(np.concatenate([rng.randn(S, 3), quaternion], -1),
                             rng.randint(0, 1024, (S, 8, 8)), 'relative', 'train')
        cameras.append(c)
        tokens.append(t)
    return (torch.from_numpy(np.stack(cameras)).to(device),
            torch.from_numpy(np.stack(tokens)).to(device))


def dropout_site_ms(model, n_streams):
    """CUDA-event ms of one non-attention dropout site (hash_dropout of one
    [B, S, 64, d] bf16 stream) forward, and forward plus backward; and the
    site runs a training step makes: the embeddings' n once, each layer's
    2n (attention output, MLP) in the forward and again in the remat
    recompute, each backward once."""
    from viewformer_tpu_torch.ops.dropout import hash_dropout

    x = torch.randn(TRAIN_B, S, 64, model.config.d_model, device='cuda',
                    dtype=torch.bfloat16, requires_grad=True)
    grad = torch.randn_like(x)
    fwd_ms = time_ms(lambda: hash_dropout(WORDS, x, RATE), n=10)
    both_ms = time_ms(lambda: hash_dropout(WORDS, x, RATE).backward(grad), n=10)
    block_sites = model.config.n_layer * 2 * n_streams
    return fwd_ms, both_ms, n_streams + 2 * block_sites, n_streams + block_sites


def train_path(ac, config, log, card, steps):
    """Phase 5. Returns the launch counts of the timed steps."""
    from viewformer_tpu_torch.train.transformer import (init_transformer_state,
                                                        make_transformer_train_step)

    model, state = init_transformer_state(config, torch.Generator().manual_seed(0),
                                          torch.bfloat16, 'cuda')
    train_step = make_transformer_train_step(model, config)
    batches = [train_batch(TRAIN_B, seed, 'cuda') for seed in range(steps + 1)]
    # each step draws its dropout seeds from a generator of its own seed
    state, metrics = train_step(state, batches[0], torch.Generator().manual_seed(0))  # warm-up
    warm_loss = metrics['loss'].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ac.reset_launch_counts()
    step_s, losses = [], []
    for i, batch in enumerate(batches[1:], 1):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, torch.Generator().manual_seed(i))
        losses.append(metrics['loss'].item())  # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in ac.KERNELS}

    # per layer and step: forward and remat recompute run the forward kernels
    # (B1 and B2, or with dropout B5 and B7) once each, the backward B4 (B8)
    # once and B3 (B6) once, except in the last layer: its stream-0 output
    # reaches no loss (the losses read the generate and localize streams), so
    # autograd never runs that B3 (B6); its K0/V0 still get gradients
    # through B4 (B8)
    n = config.n_layer * steps
    names = (['block_causal_attention_dropout_fwd', 'branch_attention_dropout_fwd',
              'block_causal_attention_dropout_bwd', 'branch_attention_dropout_bwd']
             if config.dropout > 0 else
             ['block_causal_attention_fwd', 'branch_attention_fwd',
              'block_causal_attention_bwd', 'branch_attention_bwd'])
    expected = {fn.__name__: 0 for fn in ac.KERNELS}
    expected.update(zip(names, (2 * n, 2 * n, n - steps, n)))
    median = statistics.median(step_s)
    record = {'phase': 'train', 'card': card, 'dropout': config.dropout, 'batch': TRAIN_B,
              'frames_per_sequence': S, 'tokens_per_step': TRAIN_B * S * 64, 'steps': steps,
              'step_s': step_s, 'step_s_median': median,
              'tokens_per_s': TRAIN_B * S * 64 / median,
              'max_memory_allocated_gb': torch.cuda.max_memory_allocated() / 1e9,
              'warmup_loss': warm_loss, 'losses': losses, 'metrics': {
                  key: value.item() for key, value in metrics.items()},
              'launches': launches, 'expected_launches': expected}
    if config.dropout > 0:
        fwd_ms, both_ms, fwd_runs, bwd_runs = dropout_site_ms(model, 2 + model.use_localization)
        site_ms = fwd_runs * fwd_ms + bwd_runs * (both_ms - fwd_ms)
        record['non_attention_dropout'] = {
            'site_fwd_ms': fwd_ms, 'site_fwd_bwd_ms': both_ms, 'fwd_runs_per_step': fwd_runs,
            'bwd_runs_per_step': bwd_runs, 'est_ms_per_step': site_ms,
            'est_share_of_step': site_ms / (1000 * median)}
    emit(record, log)
    check(all(np.isfinite(losses + [warm_loss])), f'non-finite train loss {losses}')
    check(launches == expected, f'train launch counts {launches} != {expected}')
    del model, state, batches
    torch.cuda.empty_cache()
    return launches


def train_card_vs_cpu(config, log):
    """Phase 6: the same weights, batch and dropout seeds through the train
    step on the card (bf16 compute, kernels, remat) and on the CPU (f32,
    plain twins)."""
    from viewformer_tpu_torch.train.transformer import (init_transformer_state,
                                                        make_transformer_train_step)

    batch = train_batch(COMPARE_B, seed=100, device='cpu')
    names = compared(config.n_layer)
    runs = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', torch.float32)):
        model, state = init_transformer_state(config, torch.Generator().manual_seed(0), dtype,
                                              device, remat=device == 'cuda', warmup_steps=1)
        step = make_transformer_train_step(model, config)
        params = dict(model.named_parameters())
        initial = {name: params[name].detach().cpu().clone() for name in names}
        device_batch = tuple(x.to(device) for x in batch)
        t0 = time.perf_counter()
        # lr(0) = 0: no update; step i draws its dropout seeds from seed i
        state, metrics = step(state, device_batch, torch.Generator().manual_seed(0))
        losses = [metrics['loss'].item()]
        first_step_s = time.perf_counter() - t0
        grads = {name: params[name].grad.detach().cpu().clone() for name in names}
        for i in (1, 2):
            state, metrics = step(state, device_batch, torch.Generator().manual_seed(i))
            losses.append(metrics['loss'].item())
        moved = {name: params[name].detach().cpu() - initial[name] for name in names}
        runs[device] = losses, grads, moved, first_step_s
        del model, state, params
    torch.cuda.empty_cache()

    def cosine(a, b):  # in float64: an f32 dot over millions of elements rounds past 1
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    (card_losses, card_grads, card_moved, card_s), (cpu_losses, cpu_grads, cpu_moved, cpu_s) = \
        runs['cuda'], runs['cpu']
    loss_rel = abs(card_losses[0] - cpu_losses[0]) / abs(cpu_losses[0])
    grad_cosine = {name: cosine(card_grads[name], cpu_grads[name]) for name in names}
    update_cosine = {name: cosine(card_moved[name], cpu_moved[name]) for name in names}
    emit({'phase': 'train_card_vs_cpu', 'dropout': config.dropout, 'n_layer': config.n_layer,
          'batch': COMPARE_B, 'frames_per_sequence': S,
          'card_losses': card_losses, 'cpu_losses': cpu_losses, 'loss_rel_err': loss_rel,
          'loss_tol': TRAIN_LOSS_TOL, 'grad_cosine': grad_cosine, 'grad_cosine_min': GRAD_COSINE,
          'update_cosine': update_cosine, 'update_cosine_min': UPDATE_COSINE,
          'card_first_step_s': card_s, 'cpu_first_step_s': cpu_s}, log)
    check(all(np.isfinite(card_losses)), f'non-finite card losses {card_losses}')
    check(loss_rel <= TRAIN_LOSS_TOL, f'card loss differs from CPU by {loss_rel}')
    for name in names:
        check(grad_cosine[name] >= GRAD_COSINE,
              f'{name}: gradient cosine {grad_cosine[name]} < {GRAD_COSINE}')
        check(update_cosine[name] >= UPDATE_COSINE,
              f'{name}: update cosine {update_cosine[name]} < {UPDATE_COSINE}')


def write_token_dataset(path, seed=0):
    """Phase 7's dataset, through the port's writer: 4 train shards of 8
    environments x 100 frames (160 sequences of S frames, 2 batches an
    epoch) and one test shard of 8 x 160 frames (one batch); 8x8 codes from
    1024 and 7-d cameras with unit quaternions, from a numpy seed."""
    from viewformer_tpu_torch.data.dataset import (get_shard_filename, write_dataset_info,
                                                   write_shard)

    rng = np.random.RandomState(seed)
    os.makedirs(path)
    shards = {'train': (4, 100), 'test': (1, 160)}
    write_dataset_info(os.path.join(path, 'info.json'), {
        'name': 'chip', 'features': ['cameras', 'codes'], 'token_image_size': 8,
        'frame_size': SIZE, 'splits': sorted(shards),
        **{f'{split}_size': n for split, (n, _) in shards.items()}})
    for split, (n, frames) in shards.items():
        for shard in range(1, n + 1):
            environments = []
            for _ in range(8):
                quaternion = rng.randn(frames, 4)
                quaternion /= np.linalg.norm(quaternion, axis=-1, keepdims=True)
                environments.append({
                    'cameras': np.concatenate([rng.randn(frames, 3), quaternion], -1),
                    'codes': rng.randint(0, 1024, (frames, 8, 8))})
            base = get_shard_filename(os.path.join(path, 'chip'), split, shard, n)
            write_shard(base[:-len('.tfrecord')], environments, ['cameras', 'codes'])
    return path


def save_codebook(path):
    """A random-weight VQGANConfig() codebook (seed 0) saved as a port job
    dir, for the loop's validation to load_model and decode_code."""
    from viewformer_tpu_torch.config import VQGANConfig
    from viewformer_tpu_torch.models import AutoModel
    from viewformer_tpu_torch.train.checkpoint import CheckpointManager

    config = VQGANConfig()
    model = AutoModel.from_config(config, torch.float32, 'cpu', torch.Generator().manual_seed(0))
    mgr = CheckpointManager(path, config)
    mgr.save(0, {'model': model.state_dict()})
    mgr.close()
    return path


def reader_ms_per_batch(path, config, n=4):
    """Host ms a batch of load_token_dataset (the train split, the loop's
    transform), over n batches made back to back by its prefetch thread."""
    import functools

    from viewformer_tpu_torch.data.pipeline import load_token_dataset
    from viewformer_tpu_torch.train.transformer import process_batch

    loader = load_token_dataset(path, TRAIN_B, S, 8, split='train', repeat=-1, seed=42,
                                transform=functools.partial(process_batch,
                                                            augment=config.augment_poses))
    t0 = time.perf_counter()
    try:
        for i, (poses, tokens) in enumerate(loader, 1):
            check(poses.shape == (TRAIN_B, S, 7) and tokens.shape == (TRAIN_B, S, 8, 8),
                  f'reader batch shapes {poses.shape}, {tokens.shape}')
            if i == n:
                break
    finally:
        loader.close()
    return 1000 * (time.perf_counter() - t0) / n


class StopBeforeStep(Exception):
    """Raised by phase 7's instrumented train step to stop a run."""


def instrument_loop(ac, ttt, ckpt_mod, stop_at=None):
    """Wraps the train and eval steps that train_transformer builds and the
    CheckpointManager's save and commit: each train and eval step records
    its launches of every kernel and a CUDA event behind its work (no sync:
    the loop syncs only where it reads a metric), each save how long it
    blocked the caller and the device memory then allocated, each commit
    when it ended. With stop_at, the
    train step raises StopBeforeStep when called at that update count.
    Returns (record, restore)."""
    record = {'train': [], 'eval': [], 'saves': {}, 'commits': {}}
    make_train, make_eval = ttt.make_transformer_train_step, ttt.make_transformer_eval_step
    save, commit = ckpt_mod.CheckpointManager.save, ckpt_mod.CheckpointManager._commit

    def counted(kind, fn):
        def run(state, *args):
            if kind == 'train' and state.step == stop_at:
                raise StopBeforeStep
            before = {f.__name__: f.launches for f in ac.KERNELS}
            out = fn(state, *args)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            record[kind].append({'end': end, 'launches': {
                f.__name__: f.launches - before[f.__name__] for f in ac.KERNELS}})
            return out
        return run

    def timed_save(self, step, *args, **kwargs):
        t0 = time.perf_counter()
        save(self, step, *args, **kwargs)
        record['saves'][step] = {'end': time.perf_counter(), 'blocked_s': time.perf_counter() - t0,
                                 'allocated_gb': torch.cuda.memory_allocated() / 1e9}

    def timed_commit(self, step):
        commit(self, step)
        record['commits'][step] = time.perf_counter()

    ttt.make_transformer_train_step = lambda *a: counted('train', make_train(*a))
    ttt.make_transformer_eval_step = lambda *a: counted('eval', make_eval(*a))
    ckpt_mod.CheckpointManager.save = timed_save
    ckpt_mod.CheckpointManager._commit = timed_commit

    def restore():
        ttt.make_transformer_train_step, ttt.make_transformer_eval_step = make_train, make_eval
        ckpt_mod.CheckpointManager.save, ckpt_mod.CheckpointManager._commit = save, commit
    return record, restore


def read_metrics(job_dir):
    """{(step, 'train' or 'val'): record} of a job's metrics.jsonl, the last
    record of a step winning (a resumed run logs its steps again)."""
    out = {}
    with open(os.path.join(job_dir, 'metrics.jsonl')) as f:
        for line in f:
            record = json.loads(line)
            val = any(key.startswith('val/') for key in record)
            out[record['step'], 'val' if val else 'train'] = record
    return out


def train_loop(ac, config, log, card):
    """Phase 7. Returns the launch counts of the uninterrupted run."""
    from viewformer_tpu_torch.train import checkpoint as ckpt_mod
    from viewformer_tpu_torch.train import transformer as ttt

    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        t0 = time.perf_counter()
        data = write_token_dataset(os.path.join(tmp, 'data'))
        codebook = save_codebook(os.path.join(tmp, 'codebook'))
        setup_s = time.perf_counter() - t0
        reader_ms = reader_ms_per_batch(data, config)
        kwargs = dict(codebook_path=codebook, total_steps=LOOP_STEPS, epochs=LOOP_EPOCHS,
                      checkpoint_every=LOOP_SAVE_EVERY, log_every=1, progress=False)

        # run A, uninterrupted: the main path of this phase
        record, restore = instrument_loop(ac, ttt, ckpt_mod)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ac.reset_launch_counts()
            t0 = time.perf_counter()
            model, state = ttt.train_transformer(config, data, os.path.join(tmp, 'a'), **kwargs)
            run_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in ac.KERNELS}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finally:
            restore()
        check(state.step == LOOP_STEPS, f'run A ended at step {state.step}')
        del model, state
        torch.cuda.empty_cache()

        # run B: stopped before step LOOP_KILL_AT + 1, then resumed
        stopped, restore = instrument_loop(ac, ttt, ckpt_mod, stop_at=LOOP_KILL_AT)
        try:
            ttt.train_transformer(config, data, os.path.join(tmp, 'b'), **kwargs)
            check(False, 'run B was not stopped')
        except StopBeforeStep:
            pass
        finally:
            restore()
        resumed, restore = instrument_loop(ac, ttt, ckpt_mod)
        try:
            model, state = ttt.train_transformer(config, data, os.path.join(tmp, 'b'), **kwargs)
        finally:
            restore()
        check(state.step == LOOP_STEPS, f'resumed run B ended at step {state.step}')
        del model, state
        torch.cuda.empty_cache()
        metrics_a = read_metrics(os.path.join(tmp, 'a'))
        metrics_b = read_metrics(os.path.join(tmp, 'b'))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    per_train = {fn.__name__: 0 for fn in ac.KERNELS}
    per_train.update(block_causal_attention_dropout_fwd=2 * config.n_layer,
                     branch_attention_dropout_fwd=2 * config.n_layer,
                     block_causal_attention_dropout_bwd=config.n_layer - 1,
                     branch_attention_dropout_bwd=config.n_layer)
    # an eval step is one forward without dropout: B1 and B2 once a layer
    per_eval = {fn.__name__: 0 for fn in ac.KERNELS}
    per_eval.update(block_causal_attention_fwd=config.n_layer,
                    branch_attention_fwd=config.n_layer)
    train_ends = [r['end'] for r in record['train']]
    step_gaps = [a.elapsed_time(b) / 1000 for a, b in zip(train_ends, train_ends[1:])]
    bare = next(r for r in log if r['phase'] == 'train' and r['dropout'] == config.dropout)
    losses = [metrics_a[step, 'train']['train/loss'] for step in range(1, LOOP_STEPS + 1)]
    resumed_steps = range(LOOP_STEPS - len(resumed['train']) + 1, LOOP_STEPS + 1)
    resume_rel = {step: abs(metrics_b[step, 'train']['train/loss']
                            - metrics_a[step, 'train']['train/loss'])
                  / abs(metrics_a[step, 'train']['train/loss']) for step in resumed_steps}
    commit_lag = {step: record['commits'][step] - save['end']
                  for step, save in record['saves'].items() if step in record['commits']}
    emit({'phase': 'train_loop', 'card': card, 'dropout': config.dropout, 'batch': TRAIN_B,
          'frames_per_sequence': S, 'steps': LOOP_STEPS, 'epochs': LOOP_EPOCHS,
          'checkpoint_every': LOOP_SAVE_EVERY, 'setup_s': setup_s, 'run_s': run_s,
          'reader_ms_per_batch': reader_ms,
          'loop_step_gaps_s': step_gaps, 'loop_step_s_median': statistics.median(step_gaps),
          'bare_step_s_median': bare['step_s_median'],
          'loop_over_bare': statistics.median(step_gaps) / bare['step_s_median'],
          'save_blocked_s': {s: v['blocked_s'] for s, v in record['saves'].items()},
          'commit_lag_s': commit_lag,
          'allocated_gb_after_save': {s: v['allocated_gb'] for s, v in record['saves'].items()},
          'max_memory_allocated_gb': peak_gb,
          'bare_max_memory_allocated_gb': bare['max_memory_allocated_gb'],
          'losses': losses, 'val': {k: v for k, v in metrics_a[LOOP_STEPS, 'val'].items()},
          'stopped_after_step': len(stopped['train']),
          'resumed_losses': [metrics_b[s, 'train']['train/loss'] for s in resumed_steps],
          'resume_loss_rel_diff': resume_rel, 'resume_tol': RESUME_TOL,
          'resume_loss_rel_diff_max': max(resume_rel.values()),
          'launches_per_train_step': [r['launches'] for r in record['train']],
          'launches_per_eval_step': [r['launches'] for r in record['eval']],
          'expected_per_train_step': per_train, 'expected_per_eval_step': per_eval,
          'launches': launches}, log)
    print(f'train_loop: largest relative loss difference after the resume '
          f'{max(resume_rel.values()):.3e} (tolerance {RESUME_TOL})', flush=True)
    check(all(np.isfinite(losses)), f'non-finite loop losses {losses}')
    check(len(record['train']) == LOOP_STEPS, f'{len(record["train"])} train steps')
    check(len(record['eval']) == LOOP_EPOCHS, f'{len(record["eval"])} eval steps')
    for i, r in enumerate(record['train'], 1):
        check(r['launches'] == per_train, f'train step {i} launches {r["launches"]}')
    for i, r in enumerate(record['eval'], 1):
        check(r['launches'] == per_eval, f'eval step {i} launches {r["launches"]}')
    check(all(launches[name] == LOOP_STEPS * per_train[name] + LOOP_EPOCHS * per_eval[name]
              for name in launches), f'loop launch counts {launches}')
    check(np.isfinite(metrics_a[LOOP_STEPS, 'val'].get('val/psnr', np.nan)), 'no finite val/psnr')
    check(len(stopped['train']) == LOOP_KILL_AT, f'run B stopped after {len(stopped["train"])}')
    # the last save before the stop is the first epoch's end
    check(len(resumed['train']) == LOOP_STEPS - LOOP_STEPS // LOOP_EPOCHS,
          f'run B resumed with {len(resumed["train"])} steps left')
    check(max(resume_rel.values()) <= RESUME_TOL,
          f'resumed losses differ from the uninterrupted run: {resume_rel}')
    return launches


def save_transformer(path):
    """A random-weight MIGTConfig() transformer (seed 0) saved as a port job
    dir, as save_codebook saves the codebook."""
    from viewformer_tpu_torch.config import MIGTConfig
    from viewformer_tpu_torch.models import AutoModel
    from viewformer_tpu_torch.train.checkpoint import CheckpointManager

    config = MIGTConfig()
    model = AutoModel.from_config(config, torch.float32, 'cpu', torch.Generator().manual_seed(0))
    mgr = CheckpointManager(path, config)
    mgr.save(0, {'model': model.state_dict()})
    mgr.close()
    return path


class RandomSequences:
    """An in-memory loader of EVAL_SEQUENCES seeded random sequences of S
    frames at SIZE px: {'frames': uint8 [S, SIZE, SIZE, 3], 'cameras':
    [S, 7] with unit quaternions}."""

    def __len__(self):
        return EVAL_SEQUENCES

    def num_images_per_sequence(self):
        return [S] * EVAL_SEQUENCES

    def __getitem__(self, idx):
        rng = np.random.RandomState(1000 + idx)
        quaternion = rng.randn(S, 4)
        quaternion /= np.linalg.norm(quaternion, axis=-1, keepdims=True)
        return {'frames': rng.randint(0, 256, (S, SIZE, SIZE, 3)).astype(np.uint8),
                'cameras': np.concatenate([rng.randn(S, 3), quaternion], -1).astype(np.float32)}


def counts(ac):
    return {fn.__name__: fn.launches for fn in ac.KERNELS}


def launches_of(ac, fn):
    """(fn's result, the kernel launches it made)."""
    before = counts(ac)
    out = fn()
    return out, {name: n - before[name] for name, n in counts(ac).items()}


@contextlib.contextmanager
def record_calls(ac, module, name):
    """Within the context, module.<name> records each call in the yielded
    list: its synced host seconds, its kernel launches and its arguments."""
    fn, calls = getattr(module, name), []

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = launches_of(ac, lambda: fn(*args, **kwargs))
        torch.cuda.synchronize()
        calls.append({'s': time.perf_counter() - t0, 'launches': launches,
                      'call': lambda: fn(*args, **kwargs)})
        return out
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def only(ac, **launches):
    out = {fn.__name__: 0 for fn in ac.KERNELS}
    out.update(launches)
    return out


def session_path(ac, session, log, card):
    """Phase 8, items 1-4: a session against the one-shot path. Returns the
    launch counts of the session's calls."""
    from viewformer_tpu_torch.evaluate.transformer import generate_batch_predictions

    n_layer = session._transformer.config.n_layer
    per_pass = only(ac, branch_attention_fwd=n_layer)
    images, cameras = make_requests(1, seed=1)[0]
    one_shot = generate_batch_predictions(session._transformer, session._codebook, images, cameras)
    torch.cuda.synchronize()

    ac.reset_launch_counts()
    steps = {}
    _, steps['start T=19'] = launches_of(ac, lambda: session.start(images[:, :S - 1],
                                                                  cameras[:, :S - 1]))
    (_, codes), steps['render N=1'] = launches_of(
        ac, lambda: session.render(cameras[:, S - 1], return_tokens=True))
    logits, steps['render_logits N=1'] = launches_of(
        ac, lambda: session.render_logits(cameras[:, S - 1:]))
    queries = cameras[:, S - VIEWS:]
    (_, view_codes), steps[f'render N={VIEWS}'] = launches_of(
        ac, lambda: session.render(queries, return_tokens=True))
    single_codes = [session.render(queries[:, n], return_tokens=True)[1] for n in range(VIEWS)]
    view_logits = session.render_logits(queries)
    single_logits = [session.render_logits(queries[:, n:n + 1])[:, 0] for n in range(VIEWS)]
    located, steps['localize'] = launches_of(ac, lambda: session.localize(images[:, S - 1]))
    with torch.inference_mode():
        query_codes = session._encode(session._prepare_images(images[:, S - 1], 1))
        request_codes = session._codebook.encode(session._prepare_images(images, 2).reshape(
            (B * S, SIZE, SIZE, 3)))[1].reshape(B, S, 8, 8)[:, S - 1]
    session.start(images[:, :S - 2], cameras[:, :S - 2])
    _, steps['observe'] = launches_of(ac, lambda: session.observe(images[:, S - 2],
                                                                  cameras[:, S - 2]))
    observed_logits = session.render_logits(cameras[:, S - 1:])
    launches = counts(ac)

    expected = {'start T=19': only(ac, block_causal_attention_fwd=n_layer - 1),
                'render N=1': per_pass, 'render_logits N=1': per_pass,
                f'render N={VIEWS}': per_pass, 'localize': per_pass, 'observe': per_pass}
    logits_rel = float(np.abs(observed_logits - logits).max() / np.abs(logits).max())
    views_rel = [float(np.abs(view_logits[:, n] - single_logits[n]).max()
                       / np.abs(single_logits[n]).max()) for n in range(VIEWS)]
    localize_err = float(np.abs(located - one_shot['generated_cameras']).max())
    localize_rel = localize_err / float(np.abs(one_shot['generated_cameras']).max())
    record = {
        'phase': 'session', 'card': card, 'batch': B, 'max_frames': S, 'views': VIEWS,
        'codes_equal_one_shot': float((codes == one_shot['generated_codes']).mean()),
        'observe_logits_rel_err': logits_rel, 'observe_logits_tol': LOGITS_TOL,
        'observe_code_agreement': float((observed_logits.argmax(-1) == logits.argmax(-1)).mean()),
        'views_codes_equal_single': [float((view_codes[:, n] == single_codes[n]).mean())
                                     for n in range(VIEWS)],
        'views_logits_rel_err': views_rel, 'views_logits_tol': LOGITS_TOL,
        'localize_max_abs_diff': localize_err, 'localize_rel_err': localize_rel,
        'localize_tol': LOGITS_TOL,
        'query_codes_equal_request_encode': float((query_codes == request_codes).float().mean()),
        'launches_by_call': steps, 'expected_by_call': expected, 'launches': launches}
    emit(record, log)
    print(f'session: observe(frame 18) vs start(0-18): logits rel err {logits_rel:.3e} '
          f'(tol {LOGITS_TOL}), equal codes {record["observe_code_agreement"]:.4f}; '
          f'{VIEWS} views vs one-view renders: logits rel err {max(views_rel):.3e}, equal codes '
          f'{min(record["views_codes_equal_single"]):.4f}; localize vs one-shot: max abs diff '
          f'{localize_err:.3e}, rel err {localize_rel:.3e} (tol {LOGITS_TOL}), query-frame codes '
          f'equal to the request encode\'s {record["query_codes_equal_request_encode"]:.4f}',
          flush=True)
    check(codes.shape == (B, 8, 8), f'session codes shape {codes.shape}')
    check(record['codes_equal_one_shot'] == 1.0,
          f'session codes differ from the one-shot path: {record["codes_equal_one_shot"]} equal')
    check(np.isfinite(observed_logits).all(), 'non-finite logits after observe')
    check(logits_rel <= LOGITS_TOL, f'observe logits differ by {logits_rel} > {LOGITS_TOL}')
    check(np.isfinite(view_logits).all() and max(views_rel) <= LOGITS_TOL,
          f'N={VIEWS} render logits differ from one-view renders by {views_rel} > {LOGITS_TOL}')
    check(np.isfinite(located).all() and localize_rel <= LOGITS_TOL,
          f'localize differs from the one-shot path by {localize_rel} > {LOGITS_TOL} (relative)')
    check(steps == expected, f'session launches {steps} != {expected}')
    return launches


def session_times(session, log, card):
    """Phase 8, item 6: CUDA-event medians of the session's calls (numpy out,
    so each ends with its copy to the host)."""
    images, cameras = make_requests(1, seed=2)[0]
    ms = {'start T=19': time_ms(lambda: session.start(images[:, :S - 1], cameras[:, :S - 1]),
                                N_TIMED)}
    for n in (1, VIEWS):
        ms[f'render N={n}'] = time_ms(lambda: session.render(cameras[:, S - n:]), N_TIMED)
    ms['localize'] = time_ms(lambda: session.localize(images[:, S - 1]), N_TIMED)
    # render N=1 in parts: the query pass (logits copied out) and the decode
    ms['render_logits N=1'] = time_ms(lambda: session.render_logits(cameras[:, S - 1:]), N_TIMED)
    codes = torch.from_numpy(session.render(cameras[:, S - 1], return_tokens=True)[1]).to(session._device)
    with torch.inference_mode():
        ms[f'decode {B} frames'] = time_ms(lambda: session._codebook.decode_code(codes), N_TIMED)
    # observe appends: time single calls as the context grows from 19 frames
    observe = []
    for t in range(session.max_frames - session.context_frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        session.observe(images[:, t % S], cameras[:, t % S])
        end.record()
        torch.cuda.synchronize()
        observe.append(start.elapsed_time(end))
    ms[f'observe n=19..{session.max_frames - 1}'] = statistics.median(observe[1:])
    emit({'phase': 'session_times', 'card': card, 'batch': B, 'ms_median': ms,
          'calls_timed': N_TIMED, 'observe_ms': observe}, log)
    for call, t in ms.items():
        print(f'session {call}: {t:.3f} ms, B={B} ({card})', flush=True)


def evaluate_path(ac, jobs, log, card):
    """Phase 8, item 5: the three evaluators over RandomSequences. Returns
    their launch counts."""
    from viewformer_tpu_torch.evaluate import codebook as ecodebook
    from viewformer_tpu_torch.evaluate import multictx as emultictx
    from viewformer_tpu_torch.evaluate import transformer as etransformer

    from viewformer_tpu_torch.config import load_config

    n_layer = load_config(jobs['transformer']).n_layer
    per_batch = {
        'transformer': only(ac, block_causal_attention_fwd=n_layer - 1,
                            branch_attention_fwd=2 * n_layer),
        'transformer-multictx': only(ac, block_causal_attention_fwd=n_layer,
                                     branch_attention_fwd=n_layer),
        'codebook': only(ac)}
    metrics = ['loc-angle', 'loc-dist', 'loc-angle-med', 'loc-dist-med',
               'mse', 'rmse', 'mae', 'psnr', 'lpips', 'ssim']  # the JAX package's keys
    expected_keys = {'transformer': metrics,
                     'transformer-multictx': [f'ctx{i:02d}' for i in range(1, S)],
                     'codebook': metrics[4:]}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_eval_')
    loader = RandomSequences()
    batches, results = {}, {}
    modules = {'transformer': etransformer, 'transformer-multictx': emultictx,
               'codebook': ecodebook}
    ac.reset_launch_counts()
    try:
        for kind, module in modules.items():
            job_dir = os.path.join(tmp, kind)
            t0 = time.perf_counter()
            with record_calls(ac, module, 'generate_batch_predictions') as batches[kind]:
                if kind == 'codebook':
                    results[kind] = ecodebook.evaluate_codebook(
                        loader, jobs['codebook'], job_dir, batch_size=CODEBOOK_BATCH,
                        num_store_images=0, progress=False)
                else:
                    evaluate = (etransformer.evaluate_transformer if kind == 'transformer'
                                else emultictx.evaluate_transformer_multictx)
                    results[kind] = evaluate(loader, jobs['transformer'], jobs['codebook'],
                                             job_dir, batch_size=B, num_store_images=0,
                                             progress=False)
            batches[kind + ' run_s'] = time.perf_counter() - t0
            with open(os.path.join(job_dir, 'results.json')) as f:
                check(json.load(f) == json.loads(json.dumps(results[kind])),
                      f'{kind}: results.json differs from the returned results')
            check(os.listdir(job_dir) == ['results.json'], f'{kind}: stored {os.listdir(job_dir)}')
        launches = counts(ac)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n_batches = {'transformer': EVAL_SEQUENCES // B, 'transformer-multictx': EVAL_SEQUENCES // B,
                 'codebook': EVAL_SEQUENCES * S // CODEBOOK_BATCH}
    emit({'phase': 'evaluate', 'card': card, 'sequences': EVAL_SEQUENCES,
          'frames_per_sequence': S, 'image_size': SIZE, 'batch': B,
          'codebook_batch': CODEBOOK_BATCH, 'results': results,
          'batch_s': {kind: [b['s'] for b in batches[kind]] for kind in modules},
          'batch_s_median': {kind: statistics.median(b['s'] for b in batches[kind])
                             for kind in modules},
          'run_s': {kind: batches[kind + ' run_s'] for kind in modules},
          'launches_per_batch': {kind: [b['launches'] for b in batches[kind]] for kind in modules},
          'expected_per_batch': per_batch, 'launches': launches}, log)
    for kind in modules:
        print(f'evaluate {kind}: {statistics.median(b["s"] for b in batches[kind]):.4f} s a batch '
              f'({len(batches[kind])} batches, {card})', flush=True)
    for kind, module in modules.items():
        check(len(batches[kind]) == n_batches[kind], f'{kind}: {len(batches[kind])} batches')
        for i, b in enumerate(batches[kind], 1):
            check(b['launches'] == per_batch[kind], f'{kind} batch {i} launches {b["launches"]}')
        rows = results[kind].values() if kind == 'transformer-multictx' else [results[kind]]
        check(list(results[kind]) == expected_keys[kind],
              f'{kind}: results.json keys {list(results[kind])}')
        for row in rows:
            if kind == 'transformer-multictx':
                check(list(row) == metrics, f'{kind}: row keys {list(row)}')
            for key, value in row.items():
                check(value is None if key == 'lpips' else np.isfinite(value),
                      f'{kind}: {key} = {value}')
    check(all(launches[name] == sum(n_batches[k] * per_batch[k][name] for k in modules)
              for name in launches), f'evaluate launch counts {launches}')
    return launches


def serve_and_evaluate(ac, log, card):
    """Phase 8. Returns the launch counts of the session and the evaluators."""
    from viewformer_tpu_torch.serve import create_session

    tmp = tempfile.mkdtemp(prefix='chip_smoke_jobs_')
    try:
        t0 = time.perf_counter()
        jobs = {'transformer': save_transformer(os.path.join(tmp, 'transformer')),
                'codebook': save_codebook(os.path.join(tmp, 'codebook'))}
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        session = create_session(jobs['transformer'], jobs['codebook'], batch_size=B,
                                 max_frames=S)
        load_s = time.perf_counter() - t0
        check(session._transformer.wte.weight.dtype == torch.bfloat16
              and session._transformer.pose_criterion.pose_classifier.c_fc.weight.dtype
              == torch.float32 and session._codebook.quantizer.embeddings.dtype == torch.float32,
              'create_session: bf16 tower with f32 islands')
        launches = {'session': session_path(ac, session, log, card)}
        session_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del session
        torch.cuda.empty_cache()
        timing = create_session(jobs['transformer'], jobs['codebook'], batch_size=B,
                                max_frames=S - 1 + N_OBSERVE)
        session_times(timing, log, card)
        del timing
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches['evaluate'] = evaluate_path(ac, jobs, log, card)
        evaluate_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({'phase': 'serve_and_evaluate', 'card': card, 'setup_s': setup_s,
          'create_session_s': load_s, 'session_max_memory_allocated_gb': session_peak_gb,
          'evaluate_max_memory_allocated_gb': evaluate_peak_gb}, log)
    print(f'serve_and_evaluate: peak memory {session_peak_gb:.3f} GB (session, B={B}, '
          f'{S} frames), {evaluate_peak_gb:.3f} GB (evaluators) ({card})', flush=True)
    return launches


def codebook_dataset(path):
    """Phase 9's image dataset through the port's generate_dataset_from_loader:
    the colors loader at SIZE px, CB_SEQUENCES sequences of CB_FRAMES
    frames a split, at most CB_SHARD sequences a shard."""
    from viewformer_tpu_torch.data.dataset import generate_dataset_from_loader
    from viewformer_tpu_torch.data.loaders import build

    for split, n in CB_SEQUENCES.items():
        loader = build('colors', split=split, num_sequences=n, sequence_size=CB_FRAMES,
                       image_size=SIZE)
        generate_dataset_from_loader(loader, split, os.path.join(path, 'colors'),
                                     max_sequences_per_shard=CB_SHARD, progress=False)
    return path


def random_lpips():
    """LPIPS with seeded random weights (not calibrated: the calibrated npz
    is not in the repository)."""
    from viewformer_tpu_torch.models.lpips import LPIPS, random_lpips_params

    return LPIPS(random_lpips_params(torch.Generator().manual_seed(0)))


def codebook_frames(data, n, split='test'):
    """The first n frames of a split of the image dataset, uint8 numpy."""
    from viewformer_tpu_torch.data.dataset import read_dataset

    frames = np.concatenate([item['frames'] for item in read_dataset(data, split)])
    return frames[:n]


def codebook_step_split(config, lpips, batch):
    """One full-width codebook train step run stage by stage, each stage
    timed with CUDA events (device ms): the encoder, the quantizer (code
    search and EMA update), the decoder and the loss with LPIPS forward;
    then the backward of the loss (LPIPS and L1), of the decoder and of the
    encoder (each with its remat recompute), and the Adam update. The
    stages are cut at detached tensors, so the gradients are those of the
    fused step; the loss is train/codebook's own codebook_loss."""
    from viewformer_tpu_torch.ops.image import normalize_images
    from viewformer_tpu_torch.ops.quantizer import quantize_ema
    from viewformer_tpu_torch.train.codebook import codebook_loss, init_codebook_state

    model, state = init_codebook_state(config, torch.Generator().manual_seed(2))
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    for _ in range(2):  # the first run picks the cuDNN algorithms
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        mark('start')
        x = normalize_images(batch).float()
        h = model._latents(x)
        mark('encoder')
        h_in = h.detach().requires_grad_()
        quant, e_latent_loss, codes = quantize_ema(model.quantizer, h_in, training=True)
        mark('quantizer')
        quant_in = quant.detach().requires_grad_()
        dec = model.decode(quant_in)
        mark('decoder')
        dec_in = dec.detach().requires_grad_()
        loss, _metrics = codebook_loss(config, lpips, x, dec_in, e_latent_loss, codes)
        mark('lpips_and_loss')
        loss.backward()
        mark('loss_backward')
        dec.backward(dec_in.grad)
        mark('decoder_backward')
        quant.backward(quant_in.grad)  # the straight-through path into h_in
        h.backward(h_in.grad)
        mark('encoder_backward')
        state.optimizer.step()
        mark('optimizer')
        torch.cuda.synchronize()
    names = list(events)
    split = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
    del model, state
    torch.cuda.empty_cache()
    return split


def codebook_card_vs_cpu(config, lpips, frames, log):
    """Phase 9 item 3: CB_COMPARE_STEPS train steps of CB_COMPARE_B frames
    from the same weights on the card (bf16 compute, remat) and on the CPU
    (f32): the first step's loss, gradients and EMA codebook, then the
    parameters' moves."""
    from viewformer_tpu_torch.ops.image import normalize_images
    from viewformer_tpu_torch.train.codebook import init_codebook_state, make_codebook_train_step

    names = ('encoder.conv_in.weight', 'encoder.mid_attn_1.q.weight', 'quant_conv.weight',
             'decoder.conv_in.weight', 'decoder.up_0_block_1.conv2.weight',
             'decoder.conv_out.weight')
    batches = [torch.from_numpy(frames[i * CB_COMPARE_B:(i + 1) * CB_COMPARE_B])
               for i in range(CB_COMPARE_STEPS)]
    runs = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', torch.float32)):
        model, state = init_codebook_state(config, torch.Generator().manual_seed(1), dtype,
                                           device, remat=device == 'cuda')
        where = next(model.parameters()).device
        step = make_codebook_train_step(model, config, copy.deepcopy(lpips).to(where))
        params = dict(model.named_parameters())
        initial = {name: params[name].detach().cpu().clone() for name in names}
        with torch.no_grad():
            _, codes = model.encode(normalize_images(batches[0].to(where)))
        t0 = time.perf_counter()
        state, metrics = step(state, batches[0].to(where))
        losses = [metrics['total_loss'].item()]
        first_step_s = time.perf_counter() - t0
        grads = {name: params[name].grad.detach().cpu().clone() for name in names}
        embeddings = model.quantizer.embeddings.detach().cpu().clone()
        for batch in batches[1:]:
            state, metrics = step(state, batch.to(where))
            losses.append(metrics['total_loss'].item())
        moved = {name: params[name].detach().cpu() - initial[name] for name in names}
        runs[device] = (losses, grads, moved, codes.cpu(), embeddings, first_step_s,
                        model.quantizer.counter.item())
        del model, state, params
    torch.cuda.empty_cache()

    def cosine(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    card, cpu = runs['cuda'], runs['cpu']
    loss_rel = abs(card[0][0] - cpu[0][0]) / abs(cpu[0][0])
    grad_cosine = {name: cosine(card[1][name], cpu[1][name]) for name in names}
    update_cosine = {name: cosine(card[2][name], cpu[2][name]) for name in names}
    # a latent whose code differs moves both codes' EMA columns: those are
    # left out; every other column is an average over the same latents
    differ = card[3] != cpu[3]
    moved_codes = torch.unique(torch.cat([card[3][differ], cpu[3][differ]]))
    keep = torch.ones(card[4].shape[1], dtype=torch.bool)
    keep[moved_codes] = False
    ema_rel = ((card[4][:, keep] - cpu[4][:, keep]).abs().max()
               / cpu[4][:, keep].abs().max()).item()
    codes_equal = 1.0 - differ.float().mean().item()
    emit({'phase': 'codebook_card_vs_cpu', 'batch': CB_COMPARE_B, 'steps': CB_COMPARE_STEPS,
          'card_losses': card[0], 'cpu_losses': cpu[0], 'loss_rel_err': loss_rel,
          'loss_tol': TRAIN_LOSS_TOL, 'grad_cosine': grad_cosine, 'grad_cosine_min': GRAD_COSINE,
          'update_cosine': update_cosine, 'update_cosine_min': UPDATE_COSINE,
          'codes_equal_fraction': codes_equal, 'codes_equal_min': CB_CODES_EQUAL,
          'ema_columns_compared': int(keep.sum()), 'ema_rel_err': ema_rel, 'ema_tol': EMA_TOL,
          'counters': [card[6], cpu[6]], 'card_first_step_s': card[5],
          'cpu_first_step_s': cpu[5]}, log)
    check(all(np.isfinite(card[0])), f'non-finite card losses {card[0]}')
    check(loss_rel <= TRAIN_LOSS_TOL, f'codebook: card loss differs from CPU by {loss_rel}')
    for name in names:
        check(grad_cosine[name] >= GRAD_COSINE,
              f'codebook {name}: gradient cosine {grad_cosine[name]} < {GRAD_COSINE}')
        check(update_cosine[name] >= UPDATE_COSINE,
              f'codebook {name}: update cosine {update_cosine[name]} < {UPDATE_COSINE}')
    check(codes_equal >= CB_CODES_EQUAL, f'codebook: {codes_equal} of the codes equal')
    check(ema_rel <= EMA_TOL, f'codebook: EMA embeddings differ by {ema_rel} (relative)')
    check(card[6] == cpu[6] == CB_COMPARE_STEPS, f'EMA counters {card[6]}, {cpu[6]}')


def generate_codes_check(data, job, out, log, card):
    """Phase 9 item 4: generate_codes at CB_BATCH over every shard, timed,
    its device encode time by CUDA events; then its codes against a direct
    encode of each shard's frames in the same batches (the tail padded)."""
    from viewformer_tpu_torch.commands import generate_codes as gc
    from viewformer_tpu_torch.config import load_config
    from viewformer_tpu_torch.data.dataset import get_dataset_info, read_dataset
    from viewformer_tpu_torch.models import load_model
    from viewformer_tpu_torch.ops.image import normalize_images

    encodes, loads = [], []
    dispatch, load = gc.LatentCodeTransformer._dispatch, gc.load_model

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return out

    def timed_dispatch(self, frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = dispatch(self, frames)
        end.record()
        encodes.append((start, end, len(frames)))
        return out

    gc.LatentCodeTransformer._dispatch, gc.load_model = timed_dispatch, timed_load
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gc.generate_codes(data, out, job, batch_size=CB_BATCH, progress=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        gc.LatentCodeTransformer._dispatch, gc.load_model = dispatch, load
    t0 = time.perf_counter()
    info = get_dataset_info(data)
    frames_total = sum(len(item['frames']) for split in CB_SEQUENCES
                       for item in read_dataset(data, split))
    read_decode_s = time.perf_counter() - t0
    encode_ms = sum(a.elapsed_time(b) for a, b, _ in encodes)

    codebook = load_model(job, torch.bfloat16, 'cuda')
    mismatched, padded = 0, 0
    for split in CB_SEQUENCES:
        for shard in range(1, info[f'{split}_size'] + 1):
            frames = np.concatenate([item['frames'] for item in
                                     read_dataset(data, split, shards=[shard])])
            written = np.concatenate([item['codes'] for item in
                                      read_dataset(out, split, shards=[shard])])
            direct = []
            for i in range(0, len(frames), CB_BATCH):
                batch = frames[i:i + CB_BATCH]
                n = len(batch)
                if n < CB_BATCH:
                    padded += 1
                    batch = np.concatenate([batch, np.zeros((CB_BATCH - n,) + batch.shape[1:],
                                                            batch.dtype)])
                with torch.inference_mode():
                    _, codes = codebook.encode(normalize_images(
                        torch.from_numpy(batch).to(codebook.quant_conv.weight.device)))
                direct.append(codes[:n].cpu().numpy())
            direct = np.concatenate(direct)
            check(written.shape == direct.shape, f'{split} shard {shard}: codes {written.shape}')
            mismatched += int((written != direct).sum())
    out_info = get_dataset_info(out)
    emit({'phase': 'generate_codes', 'card': card, 'batch': CB_BATCH, 'frames': frames_total,
          'encode_calls': len(encodes), 'padded_batches': padded, 'run_s': run_s,
          'frames_per_s': frames_total / run_s, 'load_model_s': loads[0],
          'frames_per_s_after_load': frames_total / (run_s - loads[0]),
          'encode_device_ms': encode_ms,
          'read_and_decode_s': read_decode_s, 'mismatched_codes': mismatched,
          'token_image_size': out_info['token_image_size']}, log)
    print(f'generate_codes: {frames_total / run_s:.1f} frames/s at batch {CB_BATCH} '
          f'(load_model {loads[0]:.3f} s and device encode {encode_ms / 1000:.3f} s of '
          f'{run_s:.3f} s; reading and decoding the frames alone {read_decode_s:.3f} s) '
          f'({card})', flush=True)
    check(mismatched == 0, f'generate_codes: {mismatched} codes differ from a direct encode')
    check(padded >= 1, 'generate_codes: no tail batch was padded')
    check(out_info['token_image_size'] == SIZE // load_config(job).stride,
          f'token_image_size {out_info}')
    del codebook
    torch.cuda.empty_cache()


def codebook_pipeline(ac, log, card):
    """Phase 9. Returns the launch counts of the pipeline."""
    from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig
    from viewformer_tpu_torch.data.loaders import build
    from viewformer_tpu_torch.evaluate.codebook import evaluate_codebook
    from viewformer_tpu_torch.train import checkpoint as ckpt_mod
    from viewformer_tpu_torch.train import codebook as cb
    from viewformer_tpu_torch.train import transformer as ttt

    config = VQGANConfig()
    check((config.ch, config.ch_mult, config.n_embed, config.image_size)
          == (128, [1, 1, 2, 2, 4], 1024, SIZE), f'VQGANConfig() is {config}')
    lpips = random_lpips()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_codebook_')
    try:
        t0 = time.perf_counter()
        data = codebook_dataset(os.path.join(tmp, 'images'))
        dataset_s = time.perf_counter() - t0
        job = os.path.join(tmp, 'codebook')

        # the main path: train_codebook, with CUDA events at each step's end
        ends, make, load = [], cb.make_codebook_train_step, cb.load_lpips

        def instrumented(*args):
            step = make(*args)

            def run(state, batch):
                out = step(state, batch)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                ends.append(end)
                return out
            return run

        cb.make_codebook_train_step, cb.load_lpips = instrumented, lambda net='vgg': lpips
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ac.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            model, state = cb.train_codebook(
                config, data, job, total_steps=CB_STEPS, epochs=CB_EPOCHS, batch_size=CB_BATCH,
                accumulate_grad_batches=CB_ACCUMULATE, num_val_batches=1, log_every=1,
                progress=False, profile_batch=0)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            cb.make_codebook_train_step, cb.load_lpips = make, load
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counter = model.quantizer.counter.item()
        check(next(model.parameters()).dtype == torch.float32 and model.dtype == torch.bfloat16,
              'train_codebook: f32 master weights, bf16 compute')
        del model, state
        torch.cuda.empty_cache()
        metrics = read_metrics(job)
        records = [metrics[step, 'train'] for step in range(1, CB_STEPS + 1)]
        vals = [metrics[step, 'val'] for step in sorted(s for s, kind in metrics
                                                          if kind == 'val')]
        gaps = [a.elapsed_time(b) / 1000 for a, b in zip(ends, ends[1:])]

        # the bare step and a split of one step by stage
        frames = codebook_frames(data, CB_BATCH, split='train')
        batch = torch.from_numpy(frames).cuda()
        bare_model, bare_state = cb.init_codebook_state(config, torch.Generator().manual_seed(3))
        bare_step = cb.make_codebook_train_step(bare_model, config,
                                                lpips.to(next(bare_model.parameters()).device))
        bare_step(bare_state, batch)
        bare_ms = time_ms(lambda: bare_step(bare_state, batch), n=3)
        del bare_model, bare_state, bare_step
        torch.cuda.empty_cache()
        split = codebook_step_split(config, lpips, batch)
        del batch

        codebook_card_vs_cpu(config, lpips, frames, log)
        codes = os.path.join(tmp, 'codes')
        generate_codes_check(data, job, codes, log, card)

        # train the transformer on the generated codes, then evaluate the codebook
        tconfig = MIGTConfig()
        record, restore = instrument_loop(ac, ttt, ckpt_mod)
        try:
            _, tstate = ttt.train_transformer(
                tconfig, codes, os.path.join(tmp, 'transformer'), codebook_path=job,
                total_steps=PIPE_STEPS, epochs=1, batch_size=PIPE_TRAIN_B, log_every=1,
                progress=False, profile_batch=0)
        finally:
            restore()
        check(tstate.step == PIPE_STEPS, f'train_transformer ended at step {tstate.step}')
        del tstate
        torch.cuda.empty_cache()
        tmetrics = read_metrics(os.path.join(tmp, 'transformer'))
        before = counts(ac)
        result = evaluate_codebook(build('dataset', path=data, split='test'), job,
                                   os.path.join(tmp, 'evaluate'), batch_size=CB_EVAL_IMAGES,
                                   num_eval_images=CB_EVAL_IMAGES, num_store_images=0,
                                   progress=False)
        eval_launches = {name: n - before[name] for name, n in counts(ac).items()}
        launches = counts(ac)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    per_train = only(ac, block_causal_attention_dropout_fwd=2 * tconfig.n_layer,
                     branch_attention_dropout_fwd=2 * tconfig.n_layer,
                     block_causal_attention_dropout_bwd=tconfig.n_layer - 1,
                     branch_attention_dropout_bwd=tconfig.n_layer)
    per_eval = only(ac, block_causal_attention_fwd=tconfig.n_layer,
                    branch_attention_fwd=tconfig.n_layer)
    losses = [r['train/total_loss'] for r in records]
    step_s = statistics.median(gaps)
    emit({'phase': 'codebook_pipeline', 'card': card, 'image_size': SIZE,
          'sequences': CB_SEQUENCES, 'frames_per_sequence': CB_FRAMES, 'batch': CB_BATCH,
          'accumulate_grad_batches': CB_ACCUMULATE, 'steps': CB_STEPS, 'epochs': CB_EPOCHS,
          'lpips': 'random weights, seed 0 (not calibrated)', 'dataset_s': dataset_s,
          'train_s': train_s, 'step_end_gaps_s': gaps, 'step_s_median': step_s,
          'images_per_s': CB_BATCH * CB_ACCUMULATE / step_s, 'bare_step_s': bare_ms / 1000,
          'bare_images_per_s': CB_BATCH / (bare_ms / 1000), 'step_split_ms': split,
          'max_memory_allocated_gb': peak_gb, 'ema_counter': counter,
          'train_records': records, 'val_records': vals,
          'transformer_records': {f'{s} {k}': v for (s, k), v in tmetrics.items()},
          'transformer_launches_per_train_step': [r['launches'] for r in record['train']],
          'transformer_launches_per_eval_step': [r['launches'] for r in record['eval']],
          'expected_per_train_step': per_train, 'expected_per_eval_step': per_eval,
          'evaluate_codebook': result, 'evaluate_codebook_launches': eval_launches,
          'launches': launches}, log)
    print(f'codebook_pipeline: step {step_s:.4f} s (median gap), bare {bare_ms / 1000:.4f} s, '
          f'{CB_BATCH * CB_ACCUMULATE / step_s:.1f} images/s, peak {peak_gb:.2f} GB, split '
          + ', '.join(f'{k} {v:.1f} ms' for k, v in split.items()) + f' ({card})', flush=True)
    check(counter == CB_STEPS, f'EMA counter {counter} after {CB_STEPS} steps')
    for r in records:
        for key in ('total_loss', 'rec_loss', 'quant_loss', 'p_loss', 'perplexity'):
            check(np.isfinite(r[f'train/{key}']), f'codebook step {r["step"]}: {key} not finite')
    check(records[0]['train/p_loss'] > 0, 'codebook: the LPIPS term did not run')
    check(len(vals) == CB_EPOCHS and all(np.isfinite(v['val/psnr']) for v in vals),
          f'codebook validation records {vals}')
    check(all(np.isfinite(tmetrics[s, 'train']['train/loss']) for s in range(1, PIPE_STEPS + 1)),
          'transformer on the generated codes: non-finite loss')
    check(np.isfinite(tmetrics[PIPE_STEPS, 'val'].get('val/psnr', np.nan)),
          'transformer on the generated codes: no finite val/psnr')
    check(len(record['train']) == PIPE_STEPS and len(record['eval']) == 1,
          f'{len(record["train"])} train and {len(record["eval"])} eval steps')
    for i, r in enumerate(record['train'], 1):
        check(r['launches'] == per_train, f'pipeline train step {i} launches {r["launches"]}')
    for r in record['eval']:
        check(r['launches'] == per_eval, f'pipeline eval step launches {r["launches"]}')
    check(all(v == 0 for v in eval_launches.values()), f'evaluate codebook {eval_launches}')
    check(all(launches[name] == PIPE_STEPS * per_train[name] + per_eval[name]
              for name in launches), f'codebook pipeline launch counts {launches}')
    check(np.isfinite(result['psnr']) and result['lpips'] is None,
          f'evaluate codebook {result}')
    return launches


def resize_check(log, card):
    """Phase 10, item 1: ops/image.resize of seeded uint8 frames on the card
    against the same call on the CPU (the reference preprocessing), byte for
    byte, with the count of differing bytes and the largest difference; then
    upload_frames to the card, which must give the CPU's bytes (it resizes
    on the host), so no frame of the phase is resized on the card."""
    from viewformer_tpu_torch.ops.image import resize, upload_frames

    rng = np.random.RandomState(10)
    cases = (('640x480->128 bilinear', (16, 480, 640, 3), 'bilinear'),
             ('256->128 bilinear', (32, 256, 256, 3), 'bilinear'),
             ('64->128 nearest', (32, 64, 64, 3), 'nearest'))
    record = {}
    for name, shape, method in cases:
        frames = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
        on_cpu = resize(frames, SIZE, method)
        on_card = resize(frames.cuda(), SIZE, method).cpu()
        diff = (on_card.int() - on_cpu.int()).abs()
        record[name] = {'frames': list(shape), 'bytes': diff.numel(),
                        'differing_bytes': int((diff > 0).sum()), 'max_abs_diff': int(diff.max())}
        if record[name]['differing_bytes']:
            at = tuple(int(i) for i in torch.nonzero(diff)[0])
            record[name].update(first_difference_at=at, cpu_value=int(on_cpu[at]),
                                card_value=int(on_card[at]))
        uploaded = upload_frames(frames.numpy(), SIZE, 'cuda').cpu()
        record[name]['upload_frames_differing_bytes'] = int((uploaded != on_cpu).sum())
        print(f'resize {name}: {record[name]["differing_bytes"]} of {diff.numel()} bytes differ '
              f'between the card and the CPU, max |diff| {record[name]["max_abs_diff"]}; '
              f'upload_frames: {record[name]["upload_frames_differing_bytes"]} differ ({card})',
              flush=True)
    emit({'phase': 'resize_card_vs_cpu', 'card': card, 'cases': record}, log)
    for name, r in record.items():
        check(r['upload_frames_differing_bytes'] == 0,
              f'upload_frames resized {name} otherwise than the CPU')


def write_sevenscenes(path, seed=0):
    """chess.zip in the 7-Scenes layout under path: TrainSplit.txt (sequences
    1 and 2, SEVEN_TRAIN frames), TestSplit.txt (sequence 3, SEVEN_TEST
    frames) and seq-0N.zip of frame-NNNNNN.color.png (SEVEN_W x SEVEN_H: a
    seeded sinusoid gradient plus 8x8-pixel blocks of noise, so that the
    PNGs stay small) and frame-NNNNNN.pose.txt (camera to world: a random
    rotation, and a position on a random walk)."""
    import io
    import zipfile

    from PIL import Image

    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:SEVEN_H, 0:SEVEN_W]
    sizes = {1: SEVEN_TRAIN // 2, 2: SEVEN_TRAIN - SEVEN_TRAIN // 2, 3: SEVEN_TEST}
    with zipfile.ZipFile(os.path.join(path, 'chess.zip'), 'w') as scene:
        scene.writestr('chess/TrainSplit.txt', 'sequence1\nsequence2\n')
        scene.writestr('chess/TestSplit.txt', 'sequence3\n')
        for seq, n in sizes.items():
            buf, position = io.BytesIO(), rng.randn(3)
            with zipfile.ZipFile(buf, 'w') as z:
                for i in range(n):
                    phase = rng.uniform(0, 2 * np.pi, 3)
                    base = 127.5 + 100 * np.sin(x[..., None] / 97.0 + y[..., None] / 61.0 + phase)
                    noise = rng.randint(-12, 13, (SEVEN_H // 8, SEVEN_W // 8, 3))
                    noise = noise.repeat(8, 0).repeat(8, 1)
                    png = io.BytesIO()
                    Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8)).save(
                        png, 'PNG', compress_level=1)
                    z.writestr(f'frame-{i:06d}.color.png', png.getvalue())
                    q, r = np.linalg.qr(rng.randn(3, 3))
                    rotation = q * np.sign(np.diag(r))
                    rotation[:, 0] *= np.sign(np.linalg.det(rotation))
                    position = position + 0.05 * rng.randn(3)
                    pose = np.eye(4)
                    pose[:3, :3], pose[:3, 3] = rotation, position
                    z.writestr(f'frame-{i:06d}.pose.txt',
                               '\n'.join(' '.join(f'{v:.8e}' for v in row) for row in pose))
            scene.writestr(f'chess/seq-{seq:02d}.zip', buf.getvalue())


def device_share(fn):
    """(synced host s, device busy s) of one call of fn under torch.profiler:
    the busy time is the summed self time of its CUDA kernels and copies."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, sum(e.self_device_time_total for e in prof.key_averages()) / 1e6


def check_results(kind, results, keys):
    """results {row: {metric: value}} (or one row): the metrics are `keys`,
    finite but lpips, which is null."""
    for row in results.values():
        check(list(row) == keys, f'{kind}: results.json keys {list(row)}')
        for key, value in row.items():
            check(value is None if key == 'lpips' else np.isfinite(value), f'{kind}: {key} = {value}')


def sevenscenes_and_more(ac, log, card):
    """Phase 10. Returns the launch counts of its paths."""
    import random

    from viewformer_tpu_torch import models
    from viewformer_tpu_torch.config import load_config
    from viewformer_tpu_torch.data.loaders import build
    from viewformer_tpu_torch.data.dataset import generate_dataset_from_loader
    from viewformer_tpu_torch.evaluate import generate_images as egqn
    from viewformer_tpu_torch.evaluate import multictx_allimg as eallimg
    from viewformer_tpu_torch.evaluate import sevenscenes as e7
    from viewformer_tpu_torch.evaluate import sevenscenes_baseline as e7baseline
    from viewformer_tpu_torch.evaluate import sevenscenes_multictx as e7multictx

    resize_check(log, card)
    metrics = ['loc-angle', 'loc-dist', 'loc-angle-med', 'loc-dist-med',
               'mse', 'rmse', 'mae', 'psnr', 'lpips', 'ssim']  # the JAX package's keys
    contexts = [f'ctx{i:02d}' for i in range(1, S)]
    tmp = tempfile.mkdtemp(prefix='chip_smoke_7scenes_')
    record = {'phase': 'sevenscenes_and_more', 'card': card, 'train_frames': SEVEN_TRAIN,
              'test_frames': SEVEN_TEST, 'frame': [SEVEN_W, SEVEN_H], 'image_size': SIZE}
    launches, expected = {}, {}
    try:
        t0 = time.perf_counter()
        tjob = save_transformer(os.path.join(tmp, 'transformer'))
        cjob = save_codebook(os.path.join(tmp, 'codebook'))
        scenes = os.path.join(tmp, '7scenes')
        os.makedirs(scenes)
        write_sevenscenes(scenes)
        images = os.path.join(tmp, 'images')
        loader = build('colors', split='test', num_sequences=max(ALLIMG_SEQUENCES, GQN_SEQUENCES),
                       sequence_size=S, image_size=SIZE)
        generate_dataset_from_loader(loader, 'test', os.path.join(images, 'colors'),
                                     max_sequences_per_shard=len(loader), progress=False)
        record['setup_s'] = time.perf_counter() - t0
        n_layer = load_config(tjob).n_layer
        per_call = {
            'standard': only(ac, block_causal_attention_fwd=n_layer - 1,
                             branch_attention_fwd=2 * n_layer),
            'generated_images': only(ac, block_causal_attention_fwd=4 * n_layer),
            'pose_refinement': only(ac, block_causal_attention_fwd=2 * n_layer - 1,
                                    branch_attention_fwd=2 * n_layer),
            '7scenes-multictx': only(ac, block_causal_attention_fwd=n_layer,
                                     branch_attention_fwd=n_layer)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # evaluate 7scenes, standard: SEVEN_QUERIES queries in batches of B
        ac.reset_launch_counts()
        t0 = time.perf_counter()
        with record_calls(ac, models, 'load_model') as loads, \
                record_calls(ac, e7, 'SceneLookup') as lookups, \
                record_calls(ac, e7, 'generate_batch_predictions') as batches:
            result = e7.evaluate_sevenscenes(
                scenes, tjob, cjob, os.path.join(tmp, 'standard'), batch_size=B,
                scenes=['chess'], num_eval_sequences=SEVEN_QUERIES, num_context_views=S - 1,
                num_store_images=0, image_size=SIZE, progress=False)
        run_s = time.perf_counter() - t0
        launches['7scenes'] = counts(ac)
        check_results('7scenes standard', result, metrics)
        with open(os.path.join(tmp, 'standard', 'chess', 'results.json')) as f:
            check(json.load(f) == json.loads(json.dumps(result['chess'])),
                  'chess/results.json differs from the returned results')
        n_batches = -(-SEVEN_QUERIES // B)
        check(len(batches) == n_batches, f'7scenes standard: {len(batches)} batches')
        for i, b in enumerate(batches):
            check(b['launches'] == per_call['standard'], f'standard batch {i}: {b["launches"]}')
        batch_s = [b['s'] for b in batches]
        record['standard'] = {
            'queries': SEVEN_QUERIES, 'batch': B, 'run_s': run_s,
            'load_model_s': sum(c['s'] for c in loads), 'scene_lookup_s': lookups[0]['s'],
            'batch_s': batch_s,
            'host_s_outside_loads_lookup_and_batches': run_s - sum(c['s'] for c in loads)
            - lookups[0]['s'] - sum(batch_s),
            'launches_per_batch': [b['launches'] for b in batches], 'result': result['chess']}
        wall, busy = device_share(batches[0]['call'])
        record['standard'].update(profiled_batch_s=wall, device_busy_s=busy,
                                  device_share=busy / wall)
        first_lookup = e7.SceneLookup(scenes, 'chess', SIZE)  # held for card_vs_cpu below

        # the special procedures, SEVEN_SPECIAL queries each
        for procedure, fn, num_gen_ctx in (
                ('generated_images', 'generate_batch_predictions_using_generated_images', 5),
                ('pose_refinement', 'generate_batch_predictions_using_pose_refinement', 9)):
            ac.reset_launch_counts()
            with record_calls(ac, e7, fn) as queries:
                result = e7.evaluate_sevenscenes(
                    scenes, tjob, cjob, os.path.join(tmp, procedure), scenes=['chess'],
                    num_eval_sequences=SEVEN_SPECIAL, num_context_views=S - 1,
                    num_store_images=0, image_size=SIZE, progress=False,
                    generation_procedure=procedure, num_gen_ctx=num_gen_ctx)
            launches[f'7scenes {procedure}'] = counts(ac)
            check_results(f'7scenes {procedure}', result, metrics)
            check(len(queries) == SEVEN_SPECIAL, f'{procedure}: {len(queries)} queries')
            for i, q in enumerate(queries):
                check(q['launches'] == per_call[procedure], f'{procedure} query {i}: {q["launches"]}')
            wall, busy = device_share(queries[-1]['call'])
            record[procedure] = {'num_gen_ctx': num_gen_ctx, 'query_s': [q['s'] for q in queries],
                                 'launches_per_query': [q['launches'] for q in queries],
                                 'profiled_query_s': wall, 'device_busy_s': busy,
                                 'device_share': busy / wall, 'result': result['chess']}

        # the baselines: no model, no launch
        ac.reset_launch_counts()
        t0 = time.perf_counter()
        record['baselines'] = {
            baseline: e7baseline.evaluate_sevenscenes_baseline(
                scenes, os.path.join(tmp, baseline), scenes=['chess'], baseline=baseline,
                num_eval_sequences=SEVEN_TEST, progress=False)['chess']
            for baseline in ('mean', 'position_oracle', 'orientation_oracle')}
        record['baselines_s'] = time.perf_counter() - t0
        check(counts(ac) == only(ac), f'7scenes-baseline launched {counts(ac)}')
        check_results('7scenes-baseline', record['baselines'], metrics[:4])

        # 7scenes-multictx: SEVEN_QUERIES queries in batches of B
        ac.reset_launch_counts()
        with record_calls(ac, e7multictx, 'generate_batch_predictions') as batches:
            result = e7multictx.evaluate_sevenscenes_multictx(
                scenes, tjob, cjob, os.path.join(tmp, 'multictx'), batch_size=B,
                scenes=['chess'], num_eval_sequences=SEVEN_QUERIES, store_ctx=False,
                num_store_images=0, num_context_views=S - 1, image_size=SIZE, progress=False)
        launches['7scenes-multictx'] = counts(ac)
        check(list(result['chess']) == contexts, f'7scenes-multictx keys {list(result["chess"])}')
        check_results('7scenes-multictx', result['chess'], metrics)
        check(len(batches) == n_batches, f'7scenes-multictx: {len(batches)} batches')
        for i, b in enumerate(batches):
            check(b['launches'] == per_call['7scenes-multictx'],
                  f'7scenes-multictx batch {i}: {b["launches"]}')
        record['7scenes-multictx'] = {'batch_s': [b['s'] for b in batches],
                                      'launches_per_batch': [b['launches'] for b in batches]}

        # allimg: ALLIMG_SEQUENCES sequences with the default context (one
        # predict call a sequence), then one with keep_last_frame (S calls)
        dataset = lambda size: build('dataset', path=images, split='test',  # noqa: E731
                                     image_size=size)
        ac.reset_launch_counts()
        t0 = time.perf_counter()
        result = eallimg.evaluate_transformer_multictx_allimg(
            dataset, tjob, cjob, os.path.join(tmp, 'allimg'),
            num_eval_sequences=ALLIMG_SEQUENCES, progress=False)
        chained = eallimg.evaluate_transformer_multictx_allimg(
            dataset, tjob, cjob, os.path.join(tmp, 'allimg-chained'), context_views=[0],
            keep_last_frame=True, num_eval_sequences=1, progress=False)
        record['allimg_s'] = time.perf_counter() - t0
        launches['allimg'] = counts(ac)
        expected['allimg'] = only(ac, **{name: (ALLIMG_SEQUENCES + S) * n_layer for name in
                                         ('block_causal_attention_fwd', 'branch_attention_fwd')})
        check(launches['allimg'] == expected['allimg'], f'allimg launches {launches["allimg"]}')
        check(list(result) == contexts and list(chained) == ['ctx01'],
              f'allimg keys {list(result)}, {list(chained)}')
        check_results('allimg', result, metrics)
        check_results('allimg keep_last_frame', chained, metrics)
        trees = sorted(os.listdir(os.path.join(tmp, 'allimg', 'gen_images')))
        check(len(trees) == ALLIMG_SEQUENCES and len(os.listdir(os.path.join(
            tmp, 'allimg', 'gen_images', trees[0], f'gen-{S - 1:02d}'))) == S,
            f'allimg image tree {trees}')

        # generate-gqn-images: GQN_SEQUENCES sequences, 3 context frames each
        ac.reset_launch_counts()
        t0 = time.perf_counter()
        egqn.generate_gqn_images(images, os.path.join(tmp, 'gqn'), tjob, cjob,
                                 num_eval_sequences=GQN_SEQUENCES, progress=False)
        record['gqn_s'] = time.perf_counter() - t0
        launches['generate-gqn-images'] = counts(ac)
        expected['generate-gqn-images'] = {name: GQN_SEQUENCES * n
                                           for name, n in per_call['standard'].items()}
        check(launches['generate-gqn-images'] == expected['generate-gqn-images'],
              f'generate-gqn-images launches {launches["generate-gqn-images"]}')
        check(sorted(os.listdir(os.path.join(tmp, 'gqn'))) == sorted(
            [f'{kind}{i}.png' for i in range(GQN_SEQUENCES) for kind in ('gen', 'gt')]
            + [f'c{i}_{j}.png' for i in range(GQN_SEQUENCES) for j in range(3)]),
            'generate-gqn-images files')
        record['max_memory_allocated_gb'] = torch.cuda.max_memory_allocated() / 1e9

        # card against CPU: one standard query (19 sampled train frames, then
        # the first test frame), bf16 kernels against the plain f32 twins
        test = build('sevenscenes', path=scenes, split='test', scenes=['chess'],
                     sequence_size=1, image_size=SIZE)[0]
        context = random.Random(42).sample(first_lookup.files, S - 1)
        cameras, frames = (np.stack(x, 0) for x in zip(*(first_lookup[f] for f in context)))
        frames = np.concatenate([frames, np.asarray(test['frames'])], 0)[None]
        cameras = np.concatenate([cameras, test['cameras']], 0)[None].astype(np.float32)
        card_vs_cpu((models.load_model(tjob, torch.bfloat16, 'cuda'),
                     models.load_model(cjob, torch.bfloat16, 'cuda')),
                    (models.load_model(tjob, torch.float32, 'cpu'),
                     models.load_model(cjob, torch.float32, 'cpu')),
                    log, frames, cameras, phase='sevenscenes_card_vs_cpu')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record.update(launches=launches, expected_per_call=per_call, expected=expected)
    emit(record, log)
    print(f'7scenes: SceneLookup of {SEVEN_TRAIN} frames {record["standard"]["scene_lookup_s"]:.3f} s; '
          f'standard batch of {B} {statistics.median(record["standard"]["batch_s"]):.4f} s '
          f'(device share {record["standard"]["device_share"]:.3f}), run '
          f'{record["standard"]["run_s"]:.3f} s; generated_images query '
          f'{statistics.median(record["generated_images"]["query_s"]):.4f} s (device share '
          f'{record["generated_images"]["device_share"]:.3f}); pose_refinement query '
          f'{statistics.median(record["pose_refinement"]["query_s"]):.4f} s (device share '
          f'{record["pose_refinement"]["device_share"]:.3f}); peak '
          f'{record["max_memory_allocated_gb"]:.3f} GB ({card})', flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false; '
                         'this script runs only on a CUDA device')
    sys.path.insert(0, ROOT)
    from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig
    from viewformer_tpu_torch.models import AutoModel
    from viewformer_tpu_torch.ops import attention_cuda as ac

    log = []
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = ac.build()
    build_s = time.perf_counter() - t0
    ptxas = ac.build_log().splitlines()
    emit({'phase': 'build', 'card': card, 'torch': torch.__version__,
          'cuda': torch.version.cuda,
          'libraries': [os.path.relpath(path, ROOT) for path in libs.values()],
          'seconds': build_s, 'ptxas': ptxas}, log)
    spills = [line for line in ptxas if re.search(r'[1-9][0-9]* bytes spill', line)]
    check(not spills, f'ptxas reports register spills: {spills}')

    kernels = kernel_checks(ac, log)

    def build_models(dtype, device):
        gen = torch.Generator().manual_seed(0)
        return (AutoModel.from_config(MIGTConfig(), dtype, device, gen),
                AutoModel.from_config(VQGANConfig(), dtype, device, gen))

    models = build_models(torch.bfloat16, 'cuda')
    launches = {'serve': main_path(ac, models, log, card)}
    card_vs_cpu(models, build_models(torch.float32, 'cpu'), log)
    del models
    torch.cuda.empty_cache()

    config = MIGTConfig()  # the default recipe: dropout 0.1
    check(config.dropout == RATE, f'MIGTConfig().dropout is {config.dropout}, not {RATE}')
    launches['train_dropout_0.1'] = train_path(ac, config, log, card, TRAIN_STEPS)
    no_dropout = dataclasses.replace(config, dropout=0.0)
    launches['train_dropout_0'] = train_path(ac, no_dropout, log, card, TRAIN_STEPS_NO_DROPOUT)
    train_card_vs_cpu(no_dropout, log)
    train_card_vs_cpu(dataclasses.replace(config, n_layer=COMPARE_DROPOUT_LAYERS), log)
    launches['train_loop'] = train_loop(ac, config, log, card)
    torch.cuda.empty_cache()
    launches.update(serve_and_evaluate(ac, log, card))
    torch.cuda.empty_cache()
    launches['codebook_pipeline'] = codebook_pipeline(ac, log, card)
    torch.cuda.empty_cache()
    launches.update(sevenscenes_and_more(ac, log, card))

    csrc = 'viewformer_tpu_torch/csrc/'
    sources = {
        'block_causal_attention_fwd': (csrc + 'attention_fwd_sm90.cu', ':52'),
        'branch_attention_fwd': (csrc + 'attention_fwd_sm90.cu', ':69'),
        'block_causal_attention_bwd': (csrc + 'attention_bwd_sm90.cu', ':149'),
        'branch_attention_bwd': (csrc + 'attention_bwd_sm90.cu', ':182'),
        'block_causal_attention_dropout_fwd': (csrc + 'attention_fwd_sm90.cu', ':331'),
        'block_causal_attention_dropout_bwd': (csrc + 'attention_bwd_sm90.cu', ':347'),
        'branch_attention_dropout_fwd': (csrc + 'attention_fwd_sm90.cu', ':381'),
        'branch_attention_dropout_bwd': (csrc + 'attention_bwd_sm90.cu', ':414'),
    }
    summary = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': sources[name][0],
         'replaces': 'viewformer_tpu/ops/attention_pallas.py' + sources[name][1],
         'launches': sum(path[name] for path in launches.values()),
         'launches_by_path': {path: counts[name] for path, counts in launches.items()},
         **{key: record[key] for key in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                                         'bound_by', 'library_ms')}}
        for name, record in kernels.items()]}
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
