#!/usr/bin/env python3
"""Smoke run of the PyTorch port (viewformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Refuses to run without a CUDA device. Phases, each printing a JSON line:
  1. the card's name and power limit; build the CUDA kernels from
     viewformer_tpu_torch/csrc (one nvcc a source, in parallel, sm_90a),
     print the build time and check that ptxas reports no register spills;
     build the native host codec from csrc/host (g++; data/native.py);
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
     the parameters the same way: at dropout 0.0 with 4 layers, and at
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
     with the device's busy share (torch.profiler), and the peak memory;
 11. the released-checkpoint path and the CO3D evaluators
     (released_checkpoints_and_co3d), under a temporary HOME: random-weight
     VQGANConfig() codebooks (RGB, and RGBA for CO3Dv2) saved as
     `*-codebook-th` dirs (config.json and a Lightning {'state_dict': ...}
     model.ckpt in the reference's torch names, made by an inverse map kept
     here, with perceptual_loss.* tensors to be dropped), the RGB one tarred
     and installed by `download-model --from-file`, then load_model of its
     name on the card, bit for bit; an MIGTConfig() transformer as the raw
     keys of a Keras checkpoint (with optimizer and save_counter entries)
     through resolve_keras_object_paths and import_migt_from_tf into an
     MIGT on the card, bit for bit, installed as a `*-transformer-tf` dir
     (a TF checkpoint where tensorflow imports; else load_model reads it
     through a stand-in read_tf_checkpoint, and a line says so); `model
     info` of both (totals equal to the models' element counts); evaluate
     co3d (bf16) over a stub of the co3d harness written here (2
     categories x 2 sequences of S frames at SIZE px, target first, a stub
     lpips on the card) and evaluate co3dv2-challenge with the RGBA codebook
     over a written CO3Dv2 tree (640x480 PNGs and masks, 16-bit depths of
     320x240; 2 eval batches of S frames and a stub CO3DSubmission):
     results.json keys and finite values, one add_result a batch at the
     depth's resolution with a 0/1 mask, exact launches a batch; one CO3D
     batch on the card (bf16) against the CPU (f32), logits within
     LOGITS_TOL; prints the seconds of torch.load and of the import of each
     checkpoint, of a batch of each evaluator with the device's busy share,
     and the peak memory;
 12. every remat policy, data parallel and the rest of the CLI
     (remat_ddp_and_cli): (a) the default recipe (MIGTConfig(), dropout
     0.1, B=64, S=20) for 3 steps under each remat policy (full twice,
     attn, attn_mlp, dots, nothing) from the same weights, batches and seed
     words: the losses and parameters of each policy against full's (bit
     for bit when full repeats bit for bit), the step seconds, the peak
     memory and the exact launches of B1-B8 (B5/B7 once a layer and step
     under attn and attn_mlp, twice under the others); (b) train_transformer
     (MIGTConfig() at 2 layers, 2 steps of 64 sequences) and train_codebook
     (VQGANConfig(), 2 steps of 32 images, random LPIPS) in an NCCL process
     group of one rank, initialized here, against the same runs without a
     process group: parameters and losses bit for bit, exact launches, and
     the group's job dirs restore the final parameters; (c) `dataset
     shuffle` over (b)'s image dataset (the records, undecoded, in another
     order within the shard limit), `visualize codebook --output` with a
     random-weight VQGANConfig() codebook on the card (the grid's originals
     and reconstructions against a direct reconstruction), and `dataset
     visualize`: its PNG where matplotlib imports, else the ImportError
     that says it is missing (a line says which);
 13. the data axis of inference and the host codec
     (data_axis_and_host_codec): (a) phase 9's image dataset (1056 frames
     at 128 px) and random-weight MIGTConfig() and VQGANConfig() job dirs;
     generate-codes (batch 352) and evaluate transformer,
     transformer-multictx (16 sequences a batch, S = 20) and codebook (64
     frames a batch) through the CLI over its train split, once without a
     process group and once under torchrun's environment (the CLI joins a
     one-rank NCCL group): every shard, results.json and stored file
     byte-equal, the JAX package's keys, frames/s, seconds a batch, the
     device's busy share and exact launches a batch (11 B1 + 24 B2 for
     evaluate transformer); (b) the native int64 decode that phase 1 built
     (vfcodec must build: g++ is nvcc's host compiler) on phase 7's token
     shards against the pure-Python decode, record by record, with host ms
     of each;
 14. the model and seq axes of training (model_and_seq_axes): (a) a probe
     of whether two ranks share card 0 (NCCL refuses two ranks on one
     device): gloo's all_reduce, all_gather and reduce_scatter of CUDA
     tensors in 2 spawned processes, and a line that says whether they
     did; (b) if they did, the 2 ranks over gloo on the card, at full width
     (MIGTConfig(): d 768, 12 heads, 20 frames) with MESH_LAYERS layers and
     MESH_B sequences: the meshes 1x1x2 (tensor parallel) and 1x2x1
     (context parallel) at dropout 0 and 0.1, MESH_STEPS steps each from
     the same weights and batch against rank 0's one-process steps before
     it joined (at dropout 0.1 on 1x1x2, one process drawing each head
     group's attention mask with its shard's seed words,
     shard_seeded_attention): the loss within MESH_LOSS_TOL, every
     gradient's cosine at least MESH_GRAD_COSINE and its norm within
     MESH_GRAD_NORM_TOL of the reference's, the parameter updates'
     (compared()) at least MESH_UPDATE_COSINE, the replicas bit-equal and
     the exact launches of B1-B8 a rank; otherwise a line that names the
     CPU tests and the 4-card run that hold those; (c) either way, the
     default recipe (B=64, S=20, 12 layers) timed in a one-rank NCCL group
     on create_mesh's 1x1x1 mesh against the plain step: losses bit-equal,
     exact launches;
 15. the colors quality gate of the port, --quick (quality_gate_quick):
     `python -m viewformer_tpu_torch.tools.quality_gate --quick --device
     cuda` in a temporary workdir, every stage a process of the CLI on the
     card (dataset generate, train codebook, generate-codes, train
     transformer at dropout 0.1, the three evaluators, the finetune leg and
     its evaluation; the f32 evaluation on the CPU) at the kernels' shapes
     (8x8-token frames of 128 px, one head of 64, two layers): exit code 0,
     the report's keys, a finite PSNR, the finetune leg's steps continuing
     from the restored step, and every kernel of the path (B1, B2, B5-B8)
     launched, each stage's launches appended to a file by the stage
     itself (VIEWFORMER_LAUNCH_COUNTS); prints the gate's seconds.
Any failed check raises, so the exit code is not 0. The last line is
{"ok": true, "device": {...}}; the full record goes to chiprun_out/chip_smoke.json.
"""
import contextlib
import copy
import dataclasses
import importlib
import io
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
COMPARE_LAYERS = 4  # phase 6 at dropout 0: every kernel; the CPU's time grows with the depth
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
# Phase 12: REMAT_STEPS default-recipe steps of TRAIN_B sequences under each
# of REMAT_POLICIES (warmup_steps=1: the first update at lr 0); the data
# parallel runs of train_transformer at DDP_LAYERS layers for DDP_STEPS
# steps of TRAIN_B sequences, and of train_codebook for DDP_STEPS steps of
# DDP_CB_BATCH images from DDP_CB_SEQUENCES colors sequences a split of
# CB_FRAMES frames; `visualize codebook` over VIZ_IMAGES frames.
REMAT_POLICIES, REMAT_STEPS = ('full', 'attn', 'attn_mlp', 'dots', 'nothing'), 3
DDP_LAYERS, DDP_STEPS, DDP_CB_BATCH = 2, 2, 32
DDP_CB_SEQUENCES, VIZ_IMAGES = {'train': 4, 'test': 2}, 16
# Phase 13: generate-codes over phase 9's image dataset at CB_BATCH, and
# the evaluators over its train split (CB_SEQUENCES['train'] sequences cut
# to S frames) in batches of AXIS_BATCH sequences (the codebook's of
# CODEBOOK_BATCH frames), storing AXIS_STORE samples each.
AXIS_BATCH, AXIS_STORE = 16, 4
# Phase 14: two ranks share card 0 over gloo (within MESH_PROBE_TIMEOUT and
# MESH_TIMEOUT seconds), each mesh of MESH_SHAPES (data x seq x model) at
# each of MESH_RATES taking MESH_STEPS steps of MESH_B sequences at full
# width and MESH_LAYERS layers; then the default recipe timed for
# MESH_RECIPE_STEPS steps after a warm-up, plain and in a one-rank group.
MESH_SHAPES, MESH_RATES = ((1, 1, 2), (1, 2, 1)), (0.0, 0.1)
MESH_LAYERS, MESH_B, MESH_STEPS, MESH_RECIPE_STEPS = 2, 8, 2, 3
MESH_PROBE_TIMEOUT, MESH_TIMEOUT = 120, 400
# Phase 14's bounds: bf16 on the card against bf16 on the same card, not
# phase 6's f32 on the CPU. On an H100 the losses were within 5.6e-6
# (relative), the gradient cosines >= 0.999988 and the update cosines
# >= 0.9959. Each gradient's norm within MESH_GRAD_NORM_TOL of the
# reference's sees a scale that a cosine does not (an S-fold sum of the
# gathered frames' gradients, a mean over the wrong group).
MESH_LOSS_TOL, MESH_GRAD_COSINE, MESH_GRAD_NORM_TOL, MESH_UPDATE_COSINE = 1e-4, 0.9999, 1e-3, 0.99


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
                      'call': lambda: fn(*args, **kwargs), 'args': args})
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


# Phase 11: the released-checkpoint layouts (reference names -> port names),
# inverted here, independently of the importers: a torch VQ-GAN stage name
# of the port -> the reference's, and a port MIGT entry -> its Keras name.
REFERENCE_VQGAN_NAMES = (
    (r'^(encoder|decoder)\.(down|up)_(\d+)_(block|attn)_(\d+)\.', r'\1.\2.\3.\4.\5.'),
    (r'^(encoder|decoder)\.(down|up)_(\d+)_(downsample|upsample)\.', r'\1.\2.\3.\4.'),
    (r'^(encoder|decoder)\.mid_', r'\1.mid.'),
    (r'^quantizer\.', 'quantize.'),
)


def reference_vqgan_state(state):
    """A port VQGAN state_dict in the reference's torch names, with
    perceptual-loss tensors that the importer must drop."""
    out = {}
    for key, value in state.items():
        for pattern, replacement in REFERENCE_VQGAN_NAMES:
            key = re.sub(pattern, replacement, key)
        out[key] = value.clone()
    out['quantize.counter'] = out['quantize.counter'].long()  # torch's default int
    gen = torch.Generator().manual_seed(3)
    for i in range(5):
        out[f'perceptual_loss.net.slice{i}.weight'] = torch.randn(64, 3, 3, 3, generator=gen)
    return out


def keras_migt_variables(state):
    """A port MIGT state_dict as the raw keys of a Keras save_weights
    checkpoint (model/<path>/.ATTRIBUTES/VARIABLE_VALUE): a Linear weight
    transposed to [in, out] and its bias [1, out], a LayerNorm's weight and
    bias as gamma and beta, h.<i> as h/<i>, wpe as wpe/embeddings; with the
    optimizer's and save_counter's entries."""
    out = {}
    for key, value in state.items():
        array = value.detach().float().cpu().numpy()
        *path, leaf = key.split('.')
        if key == 'wpe':
            path, leaf = ['wpe'], 'embeddings'
        elif key == 'pos_ori_weights':
            path, leaf, array = ['pose_loss_weighting_criterion'], 'pos_ori_weights', array[None]
        elif path[-1] in ('ln_1', 'ln_2', 'ln_f'):
            leaf = {'weight': 'gamma', 'bias': 'beta'}[leaf]
        elif path != ['wte']:
            array = array.T if leaf == 'weight' else array[None]
        out['/'.join(['model'] + path + [leaf, '.ATTRIBUTES', 'VARIABLE_VALUE'])] = \
            np.ascontiguousarray(array)
    out['optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE'] = np.int64(300000)
    out['optimizer/learning_rate/.ATTRIBUTES/VARIABLE_VALUE'] = np.float32(6.4e-4)
    out['save_counter/.ATTRIBUTES/VARIABLE_VALUE'] = np.int64(1)
    return out


def write_tf_checkpoint(tf, raw, directory):
    """The raw Keras variables as a TF object-graph checkpoint under
    directory (a tf.Module a path component, 'h.<i>' for a block). Returns
    the prefix."""
    root = tf.Module()
    for key, value in raw.items():
        parts = [p for p in key.split('/') if p not in ('.ATTRIBUTES', 'VARIABLE_VALUE')]
        if parts[0] != 'model':
            continue
        parts = parts[1:]
        if parts[0] == 'h':
            parts = [f'h.{parts[1]}'] + parts[2:]
        node = root
        for part in parts[:-1]:
            if not hasattr(node, part):
                setattr(node, part, tf.Module())
            node = getattr(node, part)
        setattr(node, parts[-1], tf.Variable(value))
    return tf.train.Checkpoint(model=root).save(os.path.join(directory, 'ckpt'))


CO3D_CODE = {
    'dataset/__init__.py': '',
    'evaluation/__init__.py': '',
    'dataset/co3d_dataset.py': '''
from dataset._fake_data import FakeCo3dDataset

def Co3dDataset(**params):
    return FakeCo3dDataset(params['subset_lists_file'])
''',
    'dataset/dataset_zoo.py': '''
from dataset._fake_data import FakeCo3dDataset

CO3D_CATEGORIES = ['apple', 'banana']
DATASET_CONFIGS = {'default': {'image_height': @SIZE@, 'image_width': @SIZE@}}

def dataset_zoo(dataset_name, dataset_root=None, category=None, **kw):
    assert dataset_name == 'co3d_multisequence', dataset_name
    return {'test': FakeCo3dDataset(category)}
''',
    'dataset/dataloader_zoo.py': '''
from dataset._fake_data import collate

def dataloader_zoo(datasets, dataset_name):
    ds = datasets['test']
    # one batch a sequence, its target frame first (the harness's layout)
    return {'test': [collate([ds[j] for j in seq]) for seq in ds.sequence_indices()]}
''',
    'dataset/_fake_data.py': '''
import numpy as np
import torch

SEQUENCES, FRAMES, SIZE = @SEQUENCES@, @FRAMES@, @SIZE@


class _Transform:
    def __init__(self, m):
        self._m = m

    def get_matrix(self):
        return self._m


class _Camera:
    def __init__(self, m):
        self._m = m

    def get_world_to_view_transform(self):
        return _Transform(self._m)


class _FrameData:
    pass


def _make_frame(seq, i, rs):
    fd = _FrameData()
    fd.sequence_name = seq
    y, x = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    phase = rs.uniform(0, 2 * np.pi, 3)
    fd.image_rgb = torch.from_numpy((0.5 + 0.4 * np.sin(
        6 * x[None] + 4 * y[None] + phase[:, None, None])).astype(np.float32))
    mask = torch.zeros(1, SIZE, SIZE)
    mask[:, SIZE // 4:3 * SIZE // 4, SIZE // 4:3 * SIZE // 4] = 1.0
    fd.fg_probability = mask
    fd.depth_map = torch.from_numpy(rs.rand(1, SIZE, SIZE).astype(np.float32))
    q, r = np.linalg.qr(rs.randn(3, 3))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q * np.sign(np.diag(r))
    m[3, :3] = rs.randn(3)  # PyTorch3D's row-vector convention
    fd.camera = _Camera(torch.from_numpy(m)[None])
    return fd


class FakeCo3dDataset:
    def __init__(self, category):
        rs = np.random.RandomState(sum(map(ord, str(category))))
        self._frames = [_make_frame(f'{category}_{s}', i, rs)
                        for s in range(SEQUENCES) for i in range(FRAMES)]

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, i):
        return self._frames[i]

    def sequence_indices(self):
        return [list(range(s * FRAMES, (s + 1) * FRAMES)) for s in range(SEQUENCES)]


def collate(frames):
    fd = _FrameData()
    fd.sequence_name = frames[0].sequence_name
    fd.image_rgb = torch.stack([f.image_rgb for f in frames], 0)
    fd.fg_probability = torch.stack([f.fg_probability for f in frames], 0)
    fd.depth_map = torch.stack([f.depth_map for f in frames], 0)
    fd.camera = _Camera(torch.cat([f.camera._m for f in frames], 0))
    return fd
''',
    'eval_demo.py': '''
def _print_aggregate_results(task, task_results):
    pass


def aggregate_nvs_results(results):
    return [x for category_result in results for x in category_result]
''',
    'evaluation/evaluate_new_view_synthesis.py': '''
import collections

import numpy as np
import torch

NewViewSynthesisPrediction = collections.namedtuple(
    'NewViewSynthesisPrediction', ['image_render', 'mask_render', 'depth_render'])


def eval_batch(frame_data, preds, bg_color='black', lpips_model=None, source_cameras=None):
    gt = frame_data.image_rgb[:1] * (frame_data.fg_probability[:1] >= 0.5)
    pred = preds.image_render
    assert pred.shape == gt.shape, (pred.shape, gt.shape)
    assert lpips_model.device.startswith('cuda'), lpips_model.device
    mse = float(torch.mean((pred - gt) ** 2))
    return {'psnr': -10.0 * np.log10(max(mse, 1e-10)), 'mse': mse,
            'subset': 'test_known', 'subsubset': 'all'}


def summarize_nvs_eval_results(per_batch, task):
    metrics = {key: float(np.mean([b[key] for b in per_batch])) for key in ('psnr', 'mse')}
    return per_batch, {'results': [{'subset': 'test_known', 'subsubset': 'all',
                                    'metrics': metrics}]}


def pretty_print_nvs_metrics(results):
    pass
''',
}
STUBS = {
    'lpips.py': '''
class LPIPS:
    def __init__(self, net=None):
        assert net == 'vgg', net
        self.device = 'cpu'

    def to(self, device):
        self.device = str(device)
        return self
''',
    'co3d/__init__.py': '',
    'co3d/challenge/__init__.py': '',
    'co3d/challenge/co3d_submission.py': '''
import enum


class CO3DTask(enum.Enum):
    FEW_VIEW = 'few_view'


class CO3DSequenceSet(enum.Enum):
    DEV = 'dev'
    TEST = 'test'


EVAL_BATCHES = @EVAL_BATCHES@


class CO3DSubmission:
    def __init__(self, task, sequence_set, output_folder, dataset_root):
        self.task, self.sequence_set = task, sequence_set
        self.output_folder, self.dataset_root = output_folder, dataset_root
        self.results = []

    def get_eval_batches_map(self):
        # each eval batch of seqA, its target frame first (the official layout)
        return {('apple', 'fewview_dev'): [
            [['seqA', fn, 'apple/images/seqA_%d.png' % fn] for fn in batch]
            for batch in EVAL_BATCHES]}

    def add_result(self, category, subset_name, sequence_name, frame_number, image, mask,
                   depth):
        self.results.append(dict(category=category, subset_name=subset_name,
                                 sequence_name=sequence_name, frame_number=frame_number,
                                 image=image, mask=mask, depth=depth))
''',
}
# Phase 11: CO3D_CATEGORIES x CO3D_SEQUENCES test batches of S frames at
# SIZE px; a CO3Dv2 sequence of S + 1 frames of CO3DV2_W x CO3DV2_H with
# 16-bit depths of CO3DV2_DEPTH_HW, and CO3DV2_BATCHES eval batches of S
# frames (targets 0 and 1).
CO3D_CATEGORIES, CO3D_SEQUENCES = 2, 2
CO3DV2_W, CO3DV2_H, CO3DV2_DEPTH_HW = 640, 480, (240, 320)
CO3DV2_BATCHES = [[0] + list(range(1, S)), [1, 0] + list(range(2, S))]


def write_tree(root, files, replacements):
    for name, text in files.items():
        for token, value in replacements.items():
            text = text.replace(token, str(value))
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as f:
            f.write(text.lstrip('\n'))


def write_co3dv2(root, seed=0):
    """<root>/apple in the CO3Dv2 layout: frame_annotations.jgz (sequence
    seqA, S + 1 frames with PyTorch3D viewpoints), images/ (RGB PNGs),
    masks/ (a centred foreground) and depths/ (16-bit PNGs at
    CO3DV2_DEPTH_HW)."""
    import gzip

    from PIL import Image

    rng = np.random.RandomState(seed)
    category = os.path.join(root, 'apple')
    for sub in ('images', 'masks', 'depths'):
        os.makedirs(os.path.join(category, sub))
    y, x = np.mgrid[0:CO3DV2_H, 0:CO3DV2_W]
    annotations = []
    for fn in range(S + 1):
        paths = {kind: f'apple/{kind}/seqA_{fn}.png' for kind in ('images', 'masks', 'depths')}
        phase = rng.uniform(0, 2 * np.pi, 3)
        image = 127.5 + 100 * np.sin(x[..., None] / 53.0 + y[..., None] / 71.0 + phase)
        Image.fromarray(image.astype(np.uint8)).save(os.path.join(root, paths['images']),
                                                     compress_level=1)
        mask = np.zeros((CO3DV2_H, CO3DV2_W), np.uint8)
        mask[CO3DV2_H // 4:3 * CO3DV2_H // 4, CO3DV2_W // 4:3 * CO3DV2_W // 4] = 255
        Image.fromarray(mask).save(os.path.join(root, paths['masks']))
        Image.fromarray(rng.randint(0, 60000, CO3DV2_DEPTH_HW).astype(np.uint16)).save(
            os.path.join(root, paths['depths']))
        q, r = np.linalg.qr(rng.randn(3, 3))
        annotations.append({
            'sequence_name': 'seqA', 'frame_number': fn, 'image': {'path': paths['images']},
            'mask': {'path': paths['masks']}, 'depth': {'path': paths['depths']},
            'viewpoint': {'R': (q * np.sign(np.diag(r))).tolist(), 'T': rng.randn(3).tolist()}})
    with gzip.open(os.path.join(category, 'frame_annotations.jgz'), 'wt') as f:
        json.dump(annotations, f)


@contextlib.contextmanager
def keras_reader(raw, tf):
    """Without tensorflow, utils.convert.read_tf_checkpoint stands in for
    the TF reader and gives `raw` for a checkpoint prefix named 'model' (the
    rest of load_model's path runs as it is); with it, nothing changes."""
    from viewformer_tpu_torch.utils import convert

    original = convert.read_tf_checkpoint
    if tf is None:
        def read(prefix):
            check(os.path.basename(prefix) == 'model', f'unexpected TF prefix {prefix}')
            return raw
        convert.read_tf_checkpoint = read
    try:
        yield
    finally:
        convert.read_tf_checkpoint = original


def released_checkpoints_and_co3d(ac, log, card):
    """Phase 11. Returns the launch counts of its paths."""
    import io
    import tarfile

    from viewformer_tpu_torch import cli, models
    from viewformer_tpu_torch.commands.model_info import model_info
    from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig, save_config
    from viewformer_tpu_torch.evaluate import co3d as eco3d
    from viewformer_tpu_torch.evaluate import co3dv2_challenge as eco3dv2
    from viewformer_tpu_torch.utils import convert

    tmp = tempfile.mkdtemp(prefix='chip_smoke_released_')
    home, stubs = os.environ.get('HOME'), os.path.join(tmp, 'stubs')
    os.environ['HOME'] = os.path.join(tmp, 'home')
    record = {'phase': 'released_checkpoints_and_co3d', 'card': card}
    launches = {}
    try:
        tf = None
        try:
            import tensorflow as tf
            record['tf_checkpoint'] = f'written and read with tensorflow {tf.__version__}'
        except ImportError as e:
            record['tf_checkpoint'] = f'not run: tensorflow does not import here ({e})'
            print('phase 11: the TF checkpoint step did not run: tensorflow does not import '
                  f'on this machine ({e}); the Keras variables go to load_model through a '
                  'stand-in read_tf_checkpoint', flush=True)

        # 1. a *-codebook-th dir, tarred and installed with download-model
        t0 = time.perf_counter()
        codebooks = {}
        for name, config in (('smoke-codebook-th', VQGANConfig()),
                             ('smoke-rgba-codebook-th', VQGANConfig(in_channels=4, out_ch=4))):
            source = models.AutoModel.from_config(config, torch.float32, 'cpu',
                                                  torch.Generator().manual_seed(0))
            path = os.path.join(tmp, name)
            save_config(config, path)
            torch.save({'state_dict': reference_vqgan_state(source.state_dict()), 'epoch': 9,
                        'global_step': 300000}, os.path.join(path, 'model.ckpt'))
            codebooks[name] = (source.state_dict(), path)
        tar = os.path.join(tmp, 'smoke-codebook-th.tar')
        with tarfile.open(tar, 'w') as f:
            for member in sorted(os.listdir(codebooks['smoke-codebook-th'][1])):
                f.add(os.path.join(codebooks['smoke-codebook-th'][1], member), arcname=member)
        record['codebook_write_s'] = time.perf_counter() - t0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(['download-model', 'smoke-codebook-th', '--from-file', tar])
        installed = os.path.join(tmp, 'home', '.cache', 'viewformer', 'smoke-codebook-th')
        check(out.getvalue().strip() == f'Installed at {installed}',
              f'download-model printed {out.getvalue()!r}')
        # torch.load, then the import into a model on the card (as load_model)
        t0 = time.perf_counter()
        checkpoint = convert.load_torch_checkpoint(os.path.join(installed, 'model.ckpt'))
        record['codebook_torch_load_s'] = time.perf_counter() - t0
        target = models.AutoModel.from_config(VQGANConfig(), torch.float32, 'cuda')
        t0 = time.perf_counter()
        convert.import_vqgan_from_torch(checkpoint, VQGANConfig(), target)
        record['codebook_import_s'] = time.perf_counter() - t0
        del checkpoint, target
        t0 = time.perf_counter()
        loaded = models.load_model('smoke-codebook-th', torch.float32, 'cuda')
        torch.cuda.synchronize()
        record['codebook_load_model_s'] = time.perf_counter() - t0
        expected = codebooks['smoke-codebook-th'][0]
        state = loaded.state_dict()
        check(list(state) == list(expected), 'the imported codebook has other entries')
        differing = [k for k, v in expected.items()
                     if state[k].dtype != v.dtype or not torch.equal(state[k].cpu(), v)]
        check(not differing, f'the imported codebook differs in {differing[:5]}')
        check(state['quantizer.embeddings'].is_cuda, 'load_model did not load onto the card')
        del loaded, state

        # 2. the transformer: raw Keras variables, resolved and imported on the card
        source = models.AutoModel.from_config(MIGTConfig(), torch.float32, 'cpu',
                                              torch.Generator().manual_seed(1))
        expected = source.state_dict()
        raw = keras_migt_variables(expected)
        on_card = models.AutoModel.from_config(MIGTConfig(), torch.float32, 'cuda',
                                               torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        resolved = convert.resolve_keras_object_paths(raw)
        imported = convert.import_migt_from_tf(resolved, MIGTConfig(), on_card)
        record['transformer_resolve_and_import_s'] = time.perf_counter() - t0
        on_card.load_state_dict(imported)
        state = on_card.state_dict()
        differing = [k for k, v in expected.items() if not torch.equal(state[k].cpu(), v)]
        check(list(state) == list(expected) and not differing,
              f'the imported transformer differs in {differing[:5]}')
        del on_card, state, imported
        transformer_dir = os.path.join(tmp, 'smoke-transformer-tf')
        save_config(MIGTConfig(), transformer_dir)
        if tf is not None:
            t0 = time.perf_counter()
            prefix = write_tf_checkpoint(tf, raw, transformer_dir)
            record['tf_write_s'] = time.perf_counter() - t0
            t0 = time.perf_counter()
            convert.read_tf_checkpoint(prefix)
            record['transformer_tf_read_s'] = time.perf_counter() - t0
        else:
            open(os.path.join(transformer_dir, 'model.index'), 'wb').close()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(['download-model', 'smoke-transformer-tf', '--from-file', transformer_dir])

        with keras_reader(raw, tf):
            t0 = time.perf_counter()
            transformer = models.load_model('smoke-transformer-tf', torch.float32, 'cuda')
            torch.cuda.synchronize()
            record['transformer_load_model_s'] = time.perf_counter() - t0
            state = transformer.state_dict()
            check(all(torch.equal(state[k].cpu(), v) for k, v in expected.items()),
                  'load_model of the installed transformer differs from its source')
            del transformer, state

            # 3. model info on both
            totals = {}
            for name, expected_total in (
                    ('smoke-codebook-th', sum(v.numel() for v in codebooks[
                        'smoke-codebook-th'][0].values())),
                    ('smoke-transformer-tf', sum(v.numel() for v in expected.values()))):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    totals[name] = model_info(name)
                lines = out.getvalue().strip().splitlines()
                check(totals[name] == expected_total
                      and lines[-1] == f'total: {expected_total:,} parameters',
                      f'model info {name}: {totals[name]} != {expected_total}')
            record['model_info_totals'] = totals
            torch.cuda.empty_cache()

            # 4. evaluate co3d over the stub harness (bf16, the kernels)
            write_tree(os.path.join(tmp, 'home', '.cache', 'viewformer', 'co3d'), CO3D_CODE,
                       {'@SIZE@': SIZE, '@SEQUENCES@': CO3D_SEQUENCES, '@FRAMES@': S})
            write_tree(stubs, STUBS, {'@EVAL_BATCHES@': CO3DV2_BATCHES})
            sys.path.insert(0, stubs)
            importlib.invalidate_caches()
            n_layer = MIGTConfig().n_layer
            per_batch = only(ac, block_causal_attention_fwd=n_layer - 1,
                             branch_attention_fwd=2 * n_layer)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ac.reset_launch_counts()
            t0 = time.perf_counter()
            with record_calls(ac, eco3d, 'generate_batch_predictions') as batches, \
                    contextlib.redirect_stdout(io.StringIO()):
                result = eco3d.evaluate_co3d('/co3d-data', 'smoke-transformer-tf',
                                             'smoke-codebook-th', os.path.join(tmp, 'co3d'),
                                             progress=False)
            record['co3d_run_s'] = time.perf_counter() - t0
            launches['co3d'] = counts(ac)
            n_batches = CO3D_CATEGORIES * CO3D_SEQUENCES
            check(list(result) == ['test_known_all']
                  and list(result['test_known_all']) == ['psnr', 'mse']
                  and all(np.isfinite(v) for v in result['test_known_all'].values()),
                  f'co3d results {result}')
            with open(os.path.join(tmp, 'co3d', 'results.json')) as f:
                check(json.load(f) == result, 'co3d results.json differs from the result')
            with open(os.path.join(tmp, 'co3d', 'results-co3d.json')) as f:
                check(len(json.load(f)['multisequence']) == CO3D_CATEGORIES,
                      'results-co3d.json has another number of categories')
            check(len(batches) == n_batches, f'co3d: {len(batches)} batches')
            for i, b in enumerate(batches):
                check(b['launches'] == per_batch, f'co3d batch {i}: {b["launches"]}')
                check(b['args'][2].shape == (1, S, SIZE, SIZE, 3), f'co3d batch {i} frames')
            check(launches['co3d'] == {k: n_batches * v for k, v in per_batch.items()},
                  f'co3d launches {launches["co3d"]}')
            wall, busy = device_share(batches[0]['call'])
            record['co3d'] = {'batches': n_batches, 'batch_s': [b['s'] for b in batches],
                              'launches_per_batch': [b['launches'] for b in batches],
                              'profiled_batch_s': wall, 'device_busy_s': busy,
                              'device_share': busy / wall, 'result': result}

            # 5. evaluate co3dv2-challenge with an RGBA codebook
            co3dv2 = os.path.join(tmp, 'co3dv2')
            write_co3dv2(co3dv2)
            ac.reset_launch_counts()
            t0 = time.perf_counter()
            with record_calls(ac, eco3dv2, 'generate_batch_predictions') as v2_batches:
                submission = eco3dv2.evaluate_co3dv2_challenge(
                    co3dv2, 'smoke-transformer-tf', codebooks['smoke-rgba-codebook-th'][1],
                    os.path.join(tmp, 'submission'), progress=False)
            record['co3dv2_run_s'] = time.perf_counter() - t0
            launches['co3dv2-challenge'] = counts(ac)
            check(len(v2_batches) == len(submission.results) == len(CO3DV2_BATCHES),
                  f'co3dv2: {len(v2_batches)} batches, {len(submission.results)} results')
            for i, (b, r) in enumerate(zip(v2_batches, submission.results)):
                check(b['launches'] == per_batch, f'co3dv2 batch {i}: {b["launches"]}')
                check(b['args'][2].shape == (1, S, SIZE, SIZE, 4), f'co3dv2 batch {i} frames')
                check((r['category'], r['subset_name'], r['sequence_name'], r['frame_number'])
                      == ('apple', 'fewview_dev', 'seqA', CO3DV2_BATCHES[i][0]),
                      f'co3dv2 result {i} keys')
                check(r['image'].shape == (3,) + CO3DV2_DEPTH_HW
                      and r['mask'].shape == (1,) + CO3DV2_DEPTH_HW
                      and r['depth'].shape == (1,) + CO3DV2_DEPTH_HW,
                      f'co3dv2 result {i} shapes {r["image"].shape} {r["mask"].shape}')
                check(np.isfinite(r['image']).all() and r['image'].min() >= 0
                      and r['image'].max() <= 1, f'co3dv2 result {i} image values')
                check(set(np.unique(r['mask']).tolist()) <= {0.0, 1.0},
                      f'co3dv2 result {i} mask values')
            wall, busy = device_share(v2_batches[0]['call'])
            record['co3dv2'] = {'batches': len(v2_batches), 'batch_s': [b['s'] for b in v2_batches],
                                'launches_per_batch': [b['launches'] for b in v2_batches],
                                'mask_ones': [float(r['mask'].mean()) for r in submission.results],
                                'profiled_batch_s': wall, 'device_busy_s': busy,
                                'device_share': busy / wall}
            record['max_memory_allocated_gb'] = torch.cuda.max_memory_allocated() / 1e9

            # 6. one CO3D batch, card (bf16, kernels) against CPU (f32, plain)
            images, cameras = batches[0]['args'][2:4]
            card_vs_cpu((models.load_model('smoke-transformer-tf', torch.bfloat16, 'cuda'),
                         models.load_model('smoke-codebook-th', torch.bfloat16, 'cuda')),
                        (models.load_model('smoke-transformer-tf', torch.float32, 'cpu'),
                         models.load_model('smoke-codebook-th', torch.float32, 'cpu')),
                        log, images, cameras, phase='co3d_card_vs_cpu')
    finally:
        if stubs in sys.path:
            sys.path.remove(stubs)
        for name in list(sys.modules):
            if name.split('.')[0] in ('dataset', 'evaluation', 'eval_demo', 'lpips', 'co3d'):
                del sys.modules[name]
        if home is None:
            os.environ.pop('HOME', None)
        else:
            os.environ['HOME'] = home
        shutil.rmtree(tmp, ignore_errors=True)
    record['launches'] = launches
    record['expected_per_batch'] = per_batch
    emit(record, log)
    print(f'released checkpoints: codebook torch.load {record["codebook_torch_load_s"]:.3f} s + '
          f'import {record["codebook_import_s"]:.3f} s (load_model to the card '
          f'{record["codebook_load_model_s"]:.3f} s); transformer resolve + import '
          f'{record["transformer_resolve_and_import_s"]:.3f} s'
          + (f', TF read {record["transformer_tf_read_s"]:.3f} s' if tf is not None else
             ' (no TF read)')
          + f' (load_model to the card {record["transformer_load_model_s"]:.3f} s); '
          f'CO3D batch {statistics.median(record["co3d"]["batch_s"]):.4f} s (device share '
          f'{record["co3d"]["device_share"]:.3f}); CO3Dv2 eval batch '
          f'{statistics.median(record["co3dv2"]["batch_s"]):.4f} s (device share '
          f'{record["co3dv2"]["device_share"]:.3f}); peak '
          f'{record["max_memory_allocated_gb"]:.3f} GB ({card})', flush=True)
    return launches


def remat_launches(ac, config, steps, saves_attention):
    """The launches of `steps` default-recipe train steps: per layer and
    step the forward kernels B5/B7 run in the forward, and again in the
    remat recompute unless the policy saves their outputs; the backward
    B8 once, B6 once but in the last layer (its stream-0 output reaches no
    loss)."""
    n = config.n_layer * steps
    forward = n if saves_attention else 2 * n
    return only(ac, block_causal_attention_dropout_fwd=forward,
                branch_attention_dropout_fwd=forward,
                block_causal_attention_dropout_bwd=n - steps,
                branch_attention_dropout_bwd=n)


def max_difference(params, reference):
    return max((params[name] - reference[name]).abs().max().item() for name in reference)


def remat_policies(ac, log, card):
    """Phase 12 (a). Returns {'remat_<policy>': launches}."""
    from viewformer_tpu_torch.config import MIGTConfig
    from viewformer_tpu_torch.train.transformer import (init_transformer_state,
                                                        make_transformer_train_step)

    config = MIGTConfig()
    check(config.dropout == RATE, f'MIGTConfig().dropout is {config.dropout}, not {RATE}')
    batches = [train_batch(TRAIN_B, 300 + i, 'cuda') for i in range(REMAT_STEPS)]

    def run(policy, batches):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, state = init_transformer_state(config, torch.Generator().manual_seed(0),
                                              torch.bfloat16, 'cuda', warmup_steps=1,
                                              remat_policy=policy)
        step = make_transformer_train_step(model, config)
        ac.reset_launch_counts()
        losses, step_s = [], []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, torch.Generator().manual_seed(i))
            losses.append(metrics['loss'].item())  # waits for the step
            step_s.append(time.perf_counter() - t0)
        launches = counts(ac)
        params = {name: p.detach().clone() for name, p in model.named_parameters()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, state, step
        return {'losses': losses, 'params': params, 'step_s': step_s, 'peak_gb': peak,
                'launches': launches}

    full = run('full', batches)
    repeat = run('full', batches)
    repeat_diff = max_difference(repeat.pop('params'), full['params'])
    repeat_loss_diff = max(abs(a - b) for a, b in zip(repeat['losses'], full['losses']))
    record = {'phase': 'remat_policies', 'card': card, 'batch': TRAIN_B,
              'frames_per_sequence': S, 'steps': REMAT_STEPS, 'dropout': config.dropout,
              'full_repeat_max_abs_param_diff': repeat_diff,
              'full_repeat_max_loss_diff': repeat_loss_diff, 'policies': {}}
    launches = {}
    for policy in REMAT_POLICIES:
        reference, batch_size = full, TRAIN_B
        if policy == 'full':
            result = full
        else:
            try:
                result = run(policy, batches)
            except torch.cuda.OutOfMemoryError:
                # dots keeps every product: at the largest batch that fits,
                # against full at that batch
                check(policy == 'dots', f'remat policy {policy} ran out of memory')
                batch_size = TRAIN_B // 2
                half = [tuple(x[:batch_size] for x in batch) for batch in batches]
                reference = run('full', half)
                result = run(policy, half)
        diff = max_difference(result['params'], reference['params'])
        loss_diff = max(abs(a - b) for a, b in zip(result['losses'], reference['losses']))
        expected = remat_launches(ac, config, REMAT_STEPS, policy in ('attn', 'attn_mlp'))
        record['policies'][policy] = {
            'batch': batch_size, 'losses': result['losses'], 'max_abs_param_diff_vs_full': diff,
            'max_loss_diff_vs_full': loss_diff, 'step_s': result['step_s'],
            'step_s_median': statistics.median(result['step_s']), 'peak_gb': result['peak_gb'],
            'launches': result['launches'], 'expected_launches': expected}
        launches[f'remat_{policy}'] = result['launches']
        check(all(np.isfinite(result['losses'])), f'{policy}: non-finite losses')
        check(result['launches'] == expected,
              f'{policy}: launches {result["launches"]} != {expected}')
        # every policy computes the same function; it differs from full no
        # more than full differs from itself
        check(diff <= repeat_diff and loss_diff <= repeat_loss_diff,
              f'{policy}: parameters {diff} and losses {loss_diff} from full, which repeats '
              f'within {repeat_diff} and {repeat_loss_diff}')
        del result
    emit(record, log)
    del full
    torch.cuda.empty_cache()
    return launches


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def ddp_world_one(ac, tmp, log, card):
    """Phase 12 (b): train_transformer and train_codebook without and in a
    one-rank NCCL process group. Returns (the image dataset, launches)."""
    import torch.distributed as dist

    from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig
    from viewformer_tpu_torch.data.dataset import generate_dataset_from_loader
    from viewformer_tpu_torch.data.loaders import build
    from viewformer_tpu_torch.parallel import distributed
    from viewformer_tpu_torch.train import codebook as cb
    from viewformer_tpu_torch.train import transformer as ttt
    from viewformer_tpu_torch.train.checkpoint import restore_checkpoint

    tokens = write_token_dataset(os.path.join(tmp, 'tokens'))
    images = os.path.join(tmp, 'images')
    for split, n in DDP_CB_SEQUENCES.items():
        loader = build('colors', split=split, num_sequences=n, sequence_size=CB_FRAMES,
                       image_size=SIZE)
        generate_dataset_from_loader(loader, split, os.path.join(images, 'colors'),
                                     max_sequences_per_shard=1, progress=False)
    transformer_config = dataclasses.replace(MIGTConfig(), n_layer=DDP_LAYERS)
    lpips = random_lpips()

    def transformer(job):
        ac.reset_launch_counts()
        model, state = ttt.train_transformer(
            transformer_config, tokens, job, total_steps=DDP_STEPS, epochs=1,
            batch_size=TRAIN_B, progress=False, log_every=1, profile_batch=0, device='cuda')
        return model, state.step, counts(ac)

    def codebook(job):
        # cuDNN's default convolution backward algorithms may add with
        # atomics, so two plain runs need not agree bit for bit; both runs
        # take the deterministic algorithms here
        load, deterministic = cb.load_lpips, torch.backends.cudnn.deterministic
        cb.load_lpips = lambda net='vgg': lpips
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            model, state = cb.train_codebook(
                VQGANConfig(), images, job, total_steps=DDP_STEPS, epochs=1,
                batch_size=DDP_CB_BATCH, progress=False, log_every=1, num_val_batches=1,
                profile_batch=0, device='cuda')
        finally:
            cb.load_lpips, torch.backends.cudnn.deterministic = load, deterministic
            torch.use_deterministic_algorithms(False)
        return model, state.step, None

    runs, times = {}, {}
    for grouped in (False, True):
        if grouped:
            os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()))
            torch.cuda.set_device(0)
            dist.init_process_group('nccl', rank=0, world_size=1)
        try:
            check(distributed.world_size() == 1 and distributed.is_initialized() == grouped,
                  'process group state')
            for name, fn in (('transformer', transformer), ('codebook', codebook)):
                job = os.path.join(tmp, f'{name}-{"nccl" if grouped else "plain"}')
                t0 = time.perf_counter()
                runs[name, grouped] = fn(job) + (job,)
                times[f'{name}_{"nccl" if grouped else "plain"}_s'] = time.perf_counter() - t0
        finally:
            if grouped:
                dist.destroy_process_group()

    def losses(job):
        return [r for key, r in sorted(read_metrics(job).items()) if key[1] == 'train']

    record = {'phase': 'ddp_world_one', 'card': card, 'backend': 'nccl', 'world_size': 1,
              'codebook_deterministic_algorithms': True,
              'transformer_layers': DDP_LAYERS, 'steps': DDP_STEPS, 'transformer_batch': TRAIN_B,
              'codebook_batch': DDP_CB_BATCH, **times}
    launches = {}
    for name in ('transformer', 'codebook'):
        (plain, plain_step, plain_launches, plain_job), (ddp, ddp_step, ddp_launches, ddp_job) = (
            runs[name, False], runs[name, True])
        plain_params, ddp_params = plain.state_dict(), ddp.state_dict()
        diff = max((plain_params[k].float() - ddp_params[k].float()).abs().max().item()
                   for k in plain_params)
        restored, step = restore_checkpoint(ddp_job, prefer='last')
        restored_equal = all(torch.equal(restored['model'][k], ddp_params[k].cpu())
                             for k in ddp_params)
        record[name] = {'steps': [plain_step, ddp_step], 'max_abs_param_diff': diff,
                        'losses_plain': losses(plain_job), 'losses_nccl': losses(ddp_job),
                        'restored_step': step, 'restored_equal': restored_equal}
        # the seconds between the logged ends of steps 1 and 2 (host clock)
        for run in ('plain', 'nccl'):
            logged = record[name][f'losses_{run}']
            record[name][f'step_gap_s_{run}'] = logged[1]['time'] - logged[0]['time']
        check(plain_step == ddp_step == step == DDP_STEPS, f'{name}: steps {record[name]}')
        check(diff == 0, f'{name}: the NCCL run differs from the plain run by {diff}')
        check(record[name]['losses_plain'] == [
            {**r, 'time': p['time']} for r, p in zip(record[name]['losses_nccl'],
                                                     record[name]['losses_plain'])],
              f'{name}: logged losses differ')
        check(restored_equal, f'{name}: the NCCL job dir does not restore the final parameters')
        if plain_launches is not None:
            # 2 train steps at 2 layers and one validation step
            expected = remat_launches(ac, transformer_config, DDP_STEPS, False)
            expected.update(block_causal_attention_fwd=DDP_LAYERS,
                            branch_attention_fwd=DDP_LAYERS)
            record[name].update(launches=ddp_launches, expected_launches=expected)
            check(plain_launches == ddp_launches == expected,
                  f'{name}: launches {plain_launches}, {ddp_launches} != {expected}')
            launches['ddp_world_one'] = ddp_launches
        del plain, ddp
    emit(record, log)
    torch.cuda.empty_cache()
    return images, launches


def cli_rest(ac, tmp, images, log, card):
    """Phase 12 (c). Returns {'visualize_codebook': launches}."""
    import importlib.util

    from PIL import Image

    from viewformer_tpu_torch import cli
    from viewformer_tpu_torch.commands import visualize_codebook as vc
    from viewformer_tpu_torch.data import tfrecord
    from viewformer_tpu_torch.data.loaders import build
    from viewformer_tpu_torch.models import load_model

    record = {'phase': 'cli_rest', 'card': card}
    # dataset shuffle: the records move whole
    shuffled = os.path.join(tmp, 'shuffled')
    t0 = time.perf_counter()
    cli.main(['dataset', 'shuffle', '--dataset', images, '--output', shuffled, '--seed', '3'])
    record['shuffle_s'] = time.perf_counter() - t0

    def records(root):
        names = sorted(n for n in os.listdir(root) if n.endswith('.tfrecord') and '-train-' in n)
        return [list(tfrecord.read_records(os.path.join(root, n))) for n in names]

    source, moved = records(images), records(shuffled)
    flat_source = [r for shard in source for r in shard]
    flat_moved = [r for shard in moved for r in shard]
    record.update(shuffle_records=len(flat_moved), shuffle_shards=len(moved))
    check(sorted(flat_moved) == sorted(flat_source), 'dataset shuffle changed the records')
    check(flat_moved != flat_source, 'dataset shuffle kept the order')
    check(all(len(shard) <= 1 for shard in moved), 'dataset shuffle broke the shard limit')

    # visualize codebook --output: make_grid over the card's reconstructions
    job = save_codebook(os.path.join(tmp, 'viz-codebook'))
    grid_path = os.path.join(tmp, 'grid.png')
    args = ['--loader', 'colors', '--loader-num-sequences', '2', '--loader-sequence-size',
            str(VIZ_IMAGES // 2)]
    ac.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(['visualize', 'codebook', *args, '--codebook-model', job, '--output', grid_path,
              '--num-images', str(VIZ_IMAGES)])
    record['visualize_codebook_s'] = time.perf_counter() - t0
    launches = {'visualize_codebook': counts(ac)}
    grid = np.asarray(Image.open(grid_path))
    loader = build('colors', split='test', num_sequences=2, sequence_size=VIZ_IMAGES // 2,
                   image_size=SIZE)
    frames = np.concatenate([np.asarray(loader[i]['frames']) for i in range(2)])[:VIZ_IMAGES]
    expected = vc.reconstruction_grid(load_model(job, torch.bfloat16, 'cuda'), frames)
    tiles = grid.reshape(-1, SIZE, 8, SIZE, 3).transpose(0, 2, 1, 3, 4).reshape(-1, SIZE, SIZE, 3)
    record.update(grid_shape=list(grid.shape),
                  reconstruction_mean_abs_err=float(np.abs(
                      tiles[1::2].astype(np.float32) - frames.astype(np.float32)).mean()))
    check(grid.shape == (VIZ_IMAGES * 2 // 8 * SIZE, 8 * SIZE, 3), f'grid {grid.shape}')
    check(np.array_equal(tiles[0::2], frames), 'the grid\'s originals are not the frames')
    check(np.array_equal(grid, expected), 'the grid differs from a direct reconstruction')
    check(launches['visualize_codebook'] == only(ac), f'launches {launches}')

    # dataset visualize: a PNG with matplotlib, else the error that names it
    has_matplotlib = importlib.util.find_spec('matplotlib') is not None
    print(f'matplotlib: {"present" if has_matplotlib else "absent"}', flush=True)
    record['matplotlib'] = has_matplotlib
    preview = os.path.join(tmp, 'preview.png')
    command = ['dataset', 'visualize', '--loader', 'colors', '--loader-num-sequences', '2',
               '--loader-sequence-size', '4', '--image-size', str(SIZE), '--output', preview]
    if has_matplotlib:
        cli.main(command)
        check(np.asarray(Image.open(preview)).ndim == 3, 'dataset visualize wrote no image')
    else:
        try:
            cli.main(command)
        except ImportError as e:
            record['dataset_visualize_error'] = str(e)
        check('matplotlib' in record.get('dataset_visualize_error', ''),
              'dataset visualize without matplotlib did not say so')
    emit(record, log)
    return launches


def remat_ddp_and_cli(ac, log, card):
    """Phase 12. Returns the launch counts of its paths."""
    launches = remat_policies(ac, log, card)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_ddp_')
    try:
        images, ddp_launches = ddp_world_one(ac, tmp, log, card)
        launches.update(ddp_launches)
        launches.update(cli_rest(ac, tmp, images, log, card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


@contextlib.contextmanager
def torchrun_group(port):
    """torchrun's environment for one rank on card 0 (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): a command run in it joins an NCCL
    group of one rank through the CLI, destroyed on the way out."""
    import torch.distributed as dist

    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(port))
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value


def files_of(path):
    """{relative path: bytes} of every file under path."""
    out = {}
    for d, _, names in os.walk(path):
        for name in names:
            with open(os.path.join(d, name), 'rb') as f:
                out[os.path.relpath(os.path.join(d, name), path)] = f.read()
    return out


def data_axis(ac, tmp, images, jobs, log, card):
    """Phase 13 (a): generate-codes and evaluate transformer,
    transformer-multictx and codebook through the CLI, each without a
    process group and then under torchrun's environment (a one-rank NCCL
    group joined by the CLI): the shards, results.json and the stored files
    byte-equal. Returns the launch counts of both runs."""
    import torch.distributed as dist

    from viewformer_tpu_torch import cli
    from viewformer_tpu_torch.commands import generate_codes as gc
    from viewformer_tpu_torch.config import load_config
    from viewformer_tpu_torch.evaluate import codebook as ecodebook
    from viewformer_tpu_torch.evaluate import multictx as emultictx
    from viewformer_tpu_torch.evaluate import transformer as etransformer
    from viewformer_tpu_torch.parallel import distributed

    n_layer = load_config(jobs['transformer']).n_layer
    per_batch = {
        'generate-codes': only(ac),
        'transformer': only(ac, block_causal_attention_fwd=n_layer - 1,
                            branch_attention_fwd=2 * n_layer),
        'transformer-multictx': only(ac, block_causal_attention_fwd=n_layer,
                                     branch_attention_fwd=n_layer),
        'codebook': only(ac)}
    metrics = ['loc-angle', 'loc-dist', 'loc-angle-med', 'loc-dist-med',
               'mse', 'rmse', 'mae', 'psnr', 'lpips', 'ssim']  # the JAX package's keys
    modules = {'transformer': etransformer, 'transformer-multictx': emultictx,
               'codebook': ecodebook}
    loader = ['--loader', 'dataset', '--loader-path', images, '--loader-split', 'train',
              '--codebook-model', jobs['codebook'], '--num-store-images', str(AXIS_STORE)]
    frames = sum(CB_SEQUENCES.values()) * CB_FRAMES

    def commands(out):
        yield 'generate-codes', ['generate-codes', '--dataset', images, '--output',
                                 os.path.join(out, 'codes'), '--model', jobs['codebook'],
                                 '--batch-size', str(CB_BATCH)]
        for kind in modules:
            argv = ['evaluate', kind, *loader, '--job-dir', os.path.join(out, kind)]
            if kind == 'codebook':
                argv += ['--batch-size', str(CODEBOOK_BATCH)]
            else:
                argv += ['--transformer-model', jobs['transformer'], '--batch-size',
                         str(AXIS_BATCH), '--sequence-size', str(S)]
            yield kind, argv

    loads, load = [], gc.load_model

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        model = load(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return model

    record = {'phase': 'data_axis', 'card': card, 'backend': 'nccl', 'world_size': 1,
              'image_size': SIZE, 'frames': frames, 'generate_codes_batch': CB_BATCH,
              'evaluate_sequences': CB_SEQUENCES['train'], 'evaluate_batch': AXIS_BATCH,
              'codebook_batch': CODEBOOK_BATCH, 'frames_per_sequence': S}
    launches = {}
    for grouped in (False, True):
        name = 'nccl' if grouped else 'plain'
        launches[f'data_axis_{name}'] = only(ac)
        for kind, argv in commands(os.path.join(tmp, name)):
            # generate-codes keeps a batch in flight: time it whole, unsynced
            calls, recorded = [], (contextlib.nullcontext() if kind == 'generate-codes' else
                                   record_calls(ac, modules[kind], 'generate_batch_predictions'))
            ac.reset_launch_counts()
            gc.load_model = timed_load
            with (torchrun_group(free_port()) if grouped else contextlib.nullcontext()), \
                    recorded as calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    cli.main(argv)
                finally:
                    gc.load_model = load
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                joined = distributed.is_initialized() and distributed.world_size() == 1
                busy = device_share(calls[-1]['call']) if calls else None
            check(joined == grouped, f'{kind}: process group joined {joined}, wanted {grouped}')
            total = counts(ac)
            for key, n in total.items():
                launches[f'data_axis_{name}'][key] += n
            entry = {'run_s': run_s, 'launches': nonzero(total)}
            if calls:
                batch_s = [c['s'] for c in calls]
                wall, device = busy
                entry.update(batches=len(calls), batch_s=batch_s,
                             batch_s_median=statistics.median(batch_s),
                             launches_per_batch=[nonzero(c['launches']) for c in calls],
                             busy_batch_s=wall, device_busy_share=device / wall)
                check(all(c['launches'] == per_batch[kind] for c in calls),
                      f'{kind} ({name}): launches a batch {entry["launches_per_batch"]}, '
                      f'not {nonzero(per_batch[kind])}')
                print(f'data_axis {kind} ({name}): {entry["batch_s_median"]:.4f} s a batch '
                      f'({len(calls)} batches, {run_s:.3f} s), busy '
                      f'{entry["device_busy_share"]:.1%}, launches a batch '
                      f'{nonzero(calls[0]["launches"])} ({card})', flush=True)
            else:
                entry.update(frames_per_s=frames / run_s, load_model_s=loads[-1])
                check(total == per_batch[kind], f'{kind} ({name}): launches {total}')
                print(f'data_axis {kind} ({name}): {frames / run_s:.1f} frames/s over {frames} '
                      f'frames, {run_s:.3f} s (load_model {loads[-1]:.3f} s) ({card})',
                      flush=True)
            record[f'{kind}_{name}'] = entry
        check(not dist.is_initialized(), 'the process group outlived its command')
    # generate-codes' device share, a third run
    wall, device = device_share(lambda: gc.generate_codes(
        images, os.path.join(tmp, 'busy'), jobs['codebook'], batch_size=CB_BATCH,
        progress=False))
    record.update(generate_codes_busy_run_s=wall, generate_codes_device_busy_share=device / wall)

    plain, grouped = files_of(os.path.join(tmp, 'plain')), files_of(os.path.join(tmp, 'nccl'))
    record.update(files=len(plain), differing_files=sorted(k for k in plain
                                                          if grouped.get(k) != plain[k]),
                  extra_files=sorted(set(grouped) - set(plain)))
    results = {kind: json.loads(plain[os.path.join(kind, 'results.json')]) for kind in modules}
    record['results'] = results
    emit(record, log)
    print(f'data_axis: generate-codes busy {record["generate_codes_device_busy_share"]:.1%} '
          f'of {wall:.3f} s; {len(plain)} files, {len(record["differing_files"])} differ in '
          f'the one-rank group ({card})', flush=True)
    check(not record['differing_files'] and not record['extra_files'],
          f'the one-rank group wrote other files: {record["differing_files"]} '
          f'{record["extra_files"]}')
    shards = sum(n.endswith('.tfrecord') for n in plain)
    check(shards == sum(-(-n // CB_SHARD) for n in CB_SEQUENCES.values()),
          f'generate-codes wrote {shards} shards')
    check(sum(n.endswith('-gt.png') for n in plain) == 3 * AXIS_STORE, 'stored samples')
    check_results('transformer', {'': results['transformer']}, metrics)
    check_results('transformer-multictx', results['transformer-multictx'], metrics)
    check(list(results['transformer-multictx']) == [f'ctx{i:02d}' for i in range(1, S)],
          'transformer-multictx: context sizes')
    check_results('codebook', {'': results['codebook']}, metrics[4:])
    return launches


def nonzero(launches):
    return {name: n for name, n in launches.items() if n}


def host_codec(tmp, host_build, log, card):
    """Phase 13 (b): the native int64 decode against the pure-Python path
    on phase 7's token shards, record by record, with host ms of each."""
    from viewformer_tpu_torch.data import native, tfrecord

    record = {'phase': 'host_codec', 'card': card, **host_build}
    tokens = write_token_dataset(os.path.join(tmp, 'tokens'))
    shards = sorted(os.path.join(tokens, n) for n in os.listdir(tokens) if n.endswith('.tfrecord'))
    varints = {'native': 0.0, 'python': 0.0}
    records, mismatched = 0, 0
    decode_varints = native.decode_varints
    for shard in shards:
        for payload in tfrecord.read_records(shard):
            records += 1
            t0 = time.perf_counter()
            fast = tfrecord.decode_example(payload)
            varints['native'] += time.perf_counter() - t0
            native.decode_varints = lambda buffer: None  # the pure-Python decode
            try:
                t0 = time.perf_counter()
                slow = tfrecord.decode_example(payload)
                varints['python'] += time.perf_counter() - t0
            finally:
                native.decode_varints = decode_varints
            mismatched += int(not np.array_equal(fast['codes'], slow['codes']))
    record.update(token_shards=len(shards), token_records=records,
                  example_decode_ms_per_record={k: 1e3 * v / records for k, v in varints.items()},
                  mismatched_records=mismatched)
    emit(record, log)
    print(f'host codec: example decode {record["example_decode_ms_per_record"]["native"]:.3f} ms '
          f'a record natively, {record["example_decode_ms_per_record"]["python"]:.3f} in Python '
          f'({records} records) ({card})', flush=True)
    check(records > 0, 'no token record')
    check(mismatched == 0, f'{mismatched} token records decode otherwise natively')


def data_axis_and_host_codec(ac, host_build, log, card):
    """Phase 13. Returns the launch counts of its paths."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_axis_')
    try:
        images = os.path.join(tmp, 'images')
        t0 = time.perf_counter()
        codebook_dataset(images)
        jobs = {'transformer': save_transformer(os.path.join(tmp, 'transformer')),
                'codebook': save_codebook(os.path.join(tmp, 'codebook'))}
        print(f'phase 13 set-up: {time.perf_counter() - t0:.3f} s', flush=True)
        launches = data_axis(ac, tmp, images, jobs, log, card)
        host_codec(tmp, host_build, log, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def build_host_codec():
    """Phase 1's build of the native host codec (data/native.py) from
    csrc/host/vfcodec.cc, which must build (g++ is nvcc's host compiler):
    its seconds."""
    from viewformer_tpu_torch.data import native

    t0 = time.perf_counter()
    native.build()
    out = {'vfcodec_build_s': time.perf_counter() - t0}
    check(native.get_lib() is not None, 'the native codec library does not load')
    return out


def cosine(a, b):
    """Cosine similarity in float64 (an f32 dot over millions of elements
    rounds past 1)."""
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def norm_ratio(a, b):
    """|a| / |b| in float64."""
    return (a.double().norm() / b.double().norm()).item()


def step_launches(ac, config, steps):
    """The launches of `steps` train steps under remat full (train_path's
    rule)."""
    if config.dropout > 0:
        return remat_launches(ac, config, steps, False)
    n = config.n_layer * steps
    return only(ac, block_causal_attention_fwd=2 * n, branch_attention_fwd=2 * n,
                block_causal_attention_bwd=n - steps, branch_attention_bwd=n)


def mesh_steps(config, batch, dtype, device, n=2):
    """n train steps on the current mesh (parallel/mesh.py) from generator
    seed 0, step i's seeds from seed i, on this rank's rows of the global
    `batch`, the state sharded over `model` and the frames over `seq`:
    (losses, host seconds a step, the one-process layout of the final
    parameters, of their change and of each step's gradients)."""
    from viewformer_tpu_torch.parallel import distributed, sharding
    from viewformer_tpu_torch.parallel.mesh import current_mesh
    from viewformer_tpu_torch.train import transformer as ttt

    mesh = current_mesh()
    model, state = ttt.init_transformer_state(
        config, torch.Generator().manual_seed(0), dtype, device, warmup_steps=1)
    initial = {k: p.detach().clone() for k, p in model.named_parameters()}
    sharding.shard_transformer_state(model, state, mesh)
    rows = tuple(distributed.shard_rows(x) for x in batch)
    step = ttt.make_transformer_train_step(model, config)
    losses, times, grads = [], [], []
    for i in range(n):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, rows, torch.Generator().manual_seed(i))
        losses.append(metrics['loss'].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        grads.append(sharding.unshard_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, mesh))
    params = sharding.unshard_state_dict(
        {k: p.detach() for k, p in model.named_parameters()}, mesh)
    return losses, times, params, {k: p - initial[k] for k, p in params.items()}, grads


@contextlib.contextmanager
def shard_seeded_attention(model_size):
    """Within the context, a one-process training forward draws the
    attention dropout masks of a mesh with `model_size` model ranks (and
    one data index): the heads in model_size groups, group m with the seed
    words folded with m, as rank m of the mesh draws them (models/migt.py);
    the reference a `model` mesh at dropout > 0 is held against."""
    from viewformer_tpu_torch.models import migt
    from viewformer_tpu_torch.ops.dropout import fold_rank

    attention = migt.multi_end_block_attention

    def by_shard(kset, vset, qset, dropout_rate=0.0, seeds=None):
        if dropout_rate <= 0:
            return attention(kset, vset, qset, dropout_rate, seeds)
        heads = qset[0].shape[1] // model_size
        outs = [attention(*(tuple(x[:, m * heads:(m + 1) * heads] for x in group)
                            for group in (kset, vset, qset)),
                          dropout_rate, [fold_rank(words, m) for words in seeds])
                for m in range(model_size)]
        return tuple(torch.cat(parts, 1) for parts in zip(*outs))

    migt.multi_end_block_attention = by_shard
    try:
        yield
    finally:
        migt.multi_end_block_attention = attention


def replicas_equal(tensors):
    """True when every rank holds these tensors bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().flatten().float() for t in tensors])
    low, high = flat.clone(), flat.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    return bool(torch.equal(low, high))


def first_card():
    """Card 0, made the current CUDA device."""
    torch.cuda.set_device(0)
    return torch.device('cuda', 0)


def two_rank_probe(rank, tmp):
    """Phase 14 (a), on rank `rank` of 2 on card 0: whether gloo's
    all_reduce, all_gather and reduce_scatter take CUDA tensors (f32 and
    bf16) and give the sums: 'ok' or what went wrong for each, to
    tmp/probe<rank>.json. NCCL refuses two ranks on one device."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'file://{tmp}/probe-rendezvous', rank=rank,
                            world_size=2)
    out = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.arange(4, device='cuda') + rank).to(dtype)
            total = x.clone()
            parts = [torch.empty_like(x) for _ in range(2)]
            half = torch.empty(2, device='cuda', dtype=dtype)
            ops = {'all_reduce': (lambda: dist.all_reduce(total), lambda: total.tolist(),
                                  [1, 3, 5, 7]),
                   'all_gather': (lambda: dist.all_gather(parts, x),
                                  lambda: [p.tolist() for p in parts],
                                  [[0, 1, 2, 3], [1, 2, 3, 4]]),
                   'reduce_scatter': (lambda: dist.reduce_scatter(half, list(x.chunk(2))),
                                      lambda: half.tolist(), [[1, 3], [5, 7]][rank])}
            for name, (run, value, expected) in ops.items():
                key = f'{name}_{str(dtype).split(".")[-1]}'
                try:  # the probe's answer: an error means the card cannot be shared
                    run()
                    torch.cuda.synchronize()
                    out[key] = 'ok' if value() == expected else f'wrong sums: {value()}'
                except Exception as e:
                    out[key] = f'{type(e).__name__}: {e}'[:300]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f'probe{rank}.json'), 'w') as f:
        json.dump(out, f)


def two_rank_meshes(rank, tmp):
    """Phase 14 (b) on rank `rank` of 2 sharing card 0 over gloo: rank 0
    first runs the one-process references alone (and, for the model mesh
    at dropout > 0, the reference with its masks, shard_seeded_attention);
    then both join and take MESH_STEPS steps on each of MESH_SHAPES at
    each of MESH_RATES, from the same weights and batch, with their
    launches; rank 0 holds each run against its reference. Writes
    tmp/mesh<rank>.json."""
    import torch.distributed as dist

    from viewformer_tpu_torch.config import MIGTConfig
    from viewformer_tpu_torch.ops import attention_cuda as ac
    from viewformer_tpu_torch.parallel.mesh import create_mesh

    device = first_card()
    ac.build()
    base = dataclasses.replace(MIGTConfig(), n_layer=MESH_LAYERS)
    configs = {rate: dataclasses.replace(base, dropout=rate) for rate in MESH_RATES}
    batch = train_batch(MESH_B, seed=410, device=device)
    references = {}
    if rank == 0:
        for rate, config in configs.items():
            references[rate, 1] = mesh_steps(config, batch, torch.bfloat16, device, MESH_STEPS)
            if rate > 0:
                with shard_seeded_attention(2):
                    references[rate, 2] = mesh_steps(config, batch, torch.bfloat16, device,
                                                     MESH_STEPS)
    dist.init_process_group('gloo', init_method=f'file://{tmp}/mesh-rendezvous', rank=rank,
                            world_size=2)
    out = {'rank': rank}
    try:
        for shape in MESH_SHAPES:
            D, S, M = shape
            mesh = create_mesh(D, M, seq_parallelism=S)
            for rate, config in configs.items():
                ac.reset_launch_counts()
                losses, times, params, moved, grads = mesh_steps(
                    config, batch, torch.bfloat16, device, MESH_STEPS)
                record = {'coords': mesh.coords, 'losses': losses, 'step_s': times,
                          'launches': counts(ac),
                          'expected_launches': step_launches(ac, config, MESH_STEPS),
                          'replicas_equal': replicas_equal(params.values())}
                if rank == 0:
                    ref_losses, ref_times, _, ref_moved, ref_grads = \
                        references[rate, M if rate > 0 else 1]
                    record.update(
                        reference='shard-seeded' if rate > 0 and M > 1 else 'one process',
                        reference_losses=ref_losses, reference_step_s=ref_times,
                        loss_rel_err=max(abs(a - b) / abs(b)
                                         for a, b in zip(losses, ref_losses)),
                        grad_cosine_min=min(cosine(g[k], r[k])
                                            for g, r in zip(grads, ref_grads)
                                            for k in r if r[k].any()),
                        grad_norm_ratio_err=max(abs(norm_ratio(g[k], r[k]) - 1)
                                                for g, r in zip(grads, ref_grads)
                                                for k in r if r[k].any()),
                        update_cosine={k: cosine(moved[k], ref_moved[k])
                                       for k in compared(MESH_LAYERS)})
                out['x'.join(map(str, shape)) + f'_dropout_{rate}'] = record
                del params, moved, grads
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f'mesh{rank}.json'), 'w') as f:
        json.dump(out, f)


def spawn_two(fn, tmp, timeout):
    """fn(rank, tmp) on 2 spawned processes: True when both end with exit
    code 0 within `timeout` seconds; else both are killed and False."""
    context = torch.multiprocessing.start_processes(fn, args=(tmp,), nprocs=2, join=False,
                                                    start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=1):
            if time.monotonic() > deadline:
                return False
        return True
    except torch.multiprocessing.ProcessRaisedException as e:
        print(f'{fn.__name__}: {e}', flush=True)
        return False
    except torch.multiprocessing.ProcessExitedException as e:
        print(f'{fn.__name__}: {e}', flush=True)
        return False
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()


def recipe_in_group(ac, log, card):
    """Phase 14 (c): the default recipe (MIGTConfig(), B=TRAIN_B, S=20)
    plain and in a one-rank NCCL group on the 1x1x1 mesh of create_mesh,
    MESH_RECIPE_STEPS steps each after a warm-up: losses bit-equal, the
    step seconds. Returns the group run's launches."""
    import torch.distributed as dist

    from viewformer_tpu_torch.config import MIGTConfig
    from viewformer_tpu_torch.parallel.mesh import create_mesh, current_mesh

    config = MIGTConfig()
    device = first_card()
    batch = train_batch(TRAIN_B, seed=411, device=device)
    runs, launches = {}, None
    for grouped in (False, True):
        if grouped:
            os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()))
            dist.init_process_group('nccl', rank=0, world_size=1)
            mesh = create_mesh(1, 1, seq_parallelism=1)
            check(current_mesh() is mesh, 'create_mesh did not become the current mesh')
        try:
            ac.reset_launch_counts()
            runs[grouped] = mesh_steps(config, batch, torch.bfloat16, device,
                                       MESH_RECIPE_STEPS + 1)[:2]
            if grouped:
                launches = counts(ac)
        finally:
            if grouped:
                dist.destroy_process_group()
        torch.cuda.empty_cache()
    (plain_losses, plain_s), (group_losses, group_s) = runs[False], runs[True]
    expected = step_launches(ac, config, MESH_RECIPE_STEPS + 1)
    record = {'phase': 'recipe_in_group', 'card': card, 'backend': 'nccl', 'world_size': 1,
              'batch': TRAIN_B, 'losses_plain': plain_losses, 'losses_group': group_losses,
              'step_s_plain': plain_s[1:], 'step_s_group': group_s[1:],
              'step_s_median_plain': statistics.median(plain_s[1:]),
              'step_s_median_group': statistics.median(group_s[1:]),
              'launches': launches, 'expected_launches': expected}
    emit(record, log)
    print(f'default recipe in a one-rank NCCL group: {record["step_s_median_group"]:.4f} s a '
          f'step against {record["step_s_median_plain"]:.4f} s plain ({card})', flush=True)
    check(plain_losses == group_losses, f'one-rank group losses {group_losses} != '
                                        f'{plain_losses}')
    check(launches == expected, f'recipe launches {launches} != {expected}')
    return launches


def model_and_seq_axes(ac, log, card):
    """Phase 14. Returns the launch counts of its paths."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_mesh_')
    launches = {}
    try:
        t0 = time.perf_counter()
        ended = spawn_two(two_rank_probe, tmp, MESH_PROBE_TIMEOUT)
        probe = {}
        for rank in range(2):
            path = os.path.join(tmp, f'probe{rank}.json')
            if os.path.exists(path):
                with open(path) as f:
                    probe[rank] = json.load(f)
        # only a collective that raised is a refusal; a crash, a time-out or
        # a wrong sum fails the phase
        refusals = {f'rank {rank} {op}': v for rank, p in probe.items() for op, v in p.items()
                    if v != 'ok'}
        shared = ended and len(probe) == 2 and not refusals
        emit({'phase': 'two_rank_probe', 'card': card, 'backend': 'gloo', 'results': probe,
              'ended': ended, 'two_ranks_share_the_card': shared,
              'seconds': time.perf_counter() - t0}, log)
        check(ended and len(probe) == 2, 'phase 14: a rank of the probe crashed or timed out')
        check(not any(v.startswith('wrong sums') for v in refusals.values()),
              f'phase 14: gloo gave wrong sums on the card: {refusals}')
        if shared:
            print('phase 14: two ranks share the card over gloo (NCCL refuses two ranks on '
                  'one device); the meshes 1x1x2 and 1x2x1 run on it', flush=True)
            t0 = time.perf_counter()
            check(spawn_two(two_rank_meshes, tmp, MESH_TIMEOUT),
                  'phase 14: the two ranks on the card failed')
            ranks = []
            for rank in range(2):
                with open(os.path.join(tmp, f'mesh{rank}.json')) as f:
                    ranks.append(json.load(f))
            record = {'phase': 'two_rank_meshes', 'card': card, 'backend': 'gloo',
                      'layers': MESH_LAYERS, 'batch': MESH_B, 'steps': MESH_STEPS,
                      'seconds': time.perf_counter() - t0, 'ranks': ranks}
            emit(record, log)
            for run, result in ranks[0].items():
                if run == 'rank':
                    continue
                print(f'{run}: loss rel {result["loss_rel_err"]:.3e}, gradient cosine '
                      f'>= {result["grad_cosine_min"]:.6f}, gradient norm ratio within '
                      f'{result["grad_norm_ratio_err"]:.3e} of 1, update cosine >= '
                      f'{min(result["update_cosine"].values()):.6f} against '
                      f'{result["reference"]}; '
                      f'{statistics.median(result["step_s"]):.4f} s a step against '
                      f'{statistics.median(result["reference_step_s"]):.4f} ({card})',
                      flush=True)
                check(result['loss_rel_err'] <= MESH_LOSS_TOL, f'{run}: loss {result}')
                check(result['grad_cosine_min'] >= MESH_GRAD_COSINE,
                      f'{run}: gradients {result}')
                check(result['grad_norm_ratio_err'] <= MESH_GRAD_NORM_TOL,
                      f'{run}: gradient norms {result}')
                # the parameters after the steps: their change points the
                # way one process's does (compared(): phase 6's tensors)
                check(min(result['update_cosine'].values()) >= MESH_UPDATE_COSINE,
                      f'{run}: parameter updates {result}')
                for rank in ranks:
                    rank_result = rank[run]
                    check(rank_result['replicas_equal'], f'{run}: replicas differ')
                    check(rank_result['launches'] == rank_result['expected_launches'],
                          f'{run}: launches of rank {rank["rank"]} {rank_result["launches"]}')
                    launches[f'mesh_{run}_rank{rank["rank"]}'] = rank_result['launches']
        else:
            print(f'phase 14: gloo refused CUDA tensors ({refusals}), so two ranks cannot '
                  'share the card; the two-rank checks are '
                  'tests/test_torch_tensor_parallel.py, tests/test_torch_sequence_parallel.py '
                  'and tools/ddp_check.py tensor|seq on 4 cards', flush=True)
        launches['recipe_in_group'] = recipe_in_group(ac, log, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# Phase 15: the report keys of tools/quality_gate.py, the kernels its
# stages launch (training at dropout 0.1, validation and the evaluators),
# and its time limit in seconds.
GATE_REPORT_KEYS = ('config', 'timings_s', 'transformer_eval', 'codebook_eval', 'multictx_eval',
                    'finetune', 'gate', 'ok', 'card', 'transformer_eval_fp32')
GATE_KERNELS = ('block_causal_attention_fwd', 'branch_attention_fwd',
                'block_causal_attention_dropout_fwd', 'block_causal_attention_dropout_bwd',
                'branch_attention_dropout_fwd', 'branch_attention_dropout_bwd')
GATE_TIMEOUT = 600


def quality_gate_quick(ac, log, card):
    """Phase 15. Returns the launch counts of the gate's stages, summed."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_gate_')
    try:
        counts_path = os.path.join(tmp, 'launches.jsonl')
        report_path = os.path.join(tmp, 'report.json')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'viewformer_tpu_torch.tools.quality_gate', '--quick',
             '--device', 'cuda', '--workdir', os.path.join(tmp, 'work'), '--out', report_path],
            cwd=ROOT, env=dict(os.environ, VIEWFORMER_LAUNCH_COUNTS=counts_path),
            capture_output=True, text=True, timeout=GATE_TIMEOUT)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f'phase 15: the quick gate exited with {proc.returncode}:\n'
              f'{proc.stdout[-3000:]}{proc.stderr[-3000:]}')
        with open(report_path) as f:
            report = json.load(f)
        launches, stages = {fn.__name__: 0 for fn in ac.KERNELS}, []
        with open(counts_path) as f:
            for line in f:
                stage = json.loads(line)
                stages.append({'command': ' '.join(stage['argv'][:2]),
                               'launches': nonzero(stage['launches'])})
                for name, n in stage['launches'].items():
                    launches[name] += n
        psnr = report['transformer_eval'].get('psnr')
        emit({'phase': 'quality_gate_quick', 'card': card, 'seconds': seconds,
              'timings_s': report['timings_s'], 'psnr': psnr,
              'psnr_fp32': report['transformer_eval_fp32'].get('psnr'),
              'codebook_psnr': report['codebook_eval'].get('psnr'), 'gate': report['gate'],
              'finetune': {k: v for k, v in report['finetune'].items() if k != 'eval'},
              'last_logged_step': report['last_logged_step'], 'launches_by_stage': stages,
              'launches': launches}, log)
        print(f'phase 15: the quick quality gate took {seconds:.1f} s ({card})', flush=True)
        check(all(key in report for key in GATE_REPORT_KEYS),
              f'phase 15: the report lacks {[k for k in GATE_REPORT_KEYS if k not in report]}')
        check(psnr is not None and np.isfinite(psnr), f'phase 15: quick PSNR {psnr}')
        check(report['finetune']['schedules_continue_from_restored_step'],
              f'phase 15: the finetune leg restarted its steps: {report["finetune"]}')
        check(all(launches[name] > 0 for name in GATE_KERNELS),
              f'phase 15: a kernel of the gate was not launched: {launches}')
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    host_build = build_host_codec()
    emit({'phase': 'build_host_codec', 'card': card, **host_build}, log)

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
    train_card_vs_cpu(dataclasses.replace(no_dropout, n_layer=COMPARE_LAYERS), log)
    train_card_vs_cpu(dataclasses.replace(config, n_layer=COMPARE_DROPOUT_LAYERS), log)
    launches['train_loop'] = train_loop(ac, config, log, card)
    torch.cuda.empty_cache()
    launches.update(serve_and_evaluate(ac, log, card))
    torch.cuda.empty_cache()
    launches['codebook_pipeline'] = codebook_pipeline(ac, log, card)
    torch.cuda.empty_cache()
    launches.update(sevenscenes_and_more(ac, log, card))
    torch.cuda.empty_cache()
    launches.update(released_checkpoints_and_co3d(ac, log, card))
    torch.cuda.empty_cache()
    launches.update(remat_ddp_and_cli(ac, log, card))
    torch.cuda.empty_cache()
    launches.update(data_axis_and_host_codec(ac, host_build, log, card))
    torch.cuda.empty_cache()
    launches.update(model_and_seq_axes(ac, log, card))
    torch.cuda.empty_cache()
    launches['quality_gate_quick'] = quality_gate_quick(ac, log, card)

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
