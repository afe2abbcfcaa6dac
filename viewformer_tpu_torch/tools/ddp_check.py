#!/usr/bin/env python3
"""Checks data parallel (parallel/distributed.py) and the mesh's other axes
on N cards, or on N gloo CPU processes with a tiny config, against one
process; and, on one card, full-depth train steps against the CPU. Run it
from the root of a checkout, under torchrun:

    python3 -m torch.distributed.run --nproc_per_node=4 \
        viewformer_tpu_torch/tools/ddp_check.py [inference | tensor | seq] [cpu]

or alone, on one card:

    python3 -m viewformer_tpu_torch.tools.ddp_check depth

Without a mode, training on the data axis:

1. Before joining the process group, each rank takes 2 dropout-0 train
   steps (MIGTConfig(), the global batch of chip_smoke.TRAIN_B sequences of
   20 frames, bf16 on its card) alone: the one-process reference.
2. Joined (NCCL; gloo with `cpu`), each rank takes the same 2 steps on its
   rows, judged by steps_agree: the losses, every gradient's cosine and
   norm and the parameter updates' cosines (chip_smoke.compared's tensors)
   within phase 14's bounds (chip_smoke.MESH_*) of the reference, and the
   replicas equal bit for bit.
3. train_transformer at the default dropout 0.1 for LOOP_STEPS steps over
   chip_smoke's token dataset: first on rank 0 alone before joining, then
   on every rank (batch/N rows each); the replicas equal bit for bit, the
   job dir restores the final parameters. The logged step times of both
   runs are printed.

With `inference`, generate-codes and evaluate transformer:
1. Before joining, rank 0 writes chip_smoke's image dataset (1056 frames of
   128 px) and random-weight VQGANConfig() and MIGTConfig() job dirs, and
   runs generate_codes (batch chip_smoke.CB_BATCH) over it and
   evaluate_transformer over chip_smoke.RandomSequences (64 sequences of
   20 frames, batches of chip_smoke.B, every sample stored) alone: the
   one-process reference, run twice (a cold and a warm pass). Then once
   more at the per-rank batch (CB_BATCH / N frames, B / N sequences): the
   witness, whose GEMMs and convolutions see the rows the ranks' see.
2. Joined, every rank runs the same two commands twice (batch/N rows each;
   rank 0 writes); the second, warm pass is compared and timed. Rank 0
   holds its outputs against both one-process runs, after checking that
   each split has as many sequences on both sides: against the witness,
   every code and stored image equal and results.json within WITNESS_TOL
   (|a - b| <= tol * (1 + |b|)); against the reference, results.json
   within chip_smoke.LOGITS_TOL so and at least chip_smoke.CB_CODES_EQUAL
   of the codes equal (bf16 GEMMs of N times fewer rows round otherwise
   and flip near-tied codes, which the witness separates from a fault of
   the data axis). On the CPU (f32) both within CPU_TOL, every code equal.
   The records hold frames/s, seconds a batch, load_model's seconds and
   the seconds of each gather_rows call (rank 0 waits there for the
   slowest rank).

With `tensor` and/or `seq`, training on the mesh's other axes
(parallel/mesh.py): `tensor` takes the meshes 1x1xN and, at N = 4, 2x1x2;
`seq` 1xNx1 and, at N = 4, 1x2x2 (data x seq x model). For each mesh:
1. Before joining, each rank takes 2 dropout-0 train steps (MIGTConfig(),
   the global batch of chip_smoke.TRAIN_B sequences) and times
   RECIPE_STEPS default-recipe steps (dropout 0.1) after a warm-up one,
   alone: the one-process reference.
2. Joined, create_mesh(D, M, seq_parallelism=S) and the same 2 steps on
   the mesh (the state sharded over `model`, the frames over `seq`), judged
   by steps_agree against the reference (each tensor gathered to the
   one-process layout); then the default-recipe steps timed on the mesh
   with each rank's peak memory.
3. train_transformer(mesh=) at dropout 0.1 for LOOP_STEPS steps: the job
   dir holds the one-process layout of the final parameters, which rank 0
   loads with load_model in one process.

Rank 0 prints each rank's JSON record, writes them to
chiprun_out/ddp<N>[_inference|_tensor|_seq|_tensor_seq][_cpu].json and the
line `ok` (exit 0) or `FAILED` (exit 1).

With `depth` (one card, no torchrun): chip_smoke.py phase 6's comparison at
MIGTConfig()'s full 12 layers, which the script itself runs at 4 and 2 for
its time: one train step on 2 sequences on the card (bf16, kernels, remat)
and on the CPU (f32, plain twins) from the same weights, batch and dropout
seeds, then 3 steps' updates, at dropout 0 and at 0.1, within phase 6's
bounds (chip_smoke.TRAIN_LOSS_TOL, GRAD_COSINE, UPDATE_COSINE). It writes
chiprun_out/ddp_depth.json and prints `ok` or `FAILED`.
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
from viewformer_tpu_torch.parallel import distributed, sharding  # noqa: E402
from viewformer_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from viewformer_tpu_torch.train import transformer as ttt  # noqa: E402
from viewformer_tpu_torch.train.checkpoint import restore_checkpoint  # noqa: E402

LOOP_STEPS = 4
RECIPE_STEPS = 3
# results.json's tolerance (rtol = atol): against the witness on the
# cards, the evaluator tests' (tests/test_torch_evaluate.py); on the CPU
# (f32) against both the witness and the one-process run
WITNESS_TOL, CPU_TOL = 1e-4, 1e-6


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


def compare_steps(run, reference, n_layer):
    """The record of a run's chip_smoke.mesh_steps against the one-process
    reference's: losses, seconds a step, the losses' largest relative
    error, the least cosine and the farthest norm ratio from 1 of every
    nonzero gradient of every step, the updates' cosines of
    chip_smoke.compared's tensors, the parameters' largest difference and
    whether the replicas are equal."""
    losses, times, params, moved, grads = run
    ref_losses, ref_times, ref_params, ref_moved, ref_grads = reference
    nonzero = [(g[k], r[k]) for g, r in zip(grads, ref_grads) for k in r if r[k].any()]
    return {
        'losses': losses, 'reference_losses': ref_losses, 'step_s': times,
        'reference_step_s': ref_times,
        'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        'grad_cosine_min': min(cs.cosine(g, r) for g, r in nonzero),
        'grad_norm_ratio_err': max(abs(cs.norm_ratio(g, r) - 1) for g, r in nonzero),
        'update_cosine': {k: cs.cosine(moved[k], ref_moved[k]) for k in cs.compared(n_layer)},
        'max_abs_param_diff': max((params[k].float() - ref_params[k].float()).abs().max().item()
                                  for k in params),
        'replicas_equal': cs.replicas_equal(params.values())}


def steps_agree(record):
    """Whether a compare_steps record passes: phase 14's bounds, set for
    bf16 on the card against bf16 on the same card (and so met by f32
    against f32 on the CPU): the losses within chip_smoke.MESH_LOSS_TOL
    (relative), every gradient's cosine at least MESH_GRAD_COSINE and its
    norm within MESH_GRAD_NORM_TOL of the reference's, the updates' cosines
    at least MESH_UPDATE_COSINE, and the replicas equal. Phase 6's bounds
    (f32 on the CPU against bf16 on the card) would pass a wrong mean."""
    return bool(record['replicas_equal']
                and record['loss_rel_err'] <= cs.MESH_LOSS_TOL
                and record['grad_cosine_min'] >= cs.MESH_GRAD_COSINE
                and record['grad_norm_ratio_err'] <= cs.MESH_GRAD_NORM_TOL
                and min(record['update_cosine'].values()) >= cs.MESH_UPDATE_COSINE)


def logged_times(job):
    return [r['time'] for r in cs.read_metrics(job).values() if 'train/loss' in r]


def save_job(path, config):
    """A random-weight model of `config` (seed 0) saved as a port job dir."""
    from viewformer_tpu_torch.models import AutoModel
    from viewformer_tpu_torch.train.checkpoint import CheckpointManager

    model = AutoModel.from_config(config, torch.float32, 'cpu', torch.Generator().manual_seed(0))
    mgr = CheckpointManager(path, config)
    mgr.save(0, {'model': model.state_dict()})
    mgr.close()
    return path


def tiny_sizes():
    """chip_smoke's sizes cut for the CPU: 16 px, 4-frame sequences."""
    cs.SIZE, cs.S, cs.B, cs.EVAL_SEQUENCES = 16, 4, 4, 8
    cs.CB_SEQUENCES, cs.CB_FRAMES, cs.CB_SHARD, cs.CB_BATCH = {'train': 4, 'test': 2}, 5, 2, 8


def inference_inputs(tmp, cpu):
    """Rank 0's image dataset and job dirs (tiny on the CPU)."""
    from viewformer_tpu_torch.config import VQGANConfig

    if cpu:
        codebook = VQGANConfig(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                               z_channels=32, embed_dim=8, n_embed=16, image_size=16)
        transformer = MIGTConfig(n_embeddings=16, n_head=2, d_model=32, n_layer=2,
                                 token_image_size=8, sequence_size=cs.S)
    else:
        codebook, transformer = VQGANConfig(), MIGTConfig()
    return (cs.codebook_dataset(os.path.join(tmp, 'images')),
            {'codebook': save_job(os.path.join(tmp, 'codebook'), codebook),
             'transformer': save_job(os.path.join(tmp, 'transformer'), transformer)})


def inference_pass(images, jobs, out, cpu, world=1):
    """generate_codes and evaluate_transformer into `out`, at batches of
    chip_smoke.CB_BATCH / world frames and chip_smoke.B / world sequences
    (every sequence's images stored): their seconds, frames/s,
    load_model's seconds, each evaluation batch's seconds and the seconds
    spent in gather_rows."""
    from viewformer_tpu_torch.commands import generate_codes as gc
    from viewformer_tpu_torch.evaluate import transformer as etransformer
    from viewformer_tpu_torch.ops import attention_cuda as ac

    sync = (lambda: None) if cpu else torch.cuda.synchronize
    loads, load = [], gc.load_model
    gathers, gather = [], distributed.gather_rows

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        model = load(*args, **kwargs)
        sync()
        loads.append(time.perf_counter() - t0)
        return model

    def timed_gather(rows):
        t0 = time.perf_counter()
        gathered = gather(rows)
        gathers.append(time.perf_counter() - t0)
        return gathered

    gc.load_model = timed_load
    try:
        sync()
        t0 = time.perf_counter()
        gc.generate_codes(images, os.path.join(out, 'codes'), jobs['codebook'],
                          batch_size=cs.CB_BATCH // world, progress=False,
                          use_bfloat16=not cpu, device='cpu' if cpu else 'cuda')
        sync()
        codes_s = time.perf_counter() - t0
    finally:
        gc.load_model = load
    frames = sum(cs.CB_SEQUENCES.values()) * cs.CB_FRAMES
    if cpu:
        torch.cuda.synchronize = sync  # record_calls synchronizes the card
    distributed.gather_rows = timed_gather
    try:
        with cs.record_calls(ac, etransformer, 'generate_batch_predictions') as calls:
            sync()
            t0 = time.perf_counter()
            etransformer.evaluate_transformer(
                cs.RandomSequences(), jobs['transformer'], jobs['codebook'],
                os.path.join(out, 'evaluate'), batch_size=cs.B // world,
                num_store_images=cs.EVAL_SEQUENCES, progress=False, use_bfloat16=not cpu,
                device='cpu' if cpu else 'cuda')
            sync()
            evaluate_s = time.perf_counter() - t0
    finally:
        distributed.gather_rows = gather
    return {'generate_codes_s': codes_s, 'frames': frames, 'frames_per_s': frames / codes_s,
            'load_model_s': loads[0], 'evaluate_s': evaluate_s,
            'batch_s': [c['s'] for c in calls], 'batch_rows': [len(c['args'][2]) for c in calls],
            'gather_s': gathers}


def inference_run(images, jobs, out, cpu):
    """inference_pass twice, into out-cold and out: the first pays for the
    kernels' build or load and the libraries' first calls on the card, the
    second is timed warm. Returns the warm pass's record, with the cold
    pass's under 'cold'."""
    cold = inference_pass(images, jobs, out + '-cold', cpu)
    return dict(inference_pass(images, jobs, out, cpu), cold=cold)


def inference_compare(expected, out, tol):
    """Rank 0: `out`'s generate-codes dataset and evaluation against
    `expected`'s: sequences of each split (equal counts), the codes that
    differ, the stored images that differ, and results.json's absolute and
    relative errors, within |a - b| <= tol * (1 + |b|) (the evaluator tests'
    rtol = atol)."""
    from viewformer_tpu_torch.data.dataset import read_dataset

    sequences, differing, total = {}, 0, 0
    for split in cs.CB_SEQUENCES:
        pair = [list(read_dataset(os.path.join(path, 'codes'), split)) for path in (expected, out)]
        sequences[split] = [len(side) for side in pair]
        for a, b in zip(*pair):
            differing += int((a['codes'] != b['codes']).sum())
            total += a['codes'].size
    stored = [sorted(name for name in os.listdir(os.path.join(path, 'evaluate'))
                     if name.endswith('.png')) for path in (expected, out)]
    images_differing = sum(
        _read(os.path.join(expected, 'evaluate', name)) != _read(os.path.join(out, 'evaluate',
                                                                                 name))
        for name in stored[0] if name in stored[1])
    results = [json.loads(_read(os.path.join(path, 'evaluate', 'results.json')))
               for path in (expected, out)]
    abs_err = {k: abs(results[1][k] - v) for k, v in results[0].items() if v is not None}
    rel_err = {k: e / max(abs(results[0][k]), 1e-12) for k, e in abs_err.items()}
    ok = (total > 0 and all(n == m for n, m in sequences.values())
          and stored[0] == stored[1] and len(stored[0]) == 2 * cs.EVAL_SEQUENCES
          and list(results[1]) == list(results[0])
          and all(e <= tol * (1 + abs(results[0][k])) for k, e in abs_err.items()))
    return {'sequences': sequences, 'codes': total, 'codes_differing': differing,
            'images': len(stored[0]), 'images_differing': images_differing,
            'results_expected': results[0], 'results': results[1], 'results_abs_err': abs_err,
            'results_rel_err': rel_err, 'tolerance': tol, 'ok': ok}


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def inference_main(cpu, rank, world):
    out = {'rank': rank, 'world': world, 'mode': 'inference'}
    if cpu:
        torch.set_num_threads(1)
        tiny_sizes()
    else:
        device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
        torch.cuda.set_device(device)
        out['card'] = subprocess.run(
            ['nvidia-smi', f'--id={device.index}', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True, check=True).stdout.strip()
    shared = [None, None, None]
    if rank == 0:
        tmp = tempfile.mkdtemp(prefix='ddp_check_')
        images, jobs = inference_inputs(tmp, cpu)
        out['one_process'] = inference_run(images, jobs, os.path.join(tmp, 'one'), cpu)
        out['witness'] = inference_pass(images, jobs, os.path.join(tmp, 'witness'), cpu, world)
        shared = [tmp, images, jobs]
    distributed.initialize_distributed('cpu' if cpu else 'cuda')
    dist.broadcast_object_list(shared, src=0)
    tmp, images, jobs = shared
    out['ranks'] = inference_run(images, jobs, os.path.join(tmp, 'ranks'), cpu)
    dist.barrier()
    if rank == 0:
        ranks = os.path.join(tmp, 'ranks')
        out['compare_witness'] = inference_compare(os.path.join(tmp, 'witness'), ranks,
                                                   CPU_TOL if cpu else WITNESS_TOL)
        out['compare'] = inference_compare(os.path.join(tmp, 'one'), ranks,
                                           CPU_TOL if cpu else cs.LOGITS_TOL)
    results = [None] * world
    dist.all_gather_object(results, out)
    dist.destroy_process_group()
    if rank != 0:
        return
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out',
                           f'ddp{world}_inference{"_cpu" if cpu else ""}.json'), 'w') as f:
        json.dump(results, f, indent=1)
    for r in results:
        print(json.dumps(r))
    witness, compare = results[0]['compare_witness'], results[0]['compare']
    ok = (witness['ok'] and witness['codes_differing'] == 0 and witness['images_differing'] == 0
          and compare['ok'] and (compare['codes_differing'] == 0 if cpu else
                                 compare['codes_differing'] <= (1 - cs.CB_CODES_EQUAL)
                                 * compare['codes']))
    print('ok' if ok else 'FAILED')
    sys.exit(0 if ok else 1)


def meshes_of(kinds, world):
    """The (D, S, M) meshes of the `tensor` and `seq` modes."""
    meshes = []
    if 'tensor' in kinds:
        meshes += [(1, 1, world)] + ([(2, 1, 2)] if world == 4 else [])
    if 'seq' in kinds:
        meshes += [(1, world, 1)] + ([(1, 2, 2)] if world == 4 else [])
    return meshes


def recipe_times(config, rows, dtype, device):
    """RECIPE_STEPS default-recipe steps (dropout 0.1) on the current mesh
    after a warm-up one: (host seconds a step, peak GB on this rank's
    card, None on the CPU)."""
    mesh = mesh_lib.current_mesh()
    model, state = ttt.init_transformer_state(
        config, torch.Generator().manual_seed(0), dtype, device)
    sharding.shard_transformer_state(model, state, mesh)
    batch = tuple(distributed.shard_rows(x) for x in cs.train_batch(rows, seed=401,
                                                                     device=device))
    step = ttt.make_transformer_train_step(model, config)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(RECIPE_STEPS + 1):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, torch.Generator().manual_seed(i))
        metrics['loss'].item()
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(device) / 1e9 if device.type == 'cuda' else None)
    del model, state
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return times[1:], peak


def mesh_main(kinds, cpu, rank, world):
    config, rows, dtype, device = setup(cpu)
    out = {'rank': rank, 'world': world, 'device': str(device), 'mode': '_'.join(kinds)}
    if not cpu:
        out['card'] = subprocess.run(
            ['nvidia-smi', f'--id={device.index}', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True, check=True).stdout.strip()
    no_dropout = dataclasses.replace(config, dropout=0.0)
    batch = cs.train_batch(rows, seed=400, device=device)
    reference = cs.mesh_steps(no_dropout, batch, dtype, device)
    out['one_process'] = dict(zip(('step_s', 'peak_gb'),
                                  recipe_times(config, rows, dtype, device)))
    tmp = tempfile.mkdtemp(prefix='ddp_check_') if rank == 0 else None
    if rank == 0:
        cs.write_token_dataset(os.path.join(tmp, 'tokens'))
    distributed.initialize_distributed('cpu' if cpu else 'cuda')
    shared = [tmp]
    dist.broadcast_object_list(shared, src=0)
    tmp = shared[0]
    out['meshes'], ok = {}, True
    for shape in meshes_of(kinds, world):
        D, S, M = shape
        mesh = mesh_lib.create_mesh(D, M, seq_parallelism=S)
        name = 'x'.join(map(str, shape))
        record = {'coords': mesh.coords,
                  **compare_steps(cs.mesh_steps(no_dropout, batch, dtype, device), reference,
                                  config.n_layer)}
        record['recipe_step_s'], record['recipe_peak_gb'] = recipe_times(config, rows, dtype,
                                                                          device)
        job = os.path.join(tmp, name)
        model, _ = ttt.train_transformer(
            config, os.path.join(tmp, 'tokens'), job, total_steps=LOOP_STEPS, epochs=1,
            batch_size=rows, progress=False, log_every=1, profile_batch=0, mesh=mesh,
            device='cpu' if cpu else 'cuda')
        final = sharding.unshard_state_dict(model.state_dict(), mesh)
        record['loop_replicas_equal'] = cs.replicas_equal(final.values())
        if rank == 0:
            from viewformer_tpu_torch.models import load_model

            restored, step = restore_checkpoint(job, prefer='last')
            loaded = load_model(job, torch.float32, 'cpu').state_dict()
            record.update(
                loop_restored_step=step, loop_times=logged_times(job),
                loop_restored_equal=all(torch.equal(restored['model'][k], v.cpu())
                                        for k, v in final.items()),
                loop_loaded_keys=sorted(loaded) == sorted(final))
        del model, final
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        out['meshes'][name] = record
        ok = ok and (steps_agree(record) and record['loop_replicas_equal']
                     and (rank != 0 or (record['loop_restored_step'] == LOOP_STEPS
                                        and record['loop_restored_equal']
                                        and record['loop_loaded_keys'])))
    out['ok'] = ok
    results = [None] * world
    dist.all_gather_object(results, out)
    dist.destroy_process_group()
    if rank != 0:
        return
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out',
                           f'ddp{world}_{out["mode"]}{"_cpu" if cpu else ""}.json'), 'w') as f:
        json.dump(results, f, indent=1)
    for r in results:
        print(json.dumps(r))
    ok = all(r['ok'] for r in results)
    print('ok' if ok else 'FAILED')
    sys.exit(0 if ok else 1)


def depth_main():
    """The `depth` mode: chip_smoke.train_card_vs_cpu at MIGTConfig()'s
    12 layers, at dropout 0 and at the default 0.1, on one card."""
    if not torch.cuda.is_available():
        raise SystemExit('ddp_check depth: torch.cuda.is_available() is false; '
                         'the mode compares a card with the CPU')
    from viewformer_tpu_torch.ops import attention_cuda as ac

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    ac.build()
    log, ok = [], True
    for rate in (0.0, cs.RATE):
        t0, records = time.perf_counter(), len(log)
        try:
            cs.train_card_vs_cpu(dataclasses.replace(MIGTConfig(), dropout=rate), log)
        except RuntimeError as err:
            if len(log) == records:  # not a chip_smoke.check, which emits the record first
                raise
            print(err, flush=True)
            ok = False
        log[-1].update(card=card, seconds=time.perf_counter() - t0,
                       cpu_threads=torch.get_num_threads())
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ddp_depth.json'), 'w') as f:
        json.dump(log, f, indent=1)
    print('ok' if ok else 'FAILED')
    sys.exit(0 if ok else 1)


def main():
    args = sys.argv[1:]
    if 'depth' in args:
        return depth_main()
    cpu = 'cpu' in args
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    if 'inference' in args:
        return inference_main(cpu, rank, world)
    kinds = [kind for kind in ('tensor', 'seq') if kind in args]
    if kinds:
        return mesh_main(kinds, cpu, rank, world)
    config, rows, dtype, device = setup(cpu)
    out = {'rank': rank, 'world': world, 'device': str(device)}
    if not cpu:
        out['card'] = subprocess.run(
            ['nvidia-smi', f'--id={device.index}', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True, check=True).stdout.strip()

    # before joining: the one-process reference, and rank 0's plain loop
    no_dropout = dataclasses.replace(config, dropout=0.0)
    batch = cs.train_batch(rows, seed=400, device=device)
    reference = cs.mesh_steps(no_dropout, batch, dtype, device)
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
    out['step'] = compare_steps(cs.mesh_steps(no_dropout, batch, dtype, device), reference,
                                config.n_layer)
    del reference

    job = os.path.join(tmp, 'ddp')
    model = loop(job)
    out['loop'] = {'replicas_equal': cs.replicas_equal(model.parameters())}
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
          and all(steps_agree(r['step']) and r['loop']['replicas_equal'] for r in results))
    print('ok' if ok else 'FAILED')
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
