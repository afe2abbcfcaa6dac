"""The early-collapse rate of the codebook stage over seeds, on one card.

    python tests/codebook_sweep.py [--seeds 0-15] [--budget-s SECONDS]
        [--draws jax,torch] [--variant bf16] [--out codebook_sweep.json]

Writes the colors quality gate's dataset (200 sequences x 20 frames at
128 px) once, then runs `train codebook` through the port's CLI, in this
process, at the gate's flags (batch 32, lr 1.44e-4, perceptual weight 0)
but --total-steps 200 --epochs 1, once a seed and draw, every seed of the
first draw before the next draw (a cut run has the first draw's seeds
whole):

  jax    the CLI as it is: the JAX package's initial draw of the seed
         (utils/convert.jax_initial_state);
  torch  the draw from torch.Generator().manual_seed(seed), through
         init_codebook_state's generator=, patched in for that run only.

A run's reading is the train perplexity logged at step READ_STEP (the
step's own batch): below COLLAPSED it counts as collapsed (the gate's
collapsed seed read 3.66 there, a healthy one 13.5). Each run also keeps
its logged perplexities, the validation PSNR at its end and its seconds.
No new run starts once --budget-s seconds have passed. The JSON report is
rewritten after every run. --variant runs every seed with one of
tests/codebook_precision.py's variants of the VQ-GAN's compute (default
bf16: the CLI as it is). Not a test: each run is 200 full-width steps on
the card.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from unittest import mock

import torch

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

from codebook_precision import VARIANTS, variant, write_gate_dataset  # noqa: E402
from viewformer_tpu_torch import cli  # noqa: E402
from viewformer_tpu_torch.train import codebook  # noqa: E402

COLLAPSED = 8.0
DRAWS = ('jax', 'torch')
TOTAL_STEPS, READ_STEP = 200, 150
SEQUENCES, IMAGE_SIZE = 200, 128
GATE_CODEBOOK_FLAGS = ['--batch-size', '32', '--learning-rate', '1.44e-4',
                       '--perceptual-weight', '0']


def parse_seeds(text):
    """'0-15' or '0,3,7' -> a list of ints."""
    seeds = []
    for part in text.split(','):
        lo, _, hi = part.partition('-')
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def read_run(job_dir):
    perplexity, val_psnr = {}, None
    with open(os.path.join(job_dir, 'metrics.jsonl')) as f:
        for line in f:
            record = json.loads(line)
            if 'train/perplexity' in record:
                perplexity[record['step']] = record['train/perplexity']
            if 'val/psnr' in record:
                val_psnr = record['val/psnr']
    reading = perplexity.get(READ_STEP)
    return {'perplexity': perplexity, 'val_psnr': val_psnr, 'reading': reading,
            'collapsed': None if reading is None else reading < COLLAPSED}


def train_one(dataset, job_dir, seed, draw):
    argv = ['train', 'codebook', '--dataset', dataset, '--job-dir', job_dir,
            '--total-steps', str(TOTAL_STEPS), '--epochs', '1', '--seed', str(seed)]
    if draw == 'jax':
        cli.main(argv + GATE_CODEBOOK_FLAGS)
        return
    init = codebook.init_codebook_state

    def torch_draw(*args, jax_seed, **kw):
        return init(*args, generator=torch.Generator().manual_seed(jax_seed), **kw)

    with mock.patch.object(codebook, 'init_codebook_state', torch_draw):
        cli.main(argv + GATE_CODEBOOK_FLAGS)


def summarize(runs):
    summary = {}
    for draw in sorted({run['draw'] for run in runs}):
        read = [run for run in runs if run['draw'] == draw and run['collapsed'] is not None]
        summary[draw] = {'seeds': len(read),
                         'collapsed': sum(run['collapsed'] for run in read),
                         'collapsed_seeds': [run['seed'] for run in read if run['collapsed']]}
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seeds', default='0-15')
    ap.add_argument('--budget-s', type=float, default=None)
    ap.add_argument('--draws', default=','.join(DRAWS))
    ap.add_argument('--variant', default='bf16', choices=VARIANTS)
    ap.add_argument('--out', default='codebook_sweep.json')
    args = ap.parse_args()

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix='codebook_sweep_')
    dataset = os.path.join(workdir, 'img')
    write_gate_dataset(dataset)
    report = {'config': {'total_steps': TOTAL_STEPS, 'read_step': READ_STEP,
                         'collapsed_below': COLLAPSED, 'flags': GATE_CODEBOOK_FLAGS,
                         'image_size': IMAGE_SIZE, 'dataset_sequences': SEQUENCES,
                         'variant': args.variant},
              'dataset_s': time.perf_counter() - t0, 'runs': []}
    for draw in args.draws.split(','):
        for seed in parse_seeds(args.seeds):
            if args.budget_s is not None and time.perf_counter() - t0 > args.budget_s:
                report['cut'] = f'budget of {args.budget_s} s spent before {draw} seed {seed}'
                break
            job_dir = os.path.join(workdir, f'codebook_{draw}_{seed}')
            start = time.perf_counter()
            with variant(args.variant):
                train_one(dataset, job_dir, seed, draw)
            run = {'seed': seed, 'draw': draw, 'seconds': time.perf_counter() - start,
                   **read_run(job_dir)}
            shutil.rmtree(job_dir, ignore_errors=True)
            report['runs'].append(run)
            report['summary'] = summarize(report['runs'])
            with open(args.out, 'w') as f:
                json.dump(report, f, indent=1)
            print(json.dumps({k: run[k] for k in ('seed', 'draw', 'reading', 'collapsed',
                                                  'val_psnr', 'seconds')}), flush=True)
        if 'cut' in report:
            break
    report['seconds'] = time.perf_counter() - t0
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report.get('summary')), flush=True)
    shutil.rmtree(workdir, ignore_errors=True)


if __name__ == '__main__':
    main()
