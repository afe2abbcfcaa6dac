"""Which part of the codebook stage's bf16 step on the card decides the
frozen code map: the colors quality gate's codebook flags from the JAX
package's draws, 100 steps a run, every step logged, with chosen parts of
the VQ-GAN computing in f32 and the rest in bf16.

    python tests/codebook_precision.py [--out DIR]

One card. Writes the gate's dataset (200 sequences x 20 frames at 128 px)
once, then runs `train codebook` through the port's CLI in this process,
seeds 1337 and 4 (both freeze in bf16 from JAX's draw), one run a
variant:

  bf16            the CLI as it is
  enc_f32         the encoder's convolutions and quant_conv in f32
  dec_f32         post_quant_conv and the decoder's convolutions in f32
  quant_conv_f32  quant_conv alone in f32 (the latents' last rounding)
  enc_out_f32     the encoder's conv_out and quant_conv in f32

A run is frozen when its last 20 logged perplexities are one value (the
code map no longer depends on the input). DIR/results.json gets each
run's perplexity every 10 steps, the validation PSNR at its end and its
seconds; DIR/<variant>_<seed>.metrics.jsonl its whole log. Not a test:
each run is 100 full-width steps on the card.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from viewformer_tpu_torch import cli  # noqa: E402
from viewformer_tpu_torch.models.vqgan import Conv  # noqa: E402
from viewformer_tpu_torch.train import codebook  # noqa: E402

SEEDS = (1337, 4)
STEPS = 100
VARIANTS = {
    'bf16': lambda name: False,
    'enc_f32': lambda name: name.startswith('encoder') or name == 'quant_conv',
    'dec_f32': lambda name: name.startswith('decoder') or name == 'post_quant_conv',
    'quant_conv_f32': lambda name: name == 'quant_conv',
    'enc_out_f32': lambda name: name in ('quant_conv', 'encoder.conv_out'),
}
GATE_CODEBOOK_FLAGS = ['--batch-size', '32', '--learning-rate', '1.44e-4',
                       '--perceptual-weight', '0']


def with_f32(select):
    """init_codebook_state whose model computes the convolutions that
    `select(name)` picks in f32."""
    init = codebook.init_codebook_state

    def patched(*args, **kw):
        model, state = init(*args, **kw)
        for name, module in model.named_modules():
            if isinstance(module, Conv) and select(name):
                module.dtype = torch.float32
        return model, state
    return patched


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default='codebook_precision')
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix='codebook_precision_')
    dataset = os.path.join(workdir, 'img')
    cli.main(['dataset', 'generate', '--loader', 'colors', '--loader-num-sequences', '200',
              '--loader-sequence-size', '20', '--loader-image-size', '128', '--output',
              os.path.join(dataset, 'colors'), '--max-sequences-per-shard', '32',
              '--split', 'train', '--split', 'test'])
    results = []
    for seed in SEEDS:
        for variant, select in VARIANTS.items():
            job = os.path.join(workdir, f'{variant}_{seed}')
            t0 = time.time()
            with mock.patch.object(codebook, 'init_codebook_state', with_f32(select)):
                cli.main(['train', 'codebook', '--dataset', dataset, '--job-dir', job,
                          '--total-steps', str(STEPS), '--epochs', '1', '--seed', str(seed),
                          '--log-every', '1'] + GATE_CODEBOOK_FLAGS)
            with open(os.path.join(job, 'metrics.jsonl')) as f:
                rows = [json.loads(line) for line in f]
            perplexity = [r['train/perplexity'] for r in rows if 'train/perplexity' in r]
            psnr = [r['val/psnr'] for r in rows if 'val/psnr' in r]
            result = {'seed': seed, 'variant': variant, 's': time.time() - t0,
                      'frozen': len(set(perplexity[-20:])) == 1,
                      'perplexity_every_10': perplexity[9::10],
                      'val_psnr': psnr[-1] if psnr else None}
            results.append(result)
            print(json.dumps(result), flush=True)
            with open(os.path.join(args.out, 'results.json'), 'w') as f:
                json.dump(results, f, indent=1)
            shutil.copy(os.path.join(job, 'metrics.jsonl'),
                        os.path.join(args.out, f'{variant}_{seed}.metrics.jsonl'))
            shutil.rmtree(job)
    shutil.rmtree(workdir, ignore_errors=True)


if __name__ == '__main__':
    main()
