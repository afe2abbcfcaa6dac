"""Which rounding of the codebook stage's bf16 step on the card decides the
frozen code map: the colors quality gate's codebook flags from the JAX
package's draws, STEPS steps a run, every step logged, with chosen parts of
the VQ-GAN computing in f32 or rounding where XLA rounds, the rest as the
port computes them.

    python tests/codebook_precision.py [--variants a,b,...] [--seeds 1337,4,9,10]
        [--out DIR]

One card. Writes the gate's dataset (200 sequences x 20 frames at 128 px)
once, then runs `train codebook` through the port's CLI in this process,
one run a variant and seed (by default the JAX-draw seeds that freeze in
bf16: 1337, 4, 9 and 10). Variants, each a set of patches of
models/vqgan.py applied for its runs only:

  bf16            the CLI as it is
  f32             every convolution in f32: the model computes in f32, as
                  `train codebook --fp32`
  enc_f32         the encoder's convolutions and quant_conv in f32
  dec_f32         post_quant_conv and the decoder's convolutions in f32
  quant_conv_f32  quant_conv alone in f32 (the latents' last rounding)
  enc_out_f32     the encoder's conv_out and quant_conv in f32

and the roundings of a TPU, which keeps f32 inside a fusion and rounds to
bf16 at its output (the port rounds after every op):

  gn_silu         GroupNorm32 returns f32, so that SiLU runs on it in f32
                  and the result is rounded once, as the next
                  convolution's operand (the port: GroupNorm's output
                  rounded, SiLU's rounded again)
  residual        a ResnetBlock's and an AttnBlock's last convolution
                  without its bias, rounded once, then its bias and the
                  residual added in f32 and rounded once (the port rounds
                  after the bias and after the add)
  fused           gn_silu and residual
  xla             fused, and every convolution's bf16 products accumulated
                  and returned in f32 (TF32 holds bf16 values exactly), its
                  bias (and the residual) added in f32, one rounding: the
                  MXU's f32 accumulator with the bias fused into the
                  convolution's output

A run is frozen when its last 20 logged perplexities are one value (the
code map no longer depends on the input); it moves when it is not frozen
and its perplexity at the last step is above 8 (tests/codebook_sweep.py's
reading). DIR/results.json gets each run's perplexity every 10 steps, the
validation PSNR at its end and its seconds; DIR/<variant>_<seed>.metrics.
jsonl its whole log. Not a test: each run is STEPS full-width steps on the
card. tests/codebook_sweep.py --variant runs a variant over more seeds.
"""
import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from unittest import mock

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from viewformer_tpu_torch import cli  # noqa: E402
from viewformer_tpu_torch.models import vqgan  # noqa: E402
from viewformer_tpu_torch.train import codebook  # noqa: E402

SEEDS = (1337, 4, 9, 10)
STEPS = 150
MOVED = 8.0
F32_CONVS = {
    'f32': lambda name: True,
    'enc_f32': lambda name: name.startswith('encoder') or name == 'quant_conv',
    'dec_f32': lambda name: name.startswith('decoder') or name == 'post_quant_conv',
    'quant_conv_f32': lambda name: name == 'quant_conv',
    'enc_out_f32': lambda name: name in ('quant_conv', 'encoder.conv_out'),
}
ROUNDINGS = {'gn_silu': {'gn_silu'}, 'residual': {'residual'},
             'fused': {'gn_silu', 'residual'}, 'xla': {'gn_silu', 'residual', 'conv_f32'}}
VARIANTS = ('bf16',) + tuple(F32_CONVS) + tuple(ROUNDINGS)
GATE_CODEBOOK_FLAGS = ['--batch-size', '32', '--learning-rate', '1.44e-4',
                       '--perceptual-weight', '0']


def with_f32(select):
    """init_codebook_state whose model computes the convolutions that
    `select(name)` picks in f32."""
    init = codebook.init_codebook_state

    def patched(*args, **kw):
        model, state = init(*args, **kw)
        for name, module in model.named_modules():
            if isinstance(module, vqgan.Conv) and select(name):
                module.dtype = torch.float32
        return model, state
    return patched


def _product(conv, x, f32):
    """conv's product of x without its bias: in conv.dtype, or with f32
    the bf16 operands' products accumulated and returned in f32."""
    if not f32:
        return conv._conv_forward(x.to(conv.dtype), conv.weight.to(conv.dtype), None)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        return conv._conv_forward(x.to(conv.dtype).float(), conv.weight.to(conv.dtype).float(),
                                  None)


def rounding_patches(names):
    """The patches of models/vqgan.py for the set of ROUNDINGS `names`."""
    f32 = 'conv_f32' in names
    patches = []
    if 'gn_silu' in names:
        def group_norm(self, x):
            return F.group_norm(x.float(), 32, self.weight, self.bias, 1e-6)
        patches.append(mock.patch.object(vqgan.GroupNorm32, 'forward', group_norm))
    if f32:
        def conv(self, x):
            return (_product(self, x, True) + self.bias.float()[:, None, None]).to(self.dtype)
        patches.append(mock.patch.object(vqgan.Conv, 'forward', conv))
    if 'residual' in names:
        def last(conv, h, x):
            out = _product(conv, h, f32).float() + conv.bias.float()[:, None, None] + x.float()
            return out.to(x.dtype)

        def resnet(self, x):
            h = self.conv1(F.silu(self.norm1(x)))
            h = F.silu(self.norm2(h))
            if self.nin_shortcut is not None:
                x = self.nin_shortcut(x)
            return last(self.conv2, h, x)

        def attention(self, x):
            B, C, H, W = x.shape
            h = self.norm(x)
            q = self.q(h).flatten(2).transpose(1, 2)
            k = self.k(h).flatten(2)
            v = self.v(h).flatten(2).transpose(1, 2)
            weights = torch.softmax(torch.bmm(q.float(), k.float()) * (C ** -0.5), -1)
            out = torch.bmm(weights.to(v.dtype), v).transpose(1, 2).reshape(B, C, H, W)
            return last(self.proj_out, out, x)
        patches += [mock.patch.object(vqgan.ResnetBlock, 'forward', resnet),
                    mock.patch.object(vqgan.AttnBlock, 'forward', attention)]
    return patches


@contextlib.contextmanager
def variant(name):
    """Apply VARIANTS' `name` to the codebook models built inside."""
    with contextlib.ExitStack() as stack:
        if name in F32_CONVS:
            stack.enter_context(mock.patch.object(codebook, 'init_codebook_state',
                                                  with_f32(F32_CONVS[name])))
        elif name in ROUNDINGS:
            for patch in rounding_patches(ROUNDINGS[name]):
                stack.enter_context(patch)
        elif name != 'bf16':
            raise ValueError(f'unknown variant {name!r} ({", ".join(VARIANTS)})')
        yield


def write_gate_dataset(path):
    cli.main(['dataset', 'generate', '--loader', 'colors', '--loader-num-sequences', '200',
              '--loader-sequence-size', '20', '--loader-image-size', '128', '--output',
              os.path.join(path, 'colors'), '--max-sequences-per-shard', '32',
              '--split', 'train', '--split', 'test'])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--seeds', default=','.join(map(str, SEEDS)))
    ap.add_argument('--out', default='codebook_precision')
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix='codebook_precision_')
    dataset = os.path.join(workdir, 'img')
    write_gate_dataset(dataset)
    results = []
    for name in args.variants.split(','):
        for seed in map(int, args.seeds.split(',')):
            job = os.path.join(workdir, f'{name}_{seed}')
            t0 = time.time()
            with variant(name):
                cli.main(['train', 'codebook', '--dataset', dataset, '--job-dir', job,
                          '--total-steps', str(STEPS), '--epochs', '1', '--seed', str(seed),
                          '--log-every', '1'] + GATE_CODEBOOK_FLAGS)
            with open(os.path.join(job, 'metrics.jsonl')) as f:
                rows = [json.loads(line) for line in f]
            perplexity = [r['train/perplexity'] for r in rows if 'train/perplexity' in r]
            psnr = [r['val/psnr'] for r in rows if 'val/psnr' in r]
            frozen = len(set(perplexity[-20:])) == 1
            result = {'seed': seed, 'variant': name, 's': time.time() - t0, 'frozen': frozen,
                      'moved': not frozen and perplexity[-1] > MOVED,
                      'perplexity_every_10': perplexity[9::10],
                      'val_psnr': psnr[-1] if psnr else None}
            results.append(result)
            print(json.dumps(result), flush=True)
            with open(os.path.join(args.out, 'results.json'), 'w') as f:
                json.dump(results, f, indent=1)
            shutil.copy(os.path.join(job, 'metrics.jsonl'),
                        os.path.join(args.out, f'{name}_{seed}.metrics.jsonl'))
            shutil.rmtree(job)
    shutil.rmtree(workdir, ignore_errors=True)


if __name__ == '__main__':
    main()
