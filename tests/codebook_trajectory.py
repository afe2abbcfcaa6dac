"""The codebook stage's first training steps at VQGANConfig()'s full width
on the CPU, in f32 or (--bf16) in bf16 compute with f32 parameters, from
the JAX package's draw of jax.random.PRNGKey(1337), in either package, to
hold the two trajectories against each other.

    python tests/codebook_trajectory.py batches --out B.npy [--steps 40] [--batch 32] [--gate]
    python tests/codebook_trajectory.py jax|port --batches B.npy --out DIR [--lr 1.44e-4]
        [--bf16] [--steps N] [--layers]
    python tests/codebook_trajectory.py compare DIR_A DIR_B
    python tests/codebook_trajectory.py table PORT_BF16 JAX_BF16 PORT_F32 JAX_F32

`batches` writes [steps, batch, 128, 128, 3] uint8 frames: with --gate the
colors quality gate's own first batches (its fixture of 200 sequences of 20
frames, read as `train codebook --seed 1337 --batch-size 32` reads them),
else colors frames picked with numpy seed 0. `jax` and `port` train one
step a batch (perceptual weight 0, Adam as the gate's, remat), print a JSON
line a step (losses, perplexity, the codebook columns alive) and keep each
step's codebook and the first step's gradients in DIR. `compare` prints
the largest differences step by step. --bf16 builds JAX's
create_codebook_model(config, jnp.bfloat16, remat=True) and the port's
VQGAN(dtype=torch.bfloat16, param_dtype=torch.float32); --steps N trains
the first N batches only. --layers first keeps, in DIR/acts1.npz, the
output of every ResnetBlock and AttnBlock and of quant_conv (NHWC) in a
forward of the first batch from the initial state. `table` holds those
outputs and the first step's gradients of the six parameters that
chip_smoke.codebook_card_vs_cpu names: the port's bf16 against JAX's
bf16, beside the port's f32 against JAX's f32 (the floor) and JAX's bf16
against JAX's f32 (the size of bf16's own rounding). XLA on the CPU is
not a TPU: a TPU keeps f32 inside a fusion and rounds at its output, XLA's
CPU compiler rounds a bf16 computation at nearly every op, with
`XLA_FLAGS=--xla_allow_excess_precision=false` or without (59 and 65
converts in one ResnetBlock's optimized HLO). Not a test: every step is a full-width backward on the CPU (tens of
seconds at batch 32, and ~17 GB of memory in the jax run).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
SEED = 1337
# chip_smoke.codebook_card_vs_cpu's parameters, in JAX's names
GRAD_NAMES = ('encoder/conv_in/kernel', 'encoder/mid_attn_1/q/kernel', 'quant_conv/kernel',
              'decoder/conv_in/kernel', 'decoder/up_0_block_1/conv2/kernel',
              'decoder/conv_out/kernel')


def write_batches(args):
    if args.gate:
        from viewformer_tpu_torch import cli
        from viewformer_tpu_torch.data.pipeline import load_image_dataset
        tmp = tempfile.mkdtemp()
        ds = os.path.join(tmp, 'img')
        cli.main(['dataset', 'generate', '--loader', 'colors', '--loader-num-sequences', '200',
                  '--loader-sequence-size', '20', '--loader-image-size', '128', '--output',
                  os.path.join(ds, 'colors'), '--max-sequences-per-shard', '32',
                  '--split', 'train', '--split', 'test'])
        data = load_image_dataset(ds, args.batch, 128, split='train', repeat=-1, seed=SEED,
                                  output_dtype='uint8')
        it = iter(data)
        frames = np.stack([next(it) for _ in range(args.steps or 40)])
        data.close()
        shutil.rmtree(tmp)
    else:
        from viewformer_tpu_torch.data.loaders.colors import ColorsLoader
        loader = ColorsLoader('train', num_sequences=200, sequence_size=20, image_size=128)
        rs = np.random.RandomState(0)
        steps = args.steps or 40
        picks = [(rs.randint(200), rs.randint(20)) for _ in range(steps * args.batch)]
        frames = np.stack([loader[s]['frames'][f] for s, f in sorted(picks)])
        frames = frames[rs.permutation(len(frames))].reshape(steps, args.batch, 128, 128, 3)
    np.save(args.out, frames)


def record(out, i, metrics, embeddings, seconds):
    rec = {k: float(v) for k, v in metrics.items()}
    rec.update(step=i + 1, live=int((np.abs(embeddings).sum(0) > 0).sum()), s=seconds)
    np.save(os.path.join(out, f'emb{i + 1}.npy'), embeddings)
    with open(os.path.join(out, 'log.jsonl'), 'a') as f:
        f.write(json.dumps(rec) + '\n')
    print(json.dumps(rec), flush=True)


def run_jax(batches, args):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    from flax import traverse_util
    from viewformer_tpu.config import VQGANConfig
    from viewformer_tpu.models.vqgan import AttnBlock, ResnetBlock
    from viewformer_tpu.train import codebook as jcb

    config = VQGANConfig(perceptual_weight=0.0, learning_rate=args.lr,
                         batch_size=batches.shape[1])
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    model = jcb.create_codebook_model(config, dtype, remat=True)
    optimizer = jcb.create_codebook_optimizer(config)
    params_rng, quantizer_rng = jax.random.split(jax.random.PRNGKey(SEED))
    dummy = jnp.zeros((1, 128, 128, 3), jnp.float32)
    # model.init under jit: the same keys draw the same weights as
    # init_codebook_state's eager init, without its op-by-op compiles
    v = jax.jit(lambda a, b: model.init({'params': a, 'quantizer': b}, dummy, training=False))(
        params_rng, quantizer_rng)
    state = jcb.CodebookTrainState(v['params'], v['quantizer'], optimizer.init(v['params']),
                                   jnp.zeros((), jnp.int32))
    if args.layers:
        # the same forward without remat, so that flax sees the blocks' own classes
        plain = jcb.create_codebook_model(config, dtype)

        def layer(mdl, method):
            return method == '__call__' and (isinstance(mdl, (ResnetBlock, AttnBlock))
                                             or mdl.name == 'quant_conv')
        _, acts = jax.jit(lambda p, q, x: plain.apply(
            {'params': p, 'quantizer': q}, jcb._normalize_batch(x), training=False,
            capture_intermediates=layer, mutable=['intermediates']))(
            state.params, state.quantizer, jnp.asarray(batches[0]))
        acts = traverse_util.flatten_dict(jax.device_get(acts['intermediates']))
        np.savez(os.path.join(args.out, 'acts1.npz'), **{
            '/'.join(k[:-1]): np.asarray(a[0], np.float32) for k, a in acts.items()})
    grad = jax.jit(jax.grad(lambda p, q, x: jcb.codebook_loss_fn(model, config, None, p, q, x)[0]))
    grads = traverse_util.flatten_dict(jax.device_get(grad(state.params, state.quantizer,
                                                          jnp.asarray(batches[0]))))
    np.savez(os.path.join(args.out, 'grads1.npz'),
             **{'/'.join(k): np.asarray(g) for k, g in grads.items()})
    step = jcb.make_codebook_train_step(model, config, optimizer, None, donate=False)
    for i, batch in enumerate(batches[:args.steps]):
        t0 = time.time()
        state, metrics = step(state, jnp.asarray(batch))
        record(args.out, i, metrics, np.asarray(state.quantizer['embeddings']), time.time() - t0)


def run_port(batches, args):
    import torch
    from test_torch_config import to_port
    from viewformer_tpu.config import VQGANConfig
    from viewformer_tpu_torch.models.vqgan import AttnBlock, ResnetBlock
    from viewformer_tpu_torch.ops.image import normalize_images
    from viewformer_tpu_torch.train import codebook as tcb
    from viewformer_tpu_torch.utils.convert import jax_leaves

    config = to_port(VQGANConfig(perceptual_weight=0.0, learning_rate=args.lr,
                                 batch_size=batches.shape[1]))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, state = tcb.init_codebook_state(config, dtype=dtype, device='cpu',
                                           jax_seed=SEED, remat=True)
    if args.layers:
        acts, hooks = {}, []
        for name, module in model.named_modules():
            if isinstance(module, (ResnetBlock, AttnBlock)) or name == 'quant_conv':
                hooks.append(module.register_forward_hook(
                    lambda m, i, out, key=name.replace('.', '/'):
                    acts.__setitem__(key, out.permute(0, 2, 3, 1).float().numpy().copy())))
        # training mode (GroupNorm32's training path), no EMA update
        with torch.no_grad():
            model(normalize_images(torch.from_numpy(batches[0])), training=False)
        for hook in hooks:
            hook.remove()
        np.savez(os.path.join(args.out, 'acts1.npz'), **acts)
    step = tcb.make_codebook_train_step(model, config, None)
    for i, batch in enumerate(batches[:args.steps]):
        t0 = time.time()
        state, metrics = step(state, torch.from_numpy(batch))
        seconds = time.time() - t0
        if i == 0:  # the step leaves its gradients in .grad
            # in JAX's layout (conv kernels HWIO), as the jax run keeps them
            np.savez(os.path.join(args.out, 'grads1.npz'), **{
                '/'.join(path[1:]): (tensor.grad.float().numpy().transpose(2, 3, 1, 0)
                                     if tensor.ndim == 4 else tensor.grad.float().numpy())
                for _, path, _, tensor in jax_leaves(model) if path[0] == 'params'})
        record(args.out, i, metrics, model.quantizer.embeddings.numpy().copy(), seconds)


def compare(a, b, logs):
    def steps(path):
        out = {}
        with open(path) as f:
            for line in f:
                if line.startswith('{'):
                    rec = json.loads(line)
                    out[rec['step']] = rec
        return out
    ra, rb = steps(logs[0]), steps(logs[1])
    common = sorted(set(ra) & set(rb))
    rel = max(abs(ra[s]['rec_loss'] - rb[s]['rec_loss']) / rb[s]['rec_loss'] for s in common)
    perp = max(abs(ra[s]['perplexity'] - rb[s]['perplexity']) for s in common)
    emb = max(float(np.abs(np.load(os.path.join(a, f'emb{s}.npy'))
                           - np.load(os.path.join(b, f'emb{s}.npy'))).max()) for s in common)
    ga, gb = np.load(os.path.join(a, 'grads1.npz')), np.load(os.path.join(b, 'grads1.npz'))
    assert sorted(ga.files) == sorted(gb.files)
    grads = {key: float(np.linalg.norm(ga[key] - gb[key]) / max(np.linalg.norm(gb[key]), 1e-30))
             for key in ga.files}
    # softmax ignores a bias added to every key: those gradients are 0 up
    # to rounding in both packages
    meaningful = {k: v for k, v in grads.items() if not k.endswith('k/bias')}
    print(json.dumps({
        'steps': len(common), 'rec_loss_max_rel_diff': rel, 'perplexity_max_abs_diff': perp,
        'live_equal_every_step': all(ra[s]['live'] == rb[s]['live'] for s in common),
        'codebook_max_abs_diff': emb,
        'step1_grad_max_rel_diff': max(meaningful.values()),
        'step1_grad_worst': max(meaningful, key=meaningful.get),
        'first_step_live_differ': next((s for s in common if ra[s]['live'] != rb[s]['live']),
                                       None),
        # [first, second] every 10 steps: a frozen run repeats one perplexity
        'perplexity': {s: [ra[s]['perplexity'], rb[s]['perplexity']]
                       for s in common if s in (1, 2) or s % 10 == 0 or s == common[-1]},
        'live': {s: [ra[s]['live'], rb[s]['live']]
                 for s in common if s % 10 == 0 or s == common[-1]}}, indent=1))


def table(port_bf16, jax_bf16, port_f32, jax_f32):
    """Relative L2 differences ||a - b|| / ||b|| of the first forward's
    layer outputs and the first step's gradients, in forward order."""
    dirs = (port_bf16, jax_bf16, port_f32, jax_f32)
    runs = [np.load(os.path.join(d, 'acts1.npz')) for d in dirs]
    grads = [np.load(os.path.join(d, 'grads1.npz')) for d in dirs]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    def row(src, key):
        pb, jb, pf, jf = (r[key].astype(np.float64) for r in src)
        return {'port_bf16_vs_jax_bf16': rel(pb, jb), 'port_f32_vs_jax_f32': rel(pf, jf),
                'jax_bf16_vs_jax_f32': rel(jb, jf), 'port_bf16_vs_jax_f32': rel(pb, jf)}
    names = runs[0].files  # the port's hooks fire in forward order
    assert all(sorted(r.files) == sorted(names) for r in runs)
    print(json.dumps({'layers': {k: row(runs, k) for k in names},
                      'grads': {k: row(grads, k) for k in GRAD_NAMES}}, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('mode', choices=['batches', 'jax', 'port', 'compare', 'table'])
    ap.add_argument('dirs', nargs='*')
    ap.add_argument('--out')
    ap.add_argument('--batches')
    ap.add_argument('--steps', type=int, default=None,
                    help='batches: how many (40); jax/port: train the first N only')
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--gate', action='store_true')
    ap.add_argument('--lr', type=float, default=1.44e-4)
    ap.add_argument('--bf16', action='store_true')
    ap.add_argument('--layers', action='store_true')
    args = ap.parse_args()
    if args.mode == 'batches':
        write_batches(args)
    elif args.mode == 'table':
        table(*args.dirs)
    elif args.mode == 'compare':
        a, b = args.dirs
        compare(a, b, [os.path.join(d, 'log.jsonl') for d in (a, b)])
    else:
        os.makedirs(args.out, exist_ok=True)
        if os.path.exists(os.path.join(args.out, 'log.jsonl')):
            os.remove(os.path.join(args.out, 'log.jsonl'))
        batches = np.load(args.batches)
        (run_jax if args.mode == 'jax' else run_port)(batches, args)


if __name__ == '__main__':
    main()
