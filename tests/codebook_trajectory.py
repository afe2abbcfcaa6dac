"""The codebook stage's first training steps at VQGANConfig()'s full width
on the CPU in f32, from the JAX package's draw of jax.random.PRNGKey(1337),
in either package, to hold the two trajectories against each other.

    python tests/codebook_trajectory.py batches --out B.npy [--steps 40] [--batch 32] [--gate]
    python tests/codebook_trajectory.py jax|port --batches B.npy --out DIR [--lr 1.44e-4]
    python tests/codebook_trajectory.py compare DIR_A DIR_B

`batches` writes [steps, batch, 128, 128, 3] uint8 frames: with --gate the
colors quality gate's own first batches (its fixture of 200 sequences of 20
frames, read as `train codebook --seed 1337 --batch-size 32` reads them),
else colors frames picked with numpy seed 0. `jax` and `port` train one
step a batch (perceptual weight 0, Adam as the gate's, remat), print a JSON
line a step (losses, perplexity, the codebook columns alive) and keep each
step's codebook and the first step's gradients in DIR. `compare` prints
the largest differences step by step. Not a test: every step is a
full-width backward on the CPU (tens of seconds at batch 32, and ~17 GB
of memory in the jax run).
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
        frames = np.stack([next(it) for _ in range(args.steps)])
        data.close()
        shutil.rmtree(tmp)
    else:
        from viewformer_tpu_torch.data.loaders.colors import ColorsLoader
        loader = ColorsLoader('train', num_sequences=200, sequence_size=20, image_size=128)
        rs = np.random.RandomState(0)
        picks = [(rs.randint(200), rs.randint(20)) for _ in range(args.steps * args.batch)]
        frames = np.stack([loader[s]['frames'][f] for s, f in sorted(picks)])
        frames = frames[rs.permutation(len(frames))].reshape(args.steps, args.batch, 128, 128, 3)
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
    from viewformer_tpu.train import codebook as jcb

    config = VQGANConfig(perceptual_weight=0.0, learning_rate=args.lr,
                         batch_size=batches.shape[1])
    model = jcb.create_codebook_model(config, jnp.float32, remat=True)
    optimizer = jcb.create_codebook_optimizer(config)
    params_rng, quantizer_rng = jax.random.split(jax.random.PRNGKey(SEED))
    dummy = jnp.zeros((1, 128, 128, 3), jnp.float32)
    # model.init under jit: the same keys draw the same weights as
    # init_codebook_state's eager init, without its op-by-op compiles
    v = jax.jit(lambda a, b: model.init({'params': a, 'quantizer': b}, dummy, training=False))(
        params_rng, quantizer_rng)
    state = jcb.CodebookTrainState(v['params'], v['quantizer'], optimizer.init(v['params']),
                                   jnp.zeros((), jnp.int32))
    grad = jax.jit(jax.grad(lambda p, q, x: jcb.codebook_loss_fn(model, config, None, p, q, x)[0]))
    grads = traverse_util.flatten_dict(jax.device_get(grad(state.params, state.quantizer,
                                                          jnp.asarray(batches[0]))))
    np.savez(os.path.join(args.out, 'grads1.npz'),
             **{'/'.join(k): np.asarray(g) for k, g in grads.items()})
    step = jcb.make_codebook_train_step(model, config, optimizer, None, donate=False)
    for i, batch in enumerate(batches):
        t0 = time.time()
        state, metrics = step(state, jnp.asarray(batch))
        record(args.out, i, metrics, np.asarray(state.quantizer['embeddings']), time.time() - t0)


def run_port(batches, args):
    import torch
    from test_torch_config import to_port
    from viewformer_tpu.config import VQGANConfig
    from viewformer_tpu_torch.train import codebook as tcb
    from viewformer_tpu_torch.utils.convert import jax_leaves

    config = to_port(VQGANConfig(perceptual_weight=0.0, learning_rate=args.lr,
                                 batch_size=batches.shape[1]))
    model, state = tcb.init_codebook_state(config, dtype=torch.float32, device='cpu',
                                           jax_seed=SEED, remat=True)
    step = tcb.make_codebook_train_step(model, config, None)
    for i, batch in enumerate(batches):
        t0 = time.time()
        state, metrics = step(state, torch.from_numpy(batch))
        seconds = time.time() - t0
        if i == 0:  # the step leaves its gradients in .grad
            # in JAX's layout (conv kernels HWIO), as the jax run keeps them
            np.savez(os.path.join(args.out, 'grads1.npz'), **{
                '/'.join(path[1:]): (tensor.grad.numpy().transpose(2, 3, 1, 0)
                                     if tensor.ndim == 4 else tensor.grad.numpy())
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('mode', choices=['batches', 'jax', 'port', 'compare'])
    ap.add_argument('dirs', nargs='*')
    ap.add_argument('--out')
    ap.add_argument('--batches')
    ap.add_argument('--steps', type=int, default=40)
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--gate', action='store_true')
    ap.add_argument('--lr', type=float, default=1.44e-4)
    args = ap.parse_args()
    if args.mode == 'batches':
        write_batches(args)
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
