"""Transformer training (port of viewformer_tpu/train/transformer.py): the
train step and the training entry point train_transformer.

The pieces of one optimizer step: the host-side pose augmentation
(process_batch), AdamW with the reference's weight-decay exclusions, the
per-tensor gradient clip and the warmup-cosine learning rate, and the train
and eval steps over MIGT.forward(compute_losses=True). The model keeps f32
master parameters and computes in bf16 (MIGT(dtype=bf16,
param_dtype=f32)), with each block recomputed in the backward
(torch.utils.checkpoint), as JAX's remat=True; a remat policy
(resolve_remat_policy) keeps some of the block's outputs from the forward.

Data parallel (parallel/distributed.py, one process per card under
torchrun): each rank runs the step on its rows of the global batch, the
gradients are averaged over the ranks before the clip (JAX clips the global
gradients), and so are the metrics; every rank draws the same seed words.
The mesh (parallel/mesh.py) adds the JAX package's `seq` and `model` axes:
train_transformer(seq_parallelism=) or (mesh=create_mesh(model_parallelism=
..., seq_parallelism=...)). Then the gradients are averaged over the
rank's (data, seq) group, whose ranks hold the same `model` shards: the
loss is the same on every `seq` rank and the frame gather's backward sums
over `seq`, so their mean is the global gradient. A sharded tensor is
clipped by the norm of the whole tensor.

On the card the attention runs kernels B1/B2 forward and B3/B4 backward
(ops/branching_attention.py); with config.dropout > 0 (the default recipe,
0.1) kernels B5/B7 and B6/B8, which drop attention weights in the kernel.
Dropout is the JAX package's dropout_impl='hash': each step draws every
dropout site's seed words before the forward and passes them in, so the
remat recompute regenerates the same masks. The step draws them, and the
random pose multiplier, from its rng: a JAX key gives JAX's numbers
(jax_step_draws: the keys of fold_in(rng, step), as the JAX package's train
step draws them), a torch.Generator torch's (draw_dropout_seeds).
train_transformer(seed=S) starts from the JAX package's initial draw of
PRNGKey(S) and steps from the key PRNGKey(S + 1), as JAX's
train_transformer does.

The update count lives in the train state and drives both the learning rate
and the localization-weight schedule. As in optax, the learning rate of an
update is the schedule at the count before it: the first update uses
lr(0) = 0.
"""
import dataclasses
import functools
import math
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import load_token_dataset
from ..models import load_model
from ..models.migt import MIGT
from ..ops.branching_attention import FORWARD_OPS
from ..parallel import distributed
from ..parallel import mesh as mesh_lib
from ..parallel.sharding import (shard_transformer_state, sharded_parameters,
                                 unshard_train_state)
from ..utils import geometry, jax_random
from ..utils.convert import jax_initial_state
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager, restore_checkpoint
from .logging import MetricLogger


def process_batch(cameras, tokens, augment, split, rng=None):
    """Per-sample pose augmentation on the host: cameras [S, 7] (numpy),
    tokens [S, h, w] -> (f32 cameras [S, 7], tokens). 'relative' expresses
    the cameras in the first one's frame; 'simple' and 'advanced' (train
    split only) move and turn the whole sequence at random, drawing from
    `rng` (a np.random.RandomState; default numpy's global one) in the
    reference's order, so a seeded rng gives the reference's cameras."""
    cameras = torch.from_numpy(np.asarray(cameras, np.float32))
    xyz, quaternion = cameras[..., :3], cameras[..., 3:]

    def draw(sample):
        return torch.from_numpy(np.asarray(sample, np.float32))

    if augment == 'relative':
        rotation_inverse = geometry.quaternion_conjugate(quaternion[..., :1, :])
        xyz = xyz - xyz[..., :1, :]
        xyz = geometry.quaternion_rotate(xyz, rotation_inverse.expand(xyz.shape[:-1] + (4,)))
        quaternion = geometry.quaternion_multiply(rotation_inverse, quaternion)
    elif augment == 'no' or split != 'train':
        pass
    elif augment in ('simple', 'advanced'):
        rng = rng or np.random
        xyz = xyz + draw(rng.normal(size=(1, 3)))
        rotation = geometry.make_quaternion_y(draw(rng.uniform(0, 2 * math.pi, (1,))))
        if augment == 'simple':
            tilt = geometry.make_quaternion_x(draw(rng.uniform(0, math.pi / 8, (1,))))
            turn = geometry.make_quaternion_y(draw(rng.uniform(0, 2 * math.pi, (1,))))
            rotation = geometry.quaternion_multiply(
                rotation, geometry.quaternion_multiply(tilt, turn))
        xyz = geometry.quaternion_rotate(xyz, rotation.expand(xyz.shape[:-1] + (4,)))
        quaternion = geometry.quaternion_multiply(quaternion, rotation)
    else:
        raise ValueError(f'Augment {augment} is not supported')
    quaternion = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quaternion))
    return torch.cat([xyz, quaternion], -1).numpy(), tokens


def warmup_cosine_schedule(init_lr, total_steps, warmup_steps=2000):
    """step -> learning rate: linear from 0 over warmup_steps, then a cosine
    decay to 0 at total_steps."""
    def schedule(step):
        if step < warmup_steps:
            return init_lr * step / warmup_steps
        decay_steps = max(total_steps - warmup_steps, 1)
        frac = min((step - warmup_steps) / decay_steps, 1.0)
        return init_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


def _weight_decay_mask(model):
    """{parameter name: True to decay}. No decay on LayerNorm parameters (a
    name with ln_, or a LayerNorm's weight) or on biases; decay on the rest:
    Linear weights, wte, wpe and pos_ori_weights."""
    mask = {}
    for module_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            name = f'{module_name}.{leaf}' if module_name else leaf
            mask[name] = not ('ln_' in name or isinstance(module, nn.LayerNorm)
                              or leaf == 'bias')
    return mask


@torch.no_grad()
def clip_per_tensor_norm(parameters, max_norm, sharded=(), mesh=None):
    """Scale each gradient on its own to an L2 norm of at most max_norm, in
    place: the reference clips per tensor (tf.clip_by_norm), not by the
    global norm. sharded: the parameters split over the mesh's `model` axis
    (parallel/sharding.sharded_parameters), whose norm is the whole
    tensor's: their squared norms summed over `model` in one all_reduce."""
    grads = [p.grad for p in parameters if p.grad is not None]
    split = {id(p.grad) for p in sharded if p.grad is not None}
    norms = [torch.linalg.vector_norm(g) for g in grads]
    if split:
        at = [i for i, g in enumerate(grads) if id(g) in split]
        squares = torch.stack([norms[i].float() ** 2 for i in at])
        mesh_lib.all_reduce(squares, mesh, 'model')
        for i, norm in zip(at, squares.sqrt().unbind(0)):
            norms[i] = norm.to(norms[i].dtype)
    for g, norm in zip(grads, norms):
        g.mul_(torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0))


def create_transformer_optimizer(model, config, total_steps=None, warmup_steps=2000):
    """-> (AdamW over the model's parameters, learning-rate schedule).
    b = (0.9, 0.999), eps 1e-8, config.weight_decay on the parameters that
    _weight_decay_mask selects. The train step sets each update's learning
    rate from the schedule."""
    total_steps = total_steps or config.total_steps
    mask = _weight_decay_mask(model)
    params = dict(model.named_parameters())
    groups = [{'params': [p for name, p in params.items() if mask[name]],
               'weight_decay': config.weight_decay},
              {'params': [p for name, p in params.items() if not mask[name]],
               'weight_decay': 0.0}]
    optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    return optimizer, warmup_cosine_schedule(config.learning_rate, total_steps, warmup_steps)


def resolve_remat_policy(name):
    """A remat policy's name -> the ops whose outputs the per-block
    recompute keeps from the forward (MIGT's remat_policy), None to keep
    none. The names are the JAX package's:

      full (or None), nothing: none; the whole block is recomputed
      attn:      the attention's forward ops ('attn_out': out and the
                 log-sum-exp of kernels B1/B2/B5/B7, a [B*H, T*L, dh] output
                 a stream a layer), so the backward never launches a
                 forward attention kernel again
      attn_mlp:  attn and the MLP's pre-GELU c_fc product ('mlp_fc',
                 [B, T, L, 4d] a stream a layer)
      dots:      every product without batch dimensions (the Linear layers'
                 mm/addmm and mlp_fc); the attention kernels run again

    Every policy gives the same gradients, bit for bit."""
    if name is None or name in ('full', 'nothing'):
        return None
    if name == 'attn':
        return FORWARD_OPS
    if name == 'attn_mlp':
        return FORWARD_OPS + (torch.ops.viewformer.mlp_fc.default,)
    if name == 'dots':
        return (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                torch.ops.viewformer.mlp_fc.default)
    raise ValueError(
        f'unknown remat policy {name!r} (full|attn|attn_mlp|dots|nothing)')


@dataclasses.dataclass
class TransformerTrainState:
    """What a train step reads and advances: the optimizer (holding the
    model's parameters and the AdamW moments), its learning-rate schedule,
    and the number of updates made."""
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0


def init_transformer_state(config, generator=None, dtype=torch.bfloat16, device='cuda',
                           remat=True, total_steps=None, warmup_steps=2000,
                           dropout_impl='hash', remat_policy=None, jax_seed=None):
    """-> (model, TransformerTrainState): MIGT with f32 parameters drawn from
    `generator`, computing in `dtype`, on `device` (the card unless the
    caller asks for the CPU); remat recomputes each block in the backward,
    keeping what the named remat_policy keeps (resolve_remat_policy).
    dropout_impl: 'hash' only; 'rng' raises. jax_seed: instead of
    `generator`, the parameters that the JAX package draws from
    jax.random.PRNGKey(jax_seed) (utils/convert.jax_initial_state). The
    state is in the one-process layout; parallel/sharding.
    shard_transformer_state places it on a mesh's `model` axis."""
    if generator is not None and jax_seed is not None:
        raise ValueError('init_transformer_state draws from generator or from jax_seed, '
                         'not both')
    device = resolve_device(device)
    kwargs = dict(dtype=dtype, param_dtype=torch.float32, remat=remat,
                  dropout_impl=dropout_impl, remat_policy=resolve_remat_policy(remat_policy))
    if jax_seed is None:
        model = MIGT(config, generator=generator, **kwargs).to(device)
    else:
        with torch.device('meta'):
            model = MIGT(config, **kwargs)
        model.to_empty(device=device)
        model.load_state_dict(jax_initial_state(model, jax_seed, device))
    optimizer, lr_schedule = create_transformer_optimizer(model, config, total_steps,
                                                          warmup_steps)
    return model, TransformerTrainState(optimizer, lr_schedule)


def _accuracy(labels, logits, n_loss_skip):
    pred = logits.argmax(-1)[:, n_loss_skip:]
    return (pred == labels[:, n_loss_skip:]).float().mean()


def _metrics(out, config, tokens, keys):
    B, T = tokens.shape[:2]
    metrics = {'loss': out['loss'].mean(), 'ce_loss': out['ce_loss'].mean(),
               'acc': _accuracy(tokens.reshape(B, T, -1),
                                out['logits'].reshape(B, T, -1, config.n_embeddings),
                                config.n_loss_skip)}
    metrics.update((key, torch.as_tensor(out[key]).mean()) for key in keys if key in out)
    return {key: value.detach() for key, value in metrics.items()}


def draw_dropout_seeds(model, generator=None):
    """One train step's dropout seeds: model.dropout_sites(n) pairs of uint32
    words for the training forward's n streams (context, generate, and
    localize where localization is on), drawn from `generator` (a CPU
    torch.Generator; None: torch's default one)."""
    n_streams = 2 + model.use_localization
    words = torch.randint(0, 1 << 32, (model.dropout_sites(n_streams), 2), generator=generator,
                          dtype=torch.int64)
    return words.tolist()


@functools.lru_cache(maxsize=16)
def _dropout_site_words(n_layer, n_streams):
    """The words folded into the step's 'dropout' key for each key that a
    training forward of the JAX package's MIGT makes, in the order of
    MIGT.dropout_sites, and where in that list each layer's attention key
    is. flax's scopes and counters: the root draws one key a stream's
    embedding dropout; layer i's attention first the key it splits into
    the two attention seeds (stream 0's, the side streams'), then one a
    stream's output dropout; its MLP one a stream's."""
    words, attention = [jax_random.scope_word((), c) for c in range(1, n_streams + 1)], []
    for i in range(n_layer):
        attn, mlp = (f'h_{i}', 'attn'), (f'h_{i}', 'mlp')
        attention.append(len(words))
        words += [jax_random.scope_word(attn, c) for c in range(1, n_streams + 2)]
        words += [jax_random.scope_word(mlp, c) for c in range(1, n_streams + 1)]
    return np.array(words, np.uint32), np.array(attention)


def jax_step_draws(model, rng, step, rows):
    """What the JAX package's train step `step` (the count of updates before
    it) draws from its key `rng` (uint32 [2], utils/jax_random.prng_key),
    computed without jax: (seeds, pose_noise).

    JAX splits fold_in(rng, step) into the 'dropout' and 'pose_noise'
    streams. seeds: with config.dropout > 0, the key data of every dropout
    site's key (flax's make_rng in the site's scope; each attention's key
    split in two, as multi_end_block_attention splits it), in site order
    (MIGT.dropout_sites, localization on or off), else None. pose_noise:
    with config.random_pose_multiplier != 1, JAX's uniform draw in [-1, 1)
    for the `rows` rows of the global batch (f32 [rows]), else None. Keys
    are vectorised over the sites: a pass of threefry a level of keys."""
    config = model.config
    dropout_rng, pose_rng = jax_random.split(jax_random.fold_in(rng, step))
    seeds = pose_noise = None
    if config.dropout > 0:
        words, attention = _dropout_site_words(config.n_layer, 2 + model.use_localization)
        keys = jax_random.fold_in(dropout_rng, words)                    # [sites - n_layer, 2]
        halves = jax_random.split(keys[attention])                       # [n_layer, 2, 2]
        keys = np.insert(keys, attention + 1, halves[:, 1], axis=0)
        keys[attention + np.arange(len(attention))] = halves[:, 0]
        seeds = keys.tolist()
    if config.random_pose_multiplier != 1.0:
        pose_noise = jax_random.uniform(jax_random.variable_key(pose_rng, (), 1), (rows,),
                                        -1.0, 1.0)
    return seeds, pose_noise


def make_transformer_train_step(model, config):
    """-> train_step(state, batch, rng=None) -> (state, metrics).
    batch = (poses [B, S, 7], tokens [B, S, h, w]) on the model's device:
    this rank's rows of the global batch under data parallel. rng draws
    the step's dropout seeds (when config.dropout > 0) and the random pose
    multiplier: a JAX key (uint32 [2]) as the JAX package's train step
    draws them (jax_step_draws, the step's host time in
    train_step.draw_ms), or a CPU torch.Generator (draw_dropout_seeds,
    then the multiplier; None: torch's default generator). One AdamW
    update of the model's parameters in place, from the gradients averaged
    over the rank's (data, seq) group of the current mesh; state.step
    advances by one. Metrics are 0-d tensors on the device, averaged over
    the data axis (reading them waits for the step)."""
    def train_step(state, batch, rng=None):
        poses, tokens = batch
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.zero_grad(set_to_none=True)
        generator = pose_noise = None
        if rng is None or isinstance(rng, torch.Generator):
            generator = rng
            seeds = draw_dropout_seeds(model, generator) if config.dropout > 0 else None
        else:
            t0 = time.perf_counter()
            rows = poses.shape[0] * mesh_lib.current_mesh().size('data')
            seeds, pose_noise = jax_step_draws(model, rng, state.step, rows)
            train_step.draw_ms = (time.perf_counter() - t0) * 1e3
        out = model(poses, tokens, compute_losses=True, deterministic=False, step=state.step,
                    generator=generator, dropout_seeds=seeds, pose_noise=pose_noise)
        loss = out['loss'].mean()
        loss.backward()
        distributed.average_gradients(model.parameters())
        if config.gradient_clip_val and config.gradient_clip_val > 0:
            mesh = mesh_lib.current_mesh()
            clip_per_tensor_norm(model.parameters(), config.gradient_clip_val,
                                 sharded_parameters(model, mesh), mesh)
        state.optimizer.step()
        state.step += 1
        return state, distributed.all_reduce_mean(_metrics(
            out, config, tokens, ('pose_loss', 'pose_pos_loss', 'pose_ori_loss',
                                  'localization_weight')))
    train_step.draw_ms = None
    return train_step


def make_transformer_eval_step(model, config):
    """-> eval_step(state, batch) -> (metrics, logits), with no dropout and
    no gradient."""
    @torch.no_grad()
    def eval_step(state, batch):
        poses, tokens = batch
        out = model(poses, tokens, compute_losses=True, deterministic=True, step=state.step)
        return _metrics(out, config, tokens, ('pose_loss', 'pose_pos_loss',
                                              'pose_ori_loss')), out['logits']
    return eval_step


def _to_device(batch, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in batch)


def _restore_into(model, state, restored):
    """Load a saved {'model', 'optimizer', 'step'} tree into the model and
    the train state; the weight decay stays the current config's. Returns
    the step."""
    decay = [group['weight_decay'] for group in state.optimizer.param_groups]
    model.load_state_dict(restored['model'])
    state.optimizer.load_state_dict(restored['optimizer'])
    for group, weight_decay in zip(state.optimizer.param_groups, decay):
        group['weight_decay'] = weight_decay
    state.step = int(restored['step'])
    return state.step


def _make_decode_val(codebook_path, device):
    """-> decode_val(logits, tokens) -> (mean PSNR of the last frame's argmax
    codes decoded against its true codes decoded, uint8 [B, H, W, 3] of the
    generated frames), through the codebook of the job dir
    `codebook_path` in f32."""
    codebook = load_model(codebook_path, torch.float32, device)

    @torch.no_grad()
    def decode_val(logits, tokens):
        gen = torch.clamp(codebook.decode_code(logits[:, -1].argmax(-1)) / 2 + 0.5, 0, 1)
        gt = torch.clamp(codebook.decode_code(tokens[:, -1]) / 2 + 0.5, 0, 1)
        mse = ((gen - gt) ** 2).mean((-3, -2, -1))
        psnr = (-10.0 * torch.log10(torch.clamp(mse, min=1e-10))).mean()
        return psnr, (gen * 255).to(torch.uint8)
    return decode_val


def train_transformer(config, dataset_path, job_dir, *, codebook_path=None, total_steps=None,
                      epochs=100, batch_size=None, resume=True, finetune_from=None, seed=42,
                      use_bf16=True, wandb=False, log_every=50, max_samples_per_environment=-1,
                      progress=True, profile_batch=50, dropout_impl='hash', remat=True,
                      remat_policy=None, checkpoint_every=None, mesh=None, seq_parallelism=1,
                      device='cuda'):
    """The training loop (CLI `train transformer` and `train
    finetune-transformer`). Returns (model, state).

    Epochs of max(1, total_steps // epochs) train steps, counted from the
    step the run starts at, over load_token_dataset(dataset_path) with
    process_batch(augment=config.augment_poses). The parameters start from
    the JAX package's draw of PRNGKey(seed) and each step draws from the
    key PRNGKey(seed + 1) folded with its step (jax_step_draws), as the JAX
    package's train_transformer, so a resumed run draws what the
    uninterrupted run drew. Metrics go to job_dir/metrics.jsonl
    (MetricLogger) once log_every steps have passed since the last record,
    and at the last step. At each epoch end, max(1, min(steps_per_epoch //
    10, 100)) eval steps over split 'test' (or 'val') in order; with
    codebook_path (a job dir of the codebook, whose load_model decodes the
    codes), also the PSNR of the generated last frame and its images. Then a
    save with the validation loss (CheckpointManager: last/ and best/).
    checkpoint_every: also a save every that many steps within an epoch.
    Each save carries the data cursor, so a resumed run continues the data
    order exactly.

    resume: continue from job_dir's last checkpoint, and from its data
    cursor if that belongs to the same step. finetune_from: a job dir whose
    last checkpoint gives the parameters, the AdamW state and the step (so
    the schedules continue), instead. profile_batch: torch.profiler traces
    steps profile_batch and profile_batch + 1 into job_dir/profile (0: off).
    remat: each block recomputed in the backward, keeping what
    remat_policy keeps (resolve_remat_policy: full|attn|attn_mlp|dots|
    nothing). dropout_impl: 'hash' only. device: the card unless the caller
    asks for the CPU.

    Under torchrun (parallel/distributed.initialize_distributed), the ranks
    form `mesh` (parallel/mesh.create_mesh), by default the mesh of
    create_mesh(seq_parallelism=seq_parallelism): D = W / (S * M) data
    indices, each reading its own shards (data/pipeline.py) in batches of
    batch_size / D rows, so a step takes batch_size rows over the data
    axis. seq_parallelism > 1 splits the blocks' streams by frames over
    `seq` (models/migt.py, as the JAX package's --seq-parallelism); a
    mesh whose `model` axis is > 1 shards the state's blocks over it
    (parallel/sharding.shard_transformer_state), after a restore. The
    validation metrics are the mean over every data index's batches, and
    rank 0 writes the checkpoints, in the one-process layout (the shards
    gathered over `model`), and the metric log. A resumed run restores
    every rank from rank 0's data cursor."""
    device = resolve_device(device)
    total_steps = total_steps or config.total_steps
    batch_size = batch_size or config.batch_size
    if mesh is None:
        mesh = mesh_lib.create_mesh(seq_parallelism=seq_parallelism)
    local_batch = distributed.local_batch_size(batch_size)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    model, state = init_transformer_state(config, dtype=dtype, device=device, remat=remat,
                                          total_steps=total_steps, dropout_impl=dropout_impl,
                                          remat_policy=remat_policy, jax_seed=seed)
    ckpt = CheckpointManager(job_dir, config)
    start_step, data_state = 0, None
    if finetune_from is not None:
        restored, _ = restore_checkpoint(finetune_from, prefer='last')
        if restored is None:
            raise FileNotFoundError(f'No checkpoint found at {finetune_from}')
        start_step = _restore_into(model, state, restored)
    elif resume:
        restored, _ = ckpt.restore_last()
        if restored is not None:
            start_step = _restore_into(model, state, restored)
            # the data cursor only if it belongs to the restored checkpoint
            aux = ckpt.load_aux()
            if aux is not None and aux.get('step') == start_step:
                data_state = aux.get('data_iterator')
    shard_transformer_state(model, state, mesh)

    train_step = make_transformer_train_step(model, config)
    eval_step = make_transformer_eval_step(model, config)
    decode_val = _make_decode_val(codebook_path, device) if codebook_path is not None else None
    logger = MetricLogger(job_dir, hparams=config.asdict(), use_wandb=wandb)
    transform = functools.partial(process_batch, augment=config.augment_poses)
    train_data = load_token_dataset(
        dataset_path, local_batch, config.sequence_size, config.token_image_size,
        split='train', repeat=-1, seed=seed, transform=transform,
        max_samples_per_environment=max_samples_per_environment, start_state=data_state)
    steps_per_epoch = max(1, total_steps // epochs)
    validation_steps = max(1, min(steps_per_epoch // 10, 100))

    def checkpoint_state():
        return {**unshard_train_state(model, state.optimizer, mesh), 'step': state.step}

    def aux():
        return {'data_iterator': train_data.state} if train_data.state is not None else None

    def validate(step):
        val_data = load_token_dataset(
            dataset_path, local_batch, config.sequence_size, config.token_image_size,
            split='test', repeat=1, seed=seed, shuffle=False, transform=transform)
        values = {}
        try:
            for i, batch in enumerate(val_data):
                if i >= validation_steps:
                    break
                batch = _to_device(batch, device)
                metrics, logits = eval_step(state, batch)
                for key, value in metrics.items():
                    values.setdefault(key, []).append(value.item())
                if decode_val is not None:
                    psnr, images = decode_val(logits, batch[1])
                    values.setdefault('psnr', []).append(psnr.item())
                    if i == 0:
                        logger.log_images(step, images.cpu().numpy(), tag='generated')
        finally:
            val_data.close()  # a break leaves the producer blocked otherwise
        return {key: float(np.mean(v))
                for key, v in distributed.gather_lists(values).items()}

    progress = progress and distributed.rank() == 0
    rng = jax_random.prng_key(seed + 1)
    step = last_save = last_log = start_step
    profiler = None
    try:
        train_iter = iter(train_data)
        while step < total_steps:
            epoch_end = min(step + steps_per_epoch, total_steps)
            while step < epoch_end:
                batch = _to_device(next(train_iter), device)
                if profile_batch and step == profile_batch - 1:
                    profiler = _start_profiler(device)
                state, metrics = train_step(state, batch, rng)
                step += 1
                if profiler is not None and step == profile_batch + 1:
                    _stop_profiler(profiler, device, job_dir, step)
                    profiler = None
                # at intervals, not on a grid: epochs need not divide log_every
                if step - last_log >= log_every or step == total_steps:
                    last_log = step
                    values = {key: value.item() for key, value in metrics.items()}
                    logger.log(step, values)
                    if progress:
                        print(f'step {step}/{total_steps} '
                              + ' '.join(f'{k}={v:.4f}' for k, v in values.items()))
                if (checkpoint_every and step < total_steps
                        and step - last_save >= checkpoint_every):
                    ckpt.save(step, checkpoint_state(), aux=aux())
                    last_save = step
            val_metrics = validate(step)
            if val_metrics:
                logger.log(step, val_metrics, prefix='val')
            ckpt.save(step, checkpoint_state(), val_loss=val_metrics.get('loss'), aux=aux())
            last_save = step
    finally:
        if profiler is not None:
            _stop_profiler(profiler, device, job_dir, step)
        train_data.close()
        try:
            ckpt.close()
        finally:
            logger.close()
    return model, state


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device, job_dir, step):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(os.path.join(job_dir, 'profile'), exist_ok=True)
    profiler.export_chrome_trace(os.path.join(job_dir, 'profile', f'trace-step{step}.json'))
