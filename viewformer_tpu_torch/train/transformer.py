"""Transformer training (port of viewformer_tpu/train/transformer.py): the
train step and the training entry point train_transformer.

The pieces of one optimizer step: the host-side pose augmentation
(process_batch), AdamW with the reference's weight-decay exclusions, the
per-tensor gradient clip and the warmup-cosine learning rate, and the train
and eval steps over MIGT.forward(compute_losses=True). The model keeps f32
master parameters and computes in bf16 (MIGT(dtype=bf16,
param_dtype=f32)), with each block recomputed in the backward
(torch.utils.checkpoint), as JAX's remat=True with no policy.

On the card the attention runs kernels B1/B2 forward and B3/B4 backward
(ops/branching_attention.py); with config.dropout > 0 (the default recipe,
0.1) kernels B5/B7 and B6/B8, which drop attention weights in the kernel.
Dropout is the JAX package's dropout_impl='hash': each step draws every
dropout site's seed words from the step's torch.Generator before the forward
(the counterpart of JAX's fold_in(rng, step)) and passes them in, so the
remat recompute regenerates the same masks.

The update count lives in the train state and drives both the learning rate
and the localization-weight schedule. As in optax, the learning rate of an
update is the schedule at the count before it: the first update uses
lr(0) = 0.
"""
import dataclasses
import functools
import math
import os
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import load_token_dataset
from ..models import load_model
from ..models.migt import MIGT
from ..utils import geometry
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
def clip_per_tensor_norm(parameters, max_norm):
    """Scale each gradient on its own to an L2 norm of at most max_norm, in
    place: the reference clips per tensor (tf.clip_by_norm), not by the
    global norm."""
    for p in parameters:
        if p.grad is not None:
            norm = torch.linalg.vector_norm(p.grad)
            p.grad.mul_(torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0))


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
                           dropout_impl='hash'):
    """-> (model, TransformerTrainState): MIGT with f32 parameters drawn from
    `generator`, computing in `dtype`, on `device` (the card unless the
    caller asks for the CPU); remat recomputes each block in the backward.
    dropout_impl: 'hash' only; 'rng' raises."""
    device = resolve_device(device)
    model = MIGT(config, dtype=dtype, generator=generator, param_dtype=torch.float32,
                 remat=remat, dropout_impl=dropout_impl).to(device)
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


def make_transformer_train_step(model, config):
    """-> train_step(state, batch, generator=None) -> (state, metrics).
    batch = (poses [B, S, 7], tokens [B, S, h, w]) on the model's device;
    generator (a CPU torch.Generator) draws the step's dropout seeds
    (draw_dropout_seeds, when config.dropout > 0), then the random pose
    multiplier. One AdamW update of the model's parameters in place;
    state.step advances by one. Metrics are 0-d tensors on the device
    (reading them waits for the step)."""
    def train_step(state, batch, generator=None):
        poses, tokens = batch
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.zero_grad(set_to_none=True)
        seeds = draw_dropout_seeds(model, generator) if config.dropout > 0 else None
        out = model(poses, tokens, compute_losses=True, deterministic=False, step=state.step,
                    generator=generator, dropout_seeds=seeds)
        loss = out['loss'].mean()
        loss.backward()
        if config.gradient_clip_val and config.gradient_clip_val > 0:
            clip_per_tensor_norm(model.parameters(), config.gradient_clip_val)
        state.optimizer.step()
        state.step += 1
        return state, _metrics(out, config, tokens, ('pose_loss', 'pose_pos_loss',
                                                     'pose_ori_loss', 'localization_weight'))
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


def step_generator(seed, step):
    """The CPU torch.Generator that train step `step` (the count of updates
    before it) of a run with seed `seed` draws its dropout seeds and random
    pose multiplier from: seeded with ((seed + 1) * 2**32 + step) mod 2**64,
    the counterpart of JAX's fold_in(PRNGKey(seed + 1), step). A resumed
    run draws what the uninterrupted run drew."""
    return torch.Generator().manual_seed(((seed + 1) * 2 ** 32 + step) % 2 ** 64)


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
                      checkpoint_every=None, device='cuda'):
    """The training loop (CLI `train transformer` and `train
    finetune-transformer`). Returns (model, state).

    Epochs of max(1, total_steps // epochs) train steps, counted from the
    step the run starts at, over load_token_dataset(dataset_path) with
    process_batch(augment=config.augment_poses); each step draws from
    step_generator(seed, step). Metrics go to job_dir/metrics.jsonl
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
    remat: each block recomputed in the backward (JAX's remat_policy
    'full'); the policies that keep activations are not ported (ROADMAP
    §A 4). dropout_impl: 'hash' only. device: the card unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    total_steps = total_steps or config.total_steps
    batch_size = batch_size or config.batch_size
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    model, state = init_transformer_state(config, torch.Generator().manual_seed(seed), dtype,
                                          device, remat=remat, total_steps=total_steps,
                                          dropout_impl=dropout_impl)
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

    train_step = make_transformer_train_step(model, config)
    eval_step = make_transformer_eval_step(model, config)
    decode_val = _make_decode_val(codebook_path, device) if codebook_path is not None else None
    logger = MetricLogger(job_dir, hparams=config.asdict(), use_wandb=wandb)
    transform = functools.partial(process_batch, augment=config.augment_poses)
    train_data = load_token_dataset(
        dataset_path, batch_size, config.sequence_size, config.token_image_size,
        split='train', repeat=-1, seed=seed, transform=transform,
        max_samples_per_environment=max_samples_per_environment, start_state=data_state)
    steps_per_epoch = max(1, total_steps // epochs)
    validation_steps = max(1, min(steps_per_epoch // 10, 100))

    def checkpoint_state():
        return {'model': model.state_dict(), 'optimizer': state.optimizer.state_dict(),
                'step': state.step}

    def aux():
        return {'data_iterator': train_data.state} if train_data.state is not None else None

    def validate(step):
        val_data = load_token_dataset(
            dataset_path, batch_size, config.sequence_size, config.token_image_size,
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
        return {key: float(np.mean(v)) for key, v in values.items()}

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
                state, metrics = train_step(state, batch, step_generator(seed, state.step))
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
