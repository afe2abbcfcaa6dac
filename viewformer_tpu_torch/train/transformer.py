"""Transformer training step (port of viewformer_tpu/train/transformer.py).

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
import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..models.migt import MIGT
from ..utils import geometry
from ..utils.device import resolve_device


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
