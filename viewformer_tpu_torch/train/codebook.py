"""Codebook (VQ-GAN) training (port of viewformer_tpu/train/codebook.py): the
loss, the train and eval steps, and the training entry point train_codebook.

The loss is the reference's: mean L1 + perceptual_weight * LPIPS(VGG) +
codebook_weight * e_latent_loss, with Adam(lr, betas=(0.5, 0.9), eps 1e-8);
the codebook itself moves by the EMA update of ops/quantizer.quantize_ema,
not by the optimizer. The model keeps f32 parameters and computes its
convolutions in bf16 (VQGAN(dtype=bf16, param_dtype=f32)), each
ResnetBlock and AttnBlock recomputed in the backward (remat), as JAX's
train state with remat=True.

As in optax: the gradient clip (config.gradient_clip_val > 0) scales by
max_norm / global norm only when the global norm is at least max_norm, and
accumulate_grad_batches = k > 1 is optax.MultiSteps: the running mean of k
gradients, then one Adam update on every k-th call; the parameters do not
move in between, and the step counts every call. No attention kernel runs.
"""
import dataclasses
import sys
from typing import List, Optional

import numpy as np
import torch

from ..data.pipeline import load_image_dataset
from ..models.lpips import load_lpips
from ..models.vqgan import VQGAN
from ..ops.image import normalize_images
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager
from .logging import MetricLogger
from .transformer import _start_profiler, _stop_profiler


@dataclasses.dataclass
class CodebookTrainState:
    """What a train step reads and advances: Adam over the model's
    parameters, the number of calls made (step), and with
    accumulate_grad_batches > 1 the calls since the last update (mini_step)
    and the running mean of their gradients (acc_grads)."""
    optimizer: torch.optim.Optimizer
    step: int = 0
    accumulate_grad_batches: int = 1
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


def create_codebook_optimizer(model, config):
    """Adam(lr=config.learning_rate, betas=(0.5, 0.9), eps=1e-8) over the
    model's parameters (the Quantizer's buffers are not among them)."""
    return torch.optim.Adam(model.parameters(), lr=config.learning_rate, betas=(0.5, 0.9),
                            eps=1e-8)


def init_codebook_state(config, generator=None, dtype=torch.bfloat16, device='cuda',
                        remat=True, accumulate_grad_batches=1):
    """-> (VQGAN with f32 parameters drawn from `generator`, computing in
    `dtype`, on `device`: the card unless the caller asks for the CPU;
    CodebookTrainState)."""
    device = resolve_device(device)
    model = VQGAN(config, dtype=dtype, generator=generator, param_dtype=torch.float32,
                  remat=remat).to(device)
    return model, CodebookTrainState(create_codebook_optimizer(model, config),
                                     accumulate_grad_batches=accumulate_grad_batches)


def _perplexity(codes, n_embed):
    counts = torch.bincount(codes.reshape(-1), minlength=n_embed)
    probs = counts / counts.sum().clamp(min=1)
    return torch.exp(-torch.where(probs > 0, probs * torch.log(probs), 0.0).sum())


def codebook_loss_fn(model, config, lpips, batch):
    """-> (loss, metrics) of one training forward over `batch` (uint8
    [B, H, W, C], or f32 in [-1, 1]), which updates the model's EMA codebook
    state. lpips: an LPIPS module on the batch's device, or None; the
    perceptual term's gradient flows through the reconstruction only.
    metrics (detached 0-d tensors): p_loss (NaN when perceptual_weight > 0
    but lpips is None, 0 at weight 0), rec_loss, quant_loss, total_loss and
    perplexity of the batch's codes."""
    x = normalize_images(batch).float()
    dec, e_latent_loss, _quant, codes = model(x, training=True)
    return codebook_loss(config, lpips, x, dec, e_latent_loss, codes)


def codebook_loss(config, lpips, x, dec, e_latent_loss, codes):
    """codebook_loss_fn's (loss, metrics) from the images x in [-1, 1] and
    the training forward's outputs."""
    rec_l1 = (x - dec).abs().mean()
    loss = rec_l1
    if lpips is not None and config.perceptual_weight > 0:
        p_loss = lpips(x[..., :3], dec[..., :3]).mean()
        loss = loss + config.perceptual_weight * p_loss
    elif config.perceptual_weight > 0:
        # the term is dropped (weights unavailable): NaN, never a made-up 0
        p_loss = torch.full((), float('nan'), device=x.device)
    else:
        p_loss = torch.zeros((), device=x.device)
    loss = loss + config.codebook_weight * e_latent_loss
    metrics = {'p_loss': p_loss, 'rec_loss': rec_l1, 'quant_loss': e_latent_loss,
               'total_loss': loss, 'perplexity': _perplexity(codes, config.n_embed)}
    return loss, {key: value.detach() for key, value in metrics.items()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm in place: when the global L2 norm of
    `grads` is at least max_norm, each becomes g / norm * max_norm."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_codebook_train_step(model, config, lpips=None):
    """-> train_step(state, batch) -> (state, metrics): the loss and its
    gradients, then (every accumulate_grad_batches-th call) the clip and one
    Adam update of the model's parameters in place; state.step advances by
    one a call. Metrics are those of codebook_loss_fn."""
    params = list(model.parameters())

    def update(state, grads):
        if config.gradient_clip_val and config.gradient_clip_val > 0:
            clip_by_global_norm(grads, config.gradient_clip_val)
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()

    def train_step(state, batch):
        for p in params:
            p.grad = None
        loss, metrics = codebook_loss_fn(model, config, lpips, batch)
        loss.backward()
        grads = [p.grad for p in params]
        if state.accumulate_grad_batches > 1:
            if state.acc_grads is None:
                state.acc_grads = [torch.zeros_like(p) for p in params]
            with torch.no_grad():
                for acc, g in zip(state.acc_grads, grads):
                    acc.add_((g - acc) / (state.mini_step + 1))
            state.mini_step += 1
            if state.mini_step == state.accumulate_grad_batches:
                update(state, state.acc_grads)
                state.acc_grads, state.mini_step = None, 0
        else:
            update(state, grads)
        state.step += 1
        return state, metrics

    return train_step


def make_codebook_eval_step(model, config, lpips=None):
    """-> eval_step(state, batch) -> (metrics, dec): no gradient and no EMA
    update. metrics: rec_loss, quant_loss, p_loss (with lpips),
    total_loss and psnr of the reconstructions in [0, 1]."""
    @torch.no_grad()
    def eval_step(state, batch):
        x = normalize_images(batch).float()
        dec, e_latent_loss, _quant, _codes = model(x, training=False)
        rec_l1 = (x - dec).abs().mean()
        metrics = {'rec_loss': rec_l1, 'quant_loss': e_latent_loss}
        loss = rec_l1 + config.codebook_weight * e_latent_loss
        if lpips is not None and config.perceptual_weight > 0:
            p_loss = lpips(x[..., :3], dec[..., :3]).mean()
            loss = loss + config.perceptual_weight * p_loss
            metrics['p_loss'] = p_loss
        metrics['total_loss'] = loss
        mse = ((x.clamp(-1, 1) / 2 - dec.clamp(-1, 1) / 2) ** 2).mean()
        metrics['psnr'] = -10.0 * torch.log10(mse)
        return metrics, dec

    return eval_step


def _checkpoint_state(model, state):
    saved = {'model': model.state_dict(), 'optimizer': state.optimizer.state_dict(),
             'step': state.step}
    if state.accumulate_grad_batches > 1:
        saved.update(mini_step=state.mini_step, acc_grads=state.acc_grads)
    return saved


def _restore_into(model, state, restored):
    """Load a saved tree into the model and the train state. Returns the
    step."""
    model.load_state_dict(restored['model'])
    state.optimizer.load_state_dict(restored['optimizer'])
    state.step = int(restored['step'])
    if state.accumulate_grad_batches > 1:
        state.mini_step = int(restored.get('mini_step', 0))
        acc_grads = restored.get('acc_grads')
        device = next(model.parameters()).device
        state.acc_grads = None if acc_grads is None else [g.to(device) for g in acc_grads]
    return state.step


def train_codebook(config, dataset_path, job_dir, *, total_steps=None, epochs=100,
                   batch_size=None, accumulate_grad_batches=1, resume=True, seed=42,
                   use_bf16=True, log_every=50, num_val_batches=8, progress=True,
                   profile_batch=50, checkpoint_every=None, device='cuda'):
    """The training loop (CLI `train codebook`). Returns (model, state).

    Epochs of max(1, 1 + total_steps // epochs) train steps over
    load_image_dataset(dataset_path, split='train', uint8 frames), the
    weights drawn from torch.Generator seed `seed`. Metrics go to
    job_dir/metrics.jsonl (MetricLogger) once log_every steps have passed
    since the last record, and at the last step. At each epoch end, the
    eval step over at most num_val_batches batches of split 'test' in order
    (their mean logged under val/, the first batch's reconstructions as
    images), then a save with val_loss = val total_loss (CheckpointManager:
    last/ and best/). checkpoint_every: also a save every that many steps
    within an epoch. Each save carries the data cursor, so a resumed run
    continues the data order exactly.

    With config.perceptual_weight > 0 the LPIPS term uses load_lpips('vgg');
    without its weights the term is dropped with a warning and p_loss is
    logged as NaN, as in the JAX package. resume: continue from job_dir's
    last checkpoint, and from its data cursor if that belongs to the same
    step. profile_batch: torch.profiler traces steps profile_batch and
    profile_batch + 1 into job_dir/profile (0: off). device: the card
    unless the caller asks for the CPU."""
    device = resolve_device(device)
    total_steps = total_steps or config.total_steps
    batch_size = batch_size or config.batch_size
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    model, state = init_codebook_state(config, torch.Generator().manual_seed(seed), dtype,
                                       device, accumulate_grad_batches=accumulate_grad_batches)
    lpips = load_lpips('vgg') if config.perceptual_weight > 0 else None
    if lpips is not None:
        lpips = lpips.to(device)
    elif config.perceptual_weight > 0:
        print(f'WARNING: training with perceptual_weight={config.perceptual_weight} but '
              'WITHOUT the LPIPS term (weights unavailable): the loss diverges from the '
              'reference; p_loss is logged as NaN.', file=sys.stderr)

    ckpt = CheckpointManager(job_dir, config)
    start_step, data_state = 0, None
    if resume:
        restored, _ = ckpt.restore_last()
        if restored is not None:
            start_step = _restore_into(model, state, restored)
            # the data cursor only if it belongs to the restored checkpoint
            aux = ckpt.load_aux()
            if aux is not None and aux.get('step') == start_step:
                data_state = aux.get('data_iterator')

    train_step = make_codebook_train_step(model, config, lpips)
    eval_step = make_codebook_eval_step(model, config, lpips)
    logger = MetricLogger(job_dir, hparams=config.asdict())
    steps_per_epoch = max(1, 1 + total_steps // epochs)
    train_data = load_image_dataset(dataset_path, batch_size, config.image_size, split='train',
                                    repeat=-1, seed=seed, start_state=data_state,
                                    output_dtype='uint8')

    def aux():
        return {'data_iterator': train_data.state} if train_data.state is not None else None

    def validate(step):
        val_data = load_image_dataset(dataset_path, batch_size, config.image_size,
                                      split='test', repeat=1, shuffle=False, seed=seed,
                                      output_dtype='uint8')
        outs = []
        try:
            for batch in val_data:
                if len(outs) >= num_val_batches:
                    break
                outs.append(eval_step(state, torch.from_numpy(batch).to(device)))
        finally:
            val_data.close()  # a break leaves the producer blocked otherwise
        values = {}
        for i, (metrics, dec) in enumerate(outs):
            for key, value in metrics.items():
                values.setdefault(key, []).append(value.item())
            if i == 0:
                recon = (dec / 2 + 0.5).clamp(0, 1).cpu().numpy()
                logger.log_images(step, (recon * 255).astype(np.uint8), tag='reconstructed')
        return {key: float(np.mean(v)) for key, v in values.items()}

    step = last_save = last_log = start_step
    profiler = None
    try:
        train_iter = iter(train_data)
        while step < total_steps:
            epoch_end = min(step + steps_per_epoch, total_steps)
            while step < epoch_end:
                batch = torch.from_numpy(next(train_iter)).to(device)
                if profile_batch and step == profile_batch - 1:
                    profiler = _start_profiler(device)
                state, metrics = train_step(state, batch)
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
                    ckpt.save(step, _checkpoint_state(model, state), aux=aux())
                    last_save = step
            val_metrics = validate(step)
            if val_metrics:
                logger.log(step, val_metrics, prefix='val')
            ckpt.save(step, _checkpoint_state(model, state),
                      val_loss=val_metrics.get('total_loss'), aux=aux())
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
