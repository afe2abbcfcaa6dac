"""MIGT: the branching transformer (port of viewformer_tpu/models/migt.py).

One forward pass over up to three tied-weight streams of [B, T, L, d]:

  stream 0 (context):  wte(tokens) + wpe + pose_mlp(pose)
  stream 1 (generate): wte(mask_token) + wpe + pose_mlp(output pose)
  stream 2 (localize): wte(tokens) + wpe + wte(localization_token)

through blocks of branching attention (ops/branching_attention.py), with
every training loss (MIGT.forward with compute_losses=True). The KV-cached
serving passes are in migt_incremental.py.

Reference quirks kept on purpose: c_attn output chunks are (v, q, k);
attention has no 1/sqrt(dh) scale; wpe has a static 256 rows; the mask token
is n_embeddings and the localization token n_embeddings + 1; GELU is exact
and LayerNorm eps is 1e-5.

Dropout (training, config.dropout > 0) is the JAX package's
dropout_impl='hash' (ops/dropout.py): every site's mask is a hash of two
uint32 seed words and the element index, so the seeds are drawn before the
forward (train/transformer.py) and passed in as `dropout_seeds`, one pair a
site, and a remat recompute regenerates the same masks. With n streams the
sites are, in the order the JAX module draws its dropout keys:

  1. the embeddings, one site a stream, after the cast to dtype (n sites);
  2. then for each layer, 2 + 2n sites: the attention weights of stream 0,
     then of the side streams (kernels B5-B8); the attention output of each
     stream after c_proj; the MLP output of each stream after c_proj.

`MIGT.dropout_sites(n)` counts them. The pose MLPs have no dropout. The JAX
package's dropout_impl='rng' (threefry Bernoulli noise) is not reproduced:
the marginal is the same, the noise stream is not.

Remat (MIGT(remat=True)): each block is recomputed in the backward
(torch.utils.checkpoint, non-reentrant). remat_policy names the ops whose
outputs the recompute takes from the forward instead (selective
checkpointing; train/transformer.resolve_remat_policy maps the JAX
package's names onto them): the attention's forward ops (the 'attn_out'
anchor, ops/branching_attention.FORWARD_OPS), the MLP's c_fc product (the
'mlp_fc' anchor, the op `viewformer::mlp_fc`), or every product without
batch dimensions. The dropout sites stay in the recompute and regenerate
their masks from the same seeds, so every policy gives the same gradients.

The mesh (parallel/mesh.py, the current one of the process): a training
forward on data index r of D holds rows r*B..(r+1)*B-1 of the global batch.
It draws the random pose multiplier for all D*B rows and takes its own,
hashes the non-attention dropout masks at the global arrays' element
indices, and, with more than one (data, model) shard, folds the shard
index r*M + m into the attention kernels' seed words (ops/dropout.
fold_rank). Under `model` (parallel/sharding.py) a rank holds n_head/M
heads: c_attn and the MLP's c_fc run on their local rows, and c_proj's
partial sums are summed over `model` before the bias; the model reads the
local width from the weights' shapes. Under `seq` the streams are cut to
this rank's frames after the embedding dropout, each attention gathers
every frame's projections (BranchingAttention), and ln_f's output is
gathered back, so the head, the losses and the pose criterion
run on all frames, the same on every `seq` rank. At dropout 0 a step on
any mesh thus computes what one process computes over the whole batch.

Dtypes follow flax's dtype/param_dtype. `dtype` is the tower's compute dtype;
`param_dtype` (default: dtype) is what the parameters are stored in. The
serving form keeps the tower's parameters in dtype (bf16 on the card); the
training form keeps f32 masters and computes in bf16, with the explicit
casts of flax's Dense and LayerNorm (linear, layer_norm below): embeddings
are summed in f32 and cast to dtype, LayerNorm takes its statistics in f32,
the residual streams stay in dtype. The pose MLP and the pose head are f32
islands: f32 weights and f32 compute whatever the tower's dtype.
"""
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.branching_attention import multi_end_block_attention
from ..ops.dropout import fold_rank, placed_hash_dropout
from ..parallel.mesh import copy_to_model, current_mesh, gather_frames, reduce_from_model
from ..utils import geometry, jax_random
from .initializers import truncated_normal_

LAYER_NORM_EPS = 1e-5
WPE_STATIC_SIZE = 256


def linear(module, x, dtype):
    """flax Dense(dtype=...): input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), module.weight.to(dtype), module.bias.to(dtype))


def layer_norm(module, x, dtype):
    """flax LayerNorm(dtype=...): statistics, normalisation and affine in
    f32 (or wider), the result cast to dtype."""
    wide = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(wide), module.normalized_shape, module.weight.to(wide),
                        module.bias.to(wide), module.eps).to(dtype)


@torch.library.custom_op('viewformer::mlp_fc', mutates_args=(), device_types=('cpu', 'cuda'))
def mlp_fc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The MLP's pre-GELU c_fc product F.linear(x, weight, bias), as an op of
    its own: the 'mlp_fc' remat anchor (the JAX package's
    checkpoint_name(h, 'mlp_fc')), which by its op alone selective
    checkpointing could not tell from the other products."""
    return F.linear(x, weight, bias)


def _mlp_fc_setup(ctx, inputs, output):
    x, weight, _bias = inputs
    ctx.save_for_backward(x, weight)


def _mlp_fc_backward(ctx, grad):
    x, weight = ctx.saved_tensors
    rows = grad.reshape(-1, grad.shape[-1])
    return grad @ weight, rows.t() @ x.reshape(-1, x.shape[-1]), rows.sum(0)


mlp_fc.register_autograd(_mlp_fc_backward, setup_context=_mlp_fc_setup)


class Placement(NamedTuple):
    """Where a rank's streams [B, T, L, d] lie in the global ones [rows,
    frames, L, d]: from row batch0 and frame frame0. frames None: the
    streams hold every frame."""
    batch0: int = 0
    frame0: int = 0
    frames: Optional[int] = None


def _dropout(words, x, rate, where):
    """hash_dropout of x [B, T, ...] at the global arrays' element indices
    (`where`), through the op viewformer::hash_dropout (one kernel pass on
    the card)."""
    if rate <= 0.0:
        return x
    s0, s1 = (int(w) & 0xFFFFFFFF for w in words)
    return placed_hash_dropout(x.contiguous(), s0, s1, float(rate), where.batch0, where.frame0,
                               where.frames or x.shape[1])


def _row_parallel(module, x, dtype):
    """linear(module, x, dtype) of a row-parallel layer: the local product,
    summed over `model`, then the bias."""
    partial = F.linear(x.to(dtype), module.weight.to(dtype))
    return reduce_from_model(partial, current_mesh()) + module.bias.to(dtype)


class MLP(nn.Module):
    def __init__(self, d_in, d_inner, d_out, dtype=torch.float32):
        super().__init__()
        self.c_fc = nn.Linear(d_in, d_inner)
        self.c_proj = nn.Linear(d_inner, d_out)
        self.d_inner = d_inner
        self.dtype = dtype

    def forward(self, x, dropout_rate=0.0, words=None, where=Placement()):
        """With dropout_rate > 0, hash dropout of the output with seed words
        at the element indices `where` places x. With c_fc's rows split over
        `model` (parallel/sharding.py), runs on this rank's rows and sums
        c_proj's partial products over `model`."""
        dtype = self.dtype
        sharded = self.c_fc.weight.shape[0] != self.d_inner
        if sharded:
            x = copy_to_model(x, current_mesh())
        h = F.gelu(mlp_fc(x.to(dtype), self.c_fc.weight.to(dtype), self.c_fc.bias.to(dtype)))
        out = _row_parallel(self.c_proj, h, dtype) if sharded else linear(self.c_proj, h, dtype)
        return _dropout(words, out, dropout_rate, where)


class BranchingAttention(nn.Module):
    def __init__(self, d_model, n_head, dtype=torch.float32):
        super().__init__()
        self.c_attn = nn.Linear(d_model, 3 * d_model)
        self.c_proj = nn.Linear(d_model, d_model)
        self.n_head = n_head
        self.dtype = dtype

    def forward(self, streams, dropout_rate=0.0, seeds=None, where=Placement()):
        """streams: a list of [B, T, L, d], stream 0 first -> the list of
        their attention outputs. With dropout_rate > 0, seeds holds the
        attention's two pairs of words (stream 0, side streams), then one
        pair a stream for the output dropout after c_proj, hashed at the
        element indices `where` places the streams. With c_attn's heads
        split over `model` (parallel/sharding.py), runs this rank's heads
        and sums c_proj's partial products over `model`; with the frames
        split over `seq`, the attention gathers every frame."""
        B, T, L, d = streams[0].shape
        d_local = self.c_attn.weight.shape[0] // 3
        H = self.n_head * d_local // d
        sharded = d_local != d
        mesh = current_mesh()
        vs, qs, ks = [], [], []
        for x in streams:
            if sharded:
                x = copy_to_model(x, mesh)
            # every frame's projections under `seq` (an all_gather, whose
            # backward reduce-scatters the gradient): the kernels run over
            # all frames, as on every `seq` rank of the JAX package, whose
            # shard_map replicates attention over `seq`
            qkv = gather_frames(linear(self.c_attn, x, self.dtype), mesh, 1)
            v, q, k = qkv.split(d_local, -1)  # reference chunk order
            for part, heads in ((v, vs), (q, qs), (k, ks)):
                heads.append(part.reshape(B, -1, L, H, d // self.n_head).permute(0, 3, 1, 2, 4))
        seeds = seeds or [None] * (2 + len(streams))
        outs = multi_end_block_attention(tuple(ks), tuple(vs), tuple(qs), dropout_rate,
                                         seeds[:2])
        first = mesh.index('seq') * T  # this rank's frames of the outputs
        merged = [out[:, :, first:first + T].permute(0, 2, 3, 1, 4).reshape(B, T, L, d_local)
                  for out in outs]
        project = _row_parallel if sharded else linear
        return [_dropout(words, project(self.c_proj, x, self.dtype), dropout_rate, where)
                for words, x in zip(seeds[2:], merged)]


class Block(nn.Module):
    def __init__(self, d_model, n_head, dtype=torch.float32):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.attn = BranchingAttention(d_model, n_head, dtype)
        self.ln_2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.mlp = MLP(d_model, 4 * d_model, d_model, dtype)
        self.dtype = dtype

    def forward(self, *streams, dropout_rate=0.0, seeds=None, where=Placement()):
        """seeds: the layer's 2 + 2n dropout seed pairs in site order
        (module docstring), read when dropout_rate > 0; where: the place of
        the streams in the global arrays (Placement)."""
        n = len(streams)
        seeds = seeds or [None] * (2 + 2 * n)
        normed = [layer_norm(self.ln_1, x, self.dtype) for x in streams]
        attended = self.attn(normed, dropout_rate, seeds[:2 + n], where)
        streams = [x + a for x, a in zip(streams, attended)]
        return tuple(x + self.mlp(layer_norm(self.ln_2, x, self.dtype), dropout_rate, words, where)
                     for words, x in zip(seeds[2 + n:], streams))


class QuaternionPoseRepresentation(nn.Module):
    """Pose head: d_model -> 7 (xyz + quaternion), an f32 island."""

    def __init__(self, d_model, position_multiplier=1.0):
        super().__init__()
        self.pose_classifier = MLP(d_model, 2 * d_model, 7)
        self.position_multiplier = position_multiplier

    def forward(self, hidden, targets=None, skip_first=None, pose_multiplier=None):
        """hidden [B, ..., d] -> predicted cameras [B, ..., 7]; with targets
        (broadcastable [B, ..., 7]) also the per-sample position and
        orientation losses [B], from frame skip_first on. pose_multiplier
        [B] is the random pose scale the inputs were multiplied with."""
        raw = self.pose_classifier(hidden.float())
        xyz, quaternion = raw[..., :3], raw[..., 3:]
        if pose_multiplier is not None:
            xyz = xyz / pose_multiplier.reshape((-1,) + (1,) * (xyz.dim() - 1))
        qn = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quaternion))
        output = torch.cat([xyz / self.position_multiplier, qn], -1)
        if targets is None:
            return output
        scale = torch.tensor([self.position_multiplier] * 3 + [1.0] * 4, device=raw.device)
        targets = targets.float() * scale
        position_loss = ((targets[..., :3] - xyz) ** 2).mean(-1)
        orientation_loss = ((targets[..., 3:] - quaternion) ** 2).mean(-1)
        if skip_first:
            position_loss = position_loss[:, skip_first:]
            orientation_loss = orientation_loss[:, skip_first:]
        dims = tuple(range(1, position_loss.dim()))
        return output, position_loss.mean(dims), orientation_loss.mean(dims)

    @staticmethod
    def reduce(poses, axis=-2):
        """Mean of per-token pose predictions: xyz mean, quaternion
        normalize-mean."""
        xyz, quat = poses[..., :3], poses[..., 3:]
        xyz = xyz.mean(axis)
        quat = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quat))
        quat = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quat.mean(axis)))
        return torch.cat([xyz, quat], -1)


def cross_entropy_with_label_smoothing(labels, logits, label_smoothing=0.0):
    """Per-position CE in f32: the target is the one-hot label times
    (1 - label_smoothing) plus label_smoothing / n_classes everywhere."""
    n_classes = logits.shape[-1]
    ce = F.cross_entropy(logits.float().reshape(-1, n_classes), labels.reshape(-1),
                         reduction='none', label_smoothing=label_smoothing)
    return ce.reshape(labels.shape)


def _save_only(ops, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: the outputs of `ops` are kept from the
    forward, everything else is recomputed."""
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


class MIGT(nn.Module):
    def __init__(self, config, dtype=torch.float32, generator=None, param_dtype=None,
                 remat=False, dropout_impl='hash', remat_policy=None):
        """dtype: the tower's compute dtype; param_dtype: what wte, wpe, the
        blocks and ln_f are stored in (default dtype). remat: recompute each
        block in the backward (torch.utils.checkpoint) instead of keeping
        its activations. remat_policy: with remat, the ops whose outputs the
        recompute takes from the forward (train/transformer.
        resolve_remat_policy); None or empty: none, the whole block is
        recomputed. dropout_impl: 'hash' only (module docstring)."""
        super().__init__()
        if dropout_impl != 'hash':
            raise ValueError(f"dropout_impl={dropout_impl!r} is not ported: the port "
                             "reproduces dropout_impl='hash' only")
        cfg = self.config = config
        d = cfg.d_model
        self.dtype = dtype
        self.remat = remat
        self._remat_context = {}
        if remat_policy:
            policy = functools.partial(_save_only, frozenset(remat_policy))
            self._remat_context['context_fn'] = functools.partial(
                create_selective_checkpoint_contexts, policy)
        self.wte = nn.Embedding(cfg.n_embeddings + 2, d)
        self.wpe = nn.Parameter(torch.empty(WPE_STATIC_SIZE, d))
        self.pose_embedding = MLP(7, 2 * d, d)
        self.h = nn.ModuleList(Block(d, cfg.n_head, dtype) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.use_localization = not cfg.localization_weight.is_zero()
        if self.use_localization:
            self.pose_criterion = QuaternionPoseRepresentation(d, cfg.pose_multiplier)
        if cfg.use_dynamic_pose_loss:
            self.pos_ori_weights = nn.Parameter(torch.tensor([0.0, -3.0]))

        truncated_normal_(self.wte.weight, 0.02, generator)
        truncated_normal_(self.wpe, 0.02, generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                truncated_normal_(module.weight, 0.02, generator)
                nn.init.zeros_(module.bias)
        param_dtype = param_dtype or dtype
        for module in (self.wte, self.h, self.ln_f):
            module.to(param_dtype)
        self.wpe.data = self.wpe.data.to(param_dtype)

    def dropout_sites(self, n_streams):
        """How many dropout seed pairs a training forward over n_streams
        streams reads."""
        return n_streams + self.config.n_layer * (2 + 2 * n_streams)

    @property
    def mask_token(self):
        return self.config.n_embeddings

    @property
    def localization_token(self):
        return self.config.n_embeddings + 1

    def reduce_cameras(self, cameras, axis=-2):
        return QuaternionPoseRepresentation.reduce(cameras, axis=axis)

    def embed_poses(self, poses, multiplier=None):
        """The f32 pose MLP over cameras [..., 7] -> [..., d]. multiplier
        (broadcastable to [..., 1]) scales the positions on top of
        config.pose_multiplier."""
        poses = poses.float()
        xyz = poses[..., :3] * self.config.pose_multiplier
        if multiplier is not None:
            xyz = xyz * multiplier
        return self.pose_embedding(torch.cat([xyz, poses[..., 3:]], -1))

    def forward(self, poses, input_ids, localization_tokens=None, output_poses=None, *,
                compute_losses=False, deterministic=True, step=0, generator=None,
                dropout_seeds=None, pose_noise=None):
        """poses [B, T_p, 7]; input_ids [B, T, h, w] int; optional
        localization_tokens [B, T, h, w] and output_poses [B, T, 7].

        Returns a dict: logits [B, T, h, w, n_embeddings] (f32), loss and its
        terms (with compute_losses), pose_prediction [B, T, L, 7] (with
        localization on), hidden_states. Training (deterministic=False)
        scales the poses by random_pose_multiplier ** u (f32, as XLA's pow
        on the CPU), u in [-1, 1) one a row of the global batch: the given
        pose_noise, else drawn from `generator`; `step` drives the
        localization-weight schedule. With config.dropout > 0, training
        reads dropout_seeds: dropout_sites(n streams) pairs of uint32 words in
        site order (module docstring). Under data parallel (a
        torch.distributed process group), the rows are this rank's data
        index's of the global batch (module docstring)."""
        cfg = self.config
        B, T_in = input_ids.shape[:2]
        grid = tuple(input_ids.shape[2:])
        L = math.prod(grid)
        tokens = input_ids.reshape(B, T_in, L)
        device = self.wpe.device

        mesh = current_mesh()
        data, n_data = mesh.index('data'), mesh.size('data')
        # train-time random pose-scale augmentation, drawn for the global batch
        if not deterministic and cfg.random_pose_multiplier != 1.0:
            if pose_noise is None:
                pose_noise = torch.rand(B * n_data, generator=generator) * 2 - 1
            u = torch.as_tensor(pose_noise)[data * B:(data + 1) * B]
            random_pose_multiplier = torch.from_numpy(
                jax_random.power(cfg.random_pose_multiplier, u.numpy())).to(device)
        else:
            random_pose_multiplier = torch.ones(B, device=device)

        wte = self.wte.weight.float()  # embeddings are summed in f32
        position_embeds = self.wpe[:L].float()
        per_sample = random_pose_multiplier[:, None, None]
        pose_embeds = self.embed_poses(poses, per_sample)[:, :, None]  # [B, T_p, 1, d]
        inputs_embeds = F.embedding(tokens, wte)

        localization_embeds = output_pose_embeds = None
        if compute_losses:
            if localization_tokens is None and self.use_localization:
                localization_tokens = tokens
                localization_embeds = inputs_embeds
            if output_poses is None:
                output_poses = poses
                output_pose_embeds = pose_embeds
        if localization_tokens is not None and localization_embeds is None:
            localization_embeds = F.embedding(localization_tokens.reshape(B, -1, L), wte)
        if output_poses is not None and output_pose_embeds is None:
            output_pose_embeds = self.embed_poses(output_poses, per_sample)[:, :, None]

        # eval only: frames of stream 0 beyond the given poses get the
        # localization-token embedding as their pose
        loc_seq_size = T_in - pose_embeds.shape[1]
        if self.use_localization and not compute_losses and loc_seq_size > 0:
            loc_embed = wte[self.localization_token].expand(B, loc_seq_size, 1, cfg.d_model)
            pose_embeds = torch.cat([pose_embeds, loc_embed], 1)

        streams = [inputs_embeds + position_embeds + pose_embeds]
        gen_pointer = loc_pointer = 0
        if output_pose_embeds is not None:
            streams.append(wte[self.mask_token] + position_embeds + output_pose_embeds)
            gen_pointer = len(streams) - 1
        if localization_embeds is not None:
            streams.append(localization_embeds + position_embeds + wte[self.localization_token])
            loc_pointer = len(streams) - 1

        dropout_rate = 0.0 if deterministic else cfg.dropout
        n = len(streams)
        seeds = [None] * self.dropout_sites(n)
        if dropout_rate > 0:
            if dropout_seeds is None or len(dropout_seeds) != len(seeds):
                raise ValueError(f'dropout {dropout_rate} over {n} streams needs '
                                 f'{len(seeds)} dropout seed pairs, got '
                                 f'{None if dropout_seeds is None else len(dropout_seeds)}')
            seeds = [tuple(int(w) for w in pair) for pair in dropout_seeds]
        where = Placement(data * B)
        streams = tuple(_dropout(words, x.to(self.dtype), dropout_rate, where)
                        for words, x in zip(seeds, streams))
        n_seq = mesh.size('seq')
        if n_seq > 1:
            # this rank's frames of the blocks' streams
            if T_in % n_seq:
                raise ValueError(f'the seq axis of {n_seq} ranks does not divide the '
                                 f'{T_in} frames')
            frames = T_in // n_seq
            where = Placement(data * B, mesh.index('seq') * frames, T_in)
            streams = tuple(x[:, where.frame0:where.frame0 + frames] for x in streams)
        # the (data, model) shard index, folded into the attention's seeds
        shard, n_shards = (data * mesh.size('model') + mesh.index('model'),
                           n_data * mesh.size('model'))
        per_layer = 2 + 2 * n
        for i, block in enumerate(self.h):
            layer_seeds = seeds[n + i * per_layer:n + (i + 1) * per_layer]
            if dropout_rate > 0 and n_shards > 1:
                layer_seeds[:2] = [fold_rank(words, shard) for words in layer_seeds[:2]]
            if self.remat and torch.is_grad_enabled():
                streams = checkpoint(block, *streams, dropout_rate=dropout_rate,
                                     seeds=layer_seeds, where=where, use_reentrant=False,
                                     **self._remat_context)
            else:
                streams = block(*streams, dropout_rate=dropout_rate, seeds=layer_seeds,
                                where=where)
        streams = [layer_norm(self.ln_f, x, self.dtype) for x in streams]
        if n_seq > 1:
            streams = [gather_frames(x, mesh, 1) for x in streams]

        output = {'hidden_states': streams}
        # tied output embedding over the real vocabulary: operands rounded to
        # the compute dtype, products accumulated and returned in f32
        embedding = self.wte.weight[:cfg.n_embeddings].to(self.dtype)
        logits = streams[gen_pointer].float() @ embedding.float().t()

        loss = 0.0
        if compute_losses:
            ce = cross_entropy_with_label_smoothing(tokens, logits, cfg.label_smoothing)
            ce_loss = ce[:, cfg.n_loss_skip:].mean((1, 2))
            output['ce_loss'] = ce_loss
            loss = loss + ce_loss * cfg.image_generation_weight

        if self.use_localization:
            poses_hidden = streams[loc_pointer]
            if compute_losses:
                poses_out, pos_loss, ori_loss = self.pose_criterion(
                    poses_hidden, poses[:, :, None, :], skip_first=cfg.n_loss_skip,
                    pose_multiplier=random_pose_multiplier)
                if cfg.use_dynamic_pose_loss:
                    losses = torch.stack([pos_loss.mean(), ori_loss.mean()])
                    pose_loss = (self.pos_ori_weights
                                 + torch.exp(-self.pos_ori_weights) * losses).sum()
                    output['dynamic_loss_weight_pos'] = self.pos_ori_weights[0]
                    output['dynamic_loss_weight_ori'] = self.pos_ori_weights[1]
                else:
                    pose_loss = pos_loss + ori_loss
                localization_weight = cfg.localization_weight.with_total_steps(
                    cfg.total_steps)(float(step))
                loss = loss + pose_loss * localization_weight
                output.update(pose_loss=pose_loss, pose_pos_loss=pos_loss,
                              pose_ori_loss=ori_loss, localization_weight=localization_weight)
            else:
                poses_out = self.pose_criterion(poses_hidden,
                                                pose_multiplier=random_pose_multiplier)
            output['pose_prediction'] = poses_out

        output['logits'] = logits.reshape((B, T_in) + grid + (cfg.n_embeddings,))
        output['loss'] = loss
        return output
