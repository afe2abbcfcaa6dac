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

Dtypes follow flax's dtype/param_dtype. `dtype` is the tower's compute dtype;
`param_dtype` (default: dtype) is what the parameters are stored in. The
serving form keeps the tower's parameters in dtype (bf16 on the card); the
training form keeps f32 masters and computes in bf16, with the explicit
casts of flax's Dense and LayerNorm (linear, layer_norm below): embeddings
are summed in f32 and cast to dtype, LayerNorm takes its statistics in f32,
the residual streams stay in dtype. The pose MLP and the pose head are f32
islands: f32 weights and f32 compute whatever the tower's dtype.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.branching_attention import multi_end_block_attention
from ..ops.dropout import hash_dropout
from ..utils import geometry
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


class MLP(nn.Module):
    def __init__(self, d_in, d_inner, d_out, dtype=torch.float32):
        super().__init__()
        self.c_fc = nn.Linear(d_in, d_inner)
        self.c_proj = nn.Linear(d_inner, d_out)
        self.dtype = dtype

    def forward(self, x, dropout_rate=0.0, words=None):
        """With dropout_rate > 0, hash dropout of the output with seed words."""
        out = linear(self.c_proj, F.gelu(linear(self.c_fc, x, self.dtype)), self.dtype)
        return hash_dropout(words, out, dropout_rate)


class BranchingAttention(nn.Module):
    def __init__(self, d_model, n_head, dtype=torch.float32):
        super().__init__()
        self.c_attn = nn.Linear(d_model, 3 * d_model)
        self.c_proj = nn.Linear(d_model, d_model)
        self.n_head = n_head
        self.dtype = dtype

    def forward(self, streams, dropout_rate=0.0, seeds=None):
        """streams: a list of [B, T, L, d], stream 0 first -> the list of
        their attention outputs. With dropout_rate > 0, seeds holds the
        attention's two pairs of words (stream 0, side streams), then one
        pair a stream for the output dropout after c_proj."""
        B, T, L, d = streams[0].shape
        H = self.n_head
        vs, qs, ks = [], [], []
        for x in streams:
            v, q, k = linear(self.c_attn, x, self.dtype).split(d, -1)  # reference chunk order
            for part, heads in ((v, vs), (q, qs), (k, ks)):
                heads.append(part.reshape(B, T, L, H, d // H).permute(0, 3, 1, 2, 4))
        seeds = seeds or [None] * (2 + len(streams))
        outs = multi_end_block_attention(tuple(ks), tuple(vs), tuple(qs), dropout_rate,
                                         seeds[:2])
        merged = [out.permute(0, 2, 3, 1, 4).reshape(B, T, L, d) for out in outs]
        return [hash_dropout(words, linear(self.c_proj, x, self.dtype), dropout_rate)
                for words, x in zip(seeds[2:], merged)]


class Block(nn.Module):
    def __init__(self, d_model, n_head, dtype=torch.float32):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.attn = BranchingAttention(d_model, n_head, dtype)
        self.ln_2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.mlp = MLP(d_model, 4 * d_model, d_model, dtype)
        self.dtype = dtype

    def forward(self, *streams, dropout_rate=0.0, seeds=None):
        """seeds: the layer's 2 + 2n dropout seed pairs in site order
        (module docstring), read when dropout_rate > 0."""
        n = len(streams)
        seeds = seeds or [None] * (2 + 2 * n)
        normed = [layer_norm(self.ln_1, x, self.dtype) for x in streams]
        attended = self.attn(normed, dropout_rate, seeds[:2 + n])
        streams = [x + a for x, a in zip(streams, attended)]
        return tuple(x + self.mlp(layer_norm(self.ln_2, x, self.dtype), dropout_rate, words)
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


class MIGT(nn.Module):
    def __init__(self, config, dtype=torch.float32, generator=None, param_dtype=None,
                 remat=False, dropout_impl='hash'):
        """dtype: the tower's compute dtype; param_dtype: what wte, wpe, the
        blocks and ln_f are stored in (default dtype). remat: recompute each
        block in the backward (torch.utils.checkpoint) instead of keeping
        its activations. dropout_impl: 'hash' only (module docstring)."""
        super().__init__()
        if dropout_impl != 'hash':
            raise ValueError(f"dropout_impl={dropout_impl!r} is not ported: the port "
                             "reproduces dropout_impl='hash' only")
        cfg = self.config = config
        d = cfg.d_model
        self.dtype = dtype
        self.remat = remat
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
                dropout_seeds=None):
        """poses [B, T_p, 7]; input_ids [B, T, h, w] int; optional
        localization_tokens [B, T, h, w] and output_poses [B, T, 7].

        Returns a dict: logits [B, T, h, w, n_embeddings] (f32), loss and its
        terms (with compute_losses), pose_prediction [B, T, L, 7] (with
        localization on), hidden_states. Training (deterministic=False) draws
        the random pose multiplier from `generator`; `step` drives the
        localization-weight schedule. With config.dropout > 0, training
        reads dropout_seeds: dropout_sites(n streams) pairs of uint32 words in
        site order (module docstring)."""
        cfg = self.config
        B, T_in = input_ids.shape[:2]
        grid = tuple(input_ids.shape[2:])
        L = math.prod(grid)
        tokens = input_ids.reshape(B, T_in, L)
        device = self.wpe.device

        # train-time random pose-scale augmentation
        if not deterministic and cfg.random_pose_multiplier != 1.0:
            u = torch.rand(B, generator=generator) * 2 - 1
            random_pose_multiplier = (cfg.random_pose_multiplier ** u).to(device)
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
        streams = tuple(hash_dropout(words, x.to(self.dtype), dropout_rate)
                        for words, x in zip(seeds, streams))
        per_layer = 2 + 2 * n
        for i, block in enumerate(self.h):
            layer_seeds = seeds[n + i * per_layer:n + (i + 1) * per_layer]
            if self.remat and torch.is_grad_enabled():
                streams = checkpoint(block, *streams, dropout_rate=dropout_rate,
                                     seeds=layer_seeds, use_reentrant=False)
            else:
                streams = block(*streams, dropout_rate=dropout_rate, seeds=layer_seeds)
        streams = [layer_norm(self.ln_f, x, self.dtype) for x in streams]

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
