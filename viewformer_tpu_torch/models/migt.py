"""MIGT parameters and camera reduction (port of viewformer_tpu/models/migt.py).

This module holds the parameter tree the serving path reads: wte, wpe,
pose_embedding, the blocks h.<i>, ln_f and, with localization on,
pose_criterion. The forward passes are in migt_incremental.py. The one-shot
forward over all streams is not ported yet.

Reference quirks kept on purpose: c_attn output chunks are (v, q, k);
attention has no 1/sqrt(dh) scale; wpe has a static 256 rows; the mask token
is n_embeddings and the localization token n_embeddings + 1; GELU is exact
and LayerNorm eps is 1e-5. The pose MLP and the pose head are f32 islands:
they keep f32 weights whatever the tower's dtype.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import geometry
from .initializers import truncated_normal_

LAYER_NORM_EPS = 1e-5
WPE_STATIC_SIZE = 256


class MLP(nn.Module):
    def __init__(self, d_in, d_inner, d_out):
        super().__init__()
        self.c_fc = nn.Linear(d_in, d_inner)
        self.c_proj = nn.Linear(d_inner, d_out)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class Attention(nn.Module):
    def __init__(self, d_model):
        super().__init__()
        self.c_attn = nn.Linear(d_model, 3 * d_model)
        self.c_proj = nn.Linear(d_model, d_model)


class Block(nn.Module):
    def __init__(self, d_model):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.attn = Attention(d_model)
        self.ln_2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.mlp = MLP(d_model, 4 * d_model, d_model)


class QuaternionPoseRepresentation(nn.Module):
    """Pose head: d_model -> 7 (xyz + quaternion)."""

    def __init__(self, d_model):
        super().__init__()
        self.pose_classifier = MLP(d_model, 2 * d_model, 7)

    @staticmethod
    def reduce(poses, axis=-2):
        """Mean of per-token pose predictions: xyz mean, quaternion
        normalize-mean."""
        xyz, quat = poses[..., :3], poses[..., 3:]
        xyz = xyz.mean(axis)
        quat = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quat))
        quat = geometry.quaternion_remove_sign(geometry.quaternion_normalize(quat.mean(axis)))
        return torch.cat([xyz, quat], -1)


class MIGT(nn.Module):
    def __init__(self, config, dtype=torch.float32, generator=None):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.wte = nn.Embedding(cfg.n_embeddings + 2, d)
        self.wpe = nn.Parameter(torch.empty(WPE_STATIC_SIZE, d))
        self.pose_embedding = MLP(7, 2 * d, d)
        self.h = nn.ModuleList(Block(d) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.use_localization = not cfg.localization_weight.is_zero()
        if self.use_localization:
            self.pose_criterion = QuaternionPoseRepresentation(d)
        if cfg.use_dynamic_pose_loss:
            self.pos_ori_weights = nn.Parameter(torch.tensor([0.0, -3.0]))

        truncated_normal_(self.wte.weight, 0.02, generator)
        truncated_normal_(self.wpe, 0.02, generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                truncated_normal_(module.weight, 0.02, generator)
                nn.init.zeros_(module.bias)
        for module in (self.wte, self.h, self.ln_f):
            module.to(dtype)
        self.wpe.data = self.wpe.data.to(dtype)

    @property
    def mask_token(self):
        return self.config.n_embeddings

    @property
    def localization_token(self):
        return self.config.n_embeddings + 1

    def reduce_cameras(self, cameras, axis=-2):
        return QuaternionPoseRepresentation.reduce(cameras, axis=axis)
