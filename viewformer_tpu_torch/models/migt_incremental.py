"""KV-cached MIGT inference: prefill, generate, localize (port of
viewformer_tpu/models/migt_incremental.py).

The cache holds stream-0 keys and values per layer:
  k, v: [n_layer, B, H, frames, L, dh], n: frames filled (a host int),
  grid: the (h, w) token grid of a frame.

prefill_cache runs the stream-0 tower over all context frames with
block-causal attention (kernel B1 on the card). generate_frame and
localize_frame run one 64-token frame over the cache; their attention over
the cached frames below n plus the frame's own block, under one softmax, is
kernel B2 in its cache form.
"""
import math
from dataclasses import dataclass

import torch

from ..ops.attention_cuda import branch_attention_fwd
from ..ops.branching_attention import multi_end_block_attention
from ..utils import geometry
from ..utils.device import resolve_device


@dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    n: int
    grid: tuple


def init_cache(config, batch_size, max_frames, dtype=torch.float32, device='cuda'):
    """An empty KVCache of max_frames frames, on `device`: the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    dh = config.d_model // config.n_head
    g = config.token_image_size
    shape = (config.n_layer, batch_size, config.n_head, max_frames, g * g, dh)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0, (g, g))


def _block_incremental(block, H, x, cache_k, cache_v, n):
    """One block over one frame x [B, L, d] against one layer's cache
    [B, H, F, L, dh] (frames < n valid). Returns the new x."""
    B, L, d = x.shape
    dh = d // H
    F_ = cache_k.shape[2]
    v, q, k = block.attn.c_attn(block.ln_1(x)).split(d, -1)  # reference chunk order
    # contiguous: at B=1 the reshape is a strided view, which the kernel refuses
    heads = lambda t: t.reshape(B, L, H, dh).transpose(1, 2).reshape(B * H, L, dh).contiguous()  # noqa: E731
    attended = branch_attention_fwd(heads(q), cache_k.reshape(B * H, F_ * L, dh),
                                    cache_v.reshape(B * H, F_ * L, dh), heads(k), heads(v),
                                    L, n, n)
    x = x + block.attn.c_proj(attended.reshape(B, H, L, dh).transpose(1, 2).reshape(B, L, d))
    return x + block.mlp(block.ln_2(x))


def prefill_cache(model, tokens, poses, valid_frames=None):
    """tokens [B, T, h, w], poses [B, T, 7] -> KVCache with n = T (or
    valid_frames: trailing frames cannot change earlier frames' K/V, so a
    caller may pad and mark only the first valid_frames as context)."""
    cfg = model.config
    B, T = tokens.shape[:2]
    grid = tuple(int(s) for s in tokens.shape[2:])
    L, H, d = math.prod(grid), cfg.n_head, cfg.d_model
    dh = d // H
    wte = model.wte.weight
    x = wte[tokens.reshape(B, T, L)] + model.wpe[:L] + model.embed_poses(poses)[:, :, None]
    x = x.to(wte.dtype).reshape(B, T * L, d)

    cache_k = torch.empty((cfg.n_layer, B, H, T, L, dh), dtype=wte.dtype, device=wte.device)
    cache_v = torch.empty_like(cache_k)
    heads = lambda t: t.reshape(B, T, L, H, dh).permute(0, 3, 1, 2, 4)  # noqa: E731
    for layer, block in enumerate(model.h):
        v, q, k = block.attn.c_attn(block.ln_1(x)).split(d, -1)  # reference chunk order
        cache_k[layer] = heads(k)
        cache_v[layer] = heads(v)
        if layer == cfg.n_layer - 1:
            break  # the last layer's K/V are all that is read again
        (attended,) = multi_end_block_attention((cache_k[layer],), (cache_v[layer],),
                                                (heads(q),))
        x = x + block.attn.c_proj(attended.permute(0, 2, 3, 1, 4).reshape(B, T * L, d))
        x = x + block.mlp(block.ln_2(x))
    return KVCache(cache_k, cache_v, T if valid_frames is None else int(valid_frames), grid)


def _run_frame(model, cache, x):
    for layer, block in enumerate(model.h):
        x = _block_incremental(block, model.config.n_head, x, cache.k[layer],
                               cache.v[layer], cache.n)
    return model.ln_f(x)


def generate_frame(model, cache, query_pose):
    """The query frame's logits against the cached context: query_pose
    [B, 7] -> f32 logits [B, h, w, n_embeddings]."""
    cfg = model.config
    B, L = query_pose.shape[0], cache.k.shape[4]
    wte = model.wte.weight
    x = wte[model.mask_token] + model.wpe[:L] + model.embed_poses(query_pose)[:, None]
    x = _run_frame(model, cache, x.to(wte.dtype).expand(B, L, cfg.d_model))
    logits = x.float() @ wte[:cfg.n_embeddings].float().t()
    return logits.reshape((B,) + tuple(cache.grid) + (cfg.n_embeddings,))


def localize_frame(model, cache, tokens):
    """Per-token camera predictions [B, L, 7] for a query frame's codes
    tokens [B, h, w], against the cached context (the frame rides stream 0
    with the localization token in place of its pose). Reduce them with
    MIGT.reduce_cameras."""
    cfg = model.config
    B = tokens.shape[0]
    L = math.prod(tokens.shape[1:])
    wte = model.wte.weight
    x = wte[tokens.reshape(B, L)] + model.wpe[:L] + wte[model.localization_token]
    x = _run_frame(model, cache, x.to(wte.dtype))
    raw = model.pose_criterion.pose_classifier(x.float())  # f32 island
    xyz = raw[..., :3] / cfg.pose_multiplier
    quaternion = geometry.quaternion_remove_sign(geometry.quaternion_normalize(raw[..., 3:]))
    return torch.cat([xyz, quaternion], -1)
