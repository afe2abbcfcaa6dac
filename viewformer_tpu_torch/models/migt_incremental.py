"""KV-cached MIGT inference: prefill, generate, localize (port of
viewformer_tpu/models/migt_incremental.py).

The cache holds stream-0 keys and values per layer:
  k, v: [n_layer, B, H, frames, L, dh], n: frames filled (a host int),
  grid: the (h, w) token grid of a frame.

prefill_cache runs the stream-0 tower over all context frames with
block-causal attention (kernel B1 on the card), into a cache of max_frames
frames. extend_cache, generate_frame and localize_frame run one 64-token
frame a scene over the cache; their attention over the cached frames below n
plus the frame's own block, under one softmax, is kernel B2 in its cache
form. extend_cache also writes the frame's K/V at frame n. generate_frame
takes N query cameras a scene in one pass: the N*B query frames are B2's
query rows, N-major, so query row g reads the cache of head row g % (B*H)
and no scene's cache is copied.
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


def _block_incremental(block, H, x, cache_k, cache_v, n, write=False):
    """One block over frames x [M, L, d] against one layer's cache
    [B, H, F, L, dh] (frames < n valid), M = N*B with the rows N-major: row m
    belongs to scene m % B. With write (M = B), the frames' K/V are stored
    at frame n. Returns the new x."""
    M, L, d = x.shape
    B, _, F_, _, dh = cache_k.shape
    v, q, k = block.attn.c_attn(block.ln_1(x)).split(d, -1)  # reference chunk order
    # contiguous: at M=1 the reshape is a strided view, which the kernel refuses
    heads = lambda t: t.reshape(M, L, H, dh).transpose(1, 2).reshape(M * H, L, dh).contiguous()  # noqa: E731
    k, v = heads(k), heads(v)
    if write:
        cache_k[:, :, n] = k.reshape(B, H, L, dh)
        cache_v[:, :, n] = v.reshape(B, H, L, dh)
    attended = branch_attention_fwd(heads(q), cache_k.reshape(B * H, F_ * L, dh),
                                    cache_v.reshape(B * H, F_ * L, dh), k, v, L, n, n)
    x = x + block.attn.c_proj(attended.reshape(M, H, L, dh).transpose(1, 2).reshape(M, L, d))
    return x + block.mlp(block.ln_2(x))


def prefill_cache(model, tokens, poses, valid_frames=None, max_frames=None):
    """tokens [B, T, h, w], poses [B, T, 7] -> KVCache of max_frames frames
    (default T; the frames beyond T are zeros, for extend_cache to fill)
    with n = T (or valid_frames: trailing frames cannot change earlier
    frames' K/V, so a caller may pad and mark only the first valid_frames
    as context)."""
    cfg = model.config
    B, T = tokens.shape[:2]
    max_frames = T if max_frames is None else int(max_frames)
    if max_frames < T:
        raise ValueError(f'max_frames {max_frames} < {T} context frames')
    grid = tuple(int(s) for s in tokens.shape[2:])
    L, H, d = math.prod(grid), cfg.n_head, cfg.d_model
    dh = d // H
    wte = model.wte.weight
    x = wte[tokens.reshape(B, T, L)] + model.wpe[:L] + model.embed_poses(poses)[:, :, None]
    x = x.to(wte.dtype).reshape(B, T * L, d)

    # frames past n must be finite: the plain B2 multiplies their V by 0
    alloc = torch.zeros if max_frames > T else torch.empty
    cache_k = alloc((cfg.n_layer, B, H, max_frames, L, dh), dtype=wte.dtype, device=wte.device)
    cache_v = alloc(cache_k.shape, dtype=wte.dtype, device=wte.device)
    heads = lambda t: t.reshape(B, T, L, H, dh).permute(0, 3, 1, 2, 4)  # noqa: E731
    for layer, block in enumerate(model.h):
        v, q, k = block.attn.c_attn(block.ln_1(x)).split(d, -1)  # reference chunk order
        cache_k[layer, :, :, :T] = heads(k)
        cache_v[layer, :, :, :T] = heads(v)
        if layer == cfg.n_layer - 1:
            break  # the last layer's K/V are all that is read again
        (attended,) = multi_end_block_attention((cache_k[layer, :, :, :T],),
                                                (cache_v[layer, :, :, :T],), (heads(q),))
        x = x + block.attn.c_proj(attended.permute(0, 2, 3, 1, 4).reshape(B, T * L, d))
        x = x + block.mlp(block.ln_2(x))
    return KVCache(cache_k, cache_v, T if valid_frames is None else int(valid_frames), grid)


def _run_frame(model, cache, x, write=False):
    for layer, block in enumerate(model.h):
        x = _block_incremental(block, model.config.n_head, x, cache.k[layer],
                               cache.v[layer], cache.n, write)
    return model.ln_f(x)


def extend_cache(model, cache, tokens, pose):
    """Append one context frame: tokens [B, h, w], pose [B, 7]. Runs the
    frame's stream-0 pass (the cached frames below n plus its own block) and
    writes its K/V at frame n of every layer, in place. Returns the cache
    with n + 1."""
    if cache.n >= cache.k.shape[3]:
        raise ValueError(f'the cache holds {cache.k.shape[3]} frames, all filled')
    B = tokens.shape[0]
    L = math.prod(tokens.shape[1:])
    wte = model.wte.weight
    x = wte[tokens.reshape(B, L)] + model.wpe[:L] + model.embed_poses(pose)[:, None]
    _run_frame(model, cache, x.to(wte.dtype), write=True)
    return KVCache(cache.k, cache.v, cache.n + 1, cache.grid)


def generate_frame(model, cache, query_pose):
    """Query frames' logits against the cached context: query_pose [B, 7]
    -> f32 logits [B, h, w, n_embeddings]; or N views a scene in one pass,
    [B, N, 7] -> [B, N, h, w, n_embeddings]."""
    cfg = model.config
    views = query_pose.dim() == 3
    poses = query_pose.transpose(0, 1) if views else query_pose[None]  # [N, B, 7]
    N, B = poses.shape[:2]
    L = cache.k.shape[4]
    wte = model.wte.weight
    x = (wte[model.mask_token] + model.wpe[:L]
         + model.embed_poses(poses.reshape(N * B, 7))[:, None])
    x = _run_frame(model, cache, x.to(wte.dtype).expand(N * B, L, cfg.d_model))
    logits = (x.float() @ wte[:cfg.n_embeddings].float().t()).reshape(
        (N, B) + tuple(cache.grid) + (cfg.n_embeddings,))
    return logits.transpose(0, 1) if views else logits[0]


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
