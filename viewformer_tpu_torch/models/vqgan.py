"""VQ-GAN codebook model (port of viewformer_tpu/models/vqgan.py).

The public methods take and return NHWC like the JAX package; inside, the
towers run NCHW views of NHWC memory (channels_last). Convolutions compute
in the model's dtype (bf16 on the card) from parameters stored in
param_dtype (default: dtype), as flax's nn.Conv(dtype=...) with f32
params; GroupNorm parameters and statistics, the codebook and the code
search stay f32. Module names equal the JAX parameter names, so the weight
bridge (utils/convert.py) maps them one to one. The EMA codebook state is
the Quantizer's buffers; forward(x, training=True) and encode(x,
training=True) update it (ops/quantizer.quantize_ema). remat=True recomputes
each ResnetBlock and AttnBlock in the backward (torch.utils.checkpoint), as
JAX's nn.remat.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.quantizer import embed_code, init_quantizer_state, nearest_codes, quantize_ema
from .initializers import lecun_normal_


class Conv(nn.Conv2d):
    """nn.Conv2d whose input, weight and bias are cast to `dtype` (the
    compute dtype, set by VQGAN) before the convolution."""
    dtype = torch.float32

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype))


def _conv(c_in, c_out, size, stride=1, padding=None):
    return Conv(c_in, c_out, size, stride, padding=size // 2 if padding is None else padding)


class GroupNorm32(nn.Module):
    """GroupNorm(32), eps 1e-6, f32 statistics and parameters whatever the
    compute dtype."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.weight, self.bias, 1e-6).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm1 = GroupNorm32(c_in)
        self.conv1 = _conv(c_in, c_out, 3)
        self.norm2 = GroupNorm32(c_out)
        self.conv2 = _conv(c_out, c_out, 3)
        self.nin_shortcut = _conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial positions, scaled by C^-0.5;
    scores and softmax in f32."""

    def __init__(self, channels):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = _conv(channels, channels, 1)
        self.k = _conv(channels, channels, 1)
        self.v = _conv(channels, channels, 1)
        self.proj_out = _conv(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).flatten(2).transpose(1, 2)                  # [B, HW, C]
        k = self.k(h).flatten(2)                                  # [B, C, HW]
        v = self.v(h).flatten(2).transpose(1, 2)
        scores = torch.bmm(q.float(), k.float()) * (C ** -0.5)
        weights = torch.softmax(scores, -1).to(v.dtype)
        out = torch.bmm(weights, v).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric (0, 1) pad, then a 3x3 stride-2 conv without padding."""

    def __init__(self, channels):
        super().__init__()
        self.conv = _conv(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels):
        super().__init__()
        self.conv = _conv(channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class _Tower(nn.Module):
    """Runs its named stages in the order they were added; with remat (set
    by VQGAN) each ResnetBlock and AttnBlock is recomputed in the backward."""
    remat = False

    def __init__(self):
        super().__init__()
        self._order = []

    def _stage(self, name, module):
        self.add_module(name, module)
        self._order.append(name)

    def forward(self, h):
        for name in self._order:
            stage = getattr(self, name)
            if (self.remat and torch.is_grad_enabled()
                    and isinstance(stage, (ResnetBlock, AttnBlock))):
                h = checkpoint(stage, h, use_reentrant=False)
            else:
                h = stage(h)
        return h


class Encoder(_Tower):
    def __init__(self, cfg):
        super().__init__()
        ch, levels = cfg.ch, len(cfg.ch_mult)
        self._stage('conv_in', _conv(cfg.in_channels, ch, 3))
        res, c = cfg.image_size, ch
        for i_level, mult in enumerate(cfg.ch_mult):
            for i_block in range(cfg.num_res_blocks):
                self._stage(f'down_{i_level}_block_{i_block}', ResnetBlock(c, ch * mult))
                c = ch * mult
                if res in cfg.attn_resolutions:
                    self._stage(f'down_{i_level}_attn_{i_block}', AttnBlock(c))
            if i_level != levels - 1:
                self._stage(f'down_{i_level}_downsample', Downsample(c))
                res //= 2
        self._stage('mid_block_1', ResnetBlock(c, c))
        self._stage('mid_attn_1', AttnBlock(c))
        self._stage('mid_block_2', ResnetBlock(c, c))
        self._stage('norm_out', GroupNorm32(c))
        self._stage('swish', nn.SiLU())
        self._stage('conv_out', _conv(c, cfg.z_channels, 3))


class Decoder(_Tower):
    def __init__(self, cfg):
        super().__init__()
        ch, levels = cfg.ch, len(cfg.ch_mult)
        c = ch * cfg.ch_mult[-1]
        res = cfg.image_size // 2 ** (levels - 1)
        self._stage('conv_in', _conv(cfg.z_channels, c, 3))
        self._stage('mid_block_1', ResnetBlock(c, c))
        self._stage('mid_attn_1', AttnBlock(c))
        self._stage('mid_block_2', ResnetBlock(c, c))
        for i_level in reversed(range(levels)):
            for i_block in range(cfg.num_res_blocks + 1):
                self._stage(f'up_{i_level}_block_{i_block}', ResnetBlock(c, ch * cfg.ch_mult[i_level]))
                c = ch * cfg.ch_mult[i_level]
                if res in cfg.attn_resolutions:
                    self._stage(f'up_{i_level}_attn_{i_block}', AttnBlock(c))
            if i_level != 0:
                self._stage(f'up_{i_level}_upsample', Upsample(c))
                res *= 2
        self._stage('norm_out', GroupNorm32(c))
        self._stage('swish', nn.SiLU())
        self._stage('conv_out', _conv(c, cfg.out_ch, 3))


class Quantizer(nn.Module):
    """The EMA codebook state as buffers (ops/quantizer.init_quantizer_state):
    embeddings [D, N], ema_cluster_size_hidden, ema_dw_hidden and the int32
    counter; ops/quantizer.quantize_ema updates them in training."""

    def __init__(self, embed_dim, n_embed, generator=None):
        super().__init__()
        for name, value in init_quantizer_state(embed_dim, n_embed, generator).items():
            self.register_buffer(name, value)


class VQGAN(nn.Module):
    """forward: NHWC images in [-1, 1] -> (dec, e_latent_loss, quant, codes);
    encode: images -> (quantized latents, codes); decode / decode_code:
    latents or codes -> NHWC images (f32)."""

    def __init__(self, config, dtype=torch.float32, generator=None, param_dtype=None,
                 remat=False):
        """dtype: the convolutions' compute dtype; param_dtype: what their
        parameters are stored in (default dtype). remat: recompute each
        ResnetBlock and AttnBlock in the backward."""
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = _conv(config.z_channels, config.embed_dim, 1)
        self.post_quant_conv = _conv(config.embed_dim, config.z_channels, 1)
        for module in self.modules():
            if isinstance(module, Conv):
                lecun_normal_(module.weight, generator)
                nn.init.zeros_(module.bias)
                module.to(param_dtype or dtype)
                module.dtype = dtype
        self.encoder.remat = self.decoder.remat = remat
        self.quantizer = Quantizer(config.embed_dim, config.n_embed, generator)

    @property
    def dtype(self):
        return self.quant_conv.dtype

    def _latents(self, x):
        h = self.encoder(x.permute(0, 3, 1, 2).to(self.dtype))
        return self.quant_conv(h).permute(0, 2, 3, 1).float()

    def encode(self, x, training=False):
        """-> (quant, codes). training=True quantizes through quantize_ema,
        which updates the EMA state, and gives quant the straight-through
        gradient."""
        h = self._latents(x)
        if training:
            quant, _loss, codes = quantize_ema(self.quantizer, h, training=True)
            return quant, codes
        codes = nearest_codes(self.quantizer.embeddings, h)
        return embed_code(self.quantizer.embeddings, codes), codes

    def decode(self, quant):
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2).to(self.dtype))
        return self.decoder(h).permute(0, 2, 3, 1).float()

    def decode_code(self, codes):
        return self.decode(embed_code(self.quantizer.embeddings, codes))

    def forward(self, x, training=False):
        """JAX's VQGAN.__call__: (dec f32, e_latent_loss, quant, codes), the
        EMA state updated when training."""
        quant, e_latent_loss, codes = quantize_ema(self.quantizer, self._latents(x),
                                                   training=training)
        return self.decode(quant), e_latent_loss, quant, codes
