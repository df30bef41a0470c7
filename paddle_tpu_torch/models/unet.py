"""Diffusion UNet: the counterpart of ``paddle_tpu/models/unet.py``
(BASELINE config 5, Stable Diffusion UNet training): ``UNetConfig``
(``tiny()`` too), ``timestep_embedding``, ``ResBlock``, ``AttnBlock``,
``Downsample``, ``Upsample``, ``UNet2DModel`` and ``ddpm_loss``, on the
port's ``nn`` (GroupNorm, Conv2D, Linear, nearest resize). Parameter names
and layouts are the JAX model's (conv weights ``[out, in, kh, kw]``,
Linear ``[in, out]``), so ``weights.from_paddle_tpu_state`` carries the
JAX model's parameters across.

The attention block's q, k and v are strided views of one transposed
qkv tensor (``[B, S, 3, heads, dim]``); ``F.scaled_dot_product_attention``
hands the flash kernel dense copies, so on the card every block runs the
flash forward and, under autograd, the flash backward (head dim channels
/ 4: 32 at 64 channels, 64 at 128 and 256). The residual sums go through
``amp.amp_add`` and the skip concatenation through the op surface's
``concat``, as the JAX model's operators dispatch them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import nn
from ..amp import amp_add
from ..device import resolve_device
from ..nn import functional as F
from ..ops.registry import OP_TABLE


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple = (64, 128, 256)
    layers_per_block: int = 2
    norm_groups: int = 16
    attn_resolutions: tuple = (1, 2)   # block indices with attention
    time_embed_dim: int = 256

    @staticmethod
    def tiny():
        return UNetConfig(in_channels=3, out_channels=3,
                          block_channels=(16, 32), layers_per_block=1,
                          norm_groups=4, attn_resolutions=(1,),
                          time_embed_dim=64)


def timestep_embedding(t, dim):
    """Sinusoidal timestep embedding [B, dim] in float32: cos then sin of
    t * exp(-log(10000) i / half). The frequencies are computed in
    float64 and rounded to float32, the products and the sines in float32,
    as the JAX package computes them with x64 on (a weakly typed float64
    meeting float32 t); the arguments reach ~1000 rad, where a frequency
    computed in float32 moves the phases by ~1e-4."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64, device=t.device) / half).float()
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Layer):
    def __init__(self, in_c, out_c, time_dim, groups, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm1 = nn.GroupNorm(groups, in_c, **kw)
        self.conv1 = nn.Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.time_proj = nn.Linear(time_dim, out_c, **kw)
        self.norm2 = nn.GroupNorm(groups, out_c, **kw)
        self.conv2 = nn.Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.skip = nn.Conv2D(in_c, out_c, 1, **kw) if in_c != out_c \
            else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = amp_add(h, self.time_proj(F.silu(temb))[..., None, None])
        h = self.conv2(F.silu(self.norm2(h)))
        return amp_add(h, self.skip(x) if self.skip is not None else x)


class AttnBlock(nn.Layer):
    """Spatial self-attention over the H*W positions (the SD attention
    block) through ``F.scaled_dot_product_attention``."""

    def __init__(self, channels, groups, num_heads=4, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = nn.GroupNorm(groups, channels, **kw)
        self.qkv = nn.Conv2D(channels, 3 * channels, 1, **kw)
        self.proj = nn.Conv2D(channels, channels, 1, **kw)
        self.num_heads = num_heads
        self.channels = channels

    def forward(self, x):
        b, c, hh, ww = x.shape
        qkv = self.qkv(self.norm(x))
        qkv = qkv.reshape(b, 3, self.num_heads, c // self.num_heads,
                          hh * ww).permute(0, 4, 1, 2, 3)   # b, s, 3, h, d
        q, k, v = (qkv[:, :, i] for i in range(3))
        out = F.scaled_dot_product_attention(q, k, v, training=self.training)
        out = out.permute(0, 2, 3, 1).reshape(b, c, hh, ww)
        return amp_add(x, self.proj(out))


class Downsample(nn.Layer):
    def __init__(self, channels, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2D(channels, channels, 3, stride=2, padding=1,
                              device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Layer):
    def __init__(self, channels, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2D(channels, channels, 3, padding=1,
                              device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DModel(nn.Layer):
    """model(sample [B, C, H, W], timestep [B] int) -> [B, C_out, H, W]."""

    def __init__(self, config: UNetConfig = None, *, device=None,
                 dtype=None, **kw):
        super().__init__()
        config = config or UNetConfig(**kw)
        self.config = config
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        chs = config.block_channels
        tdim = config.time_embed_dim
        g = config.norm_groups

        self.time_mlp = nn.Sequential(nn.Linear(tdim, tdim, **kw), nn.Silu(),
                                      nn.Linear(tdim, tdim, **kw))
        self.conv_in = nn.Conv2D(config.in_channels, chs[0], 3, padding=1,
                                 **kw)

        self.down_blocks = nn.LayerList()
        self.downsamplers = nn.LayerList()
        in_c = chs[0]
        for bi, out_c in enumerate(chs):
            blocks = nn.LayerList()
            for _ in range(config.layers_per_block):
                blocks.append(ResBlock(in_c, out_c, tdim, g, **kw))
                if bi in config.attn_resolutions:
                    blocks.append(AttnBlock(out_c, g, **kw))
                in_c = out_c
            self.down_blocks.append(blocks)
            self.downsamplers.append(Downsample(out_c, **kw)
                                     if bi < len(chs) - 1 else nn.Identity())

        self.mid_block1 = ResBlock(chs[-1], chs[-1], tdim, g, **kw)
        self.mid_attn = AttnBlock(chs[-1], g, **kw)
        self.mid_block2 = ResBlock(chs[-1], chs[-1], tdim, g, **kw)

        self.up_blocks = nn.LayerList()
        self.upsamplers = nn.LayerList()
        for bi, out_c in reversed(list(enumerate(chs))):
            blocks = nn.LayerList()
            for li in range(config.layers_per_block):
                # only the first res-block of each level sees the skip
                src_c = in_c + out_c if li == 0 else out_c
                blocks.append(ResBlock(src_c, out_c, tdim, g, **kw))
                if bi in config.attn_resolutions:
                    blocks.append(AttnBlock(out_c, g, **kw))
                in_c = out_c
            self.up_blocks.append(blocks)
            self.upsamplers.append(Upsample(out_c, **kw) if bi > 0
                                   else nn.Identity())

        self.norm_out = nn.GroupNorm(g, chs[0], **kw)
        self.conv_out = nn.Conv2D(chs[0], config.out_channels, 3, padding=1,
                                  **kw)

    def forward(self, sample, timestep):
        temb = self.time_mlp(timestep_embedding(
            timestep, self.config.time_embed_dim))
        h = self.conv_in(sample)
        skips = []
        for blocks, down in zip(self.down_blocks, self.downsamplers):
            for blk in blocks:
                h = blk(h, temb) if isinstance(blk, ResBlock) else blk(h)
            skips.append(h)
            h = down(h)

        h = self.mid_block2(self.mid_attn(self.mid_block1(h, temb)), temb)

        concat = OP_TABLE["concat"]["api"]
        for blocks, up in zip(self.up_blocks, self.upsamplers):
            skip = skips.pop()
            if h.shape[2:] != skip.shape[2:]:
                h = F.interpolate(h, size=[skip.shape[2], skip.shape[3]],
                                  mode="nearest")
            h = concat([h, skip], axis=1)
            for blk in blocks:
                h = blk(h, temb) if isinstance(blk, ResBlock) else blk(h)
            h = up(h)

        return self.conv_out(F.silu(self.norm_out(h)))


def _alphas_bar(device):
    """cumprod(1 - betas) of the linear schedule betas = linspace(1e-4,
    0.02, 1000) in float32 (``jnp.linspace``'s form: start (1 - i/div) +
    stop i/div), the product taken in float64 and cast."""
    n = 1000
    step = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
    start = torch.tensor(1e-4, dtype=torch.float32)
    stop = torch.tensor(0.02, dtype=torch.float32)
    betas = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return torch.cumprod((1 - betas).double(), 0).float().to(device)


def ddpm_loss(model, x0, t, noise):
    """DDPM epsilon-prediction objective: mse(model(sqrt(a) x0 +
    sqrt(1 - a) noise, t), noise), a = alphas_bar[t]."""
    a_bar = _alphas_bar(x0.device)[t.long()]
    sqrt_ab = a_bar.sqrt()[:, None, None, None]
    sqrt_1mab = (1.0 - a_bar).sqrt()[:, None, None, None]
    noisy = x0 * sqrt_ab + noise * sqrt_1mab
    return F.mse_loss(model(noisy, t), noise)


__all__ = ["AttnBlock", "Downsample", "ResBlock", "UNet2DModel",
           "UNetConfig", "Upsample", "ddpm_loss", "timestep_embedding"]
