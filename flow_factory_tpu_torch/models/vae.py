"""AutoencoderKL image VAE (port of ``flow_factory_tpu/models/vae.py``).

Parameter names are diffusers' ``AutoencoderKL`` names. The flax model runs
its convolutions channel-last with HWIO kernels; here they run NCHW with
OIHW kernels, which computes the same sums. GroupNorm is flax's: fp32 fast
variance over each group, eps 1e-6, fp32 output. The public API takes and
returns NCHW tensors: images in [-1, 1] and scaled latents.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Linear, NormParams


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 1.5305
    shift_factor: float = 0.0609
    use_mid_attention: bool = True
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)

    @staticmethod
    def sd3(**overrides) -> "VAEConfig":
        return VAEConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "VAEConfig":
        base = dict(base_channels=16, channel_mults=(1, 2), layers_per_block=1, latent_channels=16)
        base.update(overrides)
        return VAEConfig(**base)


class GroupNorm(NormParams):
    """flax ``nn.GroupNorm(num_groups=min(32, C), dtype=float32)`` on NCHW input."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels)
        self.groups = min(32, channels)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        xg = x.float().reshape(B, self.groups, C // self.groups, H, W)
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0.0)
        y = (xg - mean).reshape(B, C, H, W)
        r = torch.rsqrt(var + self.eps).reshape(B, self.groups, 1, 1, 1).repeat_interleave(
            C // self.groups, dim=1).reshape(B, C, 1, 1)
        return y * (r * self.weight.float()[None, :, None, None]) + self.bias.float()[None, :, None, None]


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (flax ``nn.Conv(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, kernel: int, compute_dtype: torch.dtype,
                 stride: int = 1, padding=0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, dt: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(cin, cout, 3, dt, padding=1)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv(cout, cout, 3, dt, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, channels: int, dt: torch.dtype):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.to_q = Linear(channels, channels, compute_dtype=dt)
        self.to_k = Linear(channels, channels, compute_dtype=dt)
        self.to_v = Linear(channels, channels, compute_dtype=dt)
        self.to_out = nn.ModuleList([Linear(channels, channels, compute_dtype=dt)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (C ** -0.5)
        out = self.to_out[0](torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v))
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, ch: int, dt: torch.dtype, attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, dt), ResnetBlock2D(ch, ch, dt)])
        if attention:
            self.attentions = nn.ModuleList([Attention(ch, dt)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.resnets[0](h)
        if hasattr(self, "attentions"):
            h = self.attentions[0](h)
        return self.resnets[1](h)


class Downsample(nn.Module):
    def __init__(self, ch: int, dt: torch.dtype):
        super().__init__()
        self.conv = Conv(ch, ch, 3, dt, stride=2)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(h, (0, 1, 0, 1)))  # flax padding ((0, 1), (0, 1))


class Upsample(nn.Module):
    def __init__(self, ch: int, dt: torch.dtype):
        super().__init__()
        self.conv = Conv(ch, ch, 3, dt, padding=1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(h, scale_factor=2, mode="nearest"))


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, dt: torch.dtype, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout, dt) for j in range(n)])
        if down:
            self.downsamplers = nn.ModuleList([Downsample(cout, dt)])


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, dt: torch.dtype, up: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout, dt) for j in range(n)])
        if up:
            self.upsamplers = nn.ModuleList([Upsample(cout, dt)])


def _run_blocks(blocks: nn.ModuleList, h: torch.Tensor, sampler: str) -> torch.Tensor:
    for block in blocks:
        for res in block.resnets:
            h = res(h)
        if hasattr(block, sampler):
            h = getattr(block, sampler)[0](h)
    return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt, ch = cfg.compute_dtype, [cfg.base_channels * m for m in cfg.channel_mults]
        n = len(ch)
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, dt, padding=1)
        self.down_blocks = nn.ModuleList([
            EncoderBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, dt, down=i < n - 1)
            for i in range(n)])
        self.mid_block = MidBlock(ch[-1], dt, cfg.use_mid_attention)
        self.conv_norm_out = GroupNorm(ch[-1])
        self.conv_out = Conv(ch[-1], 2 * cfg.latent_channels, 3, torch.float32, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _run_blocks(self.down_blocks, self.conv_in(x), "downsamplers")
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.compute_dtype
        ch = [cfg.base_channels * m for m in reversed(cfg.channel_mults)]
        n = len(ch)
        self.conv_in = Conv(cfg.latent_channels, ch[0], 3, dt, padding=1)
        self.mid_block = MidBlock(ch[0], dt, cfg.use_mid_attention)
        self.up_blocks = nn.ModuleList([
            DecoderBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block + 1, dt, up=i < n - 1)
            for i in range(n)])
        self.conv_norm_out = GroupNorm(ch[-1])
        self.conv_out = Conv(ch[-1], cfg.in_channels, 3, torch.float32, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_blocks(self.up_blocks, self.mid_block(self.conv_in(z)), "upsamplers")
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """KL image autoencoder. Public API is NCHW: images in [-1, 1], scaled latents."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images (B, C, H, W) in [-1, 1] → (mean, logvar) each (B, Cz, h, w)."""
        mean, logvar = self.encoder(images).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
               sample: bool = False) -> torch.Tensor:
        """Images (B, C, H, W) in [-1, 1] → scaled latents (B, Cz, h, w): the
        posterior mean, or with ``sample`` mean + exp(½·logvar)·ε, ε drawn
        from ``generator``; then (z − shift)·scale (JAX ``vae.py:154``)."""
        mean, logvar = self.encode_moments(images)
        z = mean
        if sample:
            if generator is None:
                raise ValueError("a generator is required when sample=True")
            eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=torch.float32)
            z = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        return (z - self.cfg.shift_factor) * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, Cz, h, w) → images (B, C, H, W) in [-1, 1]."""
        z = latents / self.cfg.scaling_factor + self.cfg.shift_factor
        return self.decoder(z)
