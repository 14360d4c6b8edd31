"""Causal 3-D video VAE of Wan 2.1 (port of ``flow_factory_tpu/models/wan/video_vae.py``).

Parameter names are diffusers' ``AutoencoderKLWan`` names (flat
``down_blocks``/``up_blocks`` lists of residual blocks, attention blocks and
resamples; ``mid_block.resnets.{0,1}``/``attentions.0``; ``resample.1`` the
spatial conv of a resample; ``quant_conv``/``post_quant_conv``), except that
each ``WanRMS_norm`` ``gamma`` keeps the JAX package's (C,) shape. The flax
model runs channel-last with (kt, kh, kw, Cin, Cout) kernels; here the
convolutions run channel-first with (Cout, Cin, kt, kh, kw) weights, which
computes the same sums:

* causal 3-D convs pad zeros on the LEFT only in time (kernel 3 → 2 frames)
  and half the kernel on each side in space;
* the channel RMS norm has eps 1e-12 and fp32 stats;
* downsampling pads (0, 1) in h and w before its stride-2 conv; the 3-D
  variant then runs a causal stride-2 time conv (T = 1 + 2k → 1 + k);
* upsample3d runs its time conv first (C → 2C, interleaved into 2T frames)
  and drops the first twin, so the first latent decodes to ONE frame; then
  both upsamples repeat each pixel 2x2 (exactly ``jax.image.resize``
  nearest at 2x) and run a 3x3 conv C → C/2;
* latents are normalised per channel with ``latents_mean/std``.

Public API as the JAX package's: videos (B, C, T, H, W) in [-1, 1]; latents
channel-last (B, Tl, hl, wl, Cz). The Wan 2.2 knobs (``spatial_patch`` > 1,
``resample_residual``) and ``decode_chunked`` are not ported and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..vae import Conv


@dataclass(frozen=True)
class VideoVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    base_channels: int = 96  # upstream ``base_dim``
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)  # upstream ``dim_mult``
    layers_per_block: int = 2  # upstream ``num_res_blocks``
    temporal_down: int = 4  # total temporal compression (1 | 2 | 4)
    attn_scales: Tuple[float, ...] = ()
    scaling_factor: float = 1.0
    shift_factor: float = 0.0
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    spatial_patch: int = 1
    resample_residual: bool = False
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def spatial_down(self) -> int:
        return 2 ** (len(self.channel_mults) - 1) * self.spatial_patch

    @property
    def n_temporal(self) -> int:
        return {1: 0, 2: 1, 4: 2}[self.temporal_down]

    def temporal_down_flags(self) -> Tuple[bool, ...]:
        """Per-resample temporal-downsample flags in encoder order: the last
        ``n_temporal`` spatial resamples (upstream ``[False, True, True]``)."""
        n_spatial = len(self.channel_mults) - 1
        return tuple(i >= n_spatial - self.n_temporal for i in range(n_spatial))

    @staticmethod
    def wan(**o) -> "VideoVAEConfig":
        """Wan 2.1 VAE with the published per-channel latent statistics."""
        base = dict(
            latents_mean=(-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653,
                          -0.1517, 1.5508, 0.4134, -0.0715, 0.5517, -0.3632,
                          -0.1922, -0.9497, 0.2503, -0.2921),
            latents_std=(2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708,
                         2.6052, 2.0743, 3.2687, 2.1526, 2.8652, 1.5579,
                         1.6382, 1.1253, 2.8251, 1.9160),
        )
        base.update(o)
        return VideoVAEConfig(**base)

    @staticmethod
    def tiny(**o) -> "VideoVAEConfig":
        base = dict(base_channels=8, channel_mults=(1, 2), layers_per_block=1, temporal_down=2)
        base.update(o)
        return VideoVAEConfig(**base)


class WanCausalConv3d(nn.Conv3d):
    """Conv3d in ``compute_dtype``: zero padding LEFT-only in time, half the
    kernel on each side in space (diffusers ``WanCausalConv3d``)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), compute_dtype=torch.float32,
                 t_stride: int = 1, s_stride: int = 1):
        super().__init__(cin, cout, kernel, stride=(t_stride, s_stride, s_stride))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel_size
        dt = self.compute_dtype
        x = F.pad(x.to(dt), (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0))
        return F.conv3d(x, self.weight.to(dt), self.bias.to(dt), self.stride)


class WanRMSNorm(nn.Module):
    """Channel RMS norm of a channel-first tensor with a (C,) ``gamma``:
    fp32 stats, eps 1e-12, output in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=1, keepdim=True) + 1e-12)
        gamma = self.gamma.float().reshape(-1, *([1] * (x.ndim - 2)))
        return (y * gamma).to(x.dtype)


def _silu_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


class WanResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dt: torch.dtype):
        super().__init__()
        self.compute_dtype = dt
        self.norm1 = WanRMSNorm(cin)
        self.conv1 = WanCausalConv3d(cin, cout, compute_dtype=dt)
        self.norm2 = WanRMSNorm(cout)
        self.conv2 = WanCausalConv3d(cout, cout, compute_dtype=dt)
        if cin != cout:
            self.conv_shortcut = WanCausalConv3d(cin, cout, kernel=(1, 1, 1), compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = self.conv1(_silu_to(self.norm1(x), dt))
        h = self.conv2(_silu_to(self.norm2(h), dt))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class WanAttentionBlock(nn.Module):
    """Per-frame spatial self-attention, 1x1-conv qkv and projection."""

    def __init__(self, channels: int, dt: torch.dtype):
        super().__init__()
        self.compute_dtype = dt
        self.norm = WanRMSNorm(channels)
        self.to_qkv = Conv(channels, 3 * channels, 1, dt)
        self.proj = Conv(channels, channels, 1, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T, H, W)
        B, C, T, H, W = x.shape
        dt = self.compute_dtype
        h = self.norm(x).permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W)
        qkv = self.to_qkv(h).reshape(B * T, 3 * C, H * W).transpose(1, 2)
        q, k, v = qkv.chunk(3, dim=-1)
        s = torch.matmul(q, k.transpose(1, 2)).float() / math.sqrt(C)
        h = torch.matmul(torch.softmax(s, dim=-1).to(dt), v)  # (BT, HW, C)
        h = self.proj(h.transpose(1, 2).reshape(B * T, C, H, W))
        return x + h.reshape(B, T, C, H, W).permute(0, 2, 1, 3, 4)


class WanResample(nn.Module):
    """Spatial (+ temporal) resampling; ``resample.1`` is the spatial conv
    (index 0 of the upstream Sequential is padding or interpolation)."""

    def __init__(self, channels: int, mode: str, dt: torch.dtype):
        super().__init__()
        self.mode = mode
        if mode.startswith("upsample"):
            conv = Conv(channels, channels // 2, 3, dt, padding=1)
            if mode == "upsample3d":
                self.time_conv = WanCausalConv3d(channels, 2 * channels, kernel=(3, 1, 1), compute_dtype=dt)
        elif mode.startswith("downsample"):
            conv = Conv(channels, channels, 3, dt, stride=2)
            if mode == "downsample3d":
                self.time_conv = WanCausalConv3d(channels, channels, kernel=(3, 1, 1), compute_dtype=dt,
                                                 t_stride=2)
        else:
            raise ValueError(f"unknown resample mode {mode!r}")
        self.resample = nn.ModuleList([nn.Identity(), conv])

    def _per_frame(self, x: torch.Tensor, fn) -> torch.Tensor:
        B, C, T, H, W = x.shape
        y = fn(x.permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W))
        return y.reshape(B, T, *y.shape[1:]).permute(0, 2, 1, 3, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.resample[1]
        if self.mode.startswith("upsample"):
            if self.mode == "upsample3d":
                B, C, T, H, W = x.shape
                h = self.time_conv(x).reshape(B, 2, C, T, H, W).permute(0, 2, 3, 1, 4, 5)
                x = h.reshape(B, C, 2 * T, H, W)[:, :, 1:]  # the first latent yields one frame
            return self._per_frame(x, lambda f: conv(F.interpolate(f, scale_factor=2, mode="nearest")))
        x = self._per_frame(x, lambda f: conv(F.pad(f, (0, 1, 0, 1))))
        return self.time_conv(x) if self.mode == "downsample3d" else x


class WanMidBlock(nn.Module):
    def __init__(self, channels: int, dt: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(channels, channels, dt),
                                      WanResidualBlock(channels, channels, dt)])
        self.attentions = nn.ModuleList([WanAttentionBlock(channels, dt)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class WanEncoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        dt = cfg.compute_dtype
        n_spatial = len(cfg.channel_mults) - 1
        t_flags = cfg.temporal_down_flags()
        self.conv_in = WanCausalConv3d(cfg.in_channels, cfg.base_channels, compute_dtype=dt)
        blocks, prev, scale = [], cfg.base_channels, 1.0
        for i, mult in enumerate(cfg.channel_mults):
            ch = cfg.base_channels * mult
            for _ in range(cfg.layers_per_block):
                blocks.append(WanResidualBlock(prev, ch, dt))
                prev = ch
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(ch, dt))
            if i < n_spatial:
                blocks.append(WanResample(ch, "downsample3d" if t_flags[i] else "downsample2d", dt))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(prev, dt)
        self.norm_out = WanRMSNorm(prev)
        self.conv_out = WanCausalConv3d(prev, 2 * cfg.latent_channels, compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.norm_out(self.mid_block(h))
        return self.conv_out(F.silu(h.float()))


class WanDecoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        dt = cfg.compute_dtype
        mults = tuple(reversed(cfg.channel_mults))
        n_spatial = len(cfg.channel_mults) - 1
        t_flags = tuple(reversed(cfg.temporal_down_flags()))  # time upsamples first
        prev = cfg.base_channels * mults[0]
        self.conv_in = WanCausalConv3d(cfg.latent_channels, prev, compute_dtype=dt)
        self.mid_block = WanMidBlock(prev, dt)
        blocks, scale = [], 1.0 / (2 ** n_spatial)
        for i, mult in enumerate(mults):
            ch = cfg.base_channels * mult
            for _ in range(cfg.layers_per_block + 1):
                blocks.append(WanResidualBlock(prev, ch, dt))
                prev = ch
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(ch, dt))
            if i < n_spatial:
                blocks.append(WanResample(ch, "upsample3d" if t_flags[i] else "upsample2d", dt))
                prev = ch // 2
                scale *= 2.0
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = WanRMSNorm(prev)
        self.conv_out = WanCausalConv3d(prev, cfg.in_channels, compute_dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.norm_out(h).float()))


class VideoVAE(nn.Module):
    """Videos (B, C, T, H, W) in [-1, 1] ↔ latents (B, Tl, hl, wl, Cz)."""

    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        if cfg.spatial_patch != 1 or cfg.resample_residual:
            raise NotImplementedError("the Wan 2.2 VAE (spatial_patch, resample_residual) is not ported yet")
        self.cfg = cfg
        self.encoder = WanEncoder(cfg)
        self.decoder = WanDecoder(cfg)
        self.quant_conv = WanCausalConv3d(2 * cfg.latent_channels, 2 * cfg.latent_channels, kernel=(1, 1, 1))
        self.post_quant_conv = WanCausalConv3d(cfg.latent_channels, cfg.latent_channels, kernel=(1, 1, 1))

    def _stats(self, z: torch.Tensor):
        shape = (1, -1, 1, 1, 1)
        cfg = self.cfg
        return (torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device).reshape(shape),
                torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device).reshape(shape))

    def _normalize(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.latents_mean is not None:
            mean, std = self._stats(z)
            z = (z - mean) / std
        return (z - cfg.shift_factor) * cfg.scaling_factor

    def _denormalize(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        z = z / cfg.scaling_factor + cfg.shift_factor
        if cfg.latents_mean is not None:
            mean, std = self._stats(z)
            z = z * std + mean
        return z

    def _pad_front(self, x: torch.Tensor) -> torch.Tensor:
        """Wan frame convention: replicate frame 0 so T ≡ 1 (mod down)."""
        pad = (1 - x.shape[2]) % self.cfg.temporal_down
        return torch.cat([x[:, :, :1].expand(-1, -1, pad, -1, -1), x], dim=2) if pad else x

    def encode(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) → normalised latents (B, Tl, hl, wl, Cz): the
        posterior mean."""
        mean, _ = self.quant_conv(self.encoder(self._pad_front(videos))).chunk(2, dim=1)
        return self._normalize(mean).permute(0, 2, 3, 4, 1)

    def decode(self, latents: torch.Tensor, num_frames: Optional[int] = None) -> torch.Tensor:
        """Latents (B, Tl, hl, wl, Cz) → videos (B, C, T, H, W) in [-1, 1],
        T = 1 + (Tl − 1)·down (the last ``num_frames`` when fewer are asked)."""
        z = self.post_quant_conv(self._denormalize(latents.permute(0, 4, 1, 2, 3)))
        video = self.decoder(z)
        if num_frames is not None and video.shape[2] > num_frames:
            video = video[:, :, -num_frames:]
        return video
