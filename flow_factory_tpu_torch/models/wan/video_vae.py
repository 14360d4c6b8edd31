"""Causal 3-D video VAE of Wan 2.1 and 2.2 (port of ``flow_factory_tpu/models/wan/video_vae.py``).

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

The Wan 2.2 (TI2V-5B) graph adds two knobs: ``spatial_patch`` folds p x p
pixels into channels at the VAE's boundary (encoder in, decoder out), and
``resample_residual`` builds one residual stage per channel multiplier
(``down_blocks.{i}.resnets.{j}`` then ``downsampler``; the decoder's
``up_blocks.{i}`` with ``upsampler``), each with a parameter-free shortcut
from the stage input: an average of pixel-unshuffled channel groups going
down, a channel repeat and pixel shuffle going up.

Public API as the JAX package's: videos (B, C, T, H, W) in [-1, 1]; latents
channel-last (B, Tl, hl, wl, Cz). :meth:`VideoVAE.decode_chunked` decodes a
long clip a few latent frames at a time with enough left context to give
the full decode's frames.
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
    def wan22_5b(**o) -> "VideoVAEConfig":
        """Wan 2.2 TI2V-5B VAE: 16x spatial (8x conv x 2x patch), 4x
        temporal, 48 latent channels, residual resample stages."""
        base = dict(base_channels=160, latent_channels=48, spatial_patch=2, resample_residual=True)
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

    def forward(self, x: torch.Tensor, first_frame_drop: bool = True) -> torch.Tensor:
        conv = self.resample[1]
        if self.mode.startswith("upsample"):
            if self.mode == "upsample3d":
                B, C, T, H, W = x.shape
                h = self.time_conv(x).reshape(B, 2, C, T, H, W).permute(0, 2, 3, 1, 4, 5).reshape(B, C, 2 * T, H, W)
                x = h[:, :, 1:] if first_frame_drop else h  # the first latent yields one frame
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


def avg_down_shortcut(x: torch.Tensor, ft: int, fs: int, out_ch: int) -> torch.Tensor:
    """Wan 2.2's parameter-free shortcut of a downsample stage (JAX
    ``avg_down_shortcut``): frame 0 replicated in front to a multiple of
    ``ft``, the (ft, fs, fs) factors unshuffled into channels in (t, h, w, c)
    order, then ``out_ch`` group means (or each channel repeated when the
    stage widens without resampling)."""
    B, C, T, H, W = x.shape
    pad = (-T) % ft
    if pad:
        x = torch.cat([x[:, :, :1].expand(-1, -1, pad, -1, -1), x], dim=2)
        T += pad
    x = x.reshape(B, C, T // ft, ft, H // fs, fs, W // fs, fs).permute(0, 3, 5, 7, 1, 2, 4, 6)
    total = ft * fs * fs * C
    x = x.reshape(B, total, T // ft, H // fs, W // fs)
    if total % out_ch == 0:
        return x.reshape(B, out_ch, total // out_ch, *x.shape[2:]).mean(2)
    return x.repeat_interleave(out_ch // total, dim=1)


def dup_up_shortcut(x: torch.Tensor, ft: int, fs: int, out_ch: int, first_frame_drop: bool) -> torch.Tensor:
    """Wan 2.2's parameter-free shortcut of an upsample stage (JAX
    ``dup_up_shortcut``): each channel repeated (or group means when the
    stage narrows without resampling), shuffled into (ft, fs, fs), and the
    leading ``ft − 1`` frames dropped at the start of a sequence."""
    B, C, T, H, W = x.shape
    total = ft * fs * fs * out_ch
    if total % C == 0:
        x = x.repeat_interleave(total // C, dim=1)
    else:
        x = x.reshape(B, total, C // total, T, H, W).mean(2)
    x = x.reshape(B, ft, fs, fs, out_ch, T, H, W).permute(0, 4, 5, 1, 6, 2, 7, 3)
    x = x.reshape(B, out_ch, T * ft, H * fs, W * fs)
    return x[:, :, ft - 1:] if first_frame_drop and ft > 1 else x


class WanResidualDownStage(nn.Module):
    """Wan 2.2 encoder stage: residual blocks, then the downsampler, plus
    the average shortcut from the stage's input."""

    def __init__(self, cin: int, cout: int, num_resnets: int, mode: str, dt: torch.dtype):
        super().__init__()
        self.mode = mode
        self.resnets = nn.ModuleList([WanResidualBlock(cin if j == 0 else cout, cout, dt) for j in range(num_resnets)])
        if mode != "none":
            self.downsampler = WanResample(cout, mode, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for block in self.resnets:
            h = block(h)
        if self.mode != "none":
            h = self.downsampler(h)
        fs = 1 if self.mode == "none" else 2
        return h + avg_down_shortcut(x, 2 if self.mode == "downsample3d" else 1, fs, h.shape[1])


class WanResidualUpStage(nn.Module):
    """Wan 2.2 decoder stage: residual blocks, then the upsampler (which
    halves the width), plus the repeat shortcut from the stage's input."""

    def __init__(self, cin: int, cout: int, num_resnets: int, mode: str, dt: torch.dtype):
        super().__init__()
        self.mode = mode
        self.resnets = nn.ModuleList([WanResidualBlock(cin if j == 0 else cout, cout, dt) for j in range(num_resnets)])
        if mode != "none":
            self.upsampler = WanResample(cout, mode, dt)

    def forward(self, x: torch.Tensor, first_frame_drop: bool = True) -> torch.Tensor:
        h = x
        for block in self.resnets:
            h = block(h)
        if self.mode != "none":
            h = self.upsampler(h, first_frame_drop)
        fs = 1 if self.mode == "none" else 2
        return h + dup_up_shortcut(x, 2 if self.mode == "upsample3d" else 1, fs, h.shape[1], first_frame_drop)


class WanEncoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        dt = cfg.compute_dtype
        n_spatial = len(cfg.channel_mults) - 1
        t_flags = cfg.temporal_down_flags()
        self.conv_in = WanCausalConv3d(cfg.in_channels * cfg.spatial_patch ** 2, cfg.base_channels, compute_dtype=dt)
        blocks, prev, scale = [], cfg.base_channels, 1.0
        for i, mult in enumerate(cfg.channel_mults):
            ch = cfg.base_channels * mult
            mode = "none" if i >= n_spatial else ("downsample3d" if t_flags[i] else "downsample2d")
            if cfg.resample_residual:  # Wan 2.2: one stage a multiplier
                blocks.append(WanResidualDownStage(prev, ch, cfg.layers_per_block, mode, dt))
                prev = ch
                continue
            for _ in range(cfg.layers_per_block):
                blocks.append(WanResidualBlock(prev, ch, dt))
                prev = ch
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(ch, dt))
            if i < n_spatial:
                blocks.append(WanResample(ch, mode, dt))
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
            mode = "none" if i >= n_spatial else ("upsample3d" if t_flags[i] else "upsample2d")
            if cfg.resample_residual:  # Wan 2.2: one stage a multiplier
                blocks.append(WanResidualUpStage(prev, ch, cfg.layers_per_block + 1, mode, dt))
                prev = ch if mode == "none" else ch // 2
                continue
            for _ in range(cfg.layers_per_block + 1):
                blocks.append(WanResidualBlock(prev, ch, dt))
                prev = ch
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(ch, dt))
            if i < n_spatial:
                blocks.append(WanResample(ch, mode, dt))
                prev = ch // 2
                scale *= 2.0
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = WanRMSNorm(prev)
        self.conv_out = WanCausalConv3d(prev, cfg.in_channels * cfg.spatial_patch ** 2, compute_dtype=torch.float32)

    def forward(self, z: torch.Tensor, first_frame_drop: bool = True) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h, first_frame_drop) if isinstance(block, (WanResample, WanResidualUpStage)) else block(h)
        return self.conv_out(F.silu(self.norm_out(h).float()))


class VideoVAE(nn.Module):
    """Videos (B, C, T, H, W) in [-1, 1] ↔ latents (B, Tl, hl, wl, Cz)."""

    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
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

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) → (B, p·p·C, T, H/p, W/p), channels in (ph, pw, c) order."""
        p = self.cfg.spatial_patch
        if p == 1:
            return x
        B, C, T, H, W = x.shape
        x = x.reshape(B, C, T, H // p, p, W // p, p).permute(0, 4, 6, 1, 2, 3, 5)
        return x.reshape(B, p * p * C, T, H // p, W // p)

    def _unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.spatial_patch
        if p == 1:
            return x
        B, C, T, H, W = x.shape
        x = x.reshape(B, p, p, C // (p * p), T, H, W).permute(0, 3, 4, 5, 1, 6, 2)
        return x.reshape(B, C // (p * p), T, H * p, W * p)

    def encode(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) → normalised latents (B, Tl, hl, wl, Cz): the
        posterior mean."""
        mean, _ = self.quant_conv(self.encoder(self._patchify(self._pad_front(videos)))).chunk(2, dim=1)
        return self._normalize(mean).permute(0, 2, 3, 4, 1)

    def _post_quant(self, latents: torch.Tensor) -> torch.Tensor:
        return self.post_quant_conv(self._denormalize(latents.permute(0, 4, 1, 2, 3)))

    @staticmethod
    def _last_frames(video: torch.Tensor, num_frames: Optional[int]) -> torch.Tensor:
        return video[:, :, -num_frames:] if num_frames is not None and video.shape[2] > num_frames else video

    def decode(self, latents: torch.Tensor, num_frames: Optional[int] = None) -> torch.Tensor:
        """Latents (B, Tl, hl, wl, Cz) → videos (B, C, T, H, W) in [-1, 1],
        T = 1 + (Tl − 1)·down (the last ``num_frames`` when fewer are asked)."""
        return self._last_frames(self._unpatchify(self.decoder(self._post_quant(latents))), num_frames)

    def decode_chunked(self, latents: torch.Tensor, chunk: int = 4, overlap: int = 8,
                       num_frames: Optional[int] = None) -> torch.Tensor:
        """:meth:`decode` ``chunk`` latent frames at a time (JAX
        ``decode_chunked``): each chunk is decoded with up to ``overlap``
        earlier latent frames of left context, which covers the causal
        decoder's temporal reach, and keeps its own frames: ``down`` a latent,
        one for the sequence's first. Activation memory goes with chunk +
        overlap instead of the clip."""
        z = self._post_quant(latents)
        Tl, d = z.shape[2], self.cfg.temporal_down
        outs = []
        for s in range(0, Tl, chunk):
            e = min(s + chunk, Tl)
            lo = max(0, s - overlap)
            seg = self._unpatchify(self.decoder(z[:, :, lo:e], first_frame_drop=lo == 0))
            keep = (e - s) * d + (1 - d if s == 0 and lo == 0 else 0)
            outs.append(seg[:, :, seg.shape[2] - keep:])
        return self._last_frames(torch.cat(outs, dim=2), num_frames)
