"""LTX causal video VAE (port of ``flow_factory_tpu/models/ltx2/video_vae.py``).

The upstream LTX-Video autoencoder graph of the JAX module, with the
diffusers ``AutoencoderKLLTXVideo`` names of the JAX key map
(``ltx_video_vae_key_map``): a 4x4 pixel patchify at the boundary; causal
(encoder) or symmetric (decoder) REPLICATE padding in time; parameter-free
channel RMS norms; joint stride-(2, 2, 2) downsamplers; per-stage
``conv_out`` / ``conv_in`` resnets that carry the channel changes; a
shared-logvar encoder head (latent_channels + 1 outputs); pixel-shuffle
upsamplers that drop the duplicated first frame; and a timestep-conditioned
decoder (``timestep_scale_multiplier``, one sinusoidal MLP time embedder per
conditioned block feeding each resnet's (4, C) ``scale_shift_table``, a
(2, C) table at the output norm).

Tensors are channel-first inside, (B, C, T, H, W); the public API keeps the
JAX module's: videos (B, C, T, H, W) in [-1, 1], latents channel-last
(B, Tl, hl, wl, Cz). Decoder noise injection (``per_channel_scale1/2``)
draws from a ``torch.Generator`` when one is given, and no noise otherwise,
as the JAX decode without a noise key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear


@dataclass(frozen=True)
class LTXVideoVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_block_out_channels: Tuple[int, ...] = (512, 512, 256, 128)
    layers_per_block: Tuple[int, ...] = (4, 3, 3, 3, 4)
    decoder_layers_per_block: Tuple[int, ...] = (4, 3, 3, 3, 4)
    spatio_temporal_scaling: Tuple[bool, ...] = (True, True, True, False)
    decoder_spatio_temporal_scaling: Tuple[bool, ...] = (False, True, True, True)
    decoder_inject_noise: Tuple[bool, ...] = (False, False, False, False)
    upsample_residual: Tuple[bool, ...] = (False, False, False, False)
    upsample_factor: Tuple[int, ...] = (1, 1, 1, 1)
    timestep_conditioning: bool = False
    patch_size: int = 4
    patch_size_t: int = 1
    resnet_norm_eps: float = 1e-8
    scaling_factor: float = 1.0
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    encoder_causal: bool = True
    decoder_causal: bool = False
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def spatial_down(self) -> int:
        return self.patch_size * 2 ** sum(self.spatio_temporal_scaling)

    @property
    def temporal_down(self) -> int:
        return self.patch_size_t * 2 ** sum(self.spatio_temporal_scaling)

    @staticmethod
    def ltx2(**o) -> "LTXVideoVAEConfig":
        base = dict(timestep_conditioning=True)
        base.update(o)
        return LTXVideoVAEConfig(**base)

    @staticmethod
    def tiny(**o) -> "LTXVideoVAEConfig":
        base = dict(latent_channels=16, block_out_channels=(8, 16), decoder_block_out_channels=(16, 8),
                    layers_per_block=(1, 1, 1), decoder_layers_per_block=(1, 1, 1),
                    spatio_temporal_scaling=(True, False), decoder_spatio_temporal_scaling=(False, True),
                    decoder_inject_noise=(False, False), upsample_residual=(False, False),
                    upsample_factor=(1, 1), timestep_conditioning=True, patch_size=2)
        base.update(o)
        return LTXVideoVAEConfig(**base)


class LTXCausalConv3d(nn.Module):
    """Conv3d (``conv``), zero padding in space, replicate padding in time:
    all in front when ``causal``, split otherwise."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=(1, 1, 1), causal: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride=stride)
        self.kernel, self.stride, self.causal, self.dtype = kernel, stride, causal, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T, H, W)
        kt, kh, kw = self.kernel
        if kt > 1:
            front, back = (kt - 1, 0) if self.causal else ((kt - 1) // 2, kt // 2)
            parts = [x[:, :, :1].expand(-1, -1, front, -1, -1)] if front else []
            parts.append(x)
            if back:
                parts.append(x[:, :, -1:].expand(-1, -1, back, -1, -1))
            x = torch.cat(parts, dim=2)
        dt = self.dtype
        return F.conv3d(x.to(dt), self.conv.weight.to(dt), self.conv.bias.to(dt), stride=self.stride,
                        padding=(0, kh // 2, kw // 2))


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free channel RMS norm (dim 1), fp32 statistics."""
    x32 = x.float()
    return (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=1, keepdim=True) + eps)).to(x.dtype)


def _silu(h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return F.silu(h.float()).to(dt)


def _bcast5(v: torch.Tensor) -> torch.Tensor:
    """(B, C) → (B, C, 1, 1, 1)."""
    return v[:, :, None, None, None]


class LTXTimeEmbedder(nn.Module):
    """Sinusoidal(256) → Linear → SiLU → Linear in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.linear_1 = Linear(256, dim, compute_dtype=dtype)
        self.linear_2 = Linear(dim, dim, compute_dtype=dtype)
        self.dtype = dtype

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        freqs = torch.exp(-math.log(10000.0) * torch.arange(128, dtype=torch.float32, device=t.device) / 128)
        ang = t.float()[:, None] * freqs[None]
        h = self.linear_1(torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).to(self.dtype))
        return self.linear_2(_silu(h, self.dtype))


def _table_param(rows: int, C: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(rows, C))


class LTXResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float, causal: bool = True, conditioned: bool = False,
                 inject_noise: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype, self.conditioned, self.inject_noise = eps, dtype, conditioned, inject_noise
        if conditioned:
            self.scale_shift_table = _table_param(4, cin)
        self.conv1 = LTXCausalConv3d(cin, cout, causal=causal, dtype=dtype)
        self.conv2 = LTXCausalConv3d(cout, cout, causal=causal, dtype=dtype)
        if inject_noise:
            self.per_channel_scale1 = nn.Parameter(torch.zeros(cout))
            self.per_channel_scale2 = nn.Parameter(torch.zeros(cout))
        if cin != cout:
            self.conv_shortcut = LTXCausalConv3d(cin, cout, kernel=(1, 1, 1), causal=causal, dtype=dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        if self.conditioned:
            C = self.scale_shift_table.shape[-1]
            self.scale_shift_table.normal_(0.0, 1.0, generator=generator).div_(C ** 0.5)
        if self.inject_noise:
            nn.init.zeros_(self.per_channel_scale1)
            nn.init.zeros_(self.per_channel_scale2)

    def _noise(self, h, amp, generator):
        sp = torch.randn(h.shape[3:], generator=generator, device=h.device, dtype=torch.float32).to(h.dtype)
        return h + sp[None, None] * amp[None, :, None, None, None]

    def forward(self, x, temb=None, generator=None):
        dt = self.dtype
        C = x.shape[1]
        mods = None
        if self.conditioned and temb is not None:
            parts = temb.reshape(temb.shape[0], 4, C) + self.scale_shift_table[None]
            mods = [_bcast5(parts[:, i]) for i in range(4)]  # shift1, scale1, shift2, scale2
        h = _rms(x, self.eps)
        if mods is not None:
            h = h * (1.0 + mods[1]) + mods[0]
        h = self.conv1(_silu(h, dt))
        if self.inject_noise and generator is not None:
            h = self._noise(h, self.per_channel_scale1, generator)
        h = _rms(h, self.eps)
        if mods is not None:
            h = h * (1.0 + mods[3]) + mods[2]
        h = self.conv2(_silu(h, dt))
        if self.inject_noise and generator is not None:
            h = self._noise(h, self.per_channel_scale2, generator)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class LTXMidBlock(nn.Module):
    def __init__(self, C: int, num_layers: int, eps: float, causal: bool = True, conditioned: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conditioned = conditioned
        if conditioned:
            self.time_embedder = LTXTimeEmbedder(4 * C, dtype)
        self.resnets = nn.ModuleList([LTXResnetBlock(C, C, eps, causal, conditioned, dtype=dtype)
                                      for _ in range(num_layers)])

    def forward(self, x, t_scaled=None):
        temb = self.time_embedder(t_scaled) if self.conditioned and t_scaled is not None else None
        for r in self.resnets:
            x = r(x, temb)
        return x


class LTXDownBlock(nn.Module):
    def __init__(self, C: int, out_channels: int, num_layers: int, scale: bool, eps: float, causal: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList([LTXResnetBlock(C, C, eps, causal, dtype=dtype) for _ in range(num_layers)])
        if scale:
            self.downsamplers = nn.ModuleList([LTXCausalConv3d(C, C, stride=(2, 2, 2), causal=causal,
                                                               dtype=dtype)])
        if C != out_channels:
            self.conv_out = LTXResnetBlock(C, out_channels, eps, causal, dtype=dtype)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        if hasattr(self, "conv_out"):
            x = self.conv_out(x)
        return x


def _shuffle(x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """(B, 8·out, T, H, W) → (B, out, 2T − 1, 2H, 2W): depth-to-space over
    (t, h, w), channel index ((pt·2 + ph)·2 + pw)·out + c; the first latent
    frame decodes to one frame."""
    B, _, T, H, W = x.shape
    x = x.reshape(B, 2, 2, 2, out_ch, T, H, W).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(B, out_ch, 2 * T, 2 * H, 2 * W)[:, :, 1:]


class LTXUpsampler(nn.Module):
    def __init__(self, C: int, out_channels: int, residual: bool, causal: bool, dtype: torch.dtype):
        super().__init__()
        self.out_channels, self.residual = out_channels, residual
        self.conv = LTXCausalConv3d(C, 8 * out_channels, causal=causal, dtype=dtype)

    def forward(self, x):
        h = _shuffle(self.conv(x), self.out_channels)
        if self.residual:
            r = x.repeat_interleave((8 * self.out_channels) // x.shape[1], dim=1)
            h = h + _shuffle(r, self.out_channels)
        return h


class LTXUpBlock(nn.Module):
    def __init__(self, C: int, out_channels: int, num_layers: int, scale: bool, eps: float, causal: bool,
                 conditioned: bool, inject_noise: bool, residual: bool, factor: int, dtype: torch.dtype):
        super().__init__()
        mid_ch = out_channels * factor if scale else out_channels
        self.conditioned = conditioned
        if C != mid_ch:
            self.conv_in = LTXResnetBlock(C, mid_ch, eps, causal, dtype=dtype)
        if conditioned:
            self.time_embedder = LTXTimeEmbedder(4 * out_channels, dtype)
        if scale:
            self.upsamplers = nn.ModuleList([LTXUpsampler(mid_ch, out_channels, residual, causal, dtype)])
        self.resnets = nn.ModuleList([LTXResnetBlock(out_channels, out_channels, eps, causal, conditioned,
                                                     inject_noise, dtype) for _ in range(num_layers)])

    def forward(self, x, t_scaled=None, generator=None):
        if hasattr(self, "conv_in"):
            x = self.conv_in(x)
        temb = self.time_embedder(t_scaled) if self.conditioned and t_scaled is not None else None
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        for r in self.resnets:
            x = r(x, temb, generator)
        return x


class LTXVideoEncoder(nn.Module):
    def __init__(self, cfg: LTXVideoVAEConfig):
        super().__init__()
        dt, blocks, causal, eps = cfg.compute_dtype, cfg.block_out_channels, cfg.encoder_causal, cfg.resnet_norm_eps
        p2 = cfg.in_channels * cfg.patch_size ** 2
        self.eps, self.dtype = eps, dt
        self.conv_in = LTXCausalConv3d(p2, blocks[0], causal=causal, dtype=dt)
        self.down_blocks = nn.ModuleList([
            LTXDownBlock(blocks[i], blocks[i + 1] if i + 1 < len(blocks) else blocks[i], cfg.layers_per_block[i],
                         cfg.spatio_temporal_scaling[i], eps, causal, dt) for i in range(len(blocks))])
        self.mid_block = LTXMidBlock(blocks[-1], cfg.layers_per_block[-1], eps, causal, dtype=dt)
        self.conv_out = LTXCausalConv3d(blocks[-1], cfg.latent_channels + 1, causal=causal, dtype=torch.float32)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(_silu(_rms(h, self.eps), self.dtype))


class LTXVideoDecoder(nn.Module):
    def __init__(self, cfg: LTXVideoVAEConfig):
        super().__init__()
        dt, blocks, causal, eps = (cfg.compute_dtype, cfg.decoder_block_out_channels, cfg.decoder_causal,
                                   cfg.resnet_norm_eps)
        cond = cfg.timestep_conditioning
        self.eps, self.dtype, self.conditioned = eps, dt, cond
        if cond:
            self.timestep_scale_multiplier = nn.Parameter(torch.tensor(1000.0))
        self.conv_in = LTXCausalConv3d(cfg.latent_channels, blocks[0], causal=causal, dtype=dt)
        self.mid_block = LTXMidBlock(blocks[0], cfg.decoder_layers_per_block[0], eps, causal, cond, dt)
        ups, width = [], blocks[0]
        for i in range(len(blocks)):
            out_ch = blocks[i + 1] if i + 1 < len(blocks) else blocks[i]
            n = (cfg.decoder_layers_per_block[i + 1] if i + 1 < len(cfg.decoder_layers_per_block)
                 else cfg.decoder_layers_per_block[-1])
            ups.append(LTXUpBlock(width, out_ch, n, cfg.decoder_spatio_temporal_scaling[i], eps, causal, cond,
                                  cfg.decoder_inject_noise[i], cfg.upsample_residual[i], cfg.upsample_factor[i], dt))
            width = out_ch
        self.up_blocks = nn.ModuleList(ups)
        if cond:
            self.scale_shift_table = _table_param(2, width)
            self.time_embedder = LTXTimeEmbedder(2 * width, dt)
        self.conv_out = LTXCausalConv3d(width, cfg.out_channels * cfg.patch_size ** 2, causal=causal,
                                        dtype=torch.float32)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        if self.conditioned:
            nn.init.constant_(self.timestep_scale_multiplier, 1000.0)
            C = self.scale_shift_table.shape[-1]
            self.scale_shift_table.normal_(0.0, 1.0, generator=generator).div_(C ** 0.5)

    def forward(self, z, timestep=None, generator=None):
        t_scaled = None
        if self.conditioned:
            if timestep is None:
                timestep = torch.zeros((z.shape[0],), dtype=torch.float32, device=z.device)
            t_scaled = timestep.float() * self.timestep_scale_multiplier.float()
        h = self.mid_block(self.conv_in(z), t_scaled)
        for blk in self.up_blocks:
            h = blk(h, t_scaled, generator)
        h = _rms(h, self.eps)
        if self.conditioned:
            C = h.shape[1]
            parts = self.time_embedder(t_scaled).reshape(h.shape[0], 2, C) + self.scale_shift_table[None]
            h = h * (1.0 + _bcast5(parts[:, 1])) + _bcast5(parts[:, 0])
        return self.conv_out(F.silu(h.float()))


class LTXVideoVAE(nn.Module):
    """videos (B, C, T, H, W) in [-1, 1] ↔ latents (B, Tl, hl, wl, Cz)."""

    def __init__(self, cfg: LTXVideoVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = LTXVideoEncoder(cfg)
        self.decoder = LTXVideoDecoder(cfg)

    def _normalize(self, z):  # channel-last
        cfg = self.cfg
        if cfg.latents_mean is not None:
            mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
            std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
            z = (z - mean) / std
        return z * cfg.scaling_factor

    def _denormalize(self, z):
        cfg = self.cfg
        z = z / cfg.scaling_factor
        if cfg.latents_mean is not None:
            mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
            std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
            z = z * std + mean
        return z

    def _patchify(self, x):  # (B, C, T, H, W) → (B, C·p·p, T, H/p, W/p), channel order (c, ph, pw)
        p = self.cfg.patch_size
        if p == 1:
            return x
        B, C, T, H, W = x.shape
        x = x.reshape(B, C, T, H // p, p, W // p, p).permute(0, 1, 4, 6, 2, 3, 5)
        return x.reshape(B, C * p * p, T, H // p, W // p)

    def _unpatchify(self, x):
        p = self.cfg.patch_size
        if p == 1:
            return x
        B, Cp, T, H, W = x.shape
        x = x.reshape(B, Cp // (p * p), p, p, T, H, W).permute(0, 1, 4, 5, 2, 6, 3)
        return x.reshape(B, Cp // (p * p), T, H * p, W * p)

    def encode(self, videos: torch.Tensor) -> torch.Tensor:
        """Videos (B, C, T, H, W) → the normalised posterior mean (B, Tl, hl,
        wl, Cz); the head's last channel, the shared log-variance, is dropped."""
        y = self.encoder(self._patchify(videos))
        return self._normalize(y[:, :self.cfg.latent_channels].permute(0, 2, 3, 4, 1))

    def decode(self, latents: torch.Tensor, num_frames: Optional[int] = None,
               timestep: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """Latents (B, Tl, hl, wl, Cz) → videos (B, C, T, H, W), T = 1 +
        (Tl − 1)·temporal_down cut to the last ``num_frames``; ``timestep``
        (B,) conditions the decoder when the config says so."""
        z = self._denormalize(latents).permute(0, 4, 1, 2, 3)
        if timestep is not None:
            timestep = torch.atleast_1d(torch.as_tensor(timestep, dtype=torch.float32, device=z.device))
        video = self._unpatchify(self.decoder(z, timestep, generator))
        if num_frames is not None and video.shape[2] > num_frames:
            video = video[:, :, -num_frames:]
        return video
