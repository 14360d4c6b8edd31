"""LTX-2 audio latent stack: mel VAE and HiFi-GAN vocoder (port of
``flow_factory_tpu/models/ltx2/audio.py``).

The STFT is a framed product against a DFT basis, the encoder and decoder
are 1-D convolutions over mel frames, the vocoder is the HiFi-GAN generator
graph (``conv_pre``, per upsample stage a leaky ReLU, a transposed
convolution of kernel 2u and stride u, and the mean of the multi-receptive-
field ``ResBlock1`` stacks, then ``conv_post`` and tanh). Tensors are
channel-first inside, (B, C, T); the public API keeps the JAX module's:
waveforms (B, 1, T) in [-1, 1], latents (B, Tl, Cz), mel (B, frames,
n_mels).

The transposed convolutions are flax's ``ConvTranspose`` (no kernel flip,
``SAME`` padding: lax's ``conv_transpose`` pads the stride-dilated input by
(a, b) = (ceil((k + s − 2) / 2), the rest)), computed as PyTorch's
``conv_transpose1d`` with the kernel flipped, cut to those pads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class AudioVAEConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 80
    latent_channels: int = 8
    base_channels: int = 32
    temporal_down: int = 4
    vocoder_channels: int = 512
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[int, ...] = (1, 3, 5)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def ltx2(**o) -> "AudioVAEConfig":
        return AudioVAEConfig(**o)

    @staticmethod
    def tiny(**o) -> "AudioVAEConfig":
        base = dict(n_fft=256, hop=64, n_mels=16, latent_channels=8, base_channels=8,
                    temporal_down=2, vocoder_channels=16, resblock_kernels=(3,), resblock_dilations=(1, 3))
        base.update(o)
        return AudioVAEConfig(**base)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-style mel filterbank (host-side constant), the JAX module's."""
    fmin, fmax = 0.0, sr / 2
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = imel(np.linspace(mel(fmin), mel(fmax), n_mels + 2))
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, ce, hi = bins[i], bins[i + 1], bins[i + 2]
        if ce > lo:
            fb[i, lo:ce] = (np.arange(lo, ce) - lo) / max(ce - lo, 1)
        if hi > ce:
            fb[i, ce:hi] = (hi - np.arange(ce, hi)) / max(hi - ce, 1)
    return fb


def waveform_to_mel(wave: torch.Tensor, cfg: AudioVAEConfig) -> torch.Tensor:
    """(B, T) waveform → (B, frames, n_mels) log-mel via a framed DFT product."""
    n_fft, hop = cfg.n_fft, cfg.hop
    T = wave.shape[1]
    n_frames = max(1, (T - n_fft) // hop + 1)
    dev = wave.device
    idx = torch.arange(n_frames, device=dev)[:, None] * hop + torch.arange(n_fft, device=dev)[None, :]
    frames = wave.float()[:, idx] * torch.as_tensor(np.hanning(n_fft), dtype=torch.float32, device=dev)
    angles = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    re = frames @ torch.as_tensor(np.cos(angles), dtype=torch.float32, device=dev)
    im = frames @ torch.as_tensor(np.sin(angles), dtype=torch.float32, device=dev)
    fb = torch.as_tensor(mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels), device=dev)
    mel = (re * re + im * im) @ fb.T
    return torch.log(torch.clamp(mel, min=1e-5))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype`` (flax ``nn.Conv(dtype=...)``)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, dilation=1, compute_dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding,
                        self.dilation)


class ConvTranspose1d(Conv1d):
    """flax ``nn.ConvTranspose`` with ``SAME`` padding; the weight is
    (out, in, k), the flax (k, in, out) kernel transposed, not flipped."""

    def forward(self, x):
        dt, k, s = self.compute_dtype, self.kernel_size[0], self.stride[0]
        pad_len = k + s - 2
        a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
        b = pad_len - a
        full = F.conv_transpose1d(x.to(dt), self.weight.to(dt).transpose(0, 1).flip(-1), self.bias.to(dt),
                                  stride=s)
        return full[:, :, k - 1 - a: full.shape[-1] - (k - 1 - b)]


class AudioEncoder(nn.Module):
    def __init__(self, cfg: AudioVAEConfig):
        super().__init__()
        dt, base = cfg.compute_dtype, cfg.base_channels
        self.conv_in = Conv1d(cfg.n_mels, base, 5, padding=2, compute_dtype=dt)
        n = {1: 0, 2: 1, 4: 2}[cfg.temporal_down]
        self.down = nn.ModuleList([Conv1d(base if i == 0 else 2 * base, 2 * base, 4, stride=2, padding=1,
                                          compute_dtype=dt) for i in range(n)])
        self.conv_out = Conv1d(2 * base if n else base, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, frames, n_mels) → (B, 2·latent_channels, Tl) moments."""
        h = self.conv_in(mel.transpose(1, 2))
        for conv in self.down:
            h = conv(F.silu(h))
        return self.conv_out(F.silu(h))


class AudioDecoder(nn.Module):
    def __init__(self, cfg: AudioVAEConfig):
        super().__init__()
        dt, base = cfg.compute_dtype, cfg.base_channels
        self.conv_in = Conv1d(cfg.latent_channels, 2 * base, 3, padding=1, compute_dtype=dt)
        n = {1: 0, 2: 1, 4: 2}[cfg.temporal_down]
        self.up = nn.ModuleList([ConvTranspose1d(2 * base if i == 0 else base, base, 4, stride=2, compute_dtype=dt)
                                 for i in range(n)])
        self.conv_out = Conv1d(base if n else 2 * base, cfg.n_mels, 5, padding=2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, Tl, Cz) → (B, n_mels, frames) mel, channel-first."""
        h = self.conv_in(z.transpose(1, 2))
        for conv in self.up:
            h = conv(F.silu(h))
        return self.conv_out(F.silu(h))


def vocoder_upsample_rates(hop: int) -> tuple:
    """The hop length as HiFi-GAN upsample stages, largest first: 256 → (8, 8, 2, 2)."""
    known = {512: (8, 8, 2, 2, 2), 256: (8, 8, 2, 2), 128: (8, 8, 2), 64: (8, 8)}
    if hop in known:
        return known[hop]
    rates, rem = [], hop
    while rem > 1:
        f = 8 if rem % 8 == 0 else (4 if rem % 4 == 0 else 2)
        rates.append(f)
        rem //= f
    return tuple(rates)


class HiFiGANResBlock(nn.Module):
    """ResBlock1: per dilation, leaky ReLU → dilated conv → leaky ReLU → conv, a residual add."""

    def __init__(self, channels: int, kernel: int, dilations: Tuple[int, ...], dtype: torch.dtype):
        super().__init__()
        self.convs1 = nn.ModuleList([Conv1d(channels, channels, kernel, padding="same", dilation=d,
                                            compute_dtype=dtype) for d in dilations])
        self.convs2 = nn.ModuleList([Conv1d(channels, channels, kernel, padding="same", compute_dtype=dtype)
                                     for _ in dilations])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, 0.1)), 0.1))
        return x


class Vocoder(nn.Module):
    """Mel (B, n_mels, frames) → waveform (B, T), the HiFi-GAN generator."""

    def __init__(self, cfg: AudioVAEConfig):
        super().__init__()
        dt, ch0 = cfg.compute_dtype, cfg.vocoder_channels
        self.rates = vocoder_upsample_rates(cfg.hop)
        self.n_kernels = len(cfg.resblock_kernels)
        self.conv_pre = Conv1d(cfg.n_mels, ch0, 7, padding=3, compute_dtype=dt)
        ups, blocks, prev = [], [], ch0
        for i, u in enumerate(self.rates):
            ch = max(ch0 // 2 ** (i + 1), 8)
            ups.append(ConvTranspose1d(prev, ch, 2 * u, stride=u, compute_dtype=dt))
            blocks.extend(HiFiGANResBlock(ch, k, cfg.resblock_dilations, dt) for k in cfg.resblock_kernels)
            prev = ch
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(blocks)
        self.conv_post = Conv1d(prev, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.conv_pre(mel)
        nk = self.n_kernels
        for i, up in enumerate(self.ups):
            h = up(F.leaky_relu(h, 0.1))
            acc = None
            for r in range(nk):
                y = self.resblocks[i * nk + r](h)
                acc = y if acc is None else acc + y
            h = acc / float(nk)
        return torch.tanh(self.conv_post(F.leaky_relu(h, 0.01))[:, 0])


class AudioVAE(nn.Module):
    """waveform (B, 1, T) in [-1, 1] ↔ latents (B, Tl, Cz)."""

    def __init__(self, cfg: AudioVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = AudioDecoder(cfg)
        self.vocoder = Vocoder(cfg)

    def encode(self, wave: torch.Tensor) -> torch.Tensor:
        """Waveforms (B, 1, T) → the posterior mean (B, Tl, Cz)."""
        moments = self.encoder(waveform_to_mel(wave[:, 0], self.cfg)).float()
        return moments[:, :self.cfg.latent_channels].transpose(1, 2)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, Tl, Cz) → waveform (B, 1, T)."""
        return self.vocoder(self.decoder(z))[:, None, :]
