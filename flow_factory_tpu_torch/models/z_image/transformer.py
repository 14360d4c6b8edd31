"""Z-Image single-stream DiT (port of ``flow_factory_tpu/models/z_image/transformer.py``).

Text tokens (the Qwen3 LM's states through ``cap_embedder``: an fp32
RMSNorm, then a linear) lead the packed image tokens through one stack of
blocks, each:

* four modulations from the timestep embedding (scale and tanh-bounded
  gate, for the attention and for the FFN; no shift);
* sandwich RMS norms around both branches (fp32, plain: no kernel), the
  pre-norm output times (1 + scale) in the compute dtype;
* one joint attention: q, k, v projections in the attention layout,
  per-head RMS qk-norm, multi-axis RoPE, ``dot_product_attention`` (K3 on
  the card, K2a/K2b in the backward);
* SwiGLU ``w2(silu(w1 x) * w3 x)``.

The final layer modulates the whole joint row to fp32 through
``adaln_modulate`` (K5: shift first) before ``final_linear``; only the
image tokens are returned. Parameter names follow the JAX package's key
map of the upstream layout (``layers.{i}.attention.to_q``,
``feed_forward.w1``, ``cap_embedder.0``/``.1``, ``t_embedder.mlp.0``/``.2``,
``final_layer.linear``). ``remat`` recomputes each block in the backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import dot_product_attention
from ...ops.norms import adaln_modulate
from .. import layers
from ..layers import (HEAD_ROWS, SAMPLE_ROWS, FP32RMSNorm, HeadProj, HeadRMSNorm, Linear, MergeProj, apply_rope,
                      checkpointed, rope_frequencies)


@dataclass(frozen=True)
class ZImageConfig:
    in_channels: int = 64  # packed 2x2 VAE latents
    hidden_dim: int = 3072
    num_heads: int = 24
    num_layers: int = 38
    ffn_dim: int = 8192  # SwiGLU inner width
    context_dim: int = 2560  # Qwen3 hidden
    freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    attn_backend: str = "auto"
    dtype: str = "bfloat16"
    remat: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @staticmethod
    def tiny(**o) -> "ZImageConfig":
        base = dict(in_channels=16, hidden_dim=64, num_heads=4, num_layers=3, ffn_dim=128, context_dim=32,
                    freq_dim=32, axes_dim=(4, 6, 6))
        base.update(o)
        return ZImageConfig(**base)


class _Modulation(nn.Module):
    """``nn.Sequential(SiLU, Linear)`` by its names (``adaLN_modulation.1``), fp32."""

    def __init__(self, hidden_dim: int, chunks: int):
        super().__init__()
        self.chunks = chunks
        self.adaLN_modulation = nn.ModuleList([nn.Identity(),
                                               Linear(hidden_dim, chunks * hidden_dim, rows=SAMPLE_ROWS)])

    def modulation(self, temb: torch.Tensor):
        return self.adaLN_modulation[1](F.silu(temb)).chunk(self.chunks, dim=-1)


class ZImageAttention(nn.Module):
    def __init__(self, cfg: ZImageConfig):
        super().__init__()
        D, H, E, dt = cfg.hidden_dim, cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        self.attn_backend = cfg.attn_backend
        self.to_q, self.to_k, self.to_v = HeadProj(D, H, E, dt), HeadProj(D, H, E, dt), HeadProj(D, H, E, dt)
        self.norm_q, self.norm_k = HeadRMSNorm(E), HeadRMSNorm(E)
        self.to_out = nn.ModuleList([MergeProj(D, D, compute_dtype=dt)])

    def forward(self, h, cos, sin):
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        q, k = apply_rope(self.norm_q(q), cos, sin), apply_rope(self.norm_k(k), cos, sin)
        return self.to_out[0](dot_product_attention(q, k, v, backend=self.attn_backend))


class _SwiGLU(nn.Module):
    def __init__(self, cfg: ZImageConfig):
        super().__init__()
        D, M, dt = cfg.hidden_dim, cfg.ffn_dim, cfg.compute_dtype
        self.w1 = Linear(D, M, bias=False, compute_dtype=dt)
        self.w2 = Linear(M, D, bias=False, compute_dtype=dt)
        self.w3 = Linear(D, M, bias=False, compute_dtype=dt)

    def forward(self, h):
        return self.w2(F.silu(self.w1(h)) * self.w3(h))


class ZImageBlock(_Modulation):
    """Sequential single-stream block: sandwich-normed attention + SwiGLU."""

    def __init__(self, cfg: ZImageConfig):
        super().__init__(cfg.hidden_dim, 4)
        self.compute_dtype = cfg.compute_dtype
        self.attention = ZImageAttention(cfg)
        self.feed_forward = _SwiGLU(cfg)
        for name in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            setattr(self, name, FP32RMSNorm(cfg.hidden_dim))

    def forward(self, x, temb, cos, sin):
        dt = self.compute_dtype
        scale_msa, gate_msa, scale_mlp, gate_mlp = self.modulation(temb)
        gate_msa, gate_mlp = torch.tanh(gate_msa)[:, None], torch.tanh(gate_mlp)[:, None]
        h = (self.attention_norm1(x) * (1 + scale_msa[:, None])).to(dt)
        attn = self.attention(h, cos, sin)
        x = x + gate_msa.to(x.dtype) * self.attention_norm2(attn).to(x.dtype)
        h = (self.ffn_norm1(x) * (1 + scale_mlp[:, None])).to(dt)
        return x + gate_mlp.to(x.dtype) * self.ffn_norm2(self.feed_forward(h)).to(x.dtype)


class _TimestepEmbedder(nn.Module):
    """Sinusoidal features → Linear → SiLU → Linear, fp32 (``t_embedder.mlp.0``/``.2``)."""

    def __init__(self, hidden_dim: int, freq_dim: int):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.ModuleList([Linear(freq_dim, hidden_dim, rows=SAMPLE_ROWS), nn.Identity(),
                                  Linear(hidden_dim, hidden_dim, rows=SAMPLE_ROWS)])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = layers.sinusoidal_timestep_embedding(t, self.freq_dim)
        return self.mlp[2](F.silu(self.mlp[0](x)))


class _FinalLayer(_Modulation):
    def __init__(self, cfg: ZImageConfig):
        super().__init__(cfg.hidden_dim, 2)
        self.linear = Linear(cfg.hidden_dim, cfg.in_channels, rows=HEAD_ROWS)

    def forward(self, x, temb):
        shift, scale = self.modulation(temb)
        return self.linear(adaln_modulate(x, shift, scale, out_dtype=torch.float32))


class ZImageTransformer(nn.Module):
    """``forward(latents (B, L, in_channels), timestep (B,) in [0, 1000],
    encoder_hidden_states (B, Lc, context_dim), img_ids (L, 3), txt_ids
    (Lc, 3))`` → the fp32 velocity of the image tokens (B, L, in_channels)."""

    def __init__(self, cfg: ZImageConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.x_embedder = Linear(cfg.in_channels, D, compute_dtype=dt)
        self.cap_embedder = nn.ModuleList([FP32RMSNorm(cfg.context_dim), Linear(cfg.context_dim, D, compute_dtype=dt)])
        self.t_embedder = _TimestepEmbedder(D, cfg.freq_dim)
        self.layers = nn.ModuleList([ZImageBlock(cfg) for _ in range(cfg.num_layers)])
        self.final_layer = _FinalLayer(cfg)

    def forward(self, latents, timestep, encoder_hidden_states, img_ids, txt_ids) -> torch.Tensor:
        cfg = self.cfg
        Lc = encoder_hidden_states.shape[1]
        img = self.x_embedder(latents)
        cap = self.cap_embedder[1](self.cap_embedder[0](encoder_hidden_states))
        x = torch.cat([cap, img], dim=1)
        temb = self.t_embedder(timestep)
        cos, sin = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0), cfg.axes_dim, cfg.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            x = checkpointed(block, x, temb, cos, sin) if remat else block(x, temb, cos, sin)
        return self.final_layer(x, temb)[:, Lc:]
