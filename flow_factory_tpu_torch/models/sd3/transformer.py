"""SD3 / SD3.5 MMDiT transformer (port of ``flow_factory_tpu/models/sd3/transformer.py``).

Dual-stream MMDiT: latent patches and text-context tokens run in parallel
streams coupled by joint attention in every block; SD3.5-medium ("MMDiT-X")
adds a latent-only self-attention in the early blocks
(``dual_attention_layers``). Parameter names are diffusers'
``SD3Transformer2DModel`` names. Latents are channel-last (B, H, W, C).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ...ops.norms import residual_gate_modulate
from ..layers import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    FeedForward,
    JointAttention,
    Linear,
    PatchEmbed,
    PooledTextEmbedding,
    SelfAttention,
    TimestepEmbedding,
    unpatchify,
)


@dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    hidden_dim: int = 1536
    depth: int = 24
    num_heads: int = 24
    context_dim: int = 4096  # T5 / concat CLIP hidden width
    pooled_dim: int = 2048  # CLIP-L (768) + CLIP-G (1280) pooled concat
    pos_embed_max_size: int = 384
    qk_norm: bool = True
    dual_attention_layers: Tuple[int, ...] = ()
    attn_backend: str = "auto"
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def sd3_5_medium(**overrides) -> "MMDiTConfig":
        base = dict(hidden_dim=1536, depth=24, num_heads=24, pos_embed_max_size=384,
                    dual_attention_layers=tuple(range(13)), qk_norm=True)
        base.update(overrides)
        return MMDiTConfig(**base)

    @staticmethod
    def sd3_5_large(**overrides) -> "MMDiTConfig":
        base = dict(hidden_dim=2432, depth=38, num_heads=38, pos_embed_max_size=192,
                    dual_attention_layers=(), qk_norm=True)
        base.update(overrides)
        return MMDiTConfig(**base)

    @staticmethod
    def tiny(**overrides) -> "MMDiTConfig":
        """Test-scale config: runs the full code path on the CPU."""
        base = dict(hidden_dim=64, depth=2, num_heads=4, context_dim=32, pooled_dim=48,
                    pos_embed_max_size=32, dual_attention_layers=(0,))
        base.update(overrides)
        return MMDiTConfig(**base)


class JointTransformerBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False,
                 use_dual_attention: bool = False):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.compute_dtype = dt
        self.context_pre_only = context_pre_only
        self.use_dual_attention = use_dual_attention
        self.norm1 = AdaLayerNormZero(D, num_chunks=9 if use_dual_attention else 6)
        self.norm1_context = (AdaLayerNormContinuous(D) if context_pre_only
                              else AdaLayerNormZero(D, num_chunks=6))
        self.attn = JointAttention(D, cfg.num_heads, cfg.qk_norm, context_pre_only,
                                   cfg.attn_backend, dt)
        if use_dual_attention:
            self.attn2 = SelfAttention(D, cfg.num_heads, cfg.qk_norm, cfg.attn_backend, dt)
        self.ff = FeedForward(D, dt)
        if not context_pre_only:
            self.ff_context = FeedForward(D, dt)

    def forward(self, x: torch.Tensor, context: torch.Tensor, temb: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.compute_dtype
        norm_out = self.norm1(x, temb)
        if self.use_dual_attention:
            x_mod, x_mod2, gate_msa, shift_mlp, scale_mlp, gate_mlp, gate2 = norm_out
        else:
            x_mod, gate_msa, shift_mlp, scale_mlp, gate_mlp = norm_out
        if self.context_pre_only:
            c_mod = self.norm1_context(context, temb)
        else:
            c_mod, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(context, temb)

        attn_out, ctx_attn_out = self.attn(x_mod, c_mod)
        # the residual join fuses with the NEXT AdaLN modulate (kernel K6)
        if self.use_dual_attention:
            # attn and attn2 are parallel branches over the same normalised x;
            # the first residual is open-coded, the second goes through K6
            attn2_out = self.attn2(x_mod2)
            x = x + gate_msa[:, None, :].to(x.dtype) * attn_out.to(x.dtype)
            x, x_ff_in = residual_gate_modulate(x, attn2_out, gate2, shift_mlp, scale_mlp, out_dtype=dt)
        else:
            x, x_ff_in = residual_gate_modulate(x, attn_out, gate_msa, shift_mlp, scale_mlp, out_dtype=dt)
        x = x + gate_mlp[:, None, :].to(x.dtype) * self.ff(x_ff_in)

        if self.context_pre_only:
            return x, None
        context, c_ff_in = residual_gate_modulate(
            context, ctx_attn_out, c_gate_msa, c_shift_mlp, c_scale_mlp, out_dtype=dt)
        context = context + c_gate_mlp[:, None, :].to(context.dtype) * self.ff_context(c_ff_in)
        return x, context


class CombinedTimestepTextProjEmbeddings(nn.Module):
    def __init__(self, hidden_dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(hidden_dim)
        self.text_embedder = PooledTextEmbedding(pooled_dim, hidden_dim)

    def forward(self, timestep: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        return self.timestep_embedder(timestep) + self.text_embedder(pooled)


class SD3Transformer(nn.Module):
    """MMDiT denoiser. Inputs channel-last; timestep in scheduler scale [0, 1000]."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.pos_embed = PatchEmbed(cfg.in_channels, D, cfg.patch_size, cfg.pos_embed_max_size, dt)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(D, cfg.pooled_dim)
        self.context_embedder = Linear(cfg.context_dim, D, compute_dtype=dt)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(cfg, context_pre_only=(i == cfg.depth - 1),
                                  use_dual_attention=(i in cfg.dual_attention_layers))
            for i in range(cfg.depth)
        ])
        self.norm_out = AdaLayerNormContinuous(D)
        self.proj_out = Linear(D, cfg.patch_size * cfg.patch_size * cfg.out_channels,
                               compute_dtype=torch.float32)

    def forward(self, latents: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, H, W, C = latents.shape
        h, w = H // cfg.patch_size, W // cfg.patch_size
        x = self.pos_embed(latents)
        temb = self.time_text_embed(timestep, pooled_projections)
        context = self.context_embedder(encoder_hidden_states)
        for block in self.transformer_blocks:
            x, context = block(x, context, temb)
        x = self.proj_out(self.norm_out(x, temb))
        return unpatchify(x, h, w, cfg.patch_size, cfg.out_channels)
