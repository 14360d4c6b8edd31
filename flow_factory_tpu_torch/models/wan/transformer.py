"""Wan 2.x video DiT (port of ``flow_factory_tpu/models/wan/transformer.py``).

Parameter names are diffusers' ``WanTransformer3DModel`` names. Per block:

    self-attention over the (t·h·w) video tokens, across-heads RMS qk-norm,
    then 3-D RoPE (kernel K3 on the card);
    cross-attention to the UMT5 context, across-heads qk-norm, no RoPE (K3);
    feed-forward; AdaLN modulation = a learned fp32 (1, 6, D) table + the
    fp32 projected time embedding (shift, scale, gate for attention and FFN),
    normalised through kernel K5 (``adaln_modulate`` and the affine norm2).

Latents are 5-D channel-last (B, T, H, W, C); patching is (1, 2, 2). The
patch embedding is diffusers' Conv3d (weight (D, C, pt, ph, pw)) computed as
the JAX package computes it: one product over (pt, ph, pw, C) voxels. Three
things follow the JAX package exactly: the modulation table and
``time_proj`` run in fp32; the gates are cast to x's dtype before they
multiply; the context is cast to the compute dtype before the text
embedder. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``; the JAX package's ``nn.remat(WanBlock)``,
``wan/transformer.py:242``). Per-frame timesteps (Wan2.2 TI2V, a (B, gt)
``timestep``) give per-token AdaLN modulations, frame-major like the tokens,
which K5 takes as (B, L, D) shift and scale.

The Wan2.1 I2V image stream (``image_context_tokens``, JAX
``transformer.py:148-162, 223-234``): the CLIP tokens go through
``condition_embedder.image_embedder`` (fp32 LayerNorm with flax's eps 1e-6,
Linear to the width, exact GELU, Linear, fp32 LayerNorm) once a forward;
each block's cross-attention then attends a second time, with the text
stream's normed query, over them (``attn2.add_k_proj`` / ``add_v_proj``, the
across-heads RMS norm on k alone, ``norm_added_k``; K3 on the card), and the
two attention outputs are summed before ``to_out``. The image tokens stay
apart from the text tokens, as in the JAX package; the names are diffusers'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from ...ops.attention import dot_product_attention
from ...ops.norms import adaln_modulate
from ..layers import (
    HEAD_ROWS,
    SAMPLE_ROWS,
    AcrossHeadsQKNorm,
    FeedForward,
    FusedLayerNorm,
    HeadProj,
    Linear,
    MergeProj,
    NormParams,
    TimestepEmbedding,
    apply_rope,
    checkpointed,
    flax_layer_norm,
    rope_frequencies,
)


@dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)  # (t, h, w)
    hidden_dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    num_layers: int = 30
    context_dim: int = 4096  # UMT5
    freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (44, 42, 42)  # rope dims for (t, h, w); sums to head_dim
    rope_theta: float = 10000.0
    qk_norm: bool = True
    attn_backend: str = "auto"
    dtype: str = "bfloat16"
    remat: bool = False  # gradient checkpointing (recompute each block in the backward)
    #: Wan2.1 I2V: CLIP image tokens read by a second cross-attention
    #: stream (0: none; Wan2.2 I2V conditions by latent concat alone)
    image_context_tokens: int = 0
    image_context_dim: int = 1280

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @staticmethod
    def wan21_1_3b(**o) -> "WanConfig":
        return WanConfig(**o)

    @staticmethod
    def wan21_14b(**o) -> "WanConfig":
        base = dict(hidden_dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
        base.update(o)
        return WanConfig(**base)

    @staticmethod
    def tiny(**o) -> "WanConfig":
        base = dict(hidden_dim=64, ffn_dim=128, num_heads=4, num_layers=2,
                    context_dim=48, freq_dim=32, axes_dim=(8, 4, 4))
        base.update(o)
        return WanConfig(**base)


class WanAttention(nn.Module):
    """Self- or cross-attention with the across-heads qk-norm; RoPE on q and k
    when tables are given (diffusers ``attn1`` / ``attn2``); with
    ``image_stream`` (``attn2`` of Wan2.1 I2V) the second attention over the
    image tokens, summed before ``to_out``."""

    def __init__(self, cfg: WanConfig, image_stream: bool = False):
        super().__init__()
        D, H, E, dt = cfg.hidden_dim, cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        self.attn_backend = cfg.attn_backend
        self.to_q = HeadProj(D, H, E, dt)
        self.to_k = HeadProj(D, H, E, dt)
        self.to_v = HeadProj(D, H, E, dt)
        if cfg.qk_norm:
            self.norm_q = AcrossHeadsQKNorm(D)
            self.norm_k = AcrossHeadsQKNorm(D)
        if image_stream:
            self.add_k_proj = HeadProj(D, H, E, dt)
            self.add_v_proj = HeadProj(D, H, E, dt)
            if cfg.qk_norm:
                self.norm_added_k = AcrossHeadsQKNorm(D)
        self.to_out = nn.ModuleList([MergeProj(D, D, compute_dtype=dt)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                context_img: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(kv), self.to_v(kv)
        if hasattr(self, "norm_q"):
            q, k = self.norm_q(q), self.norm_k(k)
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        attn = dot_product_attention(q, k, v, backend=self.attn_backend)
        if context_img is not None:
            ik, iv = self.add_k_proj(context_img), self.add_v_proj(context_img)
            if hasattr(self, "norm_added_k"):
                ik = self.norm_added_k(ik)
            attn = attn + dot_product_attention(q, ik, iv, backend=self.attn_backend)
        return self.to_out[0](attn)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.compute_dtype = dt
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 6, D))
        self.attn1 = WanAttention(cfg)
        self.norm2 = FusedLayerNorm(D, out_dtype=dt)
        self.attn2 = WanAttention(cfg, image_stream=bool(cfg.image_context_tokens))
        self.ffn = FeedForward(D, cfg.ffn_dim, dt)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, context, temb6, cos, sin, context_img=None):
        """x (B, L, D); context (B, Lc, D); temb6 (B, 6, D) fp32, or (B, L, 6,
        D) with per-frame timesteps: then every shift, scale and gate is per
        token; context_img (B, Li, D), the embedded image tokens, or None."""
        dt = self.compute_dtype
        table = self.scale_shift_table.float()
        if temb6.ndim == 4:
            mods, tok = table[:, None] + temb6.float(), (lambda m: m)
        else:
            mods, tok = table + temb6.float(), (lambda m: m[:, None])
        shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = mods.unbind(-2)
        h = adaln_modulate(x, shift_sa, scale_sa, out_dtype=dt)
        x = x + tok(gate_sa).to(x.dtype) * self.attn1(h, rope=(cos, sin))
        x = x + self.attn2(self.norm2(x), context.to(dt), context_img=context_img)
        h = adaln_modulate(x, shift_ff, scale_ff, out_dtype=dt)
        return x + tok(gate_ff).to(x.dtype) * self.ffn(h)


class WanTimeTextEmbedding(nn.Module):
    """diffusers ``condition_embedder``: the time MLP (fp32), its 6-way
    projection (fp32) and the tanh-GELU text MLP in the compute dtype."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.time_embedder = TimestepEmbedding(D, freq_dim=cfg.freq_dim)
        self.time_proj = Linear(D, 6 * D, rows=SAMPLE_ROWS)
        self.text_embedder = nn.ModuleDict({"linear_1": Linear(cfg.context_dim, D, compute_dtype=dt),
                                            "linear_2": Linear(D, D, compute_dtype=dt)})
        if cfg.image_context_tokens:
            self.image_embedder = WanImageEmbedding(cfg)


class WanImageEmbedding(nn.Module):
    """diffusers ``condition_embedder.image_embedder`` at the JAX package's
    shapes (``img_emb_*``, ``transformer.py:223-234``): fp32 LayerNorm, then
    ``ff.net.0.proj`` (image dim → width), exact GELU, ``ff.net.2`` (width →
    width) in the compute dtype, then fp32 LayerNorm, cast to the compute
    dtype. flax's LayerNorm eps (1e-6) and fast variance, not torch's."""

    EPS = 1e-6

    def __init__(self, cfg: WanConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.compute_dtype = dt
        self.norm1 = NormParams(cfg.image_context_dim)
        self.ff = FeedForward(cfg.image_context_dim, D, dt, out_dim=D, approximate="none")
        self.norm2 = NormParams(D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = self.ff(flax_layer_norm(x.float(), self.norm1, self.EPS).to(dt))
        return flax_layer_norm(h, self.norm2, self.EPS).to(dt)


class WanTransformer(nn.Module):
    """Video DiT. Input (B, T, H, W, C) channel-last; timestep (B,) in the
    scheduler's [0, 1000] scale, or (B, T / pt) per latent frame; context
    (B, Lc, context_dim); with the image stream, the CLIP tokens (B, Li,
    image_context_dim)."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.patch_embedding = nn.Conv3d(cfg.in_channels, D, cfg.patch_size, stride=cfg.patch_size)
        self.condition_embedder = WanTimeTextEmbedding(cfg)
        self.blocks = nn.ModuleList([WanBlock(cfg) for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 2, D))
        pt, ph, pw = cfg.patch_size
        self.proj_out = Linear(D, pt * ph * pw * cfg.out_channels, compute_dtype=torch.float32, rows=HEAD_ROWS)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, latents: torch.Tensor, timestep: torch.Tensor, encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_image: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, T, H, W, C = latents.shape
        pt, ph, pw = cfg.patch_size
        gt, gh, gw = T // pt, H // ph, W // pw
        D = cfg.hidden_dim

        # 3-D patch embed: one product over (pt, ph, pw, C) voxels
        x = latents.to(dt).reshape(B, gt, pt, gh, ph, gw, pw, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        weight = self.patch_embedding.weight.to(dt).permute(0, 2, 3, 4, 1).reshape(D, pt * ph * pw * C)
        x = F.linear(x.reshape(B, gt * gh * gw, pt * ph * pw * C), weight, self.patch_embedding.bias.to(dt))

        ce = self.condition_embedder
        per_frame = timestep.ndim == 2
        temb = ce.time_embedder(timestep.reshape(-1))
        temb6 = ce.time_proj(F.silu(temb))
        if per_frame:  # (B, gt) → per-token modulations, tokens frame-major
            temb = temb.reshape(B, gt, D)
            temb6 = temb6.reshape(B, gt, 6, D).repeat_interleave(gh * gw, dim=1)
        else:
            temb6 = temb6.reshape(B, 6, D)
        context = ce.text_embedder["linear_2"](
            F.gelu(ce.text_embedder["linear_1"](encoder_hidden_states.to(dt)), approximate="tanh"))

        dev = latents.device
        ids = torch.stack([torch.arange(gt, device=dev).repeat_interleave(gh * gw),
                           torch.arange(gh, device=dev).repeat_interleave(gw).repeat(gt),
                           torch.arange(gw, device=dev).repeat(gt * gh)], dim=-1)
        # the image stream: the CLIP tokens embedded once a forward
        image = ()
        if cfg.image_context_tokens and encoder_hidden_states_image is not None:
            image = (ce.image_embedder(encoder_hidden_states_image),)

        cos, sin = rope_frequencies(ids, cfg.axes_dim, cfg.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = (checkpointed(block, x, context, temb6, cos, sin, *image) if remat
                 else block(x, context, temb6, cos, sin, *image))

        # head: (1, 2, D) table + the raw time embedding, shift first
        if per_frame:
            head_mod = self.scale_shift_table.float()[:, None] + temb.float().repeat_interleave(gh * gw, dim=1)[:, :, None]
            shift, scale = head_mod[:, :, 0], head_mod[:, :, 1]  # (B, L, D)
        else:
            head_mod = self.scale_shift_table.float() + temb[:, None, :].float()
            shift, scale = head_mod[:, 0], head_mod[:, 1]
        x = adaln_modulate(x, shift, scale, out_dtype=torch.float32)
        x = self.proj_out(x)
        x = x.reshape(B, gt, gh, gw, pt, ph, pw, cfg.out_channels).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(B, T, H, W, cfg.out_channels)

