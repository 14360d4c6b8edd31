"""Shared DiT building blocks (port of ``flow_factory_tpu/models/layers.py``).

Parameter names follow diffusers, so real checkpoints load without a key map.
Each module computes in a fixed dtype as the flax modules do
(``nn.Dense(dtype=...)``): inputs and parameters are cast to that dtype at
use, whatever dtype the parameters are stored in. Norms and modulation run
in fp32 and go through :mod:`..ops.norms`; attention goes through
:mod:`..ops.attention`, so on a CUDA tensor every block runs kernels K1, K5
and K6.

Three conventions of the JAX package are load-bearing here:
* ``AdaLayerNormZero`` is shift-first; with 9 chunks (SD3.5 dual attention)
  both modulated outputs come from the same pre-attention LayerNorm;
* ``AdaLayerNormContinuous`` is scale-first;
* ``JointAttention`` puts the context tokens first, with per-position q/k
  scale maps (context rows take the added-norm scale).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention, qknorm_dot_product_attention
from ..ops.norms import adaln_modulate


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class ScaleParam(nn.Module):
    """A bare (dim,) scale initialised to ones (RMSNorm / T5 LayerNorm weight)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)


class NormParams(nn.Module):
    """Affine norm parameters (LayerNorm / GroupNorm ``weight`` and ``bias``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


# ---------------------------------------------------------------------------
# Random init (the flax initialisers' distributions, drawn from a generator)
# ---------------------------------------------------------------------------

def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Truncated-normal (clamped at 2 sigma) with std 1/sqrt(fan_in), as flax's lecun_normal."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    w.normal_(0.0, 1.0, generator=generator).clamp_(-2.0, 2.0).mul_(std)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Random-initialise every parameter of ``module`` in place, on its device."""
    for m in module.modules():
        if hasattr(m, "reset_parameters_"):
            m.reset_parameters_(generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            std = getattr(m, "init_std", 1.0 / math.sqrt(m.embedding_dim))
            m.weight.normal_(0.0, std, generator=generator)


def build_module(factory, device: torch.device, dtype: torch.dtype,
                 generator: Optional[torch.Generator]) -> nn.Module:
    """Construct ``factory()`` without allocating, then materialise it on
    ``device`` in ``dtype`` and random-initialise it there (``generator``) —
    a multi-billion-parameter encoder never touches the host."""
    with torch.device("meta"):
        module = factory()
    module = module.to(dtype).to_empty(device=device)
    if generator is not None:
        init_weights_(module, generator)
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """(B,) timesteps → (B, dim) sinusoidal features (diffusers convention)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Sinusoidal features → 2-layer SiLU MLP (fp32)."""

    def __init__(self, hidden_dim: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.linear_1 = Linear(freq_dim, hidden_dim, compute_dtype=torch.float32)
        self.linear_2 = Linear(hidden_dim, hidden_dim, compute_dtype=torch.float32)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = sinusoidal_timestep_embedding(t, self.freq_dim)
        return self.linear_2(F.silu(self.linear_1(x)))


class PooledTextEmbedding(nn.Module):
    """Pooled CLIP projection → time-conditioning vector (fp32)."""

    def __init__(self, pooled_dim: int, hidden_dim: int):
        super().__init__()
        self.linear_1 = Linear(pooled_dim, hidden_dim, compute_dtype=torch.float32)
        self.linear_2 = Linear(hidden_dim, hidden_dim, compute_dtype=torch.float32)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(pooled.float())))


class PatchEmbed(nn.Module):
    """(B, H, W, C) latents → patch tokens + cropped learned position grid.

    The patch convolution (kernel = stride = p) runs as one matmul over
    flattened (kh, kw, c) patches, the order of a flax HWIO kernel."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 pos_embed_max_size: Optional[int], compute_dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.pos_embed_max_size = pos_embed_max_size
        self.compute_dtype = compute_dtype
        self.proj = nn.Conv2d(in_channels, hidden_dim, patch_size, stride=patch_size)
        if pos_embed_max_size is not None:
            self.register_buffer(
                "pos_embed", torch.zeros(1, pos_embed_max_size * pos_embed_max_size, hidden_dim))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        if self.pos_embed_max_size is not None:
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        B, H, W, C = latents.shape
        p, dt = self.patch_size, self.compute_dtype
        h, w = H // p, W // p
        D = self.proj.out_channels
        patches = latents.to(dt).reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
        weight = self.proj.weight.to(dt).permute(0, 2, 3, 1).reshape(D, p * p * C)
        x = F.linear(patches.reshape(B, h * w, p * p * C), weight, self.proj.bias.to(dt))
        if self.pos_embed_max_size is not None:
            grid = self.pos_embed_max_size
            top, left = (grid - h) // 2, (grid - w) // 2
            pos = self.pos_embed.reshape(grid, grid, D)[top : top + h, left : left + w]
            x = x + pos.reshape(1, h * w, D).to(dt)
        return x


def unpatchify(x: torch.Tensor, h: int, w: int, patch_size: int, channels: int) -> torch.Tensor:
    """(B, h*w, p*p*C) → (B, H, W, C) channel-last."""
    B, p = x.shape[0], patch_size
    x = x.reshape(B, h, w, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * p, w * p, channels)


# ---------------------------------------------------------------------------
# Adaptive norms
# ---------------------------------------------------------------------------

class AdaLayerNormZero(nn.Module):
    """LayerNorm with 6- or 9-way shift-first conditioning from the time embedding.

    With 9 chunks (diffusers ``SD35AdaLayerNormZeroX``) both modulated outputs
    come from the SAME LayerNorm of ``x``. Returns
    (x_mod, x_mod2, gate_msa, shift_mlp, scale_mlp, gate_mlp, gate_msa2) or
    (x_mod, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, hidden_dim: int, num_chunks: int = 6):
        super().__init__()
        self.num_chunks = num_chunks
        self.linear = Linear(hidden_dim, num_chunks * hidden_dim, compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        chunks = self.linear(F.silu(emb.float())).chunk(self.num_chunks, dim=-1)
        out = adaln_modulate(x, chunks[0], chunks[1])
        if self.num_chunks == 9:
            out2 = adaln_modulate(x, chunks[6], chunks[7])
            return (out, out2, chunks[2], chunks[3], chunks[4], chunks[5], chunks[8])
        return (out, *chunks[2:])


class AdaLayerNormContinuous(nn.Module):
    """Final-layer AdaLN, scale-first (diffusers ``AdaLayerNormContinuous``)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.linear = Linear(hidden_dim, 2 * hidden_dim, compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(emb.float())).chunk(2, dim=-1)
        return adaln_modulate(x, shift, scale)


class GELUProj(nn.Module):
    """diffusers ``GELU(approximate='tanh')``: a projection then tanh-GELU."""

    def __init__(self, dim_in: int, dim_out: int, compute_dtype: torch.dtype):
        super().__init__()
        self.proj = Linear(dim_in, dim_out, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """Linear → tanh-GELU → Linear (diffusers ``ff.net.0.proj`` / ``ff.net.2``)."""

    def __init__(self, hidden_dim: int, compute_dtype: torch.dtype, mult: float = 4.0):
        super().__init__()
        inner = int(hidden_dim * mult)
        self.net = nn.ModuleList([GELUProj(hidden_dim, inner, compute_dtype), nn.Identity(),
                                  Linear(inner, hidden_dim, compute_dtype=compute_dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*E) → (B, H, S, E) view (the JAX ``HeadProj`` layout)."""
    B, S, _ = x.shape
    return x.view(B, S, heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, E) → (B, S, H*E) (the JAX ``MergeProj`` contraction input)."""
    B, H, S, E = x.shape
    return x.transpose(1, 2).reshape(B, S, H * E)


class JointAttention(nn.Module):
    """MMDiT dual-stream joint attention: separate q/k/v projections per
    stream, one attention over [context; image] tokens, per-stream output
    projections. ``context_pre_only`` drops the context output projection."""

    def __init__(self, hidden_dim: int, num_heads: int, qk_norm: bool, context_pre_only: bool,
                 attn_backend: str, compute_dtype: torch.dtype):
        super().__init__()
        D, dt = hidden_dim, compute_dtype
        self.heads, self.head_dim = num_heads, hidden_dim // num_heads
        self.qk_norm, self.context_pre_only, self.attn_backend = qk_norm, context_pre_only, attn_backend
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, Linear(D, D, compute_dtype=dt))
        if qk_norm:
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, name, ScaleParam(self.head_dim))
        self.to_out = nn.ModuleList([Linear(D, D, compute_dtype=dt)])
        if not context_pre_only:
            self.to_add_out = Linear(D, D, compute_dtype=dt)

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        H, E = self.heads, self.head_dim
        ctx_len, img_len = context.shape[1], x.shape[1]
        # context tokens lead the joint sequence (diffusers SD3 order)
        q = torch.cat([split_heads(self.add_q_proj(context), H), split_heads(self.to_q(x), H)], dim=2)
        k = torch.cat([split_heads(self.add_k_proj(context), H), split_heads(self.to_k(x), H)], dim=2)
        v = torch.cat([split_heads(self.add_v_proj(context), H), split_heads(self.to_v(x), H)], dim=2)
        if self.qk_norm:
            # per-position scale maps: context rows carry the added-norm scale
            gq = torch.cat([self.norm_added_q.weight.float().expand(ctx_len, E),
                            self.norm_q.weight.float().expand(img_len, E)])
            gk = torch.cat([self.norm_added_k.weight.float().expand(ctx_len, E),
                            self.norm_k.weight.float().expand(img_len, E)])
            out = qknorm_dot_product_attention(q, k, v, gq, gk, backend=self.attn_backend)
        else:
            out = dot_product_attention(q, k, v, backend=self.attn_backend)
        ctx_out = None
        if not self.context_pre_only:
            ctx_out = self.to_add_out(merge_heads(out[:, :, :ctx_len]))
        return self.to_out[0](merge_heads(out[:, :, ctx_len:])), ctx_out


class SelfAttention(nn.Module):
    """Plain self-attention over one stream (MMDiT-X dual-attention blocks)."""

    def __init__(self, hidden_dim: int, num_heads: int, qk_norm: bool, attn_backend: str,
                 compute_dtype: torch.dtype):
        super().__init__()
        D, dt = hidden_dim, compute_dtype
        self.heads, self.head_dim = num_heads, hidden_dim // num_heads
        self.qk_norm, self.attn_backend = qk_norm, attn_backend
        self.to_q = Linear(D, D, compute_dtype=dt)
        self.to_k = Linear(D, D, compute_dtype=dt)
        self.to_v = Linear(D, D, compute_dtype=dt)
        if qk_norm:
            self.norm_q = ScaleParam(self.head_dim)
            self.norm_k = ScaleParam(self.head_dim)
        self.to_out = nn.ModuleList([Linear(D, D, compute_dtype=dt)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = self.heads
        q, k, v = (split_heads(proj(x), H) for proj in (self.to_q, self.to_k, self.to_v))
        if self.qk_norm:
            out = qknorm_dot_product_attention(q, k, v, self.norm_q.weight, self.norm_k.weight,
                                               backend=self.attn_backend)
        else:
            out = dot_product_attention(q, k, v, backend=self.attn_backend)
        return self.to_out[0](merge_heads(out))
