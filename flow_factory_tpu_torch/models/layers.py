"""Shared DiT building blocks (port of ``flow_factory_tpu/models/layers.py``).

Parameter names follow diffusers, so real checkpoints load without a key map.
Each module computes in a fixed dtype as the flax modules do
(``nn.Dense(dtype=...)``): inputs and parameters are cast to that dtype at
use, whatever dtype the parameters are stored in. Norms and modulation run
in fp32 and go through :mod:`..ops.norms`; attention goes through
:mod:`..ops.attention`, so on a CUDA tensor every block runs kernels K1, K5
and K6.

Conventions of the JAX package that are load-bearing here:
* ``AdaLayerNormZero`` is shift-first; with 9 chunks (SD3.5 dual attention)
  both modulated outputs come from the same pre-attention LayerNorm;
* ``AdaLayerNormContinuous`` is scale-first;
* ``JointAttention`` puts the context tokens first, with per-position q/k
  scale maps (context rows take the added-norm scale);
* the FLUX qk-norm is RMS per head (:class:`QKNorm`), outside the flash
  kernel, since FLUX rotates q and k after it;
* the Wan/LTX qk-norm is RMS across heads: γ has shape (D,) and the mean
  square spans every head (:func:`_across_heads_rms`);
* RoPE rotates interleaved pairs with fp32 tables (:func:`apply_rope`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.attention import _rms_scale, dot_product_attention, qknorm_dot_product_attention
from ..ops.norms import adaln_modulate, fused_layernorm


def checkpointed(block: nn.Module, *inputs):
    """One block under ``torch.utils.checkpoint`` (the JAX package's
    per-block ``nn.remat``). The block's parameters go in as explicit inputs
    and the block runs on them through ``functional_call``, so the recompute
    in the backward sees the weights the forward saw — the LoRA-merged ones
    when the caller swapped them in."""
    names, params = zip(*block.named_parameters())
    n = len(inputs)

    def run(*args):
        return functional_call(block, dict(zip(names, args[n:])), args[:n])

    return checkpoint(run, *inputs, *params, use_reentrant=False)


#: F18. A GEMM library picks its kernel (tile shape, split-K) by the
#: product's shape, so a product whose M grows with the batch may round a
#: row by how many rows stand beside it, and a replay at another micro-batch
#: size than the rollout's would then miss the rollout's bits. The products
#: that do so on the card run at a fixed row count whatever the batch,
#: zero-padded and chunked (:func:`fixed_rows_linear`):
#:
#: * ``SAMPLE_ROWS``: the products whose rows are the batch itself (the
#:   time, guidance and pooled-text embedders, every AdaLN modulation of
#:   the time embedding; fp32, M 8 against 4 at
#:   N 18432, K 3072 rounds otherwise). A CFG batch of 16 runs as two
#:   products of 8; on the CPU a product of up to 8 rows rounds as the
#:   unpadded rows do;
#: * ``FEW_TOKEN_ROWS``: a stream of a few tokens a sample, LTX-2's 9 audio
#:   tokens (its FFN's down-projection, M 36 against 144 at K 8192);
#: * ``HEAD_ROWS``: the fp32 output heads, whose N is the latent width (the
#:   A14B's, M 2048 against 8192 at N 64, K 5120).
SAMPLE_ROWS = 8
FEW_TOKEN_ROWS = 256
HEAD_ROWS = 1024


def fixed_rows_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      rows: int = SAMPLE_ROWS) -> torch.Tensor:
    """``F.linear`` over the rows of ``x`` (every dim but the last) run as
    products of exactly ``rows`` rows: zero-padded up to a multiple of
    ``rows``, then one product a block of ``rows``."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if M % rows or M == 0:
        x2 = F.pad(x2, (0, 0, 0, rows - M % rows))
    out = torch.cat([F.linear(block, weight, bias) for block in x2.split(rows)])
    return out[:M].reshape(*lead, weight.shape[0])


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``nn.Dense(dtype=...)``);
    with ``rows``, at that fixed row count (F18, :func:`fixed_rows_linear`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32, rows: Optional[int] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.rows = rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.rows is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        return fixed_rows_linear(x.to(dt), self.weight.to(dt), bias, self.rows)


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


def flax_layer_norm(x: torch.Tensor, norm: NormParams, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` in plain PyTorch (the CLIP towers,
    Wan's image embedder): fp32 fast-variance stats, then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x32 - mean) * (torch.rsqrt(var + eps) * norm.weight.float()) + norm.bias.float()


class FusedLayerNorm(NormParams):
    """Affine fp32 LayerNorm (flax ``nn.LayerNorm`` semantics, eps 1e-6) in
    one pass through kernel K5's fold path (JAX ``layers.py:251``)."""

    def __init__(self, dim: int, out_dtype: Optional[torch.dtype] = None):
        super().__init__(dim)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layernorm(x, self.weight, self.bias, out_dtype=self.out_dtype)


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
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
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
    """Sinusoidal features → 2-layer SiLU MLP (fp32, per-sample products)."""

    def __init__(self, hidden_dim: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.linear_1 = Linear(freq_dim, hidden_dim, rows=SAMPLE_ROWS)
        self.linear_2 = Linear(hidden_dim, hidden_dim, rows=SAMPLE_ROWS)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = sinusoidal_timestep_embedding(t, self.freq_dim)
        return self.linear_2(F.silu(self.linear_1(x)))


class PooledTextEmbedding(nn.Module):
    """Pooled CLIP projection → time-conditioning vector (fp32, per-sample products)."""

    def __init__(self, pooled_dim: int, hidden_dim: int):
        super().__init__()
        self.linear_1 = Linear(pooled_dim, hidden_dim, rows=SAMPLE_ROWS)
        self.linear_2 = Linear(hidden_dim, hidden_dim, rows=SAMPLE_ROWS)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(pooled.float())))


class PatchEmbed(nn.Module):
    """(B, H, W, C) latents → patch tokens + cropped learned position grid.

    The patch convolution (kernel = stride = p) runs as one matmul over
    flattened (kh, kw, c) patches, the order of a flax HWIO kernel. The
    position grid is a parameter, as in the JAX package (``layers.py:108``),
    so a full finetune trains it (diffusers holds it as a buffer)."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 pos_embed_max_size: Optional[int], compute_dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.pos_embed_max_size = pos_embed_max_size
        self.compute_dtype = compute_dtype
        self.proj = nn.Conv2d(in_channels, hidden_dim, patch_size, stride=patch_size)
        if pos_embed_max_size is not None:
            self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_max_size * pos_embed_max_size, hidden_dim))

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
        self.linear = Linear(hidden_dim, num_chunks * hidden_dim, rows=SAMPLE_ROWS)

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
        self.linear = Linear(hidden_dim, 2 * hidden_dim, rows=SAMPLE_ROWS)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(emb.float())).chunk(2, dim=-1)
        return adaln_modulate(x, shift, scale)


class GELUProj(nn.Module):
    """diffusers ``GELU(approximate=...)``: a projection then GELU, tanh by
    default, exact with ``approximate="none"``."""

    def __init__(self, dim_in: int, dim_out: int, compute_dtype: torch.dtype, rows: Optional[int] = None,
                 approximate: str = "tanh"):
        super().__init__()
        self.proj = Linear(dim_in, dim_out, compute_dtype=compute_dtype, rows=rows)
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate=self.approximate)


class FeedForward(nn.Module):
    """Linear → tanh-GELU → Linear (diffusers ``ff.net.0.proj`` / ``ff.net.2``;
    Wan's ``ffn``), back to ``hidden_dim`` unless ``out_dim`` is given."""

    def __init__(self, hidden_dim: int, inner: int, compute_dtype: torch.dtype, rows: Optional[int] = None,
                 out_dim: Optional[int] = None, approximate: str = "tanh"):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(hidden_dim, inner, compute_dtype, rows, approximate), nn.Identity(),
                                  Linear(inner, out_dim or hidden_dim, compute_dtype=compute_dtype, rows=rows)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class SwiGLUFeedForward(nn.Module):
    """The gated FFN (JAX ``FeedForward(activation="swiglu")``, diffusers
    ``Flux2FeedForward``): ``linear_in`` packs [gate; value] along its
    output, then SiLU(gate)·value → ``linear_out``."""

    def __init__(self, hidden_dim: int, inner: int, compute_dtype: torch.dtype):
        super().__init__()
        self.linear_in = Linear(hidden_dim, 2 * inner, compute_dtype=compute_dtype)
        self.linear_out = Linear(inner, hidden_dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, value = self.linear_in(x).chunk(2, dim=-1)
        return self.linear_out(F.silu(gate) * value)


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


class HeadProj(Linear):
    """Projection emitting the attention layout (B, H, S, E) as a head-split
    view of the (B, S, H*E) product (JAX ``layers.py:346``); an
    ``nn.Linear`` by its parameters, so diffusers names hold."""

    def __init__(self, in_features: int, heads: int, head_dim: int, compute_dtype: torch.dtype,
                 rows: Optional[int] = None):
        super().__init__(in_features, heads * head_dim, compute_dtype=compute_dtype, rows=rows)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_heads(super().forward(x), self.heads)


class MergeProj(Linear):
    """Output projection consuming (B, H, S, E) (JAX ``layers.py:374``): the
    head merge is a view when the attention output is head-interleaved in
    memory, as the flash kernels write it."""

    def forward(self, attn: torch.Tensor) -> torch.Tensor:
        return super().forward(merge_heads(attn))


def _across_heads_rms(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise (B, H, S, E) over the full hidden dim (H*E jointly), the
    diffusers ``rms_norm_across_heads`` form of Wan and LTX: fp32 stats,
    γ (D,) reshaped (H, E), cast back to x's dtype."""
    B, H, S, E = x.shape
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=(1, 3), keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * gamma.float().reshape(1, H, 1, E)).to(x.dtype)


class AcrossHeadsQKNorm(ScaleParam):
    """One γ (D,) of the JAX ``AcrossHeadsQKNorm`` pair (``layers.py:321``):
    an attention holds one for q (``norm_q``) and one for k (``norm_k``),
    diffusers' names; the mean square spans every head."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _across_heads_rms(x, self.weight)


class HeadRMSNorm(ScaleParam):
    """One γ (E,) of the per-head RMS qk-norm (diffusers' ``norm_q``,
    ``norm_k``, ``norm_added_q``, ``norm_added_k``): fp32 statistics,
    ``x32 * (rsqrt(mean(x32^2) + eps) * γ)``, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_scale(x, self.weight, self.eps).to(x.dtype)


class FP32RMSNorm(ScaleParam):
    """flax ``nn.RMSNorm(epsilon=1e-6, dtype=float32)``: fp32 statistics,
    ``x32 * (rsqrt(mean(x32^2) + eps) * γ)``, fp32 out (Qwen-Image's
    ``txt_norm``, Z-Image's norms)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_scale(x, self.weight, 1e-6)


class QKNorm(nn.Module):
    """Per-head RMS norm of q and k (JAX ``QKNorm``, ``layers.py:281-303``):
    two :class:`HeadRMSNorm` scales, ``norm_q`` and ``norm_k``."""

    def __init__(self, head_dim: int, eps: float = 1e-6):
        super().__init__()
        self.norm_q = HeadRMSNorm(head_dim, eps)
        self.norm_k = HeadRMSNorm(head_dim, eps)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.norm_q(q), self.norm_k(k)


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


# ---------------------------------------------------------------------------
# Rotary position embeddings (video DiTs)
# ---------------------------------------------------------------------------

def rope_frequencies(ids: torch.Tensor, axes_dim: Sequence[int], theta: float = 10000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-axis RoPE tables (JAX ``layers.py:508``): ``ids`` (L, A) integer
    coordinates per token and axis, ``axes_dim`` the rotary dims per axis
    (summing to the head dim). Returns fp32 (cos, sin), each (L, head_dim/2)."""
    ids = ids.float()
    parts_cos, parts_sin = [], []
    for a, dim in enumerate(axes_dim):
        half = dim // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=ids.device) * 2.0 / dim))
        angles = ids[:, a][:, None] * freqs[None, :]
        parts_cos.append(torch.cos(angles))
        parts_sin.append(torch.sin(angles))
    return torch.cat(parts_cos, dim=-1), torch.cat(parts_sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, L, D) by per-position (L, D/2) tables, interleaved pairs,
    in fp32; the result is contiguous in x's dtype."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
