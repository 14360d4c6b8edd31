"""FLUX.1 transformer (port of ``flow_factory_tpu/models/flux/transformer.py``).

A hybrid DiT over packed latents: (B, L, 64) tokens of 2x2x16 latent
patches, with ``img_ids`` (L, 3) giving each token's (0, row, col) for RoPE.

* N double-stream blocks: image and text streams with their own
  projections and AdaLN modulation, one joint attention over
  [text; image] tokens (the text tokens lead), per-head RMS qk-norm, then
  multi-axis RoPE on the concatenated q and k;
* M single-stream blocks over the concatenated stream: one fused input
  projection ``linear1`` (q, k, v and the MLP branch, (3D+M, D)) and one
  fused output projection ``linear2`` ((D, D+M)) over [attention; tanh-GELU
  MLP]. Both stay single weights, as the JAX package keeps them: a LoRA on
  the fused weight is the JAX model's LoRA (``FLUX_LORA_TARGETS``);
* guidance-distilled conditioning: the time, guidance (x1000) and pooled
  CLIP embeddings summed into every AdaLN modulation.

Qwen-Image is this transformer with double blocks only, no pooled vector
and no guidance embedding, and ``txt_norm``: an fp32 RMSNorm of the LM
states before ``context_embedder``. FLUX.2 and Klein run it with no pooled
vector, and FLUX.2's upstream checkpoints with ``mlp_style`` ``swiglu``: the
double blocks' FFNs gated (``ff.linear_in``/``linear_out``, the
[gate; value] halves of one projection), the single blocks unchanged.

Parameter names are diffusers' ``FluxTransformer2DModel`` names, but for
the fused single-block projections (``linear1``, ``linear2``, BFL's
names). Every AdaLN norm goes through ``adaln_modulate`` (kernel K5 on the
card) and every attention through ``dot_product_attention`` with ``auto``
and no mask (K3 forward, K2a/K2b backward). ``remat`` recomputes each block
in the backward (``models/layers.checkpointed``; the JAX ``nn.remat``).
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
    AdaLayerNormContinuous,
    FeedForward,
    FP32RMSNorm,
    HeadProj,
    HeadRMSNorm,
    Linear,
    MergeProj,
    PooledTextEmbedding,
    QKNorm,
    SwiGLUFeedForward,
    TimestepEmbedding,
    apply_rope,
    checkpointed,
    merge_heads,
    rope_frequencies,
    split_heads,
)


@dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # packed 2x2x16
    hidden_dim: int = 3072
    num_heads: int = 24
    num_double_blocks: int = 19
    num_single_blocks: int = 38
    context_dim: int = 4096  # T5
    pooled_dim: int = 768  # CLIP-L
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embeds: bool = True
    mlp_ratio: float = 4.0
    #: the double blocks' FFN: "gelu_tanh" (FLUX.1) or "swiglu" (gated,
    #: upstream FLUX.2's ``ff.linear_in``/``linear_out``)
    mlp_style: str = "gelu_tanh"
    attn_backend: str = "auto"
    dtype: str = "bfloat16"
    remat: bool = False  # gradient checkpointing (recompute each block in the backward)
    txt_norm: bool = False  # Qwen-Image: an RMSNorm of the context before the context embedder

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)

    @staticmethod
    def flux1_dev(**o) -> "FluxConfig":
        return FluxConfig(**o)

    @staticmethod
    def tiny(**o) -> "FluxConfig":
        base = dict(in_channels=16, hidden_dim=64, num_heads=4, num_double_blocks=2, num_single_blocks=2,
                    context_dim=48, pooled_dim=16, axes_dim=(4, 6, 6))
        base.update(o)
        return FluxConfig(**base)


class _AdaLinear(nn.Module):
    """An AdaLN modulation projection holder (diffusers ``norm1.linear``):
    the fp32 projection of SiLU(temb) into ``chunks`` vectors."""

    def __init__(self, hidden_dim: int, chunks: int):
        super().__init__()
        self.chunks = chunks
        self.linear = Linear(hidden_dim, chunks * hidden_dim, rows=SAMPLE_ROWS)

    def forward(self, temb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.linear(F.silu(temb)).chunk(self.chunks, dim=-1)


class FluxAttention(nn.Module):
    """The double block's joint attention: image (``to_*``) and text
    (``add_*_proj``) projections emitting the attention layout, per-head
    RMS norms, and the two output projections."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        D, H, E, dt = cfg.hidden_dim, cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        self.attn_backend = cfg.attn_backend
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, HeadProj(D, H, E, dt))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, HeadRMSNorm(E))
        self.to_out = nn.ModuleList([MergeProj(D, D, compute_dtype=dt)])
        self.to_add_out = MergeProj(D, D, compute_dtype=dt)

    def forward(self, img_mod, txt_mod, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
        txt_len = txt_mod.shape[1]
        iq, ik, iv = self.to_q(img_mod), self.to_k(img_mod), self.to_v(img_mod)
        tq, tk, tv = self.add_q_proj(txt_mod), self.add_k_proj(txt_mod), self.add_v_proj(txt_mod)
        iq, ik = self.norm_q(iq), self.norm_k(ik)
        tq, tk = self.norm_added_q(tq), self.norm_added_k(tk)
        # the text tokens lead; RoPE after the concat and after the qk-norm
        q = apply_rope(torch.cat([tq, iq], dim=2), cos, sin)
        k = apply_rope(torch.cat([tk, ik], dim=2), cos, sin)
        v = torch.cat([tv, iv], dim=2)
        out = dot_product_attention(q, k, v, backend=self.attn_backend)
        txt_out, img_out = out.split([txt_len, out.shape[2] - txt_len], dim=2)
        return self.to_out[0](img_out), self.to_add_out(txt_out)


class FluxDoubleBlock(nn.Module):
    """diffusers ``FluxTransformerBlock`` (JAX ``FluxDoubleBlock``)."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.compute_dtype = dt
        self.norm1 = _AdaLinear(D, 6)
        self.norm1_context = _AdaLinear(D, 6)
        self.attn = FluxAttention(cfg)
        ffn = {"gelu_tanh": FeedForward, "swiglu": SwiGLUFeedForward}.get(cfg.mlp_style)
        if ffn is None:
            raise ValueError(f"Unknown FLUX mlp_style {cfg.mlp_style!r}; known: 'gelu_tanh', 'swiglu'")
        self.ff = ffn(D, cfg.mlp_dim, dt)
        self.ff_context = ffn(D, cfg.mlp_dim, dt)

    def forward(self, img, txt, temb, cos, sin):
        dt = self.compute_dtype
        i_shift, i_scale, i_gate, i_shift2, i_scale2, i_gate2 = self.norm1(temb)
        t_shift, t_scale, t_gate, t_shift2, t_scale2, t_gate2 = self.norm1_context(temb)
        img_mod = adaln_modulate(img, i_shift, i_scale, out_dtype=dt)
        txt_mod = adaln_modulate(txt, t_shift, t_scale, out_dtype=dt)
        img_attn, txt_attn = self.attn(img_mod, txt_mod, cos, sin)
        img = img + i_gate[:, None].to(img.dtype) * img_attn
        txt = txt + t_gate[:, None].to(txt.dtype) * txt_attn
        img_ff = adaln_modulate(img, i_shift2, i_scale2, out_dtype=dt)
        img = img + i_gate2[:, None].to(img.dtype) * self.ff(img_ff)
        txt_ff = adaln_modulate(txt, t_shift2, t_scale2, out_dtype=dt)
        txt = txt + t_gate2[:, None].to(txt.dtype) * self.ff_context(txt_ff)
        return img, txt


class _SingleQKVMLP(Linear):
    """The single block's fused ``linear1`` (3D+M, D): one product, then q,
    k and v as head-split views of its first 3D columns (the attention
    layout (B, H, S, E) without a copy) and the MLP branch as the rest. One
    ``split`` (not four slices), so the backward concatenates the four
    gradients once instead of scattering each into a zero (B, S, 3D+M)
    tensor and adding them."""

    def __init__(self, hidden_dim: int, heads: int, mlp_dim: int, compute_dtype: torch.dtype):
        super().__init__(hidden_dim, 3 * hidden_dim + mlp_dim, compute_dtype=compute_dtype)
        self.hidden_dim, self.heads = hidden_dim, heads

    def forward(self, x: torch.Tensor):
        D, H = self.hidden_dim, self.heads
        q, k, v, mlp = super().forward(x).split([D, D, D, self.out_features - 3 * D], dim=-1)
        return split_heads(q, H), split_heads(k, H), split_heads(v, H), mlp


class _SingleOutProj(Linear):
    """The single block's fused ``linear2`` (D, D+M) over [attention; MLP]:
    the attention columns and the MLP columns as two partial products summed,
    as the JAX module computes it (the weight split once, as in
    :class:`_SingleQKVMLP`)."""

    def __init__(self, hidden_dim: int, mlp_dim: int, compute_dtype: torch.dtype):
        super().__init__(hidden_dim + mlp_dim, hidden_dim, compute_dtype=compute_dtype)
        self.hidden_dim = hidden_dim

    def forward(self, attn: torch.Tensor, mlp: torch.Tensor) -> torch.Tensor:
        D, dt = self.hidden_dim, self.compute_dtype
        w_attn, w_mlp = self.weight.to(dt).split([D, self.in_features - D], dim=1)
        return F.linear(merge_heads(attn).to(dt), w_attn) + F.linear(mlp.to(dt), w_mlp, self.bias.to(dt))


class FluxSingleBlock(nn.Module):
    """Fused parallel attention + MLP over the concatenated stream (JAX
    ``FluxSingleBlock``); ``attn`` holds only the qk-norm scales."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.compute_dtype, self.attn_backend = dt, cfg.attn_backend
        self.norm = _AdaLinear(D, 3)
        self.linear1 = _SingleQKVMLP(D, cfg.num_heads, cfg.mlp_dim, dt)
        self.attn = QKNorm(cfg.head_dim)
        self.linear2 = _SingleOutProj(D, cfg.mlp_dim, dt)

    def forward(self, x, temb, cos, sin):
        shift, scale, gate = self.norm(temb)
        x_mod = adaln_modulate(x, shift, scale, out_dtype=self.compute_dtype)
        q, k, v, mlp = self.linear1(x_mod)
        q, k = self.attn(q, k)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = dot_product_attention(q, k, v, backend=self.attn_backend)
        out = self.linear2(attn, F.gelu(mlp, approximate="tanh"))
        return x + gate[:, None].to(x.dtype) * out


class _TimeTextEmbed(nn.Module):
    """diffusers ``CombinedTimestepGuidanceTextProjEmbeddings``, fp32."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        D = cfg.hidden_dim
        self.timestep_embedder = TimestepEmbedding(D)
        if cfg.guidance_embeds:
            self.guidance_embedder = TimestepEmbedding(D)
        if cfg.pooled_dim > 0:
            self.text_embedder = PooledTextEmbedding(cfg.pooled_dim, D)


class FluxTransformer(nn.Module):
    """Packed-latent hybrid DiT; ``timestep`` and ``guidance`` (B,) in the
    scheduler's [0, 1000] scale and as the CFG scale."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.x_embedder = Linear(cfg.in_channels, D, compute_dtype=dt)
        if cfg.txt_norm:
            self.txt_norm = FP32RMSNorm(cfg.context_dim)
        self.context_embedder = Linear(cfg.context_dim, D, compute_dtype=dt)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList([FluxDoubleBlock(cfg) for _ in range(cfg.num_double_blocks)])
        self.single_transformer_blocks = nn.ModuleList([FluxSingleBlock(cfg) for _ in range(cfg.num_single_blocks)])
        self.norm_out = AdaLayerNormContinuous(D)
        self.proj_out = Linear(D, cfg.in_channels, compute_dtype=torch.float32, rows=HEAD_ROWS)

    def forward(
        self,
        latents: torch.Tensor,  # (B, L_img, in_channels) packed
        timestep: torch.Tensor,  # (B,) scheduler scale [0, 1000]
        encoder_hidden_states: torch.Tensor,  # (B, L_txt, context_dim)
        pooled_projections: Optional[torch.Tensor],  # (B, pooled_dim)
        img_ids: torch.Tensor,  # (L_img, 3)
        txt_ids: torch.Tensor,  # (L_txt, 3)
        guidance: Optional[torch.Tensor] = None,  # (B,) distilled CFG scale
    ) -> torch.Tensor:
        cfg = self.cfg
        img = self.x_embedder(latents)
        if cfg.txt_norm:
            encoder_hidden_states = self.txt_norm(encoder_hidden_states)
        txt = self.context_embedder(encoder_hidden_states)
        emb = self.time_text_embed
        # the JAX expression, so that fp32 rounds alike (diffusers scales t to [0, 1])
        temb = emb.timestep_embedder(timestep / 1000.0 * 1000.0)
        if cfg.guidance_embeds and guidance is not None:
            temb = temb + emb.guidance_embedder(guidance * 1000.0)
        if cfg.pooled_dim > 0 and pooled_projections is not None:
            temb = temb + emb.text_embedder(pooled_projections)

        cos, sin = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0), cfg.axes_dim, cfg.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            img, txt = (checkpointed(block, img, txt, temb, cos, sin) if remat
                        else block(img, txt, temb, cos, sin))
        if self.single_transformer_blocks:
            x = torch.cat([txt, img], dim=1)
            for block in self.single_transformer_blocks:
                x = checkpointed(block, x, temb, cos, sin) if remat else block(x, temb, cos, sin)
            img = x[:, txt.shape[1]:].contiguous()  # K5 reads whole rows
        img = self.norm_out(img, temb)
        return self.proj_out(img)
