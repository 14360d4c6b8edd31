"""LTX-2 dual-stream audio-video DiT (port of ``flow_factory_tpu/models/ltx2/transformer.py``).

Parameter names are the upstream ``LTX2VideoTransformerBlock`` names of the
JAX key map (``ltx2_transformer_key_map``). Per block, video and audio stay
separate token streams:

    attn1 / audio_attn1 — modulated self-attention, across-heads RMS qk-norm,
        RoPE over (t, h, w) (K5-RMS, then K3);
    attn2 / audio_attn2 — cross-attention to the stream's text connector
        output, a plain residual on the un-normed stream, no text mask: the
        pad positions of the context are attended, as in the JAX module;
    audio_to_video_attn / video_to_audio_attn — the cross-modal exchange,
        both from one snapshot of the two streams, skipped under
        ``isolate_modalities``;
    ff / audio_ff — modulated tanh-GELU feed-forward (K5-RMS).

Modulation: a learned fp32 (1, 6, D) table per stream plus the fp32
projected time embedding (shift, scale, gate for attention and FFN). Under
I2AV the video stream modulates per token: a binary conditioning mask
interpolates the t and t=0 tables, a (B, Lv) timestep embeds every token's
own t. The two output heads run K5-RMS with an fp32 output. STG skips the
listed blocks; ``remat`` recomputes each block in the backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import dot_product_attention
from ...ops.norms import rms_modulate
from ..layers import (
    FEW_TOKEN_ROWS,
    HEAD_ROWS,
    SAMPLE_ROWS,
    AcrossHeadsQKNorm,
    FeedForward,
    HeadProj,
    Linear,
    MergeProj,
    TimestepEmbedding,
    apply_rope,
    checkpointed,
    rope_frequencies,
)


@dataclass(frozen=True)
class LTX2Config:
    video_channels: int = 128
    audio_channels: int = 128
    hidden_dim: int = 2048
    ffn_dim: int = 8192
    num_heads: int = 16
    num_layers: int = 28
    context_dim: int = 3840  # Gemma3 hidden
    freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (64, 32, 32)
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
    def ltx2(**o) -> "LTX2Config":
        return LTX2Config(**o)

    @staticmethod
    def tiny(**o) -> "LTX2Config":
        base = dict(video_channels=16, audio_channels=8, hidden_dim=64, ffn_dim=128,
                    num_heads=4, num_layers=2, context_dim=32, freq_dim=32, axes_dim=(8, 4, 4))
        base.update(o)
        return LTX2Config(**base)


class LTX2Attention(nn.Module):
    """q from ``x``, k/v from ``y`` (``x`` itself for self-attention), the
    across-heads qk-norm (``norm_q``/``norm_k``, γ (D,)), RoPE when tables
    are given; K3 on the card."""

    def __init__(self, cfg: LTX2Config, q_rows: Optional[int] = None, kv_rows: Optional[int] = None):
        super().__init__()
        D, H, E, dt = cfg.hidden_dim, cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        self.compute_dtype, self.attn_backend = dt, cfg.attn_backend
        # the query stream's products (and the output's) and the key/value
        # stream's at a fixed row count where that stream is the audio (F18)
        self.to_q = HeadProj(D, H, E, dt, rows=q_rows)
        self.to_k = HeadProj(D, H, E, dt, rows=kv_rows)
        self.to_v = HeadProj(D, H, E, dt, rows=kv_rows)
        self.norm_q = AcrossHeadsQKNorm(D)
        self.norm_k = AcrossHeadsQKNorm(D)
        self.to_out = nn.ModuleList([MergeProj(D, D, compute_dtype=dt, rows=q_rows)])

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        y = x if y is None else y.to(self.compute_dtype)
        q, k, v = self.to_q(x), self.to_k(y), self.to_v(y)
        q, k = self.norm_q(q), self.norm_k(k)
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        return self.to_out[0](dot_product_attention(q, k, v, backend=self.attn_backend))


def _mods(table: torch.Tensor, temb6: torch.Tensor, temb6_zero=None, cond_mask=None):
    """The six modulation vectors of one stream: (B, 1, D) each; per token
    (B, L, D) for a (B, L, 6, D) embedding or under a conditioning mask
    (conditioned tokens take the t=0 set, exact for a binary mask)."""
    table = table.float()
    if temb6.ndim == 4:
        m = table[:, None] + temb6.float()
        return [m[:, :, i] for i in range(6)]
    m = table + temb6.float()
    if temb6_zero is None or cond_mask is None:
        return [m[:, i, None] for i in range(6)]
    m0 = table + temb6_zero.float()
    cm = cond_mask.float()
    return [cm * m0[:, i, None] + (1.0 - cm) * m[:, i, None] for i in range(6)]


class LTX2Block(nn.Module):
    def __init__(self, cfg: LTX2Config):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.compute_dtype = dt
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 6, D))
        self.audio_scale_shift_table = nn.Parameter(torch.zeros(1, 6, D))
        # the audio stream's products at FEW_TOKEN_ROWS (F18): as queries in its
        # self- and text attention and v2a, as keys and values in a2v
        audio = dict(audio_attn1=(FEW_TOKEN_ROWS, FEW_TOKEN_ROWS), audio_attn2=(FEW_TOKEN_ROWS, None),
                     audio_to_video_attn=(None, FEW_TOKEN_ROWS), video_to_audio_attn=(FEW_TOKEN_ROWS, None))
        for name in ("attn1", "audio_attn1", "attn2", "audio_attn2", "audio_to_video_attn",
                     "video_to_audio_attn"):
            setattr(self, name, LTX2Attention(cfg, *audio.get(name, (None, None))))
        self.ff = FeedForward(D, cfg.ffn_dim, dt)
        self.audio_ff = FeedForward(D, cfg.ffn_dim, dt, rows=FEW_TOKEN_ROWS)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)
        self.audio_scale_shift_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, v, a, v_ctx, a_ctx, v_temb6, a_temb6, v_cos, v_sin, a_cos, a_sin,
                isolate_modalities: bool = False, v_temb6_zero=None, v_cond_mask=None):
        dt = self.compute_dtype
        v_shift_sa, v_scale_sa, v_gate_sa, v_shift_ff, v_scale_ff, v_gate_ff = _mods(
            self.scale_shift_table, v_temb6, v_temb6_zero, v_cond_mask)
        a_shift_sa, a_scale_sa, a_gate_sa, a_shift_ff, a_scale_ff, a_gate_ff = _mods(
            self.audio_scale_shift_table, a_temb6)
        # 1. modulated self-attention per modality
        h = rms_modulate(v, v_shift_sa, v_scale_sa, out_dtype=dt)
        v = v + v_gate_sa.to(v.dtype) * self.attn1(h, rope=(v_cos, v_sin))
        h = rms_modulate(a, a_shift_sa, a_scale_sa, out_dtype=dt)
        a = a + a_gate_sa.to(a.dtype) * self.audio_attn1(h, rope=(a_cos, a_sin))
        # 2. text cross-attention, plain residuals on the un-normed streams
        v = v + self.attn2(v, v_ctx)
        a = a + self.audio_attn2(a, a_ctx)
        # 3. the cross-modal exchange from one snapshot of both streams
        if not isolate_modalities:
            v_snap, a_snap = v, a
            v = v + self.audio_to_video_attn(v_snap, a_snap)
            a = a + self.video_to_audio_attn(a_snap, v_snap)
        # 4. modulated feed-forward per modality
        h = rms_modulate(v, v_shift_ff, v_scale_ff, out_dtype=dt)
        v = v + v_gate_ff.to(v.dtype) * self.ff(h)
        h = rms_modulate(a, a_shift_ff, a_scale_ff, out_dtype=dt)
        a = a + a_gate_ff.to(a.dtype) * self.audio_ff(h)
        return v, a


class AdaLNSingle(nn.Module):
    """The time embedding (``emb.timestep_embedder``, fp32) and its 6-way
    projection (``linear``, fp32) of one stream."""

    def __init__(self, cfg: LTX2Config):
        super().__init__()
        self.emb = nn.Module()
        self.emb.timestep_embedder = TimestepEmbedding(cfg.hidden_dim, freq_dim=cfg.freq_dim)
        self.linear = Linear(cfg.hidden_dim, 6 * cfg.hidden_dim, rows=SAMPLE_ROWS)

    def forward(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N,) timesteps → (the embedding (N, D), its projection (N, 6D))."""
        temb = self.emb.timestep_embedder(t)
        return temb, self.linear(F.silu(temb))


class LTX2Transformer(nn.Module):
    """Inputs: video tokens (B, Lv, video_channels), audio tokens (B, La,
    audio_channels), the video timestep (B,) or per token (B, Lv) in the
    scheduler's [0, 1000] scale, the LM hidden states (B, Lc, context_dim),
    the ids (Lv, 3) and (La, 3). Returns fp32 (video, audio) velocities."""

    def __init__(self, cfg: LTX2Config):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.proj_in = Linear(cfg.video_channels, D, compute_dtype=dt)
        self.audio_proj_in = Linear(cfg.audio_channels, D, compute_dtype=dt, rows=FEW_TOKEN_ROWS)
        self.time_embed = AdaLNSingle(cfg)
        self.audio_time_embed = AdaLNSingle(cfg)
        self.video_connector = Linear(cfg.context_dim, D, compute_dtype=dt)
        self.audio_connector = Linear(cfg.context_dim, D, compute_dtype=dt)
        self.transformer_blocks = nn.ModuleList([LTX2Block(cfg) for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 2, D))
        self.audio_scale_shift_table = nn.Parameter(torch.zeros(1, 2, D))
        self.proj_out = Linear(D, cfg.video_channels, compute_dtype=torch.float32, rows=HEAD_ROWS)
        self.audio_proj_out = Linear(D, cfg.audio_channels, compute_dtype=torch.float32, rows=FEW_TOKEN_ROWS)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)
        self.audio_scale_shift_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, video_latents: torch.Tensor, audio_latents: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor, video_ids: torch.Tensor, audio_ids: torch.Tensor,
                skip_blocks: Sequence[int] = (), audio_timestep: Optional[torch.Tensor] = None,
                isolate_modalities: bool = False, video_cond_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dt, D = cfg.compute_dtype, cfg.hidden_dim
        B = video_latents.shape[0]
        v = self.proj_in(video_latents.to(dt))
        a = self.audio_proj_in(audio_latents.to(dt))
        if audio_timestep is None:
            audio_timestep = timestep if timestep.ndim == 1 else timestep[:, 0]
        v_temb6_zero = v_temb0 = None
        if timestep.ndim == 2:  # per-token video timestep: every token embeds its own t
            Lv = timestep.shape[1]
            v_temb, v_temb6 = self.time_embed(timestep.reshape(-1))
            v_temb, v_temb6 = v_temb.reshape(B, Lv, D), v_temb6.reshape(B, Lv, 6, D)
            video_cond_mask = None
        else:
            v_temb, v_temb6 = self.time_embed(timestep)
            v_temb6 = v_temb6.reshape(B, 6, D)
            if video_cond_mask is not None:  # conditioned tokens modulate at t = 0
                v_temb0, v_temb6_zero = self.time_embed(torch.zeros_like(timestep))
                v_temb6_zero = v_temb6_zero.reshape(B, 6, D)
        a_temb, a_temb6 = self.audio_time_embed(audio_timestep)
        a_temb6 = a_temb6.reshape(B, 6, D)

        ctx = encoder_hidden_states.to(dt)
        v_ctx, a_ctx = self.video_connector(ctx), self.audio_connector(ctx)
        v_cos, v_sin = rope_frequencies(video_ids, cfg.axes_dim, cfg.rope_theta)
        a_cos, a_sin = rope_frequencies(audio_ids, cfg.axes_dim, cfg.rope_theta)

        remat = cfg.remat and torch.is_grad_enabled()
        skip = set(skip_blocks)
        for i, block in enumerate(self.transformer_blocks):
            if i in skip:  # STG: identity through the perturbed blocks
                continue
            args = (v, a, v_ctx, a_ctx, v_temb6, a_temb6, v_cos, v_sin, a_cos, a_sin,
                    isolate_modalities, v_temb6_zero, video_cond_mask)
            v, a = checkpointed(block, *args) if remat else block(*args)

        v_out = self._head(v, v_temb, self.scale_shift_table, self.proj_out, v_temb0, video_cond_mask)
        a_out = self._head(a, a_temb, self.audio_scale_shift_table, self.audio_proj_out)
        return v_out, a_out

    @staticmethod
    def _head(x, temb, table, proj, temb_zero=None, cond_mask=None):
        """K5-RMS with an fp32 output under the (1, 2, D) table + the raw
        time embedding (shift first), then the fp32 projection."""
        table = table.float()
        if temb.ndim == 3:  # per-token (B, L, D)
            mod = table[:, None] + temb[:, :, None, :].float()
            return proj(rms_modulate(x, mod[:, :, 0], mod[:, :, 1], out_dtype=torch.float32))
        mod = table + temb[:, None, :].float()
        if temb_zero is not None and cond_mask is not None:
            mod0 = table + temb_zero[:, None, :].float()
            cm = cond_mask.float()
            shift = cm * mod0[:, 0, None] + (1.0 - cm) * mod[:, 0, None]
            scale = cm * mod0[:, 1, None] + (1.0 - cm) * mod[:, 1, None]
        else:
            shift, scale = mod[:, 0, None], mod[:, 1, None]
        return proj(rms_modulate(x, shift, scale, out_dtype=torch.float32))
