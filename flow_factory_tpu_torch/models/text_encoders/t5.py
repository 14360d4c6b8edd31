"""T5 v1.1 and UMT5 encoders (port of ``flow_factory_tpu/models/text_encoders/t5.py``).

Hand-ported: the card's machine has no ``transformers``. Parameter names are
``transformers``' ``T5EncoderModel`` / ``UMT5EncoderModel`` names. RMS
``T5LayerNorm`` (no mean, no bias), relative-position-bucket attention bias
owned by block 0 and shared (T5) or owned by every block (UMT5,
``per_layer_rel_bias``), no q scaling, gated tanh-GELU feed-forward.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear, ScaleParam, merge_heads, split_heads


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    hidden_dim: int = 4096
    ff_dim: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    #: UMT5 (Wan's text encoder): every block owns its relative-attention bias table
    per_layer_rel_bias: bool = False
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def xxl(**o) -> "T5Config":
        return T5Config(**o)

    @staticmethod
    def umt5_xxl(**o) -> "T5Config":
        """Wan2.x text encoder: UMT5-XXL (per-block bias tables, vocab 256384)."""
        base = dict(vocab_size=256384, per_layer_rel_bias=True)
        base.update(o)
        return T5Config(**base)

    @staticmethod
    def tiny(**o) -> "T5Config":
        base = dict(vocab_size=1000, hidden_dim=32, ff_dim=64, num_layers=2, num_heads=4, head_dim=8)
        base.update(o)
        return T5Config(**base)


def t5_layer_norm(x: torch.Tensor, norm: ScaleParam) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * norm.weight.float()).to(x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = torch.abs(rel_pos)
    max_exact = num_buckets // 2
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        inner, dt = cfg.num_heads * cfg.head_dim, cfg.compute_dtype
        self.cfg = cfg
        self.q = Linear(cfg.hidden_dim, inner, bias=False, compute_dtype=dt)
        self.k = Linear(cfg.hidden_dim, inner, bias=False, compute_dtype=dt)
        self.v = Linear(cfg.hidden_dim, inner, bias=False, compute_dtype=dt)
        self.o = Linear(inner, cfg.hidden_dim, bias=False, compute_dtype=dt)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_pos_buckets, cfg.num_heads)
            self.relative_attention_bias.init_std = 0.02

    def position_bias(self, L: int, device) -> torch.Tensor:
        pos = torch.arange(L, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.cfg.rel_pos_buckets,
                                           self.cfg.rel_pos_max_distance)
        return self.relative_attention_bias.weight[buckets].permute(2, 0, 1)[None]  # (1, H, L, L)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        H = self.cfg.num_heads
        q, k, v = (split_heads(p(x), H) for p in (self.q, self.k, self.v))
        if hasattr(self, "relative_attention_bias"):
            bias = self.position_bias(x.shape[1], x.device)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()  # no q scaling
        p = torch.softmax(s, dim=-1).to(self.cfg.compute_dtype)
        return self.o(merge_heads(torch.matmul(p, v))), bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = ScaleParam(cfg.hidden_dim)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        dt = cfg.compute_dtype
        self.wi_0 = Linear(cfg.hidden_dim, cfg.ff_dim, bias=False, compute_dtype=dt)
        self.wi_1 = Linear(cfg.hidden_dim, cfg.ff_dim, bias=False, compute_dtype=dt)
        self.wo = Linear(cfg.ff_dim, cfg.hidden_dim, bias=False, compute_dtype=dt)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = ScaleParam(cfg.hidden_dim)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_attention_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]):
        sa, ff = self.layer
        attn_out, bias = sa.SelfAttention(t5_layer_norm(x, sa.layer_norm), bias)
        x = x + attn_out
        return x + ff.DenseReluDense(t5_layer_norm(x, ff.layer_norm)), bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0 or cfg.per_layer_rel_bias)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = ScaleParam(cfg.hidden_dim)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.encoder = T5Stack(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared.weight.to(self.cfg.compute_dtype)[input_ids]
        bias = None
        for block in self.encoder.block:
            x, bias = block(x, bias)
        return t5_layer_norm(x, self.encoder.final_layer_norm)
