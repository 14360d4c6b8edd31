"""CLIP text encoder (port of ``flow_factory_tpu/models/text_encoders/clip.py``).

Hand-ported: the card's machine has no ``transformers``. Parameter names are
``transformers``' ``CLIPTextModelWithProjection`` names. Covers CLIP-L
(quick-GELU) and OpenCLIP-bigG (exact GELU) via config. LayerNorms are flax's
fast-variance form (``max(0, E[x^2] - E[x]^2)``), not ``F.layer_norm``'s
two-pass variance. Returns the final and penultimate hidden states and the
projected EOS embedding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear, NormParams, merge_heads, split_heads


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def clip_l(**o) -> "CLIPTextConfig":
        return CLIPTextConfig(**o)

    @staticmethod
    def clip_g(**o) -> "CLIPTextConfig":
        base = dict(hidden_dim=1280, num_layers=32, num_heads=20, projection_dim=1280,
                    hidden_act="gelu")
        base.update(o)
        return CLIPTextConfig(**base)

    @staticmethod
    def tiny(**o) -> "CLIPTextConfig":
        base = dict(vocab_size=1000, hidden_dim=32, num_layers=2, num_heads=4, projection_dim=32,
                    eos_token_id=2)
        base.update(o)
        return CLIPTextConfig(**base)


class CLIPTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # (B, L, D) post-final-LN
    penultimate_hidden_state: torch.Tensor  # (B, L, D) input of the last block
    pooled: torch.Tensor  # (B, projection_dim) projected EOS embedding


def flax_layer_norm(x: torch.Tensor, norm: NormParams, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 fast-variance stats, then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x32 - mean) * (torch.rsqrt(var + eps) * norm.weight.float()) + norm.bias.float()


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.heads = cfg.num_heads
        self.q_proj = Linear(D, D, compute_dtype=dt)
        self.k_proj = Linear(D, D, compute_dtype=dt)
        self.v_proj = Linear(D, D, compute_dtype=dt)
        self.out_proj = Linear(D, D, compute_dtype=dt)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(p(h), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1).to(h.dtype)
        return self.out_proj(merge_heads(torch.matmul(p, v)))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.act = _act(cfg.hidden_act)
        self.fc1 = Linear(D, 4 * D, compute_dtype=dt)
        self.fc2 = Linear(4 * D, D, compute_dtype=dt)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(h)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.eps, self.dtype = cfg.layer_norm_eps, cfg.compute_dtype
        self.layer_norm1 = NormParams(cfg.hidden_dim)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = NormParams(cfg.hidden_dim)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(flax_layer_norm(x, self.layer_norm1, self.eps).to(self.dtype), mask)
        return x + self.mlp(flax_layer_norm(x, self.layer_norm2, self.eps).to(self.dtype))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_dim)
        self.position_embedding.init_std = 0.01


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = NormParams(cfg.hidden_dim)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = Linear(cfg.hidden_dim, cfg.projection_dim, bias=False,
                                      compute_dtype=torch.float32)

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        cfg, dt = self.cfg, self.cfg.compute_dtype
        tm = self.text_model
        B, L = input_ids.shape
        x = tm.embeddings.token_embedding.weight.to(dt)[input_ids]
        x = x + tm.embeddings.position_embedding.weight[:L].to(dt)[None]
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None]
        penultimate = x
        for layer in tm.encoder.layers:
            penultimate = x
            x = layer(x, causal)
        final = flax_layer_norm(x, tm.final_layer_norm, cfg.layer_norm_eps)
        # EOS pooling: first position holding eos_token_id (HF convention)
        eos_idx = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
        pooled = self.text_projection(final[torch.arange(B, device=x.device), eos_idx])
        return CLIPTextOutput(final.to(dt), penultimate, pooled)
