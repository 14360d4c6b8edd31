"""Decoder-only LM text encoder (port of ``flow_factory_tpu/models/text_encoders/lm.py``).

Hand-ported: the card's machine has no ``transformers``. Parameter names are
``transformers``' causal-LM names (``model.embed_tokens``,
``model.layers.{i}.self_attn.q_proj``, ``.mlp.gate_proj``, ``model.norm``).
Two layouts, ``arch``:

* ``llama`` (Llama, Mistral, Qwen2): pre-norm RMSNorm, GQA attention with
  half-split ("rotate_half") RoPE, SwiGLU, optional q/k/v biases (Qwen2);
* ``gemma3`` (LTX-2's conditioning LM) differs in seven ways: the embedding
  times sqrt(hidden) in the compute dtype; (1 + w) RMSNorms with zero-init
  ``w``, computed in fp32; a post-attention and a post-feed-forward norm
  before each residual add (``post_attention_layernorm``,
  ``post_feedforward_layernorm``; the MLP's pre-norm is
  ``pre_feedforward_layernorm``); per-head q/k RMSNorms before RoPE;
  tanh-GELU GeGLU; the ``query_pre_attn_scalar ** -0.5`` attention scale;
  and sliding-window layers (a causal band of ``sliding_window`` keys, their
  own RoPE theta, unscaled positions) between global layers (linear RoPE
  scaling: positions divided by ``rope_scaling_factor``).

The attention is the JAX package's masked product: fp32 logits, the mask as
-1e30, an fp32 softmax rounded to the compute dtype before PV. Pad
positions are computed like any other row (their outputs are what the JAX
encoder gives there, and LTX-2's transformer attends them).

Qwen2.5-VL's conditioning path (Qwen-Image-Edit-Plus): the vision tower's
merged tokens replace the embeddings of the image-pad positions
(``vision_embeds`` scattered by ``vision_mask``, in order), and M-RoPE
(``mrope_sections``) takes each rotary frequency's position from the
temporal, height or width id of ``position_ids``; with equal ids on the
three axes it is the 1-D RoPE.

``return_logits`` adds the next-token logits of the tied embedding (JAX
``Embed.attend``): the final states times the token table in the compute
dtype, cast to fp32, with no Gemma √width scale (it scales the input
embedding only). The caption upsampler (``caption.py``) generates from them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear, rope_frequencies


def _apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """NeoX/Llama rotation, pairs (i, i + d/2): x (B, H, L, D), cos/sin (L, D/2), fp32."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = torch.cat([cos, cos], dim=-1)
    s = torch.cat([sin, sin], dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * c + rot * s).to(x.dtype)


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 151936
    hidden_dim: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    mlp_dim: int = 18944
    rope_theta: float = 1000000.0
    attn_bias: bool = False  # Qwen2.x: biases on the q/k/v projections
    rms_eps: float = 1e-6
    #: M-RoPE rotary frequencies per (t, h, w) section (sum head_dim // 2)
    mrope_sections: Optional[Tuple[int, int, int]] = None
    arch: str = "llama"
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: int = 0
    sliding_window_pattern: int = 6
    rope_local_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def qwen25_7b(**o) -> "LMConfig":
        """Qwen2.5-7B (Qwen-Image's encoder): the default widths with q/k/v biases."""
        return LMConfig(**{"attn_bias": True, **o})

    @staticmethod
    def qwen25_vl_7b(**o) -> "LMConfig":
        """Qwen2.5-VL-7B's language side: M-RoPE sections (16, 24, 24)."""
        return LMConfig(**{"attn_bias": True, "mrope_sections": (16, 24, 24), **o})

    @staticmethod
    def mistral_small(**o) -> "LMConfig":
        """Mistral-Small (FLUX.2's encoder): 40 layers, width 5120, 32 q / 8
        kv heads of 128, MLP 32768, vocabulary 131072."""
        base = dict(vocab_size=131072, hidden_dim=5120, num_layers=40, num_heads=32,
                    num_kv_heads=8, head_dim=128, mlp_dim=32768)
        base.update(o)
        return LMConfig(**base)

    @staticmethod
    def gemma3(**o) -> "LMConfig":
        """Gemma3-12B text stack: 48 layers, width 3840, 16 q / 8 kv heads of
        256, 5 sliding-window layers (window 1024) per global layer."""
        base = dict(vocab_size=262208, hidden_dim=3840, num_layers=48, num_heads=16,
                    num_kv_heads=8, head_dim=256, mlp_dim=15360, arch="gemma3",
                    query_pre_attn_scalar=256.0, sliding_window=1024,
                    sliding_window_pattern=6, rope_theta=1_000_000.0,
                    rope_local_theta=10_000.0, rope_scaling_factor=8.0)
        base.update(o)
        return LMConfig(**base)

    @staticmethod
    def gemma3_tiny(**o) -> "LMConfig":
        base = dict(vocab_size=1000, hidden_dim=32, num_layers=3, num_heads=4,
                    num_kv_heads=2, head_dim=8, mlp_dim=64, arch="gemma3",
                    query_pre_attn_scalar=8.0, sliding_window=4,
                    sliding_window_pattern=2, rope_theta=1_000_000.0,
                    rope_local_theta=10_000.0, rope_scaling_factor=8.0)
        base.update(o)
        return LMConfig(**base)

    @staticmethod
    def tiny(**o) -> "LMConfig":
        base = dict(vocab_size=1000, hidden_dim=32, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=8, mlp_dim=64, rope_theta=10000.0)
        base.update(o)
        return LMConfig(**base)


class RMSNorm(nn.Module):
    """RMSNorm with an fp32 product; ``plus_one`` is Gemma's zero-init
    weight applied as (1 + w), the sum taken in the weight's dtype as the
    JAX module takes it."""

    def __init__(self, dim: int, eps: float = 1e-6, plus_one: bool = False):
        super().__init__()
        self.eps, self.plus_one = eps, plus_one
        self.weight = nn.Parameter(torch.zeros(dim) if plus_one else torch.ones(dim))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        (nn.init.zeros_ if self.plus_one else nn.init.ones_)(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = 1.0 + self.weight if self.plus_one else self.weight
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * scale.float()).to(x.dtype)


class LMAttention(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        D, dt, hd = cfg.hidden_dim, cfg.compute_dtype, cfg.head_dim
        self.cfg = cfg
        self.q_proj = Linear(D, cfg.num_heads * hd, bias=cfg.attn_bias, compute_dtype=dt)
        self.k_proj = Linear(D, cfg.num_kv_heads * hd, bias=cfg.attn_bias, compute_dtype=dt)
        self.v_proj = Linear(D, cfg.num_kv_heads * hd, bias=cfg.attn_bias, compute_dtype=dt)
        self.o_proj = Linear(cfg.num_heads * hd, D, bias=False, compute_dtype=dt)
        if cfg.arch == "gemma3":
            self.q_norm = RMSNorm(hd, cfg.rms_eps, plus_one=True)
            self.k_norm = RMSNorm(hd, cfg.rms_eps, plus_one=True)

    def forward(self, h, cos, sin, mask):
        cfg = self.cfg
        Hq, Hkv, hd, dt = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.compute_dtype
        B, L, _ = h.shape
        q = self.q_proj(h).view(B, L, Hq, hd).transpose(1, 2)
        k = self.k_proj(h).view(B, L, Hkv, hd).transpose(1, 2)
        v = self.v_proj(h).view(B, L, Hkv, hd).transpose(1, 2)
        if cfg.arch == "gemma3":  # per-head q/k norms before RoPE
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = _apply_rope_half(q, cos, sin), _apply_rope_half(k, cos, sin)
        rep = Hq // Hkv  # GQA: each kv head serves ``rep`` consecutive q heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        scale = (cfg.query_pre_attn_scalar if cfg.query_pre_attn_scalar is not None else hd) ** -0.5
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1).to(dt)
        o = torch.matmul(p, v.to(dt)).transpose(1, 2).reshape(B, L, Hq * hd)
        return self.o_proj(o)


class LMMLP(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.gemma = cfg.arch == "gemma3"
        self.gate_proj = Linear(D, cfg.mlp_dim, bias=False, compute_dtype=dt)
        self.up_proj = Linear(D, cfg.mlp_dim, bias=False, compute_dtype=dt)
        self.down_proj = Linear(cfg.mlp_dim, D, bias=False, compute_dtype=dt)

    def forward(self, h):
        gate = self.gate_proj(h)
        act = F.gelu(gate, approximate="tanh") if self.gemma else F.silu(gate)
        return self.down_proj(act * self.up_proj(h))


class LMBlock(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        D, gemma = cfg.hidden_dim, cfg.arch == "gemma3"
        self.gemma = gemma
        self.input_layernorm = RMSNorm(D, cfg.rms_eps, plus_one=gemma)
        self.self_attn = LMAttention(cfg)
        self.post_attention_layernorm = RMSNorm(D, cfg.rms_eps, plus_one=gemma)
        if gemma:  # sandwich norms: post_attention before the residual add, pre/post feed-forward
            self.pre_feedforward_layernorm = RMSNorm(D, cfg.rms_eps, plus_one=True)
            self.post_feedforward_layernorm = RMSNorm(D, cfg.rms_eps, plus_one=True)
        self.mlp = LMMLP(cfg)

    def forward(self, x, cos, sin, mask):
        o = self.self_attn(self.input_layernorm(x), cos, sin, mask)
        if self.gemma:
            x = x + self.post_attention_layernorm(o)
            return x + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))
        x = x + o
        return x + self.mlp(self.post_attention_layernorm(x))


class _LMModel(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.layers = nn.ModuleList([LMBlock(cfg) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_dim, cfg.rms_eps, plus_one=cfg.arch == "gemma3")


class LMEncoder(nn.Module):
    """Causal LM; ``forward(input_ids, attention_mask)`` returns the final
    hidden states (B, L, D) in the compute dtype, and with ``return_logits``
    also the tied-embedding logits (B, L, vocab) in fp32."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _LMModel(cfg)

    def layer_is_sliding(self, i: int) -> bool:
        cfg = self.cfg
        return cfg.arch == "gemma3" and cfg.sliding_window > 0 and bool((i + 1) % cfg.sliding_window_pattern)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None, vision_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None, return_logits: bool = False):
        """``vision_embeds`` (B, Lv, D) replace, in order, the embeddings at
        the True positions of ``vision_mask`` (B, L); ``position_ids``
        (3, L) or per row (B, 3, L) are the M-RoPE (t, h, w) ids."""
        cfg = self.cfg
        dt, gemma = cfg.compute_dtype, cfg.arch == "gemma3"
        L = input_ids.shape[1]
        dev = input_ids.device
        x = self.model.embed_tokens.weight.to(dt)[input_ids]
        if gemma:  # the sqrt(hidden) scale in the embedding dtype
            x = x * torch.tensor(cfg.hidden_dim ** 0.5, dtype=dt, device=dev)
        if vision_embeds is not None and vision_mask is not None:
            vm = vision_mask.bool()
            idx = (torch.cumsum(vm.long(), dim=1) - 1).clamp(0, vision_embeds.shape[1] - 1)
            gathered = torch.gather(vision_embeds.to(x.dtype), 1, idx[..., None].expand(-1, -1, x.shape[-1]))
            x = torch.where(vm[..., None], gathered, x)
        if position_ids is not None and cfg.mrope_sections is not None:
            cos, sin = self._mrope_tables(position_ids)
        else:
            pos = torch.arange(L, device=dev, dtype=torch.float32)[:, None]
            cos, sin = rope_frequencies(pos / cfg.rope_scaling_factor, (cfg.head_dim,), cfg.rope_theta)
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None, None]
        if attention_mask is not None:
            causal = causal & attention_mask.bool()[:, None, None, :]
        if gemma and cfg.sliding_window > 0:
            pos = torch.arange(L, device=dev, dtype=torch.float32)[:, None]
            cos_l, sin_l = rope_frequencies(pos, (cfg.head_dim,), cfg.rope_local_theta)
            idx = torch.arange(L, device=dev)
            band = (idx[:, None] - idx[None, :]) < cfg.sliding_window
            sliding = causal & band[None, None]
        else:
            cos_l, sin_l, sliding = cos, sin, causal
        for i, layer in enumerate(self.model.layers):
            if self.layer_is_sliding(i):
                x = layer(x, cos_l, sin_l, sliding)
            else:
                x = layer(x, cos, sin, causal)
        x = self.model.norm(x)
        if return_logits:
            return x, F.linear(x.to(dt), self.model.embed_tokens.weight.to(dt)).float()
        return x

    def _mrope_tables(self, position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """M-RoPE (cos, sin): frequency j rotates by the id of its section's
        axis; (L, hd/2) for (3, L) ids, (B, 1, L, hd/2) for (B, 3, L)."""
        cfg = self.cfg
        half = cfg.head_dim // 2
        dev = position_ids.device
        freqs = 1.0 / (cfg.rope_theta ** (torch.arange(half, dtype=torch.float32, device=dev) * 2.0 / cfg.head_dim))
        sel = torch.cat([torch.full((n,), i, dtype=torch.long, device=dev)
                         for i, n in enumerate(cfg.mrope_sections)])
        pos = position_ids.float().index_select(-2, sel)  # (..., half, L)
        angles = pos.transpose(-1, -2) * freqs  # (..., L, half)
        if angles.ndim == 3:
            angles = angles[:, None]
        return torch.cos(angles), torch.sin(angles)
