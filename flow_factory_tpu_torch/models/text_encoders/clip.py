"""CLIP text and vision towers (port of ``flow_factory_tpu/models/text_encoders/clip.py``).

Hand-ported: the card's machine has no ``transformers``. Parameter names are
``transformers``' ``CLIPTextModelWithProjection`` and ``CLIPVisionModel``
names (the vision tower's ``pre_layrnorm`` spelling included), so a
transformers checkpoint imports with no renames. The text tower covers
CLIP-L (quick-GELU) and OpenCLIP-bigG (exact GELU) via config and returns
the final and penultimate hidden states and the projected EOS embedding.
The vision tower is the ViT-H/14 of Wan2.1-I2V's image stream and of the
native PickScore reward: OpenAI-CLIP pixel normalisation, a bias-free patch
convolution, the class token and position table, an fp32 pre-LN, the
text tower's blocks with no mask, and the optional post-LN; it returns the
fp32 states of every token. LayerNorms are flax's fast-variance form
(``max(0, E[x^2] - E[x]^2)``), not ``F.layer_norm``'s two-pass variance.
Attention is the plain masked product of the JAX ``CLIPBlock`` (head dim
64 or 80), not a flash kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear, NormParams, flax_layer_norm, merge_heads, split_heads

#: OpenAI-CLIP pixel normalisation
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


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


# ---------------------------------------------------------------------------
# The vision tower (JAX ``CLIPVisionConfig`` / ``CLIPVisionEncoder``, clip.py:157-218)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_dim: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    hidden_act: str = "gelu"
    #: the final LayerNorm (the contrastive pooling wants it; Wan's image
    #: stream reads the block stack's output without it)
    use_post_ln: bool = False
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def num_tokens(self) -> int:
        """The class token and one a patch."""
        return (self.image_size // self.patch_size) ** 2 + 1

    @staticmethod
    def vit_h14(**o) -> "CLIPVisionConfig":
        return CLIPVisionConfig(**o)

    @staticmethod
    def tiny(**o) -> "CLIPVisionConfig":
        base = dict(image_size=16, patch_size=8, hidden_dim=32, num_layers=2, num_heads=4)
        base.update(o)
        return CLIPVisionConfig(**base)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        D, P = cfg.hidden_dim, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.patch_embedding = nn.Conv2d(3, D, P, stride=P, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_tokens, D)
        self.position_embedding.init_std = 0.02

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 0.02, generator=generator)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = NormParams(cfg.hidden_dim)
        self.encoder = CLIPEncoder(cfg)
        if cfg.use_post_ln:
            self.post_layernorm = NormParams(cfg.hidden_dim)


class CLIPVisionEncoder(nn.Module):
    """(B, 3, H, W) pixels in [0, 1] at ``image_size`` → (B, L, D) fp32 token
    states (the class token first), through the post-LN only with
    ``use_post_ln``."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.compute_dtype
        vm = self.vision_model
        emb = vm.embeddings
        mean = torch.tensor(CLIP_IMAGE_MEAN, device=pixels.device).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_IMAGE_STD, device=pixels.device).reshape(1, 3, 1, 1)
        x = F.conv2d(((pixels.float() - mean) / std).to(dt), emb.patch_embedding.weight.to(dt),
                     stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, h·w, D), row-major patches as the flax NHWC conv gives
        B, _, D = x.shape
        x = torch.cat([emb.class_embedding.to(dt).expand(B, 1, D), x], dim=1)
        x = x + emb.position_embedding.weight.to(dt)[None]
        x = flax_layer_norm(x, vm.pre_layrnorm, cfg.layer_norm_eps).to(dt)
        keep_all = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=x.device)
        for layer in vm.encoder.layers:
            x = layer(x, keep_all)
        if cfg.use_post_ln:
            x = flax_layer_norm(x, vm.post_layernorm, cfg.layer_norm_eps)
        return x.float()
