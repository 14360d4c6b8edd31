"""Qwen2.5-VL vision tower (port of ``flow_factory_tpu/models/text_encoders/vl_vision.py``).

Qwen-Image-Edit-Plus feeds each condition image through the VLM's vision
tower into the LM's token stream. The host side is the Qwen2-VL image
processor's contract, copied from the JAX package (numpy only):
``smart_resize``, the bilinear resize, ``preprocess_vision_image`` (CLIP
normalisation, the frame tiled to the temporal patch of 2, patches
flattened merge-group major), ``window_layout`` (the window re-ordering,
its undo and the block-diagonal mask) and ``rot_pos_ids``.

The tower, one image a call: a bias-free patch projection (the upstream
conv3d as a linear over the flattened patch), 2-D rotary embeddings over
the (h, w) patch coordinates, pre-norm blocks (RMSNorm, fused-qkv attention
with bias, SwiGLU with biases) whose attention is windowed (8 x 8 patches)
but at ``fullatt_block_indexes``, then the merger (RMSNorm, the 2 x 2 merge
groups flattened, a GELU MLP) and the undo of the window order. Parameter
names are the upstream ``visual`` module's, without the prefix. The
windowed attention is the JAX package's plain masked product (fp32 logits,
the mask as -1e30, an fp32 softmax rounded to the compute dtype before PV),
computed outside any kernel as the JAX package computes it: at head dim 80
it is no kernel's shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Linear
from .lm import RMSNorm

# CLIP normalization (Qwen2-VL image processor defaults)
_VL_MEAN = np.asarray((0.48145466, 0.4578275, 0.40821073), np.float32)
_VL_STD = np.asarray((0.26862954, 0.26130258, 0.27577711), np.float32)


@dataclass(frozen=True)
class VLVisionConfig:
    hidden_dim: int = 1280
    out_dim: int = 3584  # the LM's hidden size (Qwen2.5-VL-7B)
    depth: int = 32
    num_heads: int = 16
    mlp_dim: int = 3420
    patch_size: int = 14
    temporal_patch_size: int = 2
    merge_size: int = 2
    window_size: int = 112  # pixels: 8 patches, 4 merged positions
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rope_theta: float = 10000.0
    in_channels: int = 3
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @staticmethod
    def qwen25_vl(**o) -> "VLVisionConfig":
        return VLVisionConfig(**o)

    @staticmethod
    def tiny(**o) -> "VLVisionConfig":
        base = dict(hidden_dim=32, out_dim=32, depth=2, num_heads=4, mlp_dim=64, fullatt_block_indexes=(1,))
        base.update(o)
        return VLVisionConfig(**base)


# ---------------------------------------------------------------------------
# Host-side preprocessing (the Qwen2VLImageProcessor contract)
# ---------------------------------------------------------------------------

def smart_resize(h: int, w: int, factor: int, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Round (h, w) to multiples of ``factor`` within the pixel budget."""
    hb = max(factor, round(h / factor) * factor)
    wb = max(factor, round(w / factor) * factor)
    if hb * wb > max_pixels:
        beta = math.sqrt((h * w) / max_pixels)
        hb = math.floor(h / beta / factor) * factor
        wb = math.floor(w / beta / factor) * factor
    elif hb * wb < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        hb = math.ceil(h * beta / factor) * factor
        wb = math.ceil(w * beta / factor) * factor
    return int(hb), int(wb)


def _bilinear_resize_chw(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    C, H, W = img.shape
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :]
    a = img[:, y0][:, :, x0]
    b = img[:, y0][:, :, x1]
    c = img[:, y1][:, :, x0]
    d = img[:, y1][:, :, x1]
    return ((a * (1 - wx) + b * wx) * (1 - wy) + (c * (1 - wx) + d * wx) * wy).astype(np.float32)


def preprocess_vision_image(img_chw: np.ndarray, cfg: VLVisionConfig, max_area: int = 384 * 384
                            ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """(C, H, W) float [0, 1] → (n_patches, patch_dim) flattened patches and
    the grid (t, h, w): an aspect-preserving resize to about ``max_area``
    rounded to multiples of patch x merge, CLIP normalisation, the frame
    tiled to the temporal patch, the upstream flatten order (merge-group
    major)."""
    C, H, W = img_chw.shape
    factor = cfg.patch_size * cfg.merge_size
    tgt_h = math.sqrt(max_area * (H / W))
    tgt_w = tgt_h * W / H
    rh, rw = smart_resize(int(round(tgt_h)), int(round(tgt_w)), factor)
    img = _bilinear_resize_chw(img_chw.astype(np.float32), rh, rw)
    img = (img - _VL_MEAN[:, None, None]) / _VL_STD[:, None, None]
    patches = np.tile(img[None], (cfg.temporal_patch_size, 1, 1, 1))  # (T, C, H, W)
    grid_t = 1
    grid_h, grid_w = rh // cfg.patch_size, rw // cfg.patch_size
    m, p = cfg.merge_size, cfg.patch_size
    patches = patches.reshape(grid_t, cfg.temporal_patch_size, C, grid_h // m, m, p, grid_w // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, cfg.patch_dim)
    return flat.astype(np.float32), (grid_t, grid_h, grid_w)


def window_layout(grid_thw: Tuple[int, int, int], cfg: VLVisionConfig):
    """The window re-ordering of one image (upstream ``get_window_index``):
    ``patch_perm`` (L,) puts each 2 x 2 merge group's patches together and
    the groups window by window; ``inv_perm`` undoes it on the merged
    sequence (merged row-major order out); ``window_mask`` (L, L) is the
    block-diagonal mask of the windowed layers (True: may attend)."""
    t, h, w = grid_thw
    m = cfg.merge_size
    hm, wm = h // m, w // m
    win = cfg.window_size // (cfg.patch_size * m)  # merged positions a window side
    order, win_sizes = [], []
    for wy in range(0, hm, win):
        for wx in range(0, wm, win):
            n = 0
            for y in range(wy, min(wy + win, hm)):
                for x in range(wx, min(wx + win, wm)):
                    order.append(y * wm + x)
                    n += 1
            win_sizes.append(n)
    order = np.asarray(order, np.int64)
    patch_perm = np.empty(h * w, np.int64)
    k = 0
    for mi in order:
        for d in range(m * m):
            patch_perm[k] = int(mi) * m * m + d
            k += 1
    inv_perm = np.argsort(order)
    L = h * w
    mask = np.zeros((L, L), bool)
    start = 0
    for n in win_sizes:
        span = n * m * m
        mask[start: start + span, start: start + span] = True
        start += span
    return patch_perm, inv_perm, mask


def rot_pos_ids(grid_thw: Tuple[int, int, int], merge_size: int = 2) -> np.ndarray:
    """(L, 2) (h, w) coordinates of each patch in the merge-group-major
    order the processor emits (upstream ``rot_pos_emb``)."""
    t, h, w = grid_thw
    m = merge_size
    hh = np.broadcast_to(np.arange(h).reshape(h // m, m, 1, 1), (h // m, m, w // m, m))
    ww = np.broadcast_to(np.arange(w).reshape(1, 1, w // m, m), (h // m, m, w // m, m))
    hh = hh.transpose(0, 2, 1, 3).reshape(-1)
    ww = ww.transpose(0, 2, 1, 3).reshape(-1)
    out = np.stack([hh, ww], axis=1).astype(np.float32)
    return np.tile(out, (t, 1))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _VLAttention(nn.Module):
    def __init__(self, cfg: VLVisionConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.heads, self.head_dim, self.dtype = cfg.num_heads, cfg.head_dim, dt
        self.qkv = Linear(D, 3 * D, compute_dtype=dt)
        self.proj = Linear(D, D, compute_dtype=dt)

    def forward(self, x, cos, sin, mask):
        L = x.shape[0]
        H, E, dt = self.heads, self.head_dim, self.dtype
        q, k, v = self.qkv(x).view(L, 3, H, E).unbind(1)  # (L, H, E) each

        def rope(t):  # half-split rotation on the concatenated (h, w) frequencies, fp32
            t1, t2 = t.float().chunk(2, dim=-1)
            return (t.float() * cos[:, None] + torch.cat([-t2, t1], dim=-1) * sin[:, None]).to(t.dtype)

        q, k = rope(q).transpose(0, 1), rope(k).transpose(0, 1)  # (H, L, E)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (E ** -0.5)
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1).to(dt)
        o = torch.matmul(p, v.transpose(0, 1).to(dt)).transpose(0, 1).reshape(L, H * E)
        return self.proj(o)


class _VLMLP(nn.Module):
    def __init__(self, cfg: VLVisionConfig):
        super().__init__()
        D, dt = cfg.hidden_dim, cfg.compute_dtype
        self.gate_proj = Linear(D, cfg.mlp_dim, compute_dtype=dt)
        self.up_proj = Linear(D, cfg.mlp_dim, compute_dtype=dt)
        self.down_proj = Linear(cfg.mlp_dim, D, compute_dtype=dt)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class VLVisionBlock(nn.Module):
    """Pre-norm block: RMSNorm, fused-qkv rotary attention under ``mask``,
    RMSNorm, SwiGLU; both with biases."""

    def __init__(self, cfg: VLVisionConfig):
        super().__init__()
        self.norm1 = RMSNorm(cfg.hidden_dim)
        self.attn = _VLAttention(cfg)
        self.norm2 = RMSNorm(cfg.hidden_dim)
        self.mlp = _VLMLP(cfg)

    def forward(self, x, cos, sin, mask):
        x = x + self.attn(self.norm1(x), cos, sin, mask)
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: VLVisionConfig):
        super().__init__()
        self.proj = Linear(cfg.patch_dim, cfg.hidden_dim, bias=False, compute_dtype=cfg.compute_dtype)


class _Merger(nn.Module):
    def __init__(self, cfg: VLVisionConfig):
        super().__init__()
        g = cfg.merge_size ** 2 * cfg.hidden_dim
        self.ln_q = RMSNorm(cfg.hidden_dim)
        self.mlp = nn.ModuleList([Linear(g, g, compute_dtype=cfg.compute_dtype), nn.Identity(),
                                  Linear(g, cfg.out_dim, compute_dtype=cfg.compute_dtype)])

    def forward(self, x: torch.Tensor, merge_size: int) -> torch.Tensor:
        x = self.ln_q(x)
        x = x.reshape(x.shape[0] // merge_size ** 2, -1)  # merge groups are contiguous after the re-order
        return self.mlp[2](F.gelu(self.mlp[0](x)))


class VLVisionTower(nn.Module):
    """One image a call: ``forward(patches (L, patch_dim), pos_hw (L, 2),
    patch_perm (L,), window_mask (L, L), inv_perm (L / merge²,))`` → merged
    embeddings (L / merge², out_dim) in fp32, merged row-major order; the
    index inputs are the host functions' for the image's grid."""

    def __init__(self, cfg: VLVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.blocks = nn.ModuleList([VLVisionBlock(cfg) for _ in range(cfg.depth)])
        self.merger = _Merger(cfg)

    def forward(self, patches, pos_hw, patch_perm, window_mask, inv_perm) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed.proj(patches.to(cfg.compute_dtype))
        half = cfg.head_dim // 2  # rotary dims a token: half on h, half on w
        inv_freq = torch.as_tensor(1.0 / (cfg.rope_theta ** (np.arange(0, half, 2) / half)), dtype=torch.float32,
                                   device=x.device)
        pos_hw = pos_hw.float()
        freqs = torch.cat([pos_hw[:, 0:1] * inv_freq[None], pos_hw[:, 1:2] * inv_freq[None]], dim=-1)
        emb = torch.cat([freqs, freqs], dim=-1)  # (L, head_dim)
        cos, sin = torch.cos(emb)[patch_perm], torch.sin(emb)[patch_perm]
        x = x[patch_perm]
        full = torch.ones_like(window_mask)
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, full if i in cfg.fullatt_block_indexes else window_mask)
        return self.merger(x, cfg.merge_size)[inv_perm].float()
