"""The native CLIP dual-tower reward (port of ``flow_factory_tpu/rewards/clip_native.py``).

PickScore's and CLIPScore's architecture, CLIP-H/14, as the port's own
towers (``models/text_encoders/clip.py``) in fp32 on the card:

    score = exp(logit_scale) · cos(visual_projection(CLS of the ViT), text_projection(EOS))

one score a prompt-image pair; a video scores as the mean over its frames.
The images are resized bilinearly (with JAX's antialias) to the tower's 224
px on the device. Weights import from a local transformers CLIP / PickScore
directory (``vision_model.*``, ``text_model.*``, ``visual_projection``,
``logit_scale``; the port's names are transformers' own). Without one, the
towers are random-initialised on the device from a seeded generator, so the
whole path runs with nothing downloaded (the scores are stable, not
meaningful). ``model_name_or_path`` ``""`` or ``"tiny"`` gives the tiny
towers, as in the JAX package.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..models.layers import build_module
from ..models.text_encoders.clip import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder
from ..utils.base import make_generator, resolve_device
from ..utils.checkpoint import import_state_dict, load_safetensors_dir
from ..utils.media import resize_bilinear, standardize_image_batch
from ..utils.tokenizer import load_tokenizer
from .abc import PointwiseRewardModel

logger = logging.getLogger(__name__)


def clip_scores(vision: CLIPVisionEncoder, text: CLIPTextEncoder, visual_projection: torch.Tensor,
                logit_scale: torch.Tensor, pixels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B,) scores of B pixel batches (B, 3, S, S) in [0, 1] against B token-id
    rows: the normalised CLS projection and EOS projection, their cosine
    times exp(logit_scale) (JAX ``_score_impl``)."""
    img = vision(pixels)[:, 0] @ visual_projection
    img = img / torch.clamp(torch.linalg.vector_norm(img, dim=-1, keepdim=True), min=1e-6)
    txt = text(ids).pooled
    txt = txt / torch.clamp(torch.linalg.vector_norm(txt, dim=-1, keepdim=True), min=1e-6)
    return torch.exp(logit_scale) * torch.sum(img * txt, dim=-1)


class NativeCLIPReward(PointwiseRewardModel):
    """CLIP-H/14 image-text score on the device (``cuda`` unless ``device``
    asks for another: the CPU tests)."""

    required_fields = ("image", "video", "prompt")

    #: preset geometry (PickScore = CLIP-H/14)
    VISION = dict(image_size=224, patch_size=14, hidden_dim=1280, num_layers=32, num_heads=16)
    TEXT = dict(hidden_dim=1024, num_layers=24, num_heads=16, projection_dim=1024, hidden_act="gelu")

    def __init__(self, reward_args, device: Optional[str] = None):
        super().__init__(reward_args)
        self.device = device

    def setup(self) -> None:
        self.device = resolve_device(self.device)
        path = self.args.model_name_or_path
        tiny = bool(getattr(self.args, "tiny", False)) or path in ("", "tiny", None)
        if tiny:
            self.vision_cfg = CLIPVisionConfig.tiny(use_post_ln=True, dtype="float32")
            self.text_cfg = CLIPTextConfig.tiny(dtype="float32")
        else:
            self.vision_cfg = CLIPVisionConfig(use_post_ln=True, dtype="float32", **self.VISION)
            self.text_cfg = CLIPTextConfig(dtype="float32", **self.TEXT)
        gen = lambda part: make_generator(self.device, "clip_reward", 0, part)
        self.vision = build_module(lambda: CLIPVisionEncoder(self.vision_cfg), self.device, torch.float32,
                                   gen("vision"))
        self.text = build_module(lambda: CLIPTextEncoder(self.text_cfg), self.device, torch.float32, gen("text"))
        hidden, proj = self.vision_cfg.hidden_dim, self.text_cfg.projection_dim
        self.visual_projection = torch.randn((hidden, proj), generator=gen("projection"), device=self.device) \
            * hidden ** -0.5
        self.logit_scale = torch.tensor(math.log(100.0), device=self.device)
        if path and os.path.isdir(path):
            self._import_weights(path)
        self.tokenizer = load_tokenizer(path or "", "", self.text_cfg.vocab_size, self.text_cfg.max_positions,
                                        eos_token_id=self.text_cfg.eos_token_id)

    def _import_weights(self, path: str) -> None:
        """A transformers CLIP / PickScore directory's safetensors (JAX
        ``_import_weights``): each tower its own keys, then the visual
        projection (stored (proj, hidden)) and the logit scale."""
        sd = load_safetensors_dir(path)
        if not sd:
            logger.warning("NativeCLIPReward: no safetensors under %s", path)
            return
        import_state_dict(self.vision, sd, component="vision", unmatched_scope=r"vision_model\.")
        import_state_dict(self.text, sd, component="text", unmatched_scope=r"text_model\.|text_projection\.")
        if "visual_projection.weight" in sd:
            self.visual_projection = sd["visual_projection.weight"].T.to(self.device, torch.float32).contiguous()
        if "logit_scale" in sd:
            self.logit_scale = sd["logit_scale"].to(self.device, torch.float32).reshape(())
        logger.info("NativeCLIPReward: imported CLIP weights from %s", path)

    def _pixels(self, images: Sequence[Any]) -> torch.Tensor:
        s = self.vision_cfg.image_size
        arr = torch.from_numpy(standardize_image_batch(list(images))).to(self.device)
        return resize_bilinear(arr, s, s)

    @torch.no_grad()  # grad mode is a thread's own: an async worker starts with it on
    def compute_reward(self, prompt: Sequence[str], image=None, video=None, **_) -> np.ndarray:
        ids = np.asarray(self.tokenizer(list(prompt), max_length=self.text_cfg.max_positions)["input_ids"])
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        towers = (self.vision, self.text, self.visual_projection, self.logit_scale)
        if image is not None and image[0] is not None:
            return clip_scores(*towers, self._pixels(image), ids).double().cpu().numpy()
        out = []  # videos: the mean of the frames' scores
        for row, vid in zip(ids, video):
            frames = self._pixels(list(np.asarray(vid)))
            s = clip_scores(*towers, frames, row[None].expand(len(frames), -1))
            out.append(float(s.cpu().numpy().mean()))
        return np.asarray(out, np.float64)
