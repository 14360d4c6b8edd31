"""Wan image→video and video→video adapters (port of ``flow_factory_tpu/models/wan/i2v.py``).

Conditioning is channel concatenation in latent space (Wan's "y" tensor):
the condition media is VAE-encoded, placed on its temporal span (the first
latent frame for I2V, optionally the last too; the whole clip for V2V),
zero elsewhere, and concatenated with a binary presence-mask channel to the
denoised latents before the patch embedding, whose ``in_channels`` widens
by ``latent_channels + 1``. CFG, the UniPC-SDE scheduler and the Wan2.2
MoE come from the T2V adapter.

Wan2.2-TI2V-5B (``expand_timesteps``) conditions instead by replacement:
latent frame 0 of what the transformer sees is the clean encoded image and
its tokens ride t = 0 through per-frame timesteps, while the SDE step
evolves the raw latents (frame 0 included, as in the JAX package); the
decode composites the clean frame back in.

Wan2.1-I2V-14B (``use_image_encoder``) also reads the condition image
through the CLIP ViT-H/14 tower (``image_encoder``, no post-LN; ``tiny``
for the tiny variant): resized bilinearly to 224 px, its 257 token states
(``image_embeds``, host fp32 like the text context, cast to the compute
dtype at use) ride every step's embeds and every sample, and the DiT's
image cross-attention stream reads them (JAX ``i2v.py:73-105, 139-151``).
The CLIP tower imports from no checkpoint subfolder, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...samples import I2VSample, V2VSample
from ...utils.base import make_generator
from ...utils.media import resize_bilinear, standardize_image_batch, standardize_video_batch
from ..layers import build_module
from ..text_encoders.clip import CLIPVisionConfig, CLIPVisionEncoder
from .t2v import WanT2VAdapter
from .transformer import WanConfig
from .video_vae import VideoVAEConfig


def _first_images(images: Sequence[Any]) -> List[Any]:
    """A batch's condition images: each record's first where it holds a list."""
    return [im[0] if isinstance(im, (list, tuple)) else im for im in images]


class WanI2VAdapter(WanT2VAdapter):
    """First-frame-conditioned video generation."""

    sample_class = I2VSample
    embed_keys = ("prompt_embeds", "negative_prompt_embeds", "cond_latents")

    def transformer_config(self, cfg: WanConfig, vae: VideoVAEConfig, declared_width: bool = False) -> WanConfig:
        ma = self.model_args
        # Wan2.2-TI2V-5B: no widening, no mask channel, no CLIP tower (JAX i2v.py:44-52)
        self.expand_timesteps = bool(getattr(ma, "expand_timesteps", False))
        self._ti2v_cond: Optional[np.ndarray] = None
        self.use_image_encoder = not self.expand_timesteps and bool(getattr(ma, "use_image_encoder", False))
        if self.expand_timesteps:
            return cfg
        if self.use_image_encoder:  # Wan2.1's CLIP image stream (JAX i2v.py:73-90)
            variant = getattr(ma, "variant", None) or ("tiny" if ma.model_name_or_path in ("", "tiny") else "1.3b")
            make = CLIPVisionConfig.tiny if variant == "tiny" else CLIPVisionConfig.vit_h14
            self.vision_config = make(dtype=ma.inference_dtype)
            self.embed_keys = tuple(self.embed_keys) + ("image_embeds",)
        vis = self.vision_config if self.use_image_encoder else None
        cfg = dataclasses.replace(cfg, image_context_tokens=vis.num_tokens if vis else 0,
                                  image_context_dim=vis.hidden_dim if vis else 0)
        if declared_width:  # a checkpoint's config.json gives the widened input (JAX :59-66)
            return cfg
        return dataclasses.replace(cfg, in_channels=cfg.in_channels + vae.latent_channels + 1)

    def load_models(self) -> None:
        super().load_models()
        if self.use_image_encoder:
            wanted = getattr(self.model_args, "load_components", None)
            self.component_configs["image_encoder"] = vis = self.vision_config
            if not wanted or "image_encoder" in set(wanted):
                self.modules["image_encoder"] = build_module(
                    lambda: CLIPVisionEncoder(vis), self.device, self.inference_dtype,
                    make_generator(self.device, "wan_init", self.training_args.seed, "image_encoder"))

    @torch.no_grad()
    def encode_image_clip(self, images: Sequence[Any]) -> np.ndarray:
        """Condition images (each record's first) → the CLIP tower's token
        states (B, 257, 1280), host fp32: the images resized bilinearly (with
        JAX's antialias) to the tower's size."""
        if "image_encoder" not in self.modules:
            raise RuntimeError("image_encoder was not loaded (load_components); cannot encode images")
        size = self.vision_config.image_size
        pixels = resize_bilinear(self._on_device(standardize_image_batch(_first_images(images))), size, size)
        return self.modules["image_encoder"](pixels).cpu().numpy()

    # ------------------------------------------------------------------
    # Conditions
    # ------------------------------------------------------------------
    def build_condition(self, images: Sequence[Any], num_frames: int, height: int, width: int,
                        last_images: Optional[Sequence[Any]] = None) -> np.ndarray:
        """First-frame conditioning, host fp32: (B, T', h, w, c + 1), the
        encoded image on latent frame 0 with the mask channel 1 there, and
        with ``last_images`` the last frame pinned too (FLF2V); under
        ``expand_timesteps`` (B, T', h, w, c), the clean latent that replaces
        frame 0."""
        lat = self.encode_video(standardize_image_batch(_first_images(images))[:, None])  # (B, 1, h, w, c)
        tl, h, w, c = self.latent_shape(height, width, num_frames)
        B = lat.shape[0]
        if self.expand_timesteps:
            cond = np.zeros((B, tl, h, w, c), np.float32)
            cond[:, :1] = lat[:, :1]
            return cond
        cond = np.zeros((B, tl, h, w, c + 1), np.float32)
        cond[:, :1, ..., :c] = lat[:, :1]
        cond[:, :1, ..., c] = 1.0
        if last_images is not None:
            last = self.encode_video(standardize_image_batch(_first_images(last_images))[:, None])
            cond[:, -1:, ..., :c] = last[:, :1]
            cond[:, -1:, ..., c] = 1.0
        return cond

    # ------------------------------------------------------------------
    # Velocity and decode
    # ------------------------------------------------------------------
    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        cond = embeds["cond_latents"].to(latents.dtype)
        sub = {k: v for k, v in embeds.items() if k != "cond_latents"}
        if self.expand_timesteps:
            # the composite (clean frame 0, noisy rest) at per-frame t, 0 on frame 0
            fmask = torch.ones((1, latents.shape[1], 1, 1, 1), dtype=latents.dtype, device=latents.device)
            fmask[:, 0] = 0.0
            x = (1.0 - fmask) * cond + fmask * latents
            t_frames = t[:, None] * fmask[0, :, 0, 0, 0][None, :].to(t.dtype)
            return super()._velocity(x, t_frames, sub, guidance_scale, do_cfg, params)
        x = torch.cat([latents, cond], dim=-1)
        return super()._velocity(x, t, sub, guidance_scale, do_cfg, params)[..., : self.latent_channels]

    def decode_latents(self, latents, num_frames=None, fetch=True):
        """TI2V composites the clean conditioned frame back before decoding."""
        if self.expand_timesteps and self._ti2v_cond is not None:
            latents = self._on_device(latents).clone()
            latents[:, 0] = self._on_device(self._ti2v_cond[:, 0])
        return super().decode_latents(latents, num_frames=num_frames, fetch=fetch)

    # ------------------------------------------------------------------
    # Rollout and preprocessing
    # ------------------------------------------------------------------
    def inference(self, images=None, cond_latents=None, last_images=None, image_embeds=None,
                  **kwargs) -> List[I2VSample]:
        """:meth:`WanT2VAdapter.inference` with the condition latents (built
        from ``images`` when not given) among the embeds, and with the image
        stream its ``image_embeds`` (encoded from ``images`` when not given);
        each sample keeps its ``cond_latents``, ``image_embeds`` and its
        condition image."""
        ta = self.training_args
        num_frames = kwargs.get("num_frames") or int(getattr(ta, "num_frames", 5))
        height = kwargs.get("height") or ta.height
        width = kwargs.get("width") or ta.width
        if cond_latents is None and images is not None:
            cond_latents = self.build_condition(images, num_frames, height, width, last_images=last_images)
        if cond_latents is None:
            raise ValueError("WanI2VAdapter.inference needs images or cond_latents")
        extra = {"cond_latents": np.asarray(cond_latents, np.float32)}
        if self.use_image_encoder:
            if image_embeds is None and images is not None:
                image_embeds = self.encode_image_clip(images)
            if image_embeds is None:
                raise ValueError("use_image_encoder needs images or image_embeds")
            extra["image_embeds"] = np.asarray(image_embeds, np.float32)
        if self.expand_timesteps:
            self._ti2v_cond = extra["cond_latents"]
        try:
            samples = super().inference(extra_embeds=extra, **kwargs)
        finally:
            self._ti2v_cond = None
        if images is not None:
            for s, im in zip(samples, _first_images(images)):
                s.images = [standardize_image_batch([im])[0]]
                s._unique_id = None
        return samples

    def preprocess_func(self, batch: Dict[str, Any], **kwargs) -> Dict[str, np.ndarray]:
        """The prompt embeddings, and for records with images their
        ``cond_latents`` and with the image stream their ``image_embeds``."""
        out = super().preprocess_func(batch, **kwargs)
        images = batch.get("images") or batch.get("image")
        if images is not None:
            ta = self.training_args
            out["cond_latents"] = self.build_condition(images, int(getattr(ta, "num_frames", 5)), ta.height, ta.width)
            if self.use_image_encoder:
                out["image_embeds"] = self.encode_image_clip(images)
        return out


class WanV2VAdapter(WanI2VAdapter):
    """Video-conditioned video generation (the whole clip conditions)."""

    sample_class = V2VSample

    def build_condition(self, videos: Sequence[Any], num_frames: int, height: int, width: int) -> np.ndarray:
        """(B, T', h, w, c + 1): the encoded clip over its latent span with
        the mask channel 1 there, zeros past it."""
        lat = self.encode_video(standardize_video_batch(list(videos)))  # (B, Tl, h, w, c)
        tl, h, w, c = self.latent_shape(height, width, num_frames)
        cond = np.zeros((lat.shape[0], tl, h, w, c + 1), np.float32)
        span = min(tl, lat.shape[1])
        cond[:, :span, ..., :c] = lat[:, :span]
        cond[:, :span, ..., c] = 1.0
        return cond

    def inference(self, condition_video=None, images=None, cond_latents=None, **kwargs) -> List[V2VSample]:
        ta = self.training_args
        num_frames = kwargs.get("num_frames") or int(getattr(ta, "num_frames", 5))
        height = kwargs.get("height") or ta.height
        width = kwargs.get("width") or ta.width
        if cond_latents is None and condition_video is not None:
            cond_latents = self.build_condition(condition_video, num_frames, height, width)
        if cond_latents is None:
            raise ValueError("WanV2VAdapter.inference needs condition_video or cond_latents")
        samples = WanT2VAdapter.inference(
            self, extra_embeds={"cond_latents": np.asarray(cond_latents, np.float32)}, **kwargs)
        if condition_video is not None:
            for s, video in zip(samples, condition_video):
                s.condition_video = standardize_video_batch([video])[0]
                s._unique_id = None
        return samples

    def preprocess_func(self, batch: Dict[str, Any], **kwargs) -> Dict[str, np.ndarray]:
        out = WanT2VAdapter.preprocess_func(self, batch, **kwargs)
        videos = batch.get("condition_video") or batch.get("video")
        if videos is not None:
            ta = self.training_args
            out["cond_latents"] = self.build_condition(videos, int(getattr(ta, "num_frames", 5)), ta.height, ta.width)
        return out
