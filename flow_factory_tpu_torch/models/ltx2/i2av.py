"""LTX-2 image→audio-video adapter (port of ``flow_factory_tpu/models/ltx2/i2av.py``).

The condition image is VAE-encoded and planted in the first latent frame's
tokens of the initial latents, with a binary ``cond_mask`` (B, Lv, 1). The
planted tokens are put back before every forward, modulate at t = 0 (the
t/0 interpolation of the binary mask, or with ``per_token_time`` every
token's own t·(1 − mask)), never step and stay out of the log-prob
(:meth:`token_mask`). A fractional mask (the reference's ``noise_scale``)
turns ``per_token_time`` on and plants clean·m + noise·(1 − m), the noise
from a numpy generator seeded as the JAX adapter seeds it. Everything else
is the T2AV adapter's.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ...samples import I2AVSample
from ...utils.media import standardize_image_batch
from .t2av import LTX2T2AVAdapter

logger = logging.getLogger(__name__)


class LTX2I2AVAdapter(LTX2T2AVAdapter):
    sample_class = I2AVSample
    embed_keys = ("prompt_embeds", "negative_prompt_embeds", "video_ids", "audio_ids", "cond_mask", "cond_tokens")

    @torch.no_grad()
    def encode_first_frame(self, images: Sequence[Any], height: int, width: int,
                           num_frames: int) -> Tuple[np.ndarray, np.ndarray]:
        """Images → (video tokens with the first latent frame's tokens set,
        zero elsewhere; the mask of those tokens), host fp32."""
        arr = standardize_image_batch([im[0] if isinstance(im, (list, tuple)) else im for im in images])
        video = self._on_device(arr)[:, :, None] * 2.0 - 1.0  # (B, 3, 1, H, W)
        lat = self.modules["vae"].encode(video).float().cpu().numpy()  # (B, 1, h, w, C)
        tl, h, w = self.video_token_geometry(height, width, num_frames)
        B = lat.shape[0]
        tokens = np.zeros((B, tl * h * w, self.video_latent_channels), np.float32)
        tokens[:, : h * w] = lat[:, 0].reshape(B, h * w, -1)[..., : self.video_latent_channels]
        mask = np.zeros((B, tl * h * w, 1), np.float32)
        mask[:, : h * w] = 1.0
        return tokens, mask

    def _joint_velocity(self, params, v_lat, a_lat, t, embeds, guidance_scale: float, do_cfg: bool):
        if "cond_tokens" in embeds:  # the planted tokens, put back whole even under a fractional mask
            m = (embeds["cond_mask"] > 0.0).float()
            v_lat = v_lat * (1.0 - m) + embeds["cond_tokens"] * m
            embeds = {k: v for k, v in embeds.items() if k != "cond_tokens"}
        return super()._joint_velocity(params, v_lat, a_lat, t, embeds, guidance_scale, do_cfg)

    def inference(self, images=None, cond_tokens=None, cond_mask=None, **kwargs):
        ta = self.training_args
        height = kwargs.get("height") or ta.height
        width = kwargs.get("width") or ta.width
        num_frames = kwargs.get("num_frames") or int(getattr(ta, "num_frames", 5))
        extra = dict(kwargs.pop("extra_embeds", None) or {})
        if cond_tokens is None and images is not None:
            cond_tokens, cond_mask = self.encode_first_frame(images, height, width, num_frames)
        if cond_tokens is None:
            raise ValueError("LTX2I2AVAdapter.inference needs images or cond_tokens")
        cm_np = np.asarray(cond_mask, np.float32)
        clean = np.asarray(cond_tokens, np.float32)
        planted = clean
        if not np.all((cm_np == 0.0) | (cm_np == 1.0)):
            # a fractional mask needs the exact per-token timestep embedding
            if not self.per_token_time:
                if ta.extra_kwargs.get("per_token_time") is False:
                    raise ValueError("Non-binary cond_mask with `per_token_time: false`: the t/0 modulation "
                                     "interpolation is only exact for binary masks. Remove the explicit "
                                     "`per_token_time: false` (or binarize the mask) to proceed.")
                logger.warning("Non-binary cond_mask: turning per_token_time on (the exact per-token timestep "
                               "embedding); samples rolled out before under the binary path replay under it")
                ta.extra_kwargs["per_token_time"] = True
            # planted (and frozen) at clean·m + noise·(1 − m), the noise from the seed
            rng = np.random.default_rng(np.uint64(int(kwargs.get("seed") or ta.seed or 0) + 0x12A5))
            noise = rng.standard_normal(clean.shape).astype(np.float32)
            planted = np.where(cm_np > 0.0, clean * cm_np + noise * (1.0 - cm_np), 0.0).astype(np.float32)
        extra["cond_tokens"] = planted
        extra["cond_mask"] = cm_np
        samples = super().inference(extra_embeds=extra, **kwargs)
        for i, s in enumerate(samples):
            s.extra_kwargs["cond_mask"] = cm_np[i]
            if images is not None:
                s.images = [standardize_image_batch(images[i:i + 1] if not isinstance(images[i], (list, tuple))
                                                    else images[i][:1])[0]]
                s._unique_id = None
            # the group key hashes the clean tokens (a per-seed noise blend
            # must not split groups); replay reads the planted ones
            s.extra_kwargs["cond_tokens"] = clean[i]
            s.unique_id  # noqa: B018 — computed and cached before the swap
            s.extra_kwargs["cond_tokens"] = planted[i]
        return samples

    def preprocess_func(self, batch: Dict[str, Any], **kwargs) -> Dict[str, np.ndarray]:
        out = super().preprocess_func(batch, **kwargs)
        images = batch.get("images") or batch.get("image")
        if images is not None:
            ta = self.training_args
            out["cond_tokens"], out["cond_mask"] = self.encode_first_frame(
                images, ta.height, ta.width, int(getattr(ta, "num_frames", 5)))
        return out
