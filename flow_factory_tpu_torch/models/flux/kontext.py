"""FLUX.1-Kontext adapter (port of ``flow_factory_tpu/models/flux/kontext.py``).

Image → image editing: each record's reference image(s) are VAE-encoded
(the posterior mean), packed, and concatenated after the target's tokens;
their RoPE ids carry the first-axis coordinate 1 + r for reference r, so
attention tells target from condition tokens; the velocity is read off the
target slice only. A record may hold several references (the
``multi_ref_image`` dataset); ragged counts are zero-padded to the batch's
longest with ids of −1 and no mask.

As in the JAX package, the velocity takes the condition ids of the batch's
first row for every row (``cond_ids[0]``): rows whose references differ in
count or size are replayed under row 0's ids (ROADMAP Queue 3, F13). There
is no pipelined ``finish_rollout`` yet, so the per-sample step runs inline.
Qwen-Image-Edit-Plus shares the condition tokens (:class:`ConditionTokens`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...samples import I2ISample
from ...utils.media import standardize_image_batch
from .adapter import Flux1Adapter


def _pad_cond_rows(lat_rows: Sequence[np.ndarray], id_rows: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged per-record condition tokens to the batch's longest: zero
    tokens with ids of −1 (a coordinate no real token has), no mask."""
    max_len = max(r.shape[0] for r in lat_rows)
    lats, ids = [], []
    for lat, rid in zip(lat_rows, id_rows):
        pad = max_len - lat.shape[0]
        if pad:
            lat = np.concatenate([lat, np.zeros((pad, lat.shape[1]), lat.dtype)], axis=0)
            rid = np.concatenate([rid, np.full((pad, 3), -1.0, np.float32)], axis=0)
        lats.append(lat)
        ids.append(rid)
    return np.stack(lats), np.stack(ids)


class ConditionTokens:
    """Condition images as latent tokens after the target's (Kontext, and
    Qwen-Image-Edit-Plus over its own velocity): a mixin before a packed-
    latent adapter in the bases. ``cond_latents``/``cond_ids`` ride the
    embeds; the velocity concatenates them after the target's tokens, the
    ids of the batch's first row for every row (F13), and reads the target
    slice out."""

    @torch.no_grad()
    def encode_image(self, images_nchw: np.ndarray) -> np.ndarray:
        """(B, 3, H, W) in [0, 1] → packed latent tokens (B, L, 4c), host fp32."""
        img = torch.as_tensor(np.asarray(images_nchw, np.float32), device=self.device)
        z = self.modules["vae"].encode(img * 2.0 - 1.0, sample=False)
        return self.pack_latents(z.permute(0, 2, 3, 1).float()).cpu().numpy()

    def condition_tokens(self, images: Sequence[Any]) -> Tuple[np.ndarray, np.ndarray]:
        """Each record's references encoded and packed one after another
        (``cond_latents``) with their ids (``cond_ids``: first coordinate
        1 + r for reference r), padded to the batch's longest."""
        lat_rows, id_rows = [], []
        for per_record in images:
            refs = per_record if isinstance(per_record, list) else [per_record]
            toks, ids = [], []
            for r_i, ref in enumerate(refs):
                arr = standardize_image_batch(ref, output_type="np")  # (1, 3, H, W)
                toks.append(self.encode_image(arr)[0])
                rid = self.latent_image_ids(arr.shape[2] // self.vae_downscale,
                                            arr.shape[3] // self.vae_downscale).copy()
                rid[:, 0] = 1.0 + r_i  # the condition stream's coordinate
                ids.append(rid)
            lat_rows.append(np.concatenate(toks, axis=0))
            id_rows.append(np.concatenate(ids, axis=0).astype(np.float32))
        return _pad_cond_rows(lat_rows, id_rows)

    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        if "cond_latents" not in embeds:
            return super()._velocity(latents, t, embeds, guidance_scale, do_cfg, params)
        L = latents.shape[1]
        img_ids, cond_ids = embeds["img_ids"], embeds["cond_ids"]
        img_ids = img_ids[0] if img_ids.ndim == 3 else img_ids
        cond_ids = cond_ids[0] if cond_ids.ndim == 3 else cond_ids  # row 0's for every row (F13)
        x = torch.cat([latents, embeds["cond_latents"].to(latents.dtype)], dim=1)
        joint = {**embeds, "img_ids": torch.cat([img_ids, cond_ids], dim=0)}
        return super()._velocity(x, t, joint, guidance_scale, do_cfg, params)[:, :L]

    @staticmethod
    def keep_condition_images(samples, images) -> None:
        """Each sample keeps its record's reference images (its group
        identity recomputed with them)."""
        for s, per in zip(samples, images):
            s.images = [standardize_image_batch(p, output_type="np")[0]
                        for p in (per if isinstance(per, list) else [per])]
            s._unique_id = None


class Flux1KontextAdapter(ConditionTokens, Flux1Adapter):
    sample_class = I2ISample
    embed_keys = ("prompt_embeds", "pooled_prompt_embeds", "img_ids", "txt_ids", "cond_latents", "cond_ids")

    def preprocess_func(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        """The prompt embeddings, and for records with images their
        :meth:`condition_tokens`."""
        out = super().preprocess_func(batch, **kwargs)
        images = batch.get("images") or batch.get("image")
        if images is not None:
            out["cond_latents"], out["cond_ids"] = self.condition_tokens(images)
        return out

    @torch.no_grad()
    def inference(self, images=None, cond_latents=None, cond_ids=None, **kwargs) -> List[I2ISample]:
        """The rollout with the condition tokens in every step's embeds:
        ``cond_latents``/``cond_ids`` as preprocessed, or encoded here from
        ``images``; each sample keeps its row of them, and with ``images``
        its reference images."""
        if cond_latents is None and images is not None:
            cond_latents, cond_ids = self.condition_tokens(images)
        extra = {}
        if cond_latents is not None:
            extra["cond_latents"] = np.asarray(cond_latents, np.float32)
            extra["cond_ids"] = np.asarray(cond_ids if cond_ids is not None else 0.0, np.float32)
        samples = super().inference(extra_embeds=extra, **kwargs)
        if cond_latents is not None and images is not None:
            self.keep_condition_images(samples, images)
        return samples
