"""Qwen-Image-Edit-Plus adapter (port of ``flow_factory_tpu/models/qwen_image/edit_plus.py``).

Multi-reference image editing over Qwen-Image, with both of its
conditioning channels:

* latent concat: each record's references VAE-encoded, packed and
  concatenated after the target's tokens with offset ids
  (:class:`~..flux.kontext.ConditionTokens`, as FLUX.1-Kontext; the ids of
  the batch's first row serve every row, F15);
* vision-tower conditioning: each reference, resized to about the 384²
  encode area, runs through the Qwen2.5-VL vision tower (a component of its
  own); its merged tokens replace the image-pad embeddings that lead the
  prompt's tokens, with M-RoPE (t, h, w) ids, and the LM's states at the
  fixed length ``vl_total_length`` (the text length plus room for
  ``max_condition_images`` references) become ``prompt_embeds``. Negatives
  are encoded with the same images.

Under the HashTokenizer a row is [image pads][text tokens][padding]; the
vision embeddings replace the pads' embeddings either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...samples import I2ISample
from ...utils.checkpoint import VL_VISION_RENAMES, ComponentImport, qwen_vl_vision_preprocess
from ...utils.media import standardize_image_batch
from ..flux.kontext import ConditionTokens
from ..text_encoders import LMConfig
from ..text_encoders.vl_vision import (
    VLVisionConfig,
    VLVisionTower,
    preprocess_vision_image,
    rot_pos_ids,
    window_layout,
)
from .adapter import QwenImageAdapter

#: the vision tower's input area (the reference's CONDITION_IMAGE_SIZE_FOR_ENCODE)
CONDITION_ENCODE_AREA = 384 * 384


class QwenImageEditPlusAdapter(ConditionTokens, QwenImageAdapter):
    sample_class = I2ISample
    embed_keys = ("prompt_embeds", "negative_prompt_embeds", "img_ids", "txt_ids", "cond_latents", "cond_ids")

    def _preset(self, variant, attn_backend, dtype):
        preset = super()._preset(variant, attn_backend, dtype)
        lm = preset["lm"]
        if lm.hidden_dim < 256:  # tiny: M-RoPE sections summing to its head dim 8 / 2
            preset["lm"] = dataclasses.replace(lm, mrope_sections=(2, 1, 1))
            preset["vision"] = VLVisionConfig.tiny(out_dim=lm.hidden_dim, dtype=lm.dtype)
        else:
            preset["lm"] = LMConfig.qwen25_vl_7b(dtype=lm.dtype)
            preset["vision"] = VLVisionConfig.qwen25_vl(out_dim=lm.hidden_dim, dtype=lm.dtype)
        return preset

    def _components(self, preset):
        return {**super()._components(preset), "vision_tower": (preset["vision"], VLVisionTower)}

    def pretrained_component_maps(self):
        # JAX edit_plus.py:119-134: the tower ships in text_encoder/ and
        # claims its visual.* keys
        return {**super().pretrained_component_maps(),
                "vision_tower": ComponentImport("text_encoder", VL_VISION_RENAMES, qwen_vl_vision_preprocess,
                                                r"^visual\.")}

    def load_models(self) -> None:
        super().load_models()
        if "vision_tower" not in self.modules:
            self.component_configs.pop("vision_tower", None)
        vcfg: VLVisionConfig = self.component_configs.get("vision_tower") or VLVisionConfig.qwen25_vl()
        ma = self.model_args
        self.condition_encode_area = int(getattr(ma, "condition_encode_area", None) or CONDITION_ENCODE_AREA)
        factor = vcfg.patch_size * vcfg.merge_size
        max_vis = math.ceil(self.condition_encode_area / factor ** 2) + 8
        max_refs = int(getattr(ma, "max_condition_images", None) or 3)
        #: the fixed text + vision length of every encoded row
        self.vl_total_length = self.max_length + max_vis * max_refs

    # ------------------------------------------------------------------
    # Vision-tower conditioning
    # ------------------------------------------------------------------
    @torch.no_grad()
    def vision_forward(self, flat: np.ndarray, grid: Tuple[int, int, int]) -> torch.Tensor:
        """(L, patch_dim) patches of one image → (L / merge², LM width) fp32 on the device."""
        vcfg: VLVisionConfig = self.component_configs["vision_tower"]
        perm, inv, mask = window_layout(grid, vcfg)
        dev = self.device
        return self.modules["vision_tower"](
            torch.as_tensor(flat, device=dev), torch.as_tensor(rot_pos_ids(grid, vcfg.merge_size), device=dev),
            torch.as_tensor(perm, device=dev), torch.as_tensor(mask, device=dev), torch.as_tensor(inv, device=dev))

    def vision_rows(self, prompts: Sequence[str], images: Sequence[Any]):
        """Each record's LM inputs at ``vl_total_length``: ids, attention
        mask, image-pad mask and M-RoPE ids (host numpy; a leading image
        gets t = st, h = st + row, w = st + col, st advancing by its merged
        grid's longer side, the text sequential after), and the records'
        vision embeddings padded to the longest (B, Lv, D) on the device."""
        vcfg: VLVisionConfig = self.component_configs["vision_tower"]
        lmcfg = self.component_configs["text_encoder"]
        L_total, pad_id, B = self.vl_total_length, lmcfg.vocab_size - 1, len(prompts)
        ids = np.zeros((B, L_total), np.int64)
        mask = np.zeros((B, L_total), np.float32)
        vis_mask = np.zeros((B, L_total), bool)
        pos_ids = np.zeros((B, 3, L_total), np.float32)
        rows: List[torch.Tensor] = []
        for bi, (prompt, per_record) in enumerate(zip(prompts, images)):
            refs = per_record if isinstance(per_record, list) else [per_record]
            embs, grids = [], []
            for ref in refs:
                arr = standardize_image_batch(ref, output_type="np")[0]  # (3, H, W)
                flat, grid = preprocess_vision_image(arr, vcfg, self.condition_encode_area)
                embs.append(self.vision_forward(flat, grid))
                grids.append(grid)
            v = torch.cat(embs) if embs else torch.zeros((0, lmcfg.hidden_dim), device=self.device)
            lv = v.shape[0]
            enc = self.tokenizer([prompt], max_length=self.max_length)
            t_ids = np.asarray(enc["input_ids"][0])
            total = min(lv + int(np.asarray(enc["attention_mask"][0]).sum()), L_total)
            ids[bi, :lv] = pad_id
            ids[bi, lv:total] = t_ids[: total - lv]
            mask[bi, :total] = 1.0
            vis_mask[bi, :lv] = True
            st, off = 0, 0
            for _, h, w in grids:
                hm, wm = h // vcfg.merge_size, w // vcfg.merge_size
                pos_ids[bi, 0, off: off + hm * wm] = st
                pos_ids[bi, 1, off: off + hm * wm] = st + np.repeat(np.arange(hm), wm)
                pos_ids[bi, 2, off: off + hm * wm] = st + np.tile(np.arange(wm), hm)
                st += int(max(hm, wm))
                off += hm * wm
            pos_ids[bi, :, lv:] = (st + np.arange(L_total - lv))[None]
            rows.append(v)
        vis = torch.zeros((B, max(max(r.shape[0] for r in rows), 1), lmcfg.hidden_dim), device=self.device)
        for bi, v in enumerate(rows):
            vis[bi, : v.shape[0]] = v
        return dict(ids=ids, mask=mask, vis_mask=vis_mask, pos_ids=pos_ids), vis

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str], images: Optional[Sequence[Any]] = None, **kw):
        """With ``images`` (one entry a prompt: an image or a list of
        references), the LM's states of the rows of :meth:`vision_rows`,
        fp32 on the device; without, Qwen-Image's encoding."""
        if images is None or "vision_tower" not in self.modules:
            return super().encode_prompt(prompts, **kw)
        if isinstance(prompts, str):
            prompts = [prompts]
        host, vis = self.vision_rows(list(prompts), images)
        dev = self.device
        emb = self.modules["text_encoder"](
            torch.as_tensor(host["ids"], device=dev), torch.as_tensor(host["mask"], device=dev),
            vision_embeds=vis, vision_mask=torch.as_tensor(host["vis_mask"], device=dev),
            position_ids=torch.as_tensor(host["pos_ids"], device=dev))
        return {"prompt_embeds": emb.float()}

    def preprocess_func(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        """Prompts and negatives (" " by default) encoded with the record's
        images, and the images' condition tokens."""
        images = batch.get("images") or batch.get("image")
        out: Dict[str, Any] = {}
        prompts = batch.get("prompt")
        if prompts is not None:
            neg = batch.get("negative_prompt") or [" "] * len(prompts)
            out["prompt_embeds"] = self.encode_prompt(prompts, images=images)["prompt_embeds"].cpu().numpy()
            out["negative_prompt_embeds"] = self.encode_prompt(neg, images=images)["prompt_embeds"].cpu().numpy()
        if images is not None:
            out["cond_latents"], out["cond_ids"] = self.condition_tokens(images)
        return out

    def inference(self, images=None, cond_latents=None, cond_ids=None, **kwargs):
        """The rollout with the condition tokens in every step's embeds;
        prompts given as text with ``images`` are encoded with them,
        positives and negatives alike. Each sample keeps its row of the
        condition tokens, and with ``images`` its reference images."""
        extra = dict(kwargs.pop("extra_embeds", None) or {})
        if images is not None and kwargs.get("prompt_embeds") is None and kwargs.get("prompt") is not None:
            kwargs["prompt_embeds"] = self.encode_prompt(kwargs["prompt"], images=images)["prompt_embeds"]
            g = float(kwargs.get("guidance_scale") or self.training_args.guidance_scale)
            if g > 1.0 and kwargs.get("negative_prompt_embeds") is None:
                neg = kwargs.get("negative_prompt") or [" "] * len(kwargs["prompt"])
                kwargs["negative_prompt_embeds"] = self.encode_prompt(list(neg), images=images)["prompt_embeds"]
        if cond_latents is None and images is not None:
            cond_latents, cond_ids = self.condition_tokens(images)
        if cond_latents is not None:
            extra["cond_latents"] = np.asarray(cond_latents, np.float32)
            extra["cond_ids"] = np.asarray(cond_ids, np.float32)
        samples = super().inference(extra_embeds=extra, **kwargs)
        if cond_latents is not None and images is not None:
            self.keep_condition_images(samples, images)
        return samples
