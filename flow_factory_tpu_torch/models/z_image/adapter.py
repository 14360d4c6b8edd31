"""Z-Image adapter (port of ``flow_factory_tpu/models/z_image/adapter.py``).

Text → image with the single-stream S3-DiT (``transformer.py``) on a
Qwen3-sized LM's states (36 layers, width 2560, 32 q / 8 kv heads of 128,
MLP 9728, the llama layout as the JAX package builds it). The transformer
takes no guidance embedding and no pooled vector: CFG, when the guidance
scale exceeds 1 and negatives exist (the negative prompt ""), is a doubled
batch. The Turbo checkpoint runs at guidance 0 with no negatives.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...utils.checkpoint import ComponentImport
from ...utils.model_config import z_image_transformer_overrides_from_config
from ...utils.weights import z_image_component_maps
from ..flux.lm_conditioned import LMConditionedAdapter
from ..text_encoders import LMConfig
from ..vae import VAEConfig
from .transformer import ZImageConfig, ZImageTransformer

#: LoRA targets (JAX ``Z_IMAGE_LORA_TARGETS``): each block's four attention
#: projections and its three SwiGLU linears
Z_IMAGE_LORA_TARGETS = (
    r".*layers\.\d+\.attention\.(to_q|to_k|to_v|to_out\.0)\.weight$",
    r".*layers\.\d+\.feed_forward\.(w1|w2|w3)\.weight$",
)


def _preset(name: str, attn_backend: str, dtype: str) -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=ZImageConfig.tiny(attn_backend=attn_backend, dtype=dtype),
            vae=VAEConfig.tiny(latent_channels=4, dtype=dtype),
            lm=LMConfig.tiny(hidden_dim=32, dtype=dtype),
            max_length=16,
        )
    if name in ("z-image", "6b"):
        return dict(
            transformer=ZImageConfig(in_channels=64, hidden_dim=3072, num_heads=24, num_layers=38, ffn_dim=8192,
                                     context_dim=2560, axes_dim=(16, 56, 56), attn_backend=attn_backend,
                                     dtype=dtype),
            vae=VAEConfig(latent_channels=16, dtype=dtype),
            lm=LMConfig(vocab_size=151936, hidden_dim=2560, num_layers=36, num_heads=32, num_kv_heads=8,
                        head_dim=128, mlp_dim=9728, dtype=dtype),
            max_length=512,
        )
    raise ValueError(f"Unknown Z-Image preset {name!r}")


class ZImageAdapter(LMConditionedAdapter):
    default_target_patterns = Z_IMAGE_LORA_TARGETS
    default_variant = "z-image"
    init_tag = "z_image_init"
    transformer_overrides_fn = staticmethod(z_image_transformer_overrides_from_config)

    def _preset(self, variant, attn_backend, dtype):
        return _preset(variant, attn_backend, dtype)

    def _components(self, preset):
        return {"transformer": (preset["transformer"], ZImageTransformer)}

    def weight_maps(self):
        return z_image_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # the upstream names throughout (JAX z_image/adapter.py:67-84)
        return {comp: ComponentImport(comp) for comp in ("transformer", "text_encoder", "vae")}

    def _transformer_args(self, x, t, ctx, img_ids, txt_ids):
        return (x, t, ctx, img_ids, txt_ids)

    def _transformer_call(self, params, x, t, ctx, img_ids, txt_ids) -> torch.Tensor:
        """On the CPU one sample a call (F19): the CPU splits an elementwise op
        (the SwiGLU's silu, the RMS norms' rsqrt) over its threads in chunks
        and rounds an element in a chunk's scalar tail otherwise than in its
        vector body, so at several threads a row's bits would follow its
        place in the batch, and a replay of shuffled rows would miss the
        rollout's; alone, a sample meets the same ops wherever it sits, at any
        thread count. On the card the batch runs whole (F18 holds it there)."""
        call = super()._transformer_call
        if x.device.type != "cpu" or x.shape[0] == 1:
            return call(params, x, t, ctx, img_ids, txt_ids)
        return torch.cat([call(params, *row, img_ids, txt_ids) for row in zip(x.split(1), t.split(1), ctx.split(1))])

    def preprocess_func(self, batch: Dict[str, Any], **_) -> Dict[str, np.ndarray]:
        """Prompts, and under CFG (guidance > 1) their negatives (the
        record's, else "") → host fp32."""
        prompts = batch.get("prompt")
        if prompts is None:
            return {}
        if float(self.training_args.guidance_scale) > 1.0:
            return self._encode_negatives(prompts, batch.get("negative_prompt"), "")
        return {"prompt_embeds": self.encode_prompt(prompts)["prompt_embeds"].cpu().numpy()}

    def inference(self, negative_prompt=None, negative_prompt_embeds=None, guidance_scale=None, extra_embeds=None,
                  **kwargs):
        """True CFG when the guidance scale (the call's, else the config's)
        exceeds 1: the negatives as given, else encoded from
        ``negative_prompt`` or ""; at guidance ≤ 1 (Turbo) no CFG."""
        g = float(self.training_args.guidance_scale if guidance_scale is None else guidance_scale)
        extra = dict(extra_embeds or {})
        if g > 1.0 and "negative_prompt_embeds" not in extra:
            if negative_prompt_embeds is None:
                prompts = kwargs.get("prompt")
                n = len(prompts) if prompts is not None else len(kwargs["prompt_embeds"])
                neg = list(negative_prompt) if negative_prompt is not None else [""] * n
                negative_prompt_embeds = self.encode_prompt(neg)["prompt_embeds"]
            extra["negative_prompt_embeds"] = negative_prompt_embeds
        neg = extra.get("negative_prompt_embeds")
        do_cfg = kwargs.pop("do_cfg_override", None)
        return self._rollout_with_negatives(neg, extra, neg is not None if do_cfg is None else do_cfg,
                                            guidance_scale=g, **kwargs)
