"""Qwen-Image adapter (port of ``flow_factory_tpu/models/qwen_image/adapter.py``).

Text → image with a pure double-stream MMDiT: the FLUX transformer with
double blocks only, no pooled vector, no guidance embedding and ``txt_norm``
on the Qwen2.5-7B states (context 3584, q/k/v biases); true CFG with the
negative prompt " ". Every attention is unmasked at head dim 128 (K3, and
K2a/K2b in the backward) and every AdaLN norm goes through K5.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ...utils.checkpoint import QWEN_IMAGE_TRANSFORMER_RENAMES, ComponentImport
from ...utils.model_config import flux_transformer_overrides_from_config
from ...utils.weights import qwen_image_component_maps
from ..flux.lm_conditioned import LMConditionedAdapter
from ..flux.transformer import FluxConfig, FluxTransformer
from ..text_encoders import LMConfig
from ..vae import VAEConfig


def _preset(name: str, attn_backend: str, dtype: str) -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=FluxConfig.tiny(attn_backend=attn_backend, dtype=dtype, pooled_dim=0, guidance_embeds=False,
                                        num_single_blocks=0, num_double_blocks=2, context_dim=32, txt_norm=True),
            vae=VAEConfig.tiny(latent_channels=4, dtype=dtype),
            lm=LMConfig.tiny(hidden_dim=32, dtype=dtype),
            max_length=16,
        )
    if name in ("qwen-image", "20b"):
        return dict(
            transformer=FluxConfig(in_channels=64, hidden_dim=3072, num_heads=24, num_double_blocks=60,
                                   num_single_blocks=0, context_dim=3584, pooled_dim=0, guidance_embeds=False,
                                   axes_dim=(16, 56, 56), attn_backend=attn_backend, dtype=dtype, txt_norm=True),
            vae=VAEConfig(latent_channels=16, dtype=dtype),
            lm=LMConfig.qwen25_7b(dtype=dtype),
            max_length=512,
        )
    raise ValueError(f"Unknown Qwen-Image preset {name!r}")


class QwenImageAdapter(LMConditionedAdapter):
    default_variant = "qwen-image"
    init_tag = "qwen_image_init"
    transformer_overrides_fn = staticmethod(flux_transformer_overrides_from_config)

    def _preset(self, variant, attn_backend, dtype):
        return _preset(variant, attn_backend, dtype)

    def _components(self, preset):
        return {"transformer": (preset["transformer"], FluxTransformer)}

    def weight_maps(self):
        return qwen_image_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # JAX qwen_image/adapter.py:72-97: the LM claims the language-side keys
        # of text_encoder/, where Qwen2.5-VL also ships its vision tower
        return {"transformer": ComponentImport("transformer", QWEN_IMAGE_TRANSFORMER_RENAMES),
                "text_encoder": ComponentImport("text_encoder", scope=r"^(model\.|lm_head)"),
                "vae": ComponentImport("vae")}

    def _transformer_args(self, x, t, ctx, img_ids, txt_ids):
        return (x, t, ctx, None, img_ids, txt_ids, None)

    def preprocess_func(self, batch: Dict[str, Any], **_) -> Dict[str, np.ndarray]:
        """Prompts and their negatives (the record's, else " ") → host fp32."""
        if batch.get("prompt") is None:
            return {}
        return self._encode_negatives(batch["prompt"], batch.get("negative_prompt"), " ")

    def inference(self, negative_prompt=None, negative_prompt_embeds=None, extra_embeds=None, **kwargs):
        """True CFG when the guidance scale (the call's, else the config's)
        exceeds 1: the negatives as given, else encoded from
        ``negative_prompt`` or " "; samples keep the negatives they were given."""
        g = float(kwargs.get("guidance_scale") or self.training_args.guidance_scale)
        extra = dict(extra_embeds or {})
        if g > 1.0 and negative_prompt_embeds is None:
            prompts = kwargs.get("prompt")
            n = len(prompts) if prompts is not None else len(kwargs["prompt_embeds"])
            neg = list(negative_prompt) if negative_prompt is not None else [" "] * n
            negative_prompt_embeds = self.encode_prompt(neg)["prompt_embeds"]
        if negative_prompt_embeds is not None and g > 1.0:
            extra["negative_prompt_embeds"] = negative_prompt_embeds
        return self._rollout_with_negatives(negative_prompt_embeds, extra, g > 1.0, **kwargs)
