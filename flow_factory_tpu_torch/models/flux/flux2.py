"""FLUX.2 and FLUX.2-Klein adapters (port of ``flow_factory_tpu/models/flux/flux2.py``).

The FLUX hybrid DiT conditioned on a Mistral LM's final states alone (no
pooled text vector: ``pooled_dim`` 0 in every preset), with Kontext's
multi-reference image conditioning, so that plain T2I and multi-reference
I2I are one adapter. The encode keeps, as JAX keeps it, the mask-mean of
the LM states as ``pooled_prompt_embeds``, which the transformer does not
read. Under ``use_caption_upsampler`` the prompts are first rewritten by the
same LM (``text_encoders/caption.py``), greedy from its tied-embedding
logits.

Presets: ``flux2``/``dev2`` (24 double + 48 single blocks at width 4096, 32
heads of 128, Mistral-Small), ``klein`` (8 + 24 blocks at width 3072) and
``tiny``. ``mlp_style`` (a model config key) picks the double blocks' FFN:
``gelu_tanh``, or ``swiglu``, the gated layout of upstream FLUX.2
checkpoints; an import raises when the checkpoint disagrees.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ...utils.base import make_generator
from ...utils.checkpoint import FLUX2_TRANSFORMER_RENAMES, ComponentImport, check_flux2_mlp_style
from ...utils.model_config import (
    apply_config_json_overrides,
    flux_transformer_overrides_from_config,
    image_vae_overrides_from_config,
    lm_overrides_from_config,
)
from ...utils.tokenizer import load_tokenizer
from ...utils.weights import flux2_component_maps
from ..layers import build_module
from ..text_encoders import LMConfig, LMEncoder
from ..text_encoders.caption import LMCaptionUpsampler
from ..vae import AutoencoderKL, VAEConfig
from .kontext import Flux1KontextAdapter
from .transformer import FluxConfig, FluxTransformer


def _preset(name: str, attn_backend: str, dtype: str, mlp_style: str = "gelu_tanh") -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=FluxConfig.tiny(attn_backend=attn_backend, dtype=dtype, context_dim=32, pooled_dim=0,
                                        mlp_style=mlp_style),
            vae=VAEConfig.tiny(latent_channels=4, dtype=dtype),
            lm=LMConfig.tiny(hidden_dim=32, dtype=dtype),
            max_length=16,
        )
    if name in ("flux2", "dev2"):
        return dict(
            transformer=FluxConfig(in_channels=64, hidden_dim=4096, num_heads=32, num_double_blocks=24,
                                   num_single_blocks=48, context_dim=5120, pooled_dim=0, guidance_embeds=True,
                                   axes_dim=(32, 48, 48), attn_backend=attn_backend, dtype=dtype,
                                   mlp_style=mlp_style),
            vae=VAEConfig(latent_channels=16, dtype=dtype),
            lm=LMConfig.mistral_small(dtype=dtype),
            max_length=512,
        )
    if name == "klein":
        return dict(
            transformer=FluxConfig(in_channels=64, hidden_dim=3072, num_heads=24, num_double_blocks=8,
                                   num_single_blocks=24, context_dim=5120, pooled_dim=0, guidance_embeds=True,
                                   axes_dim=(16, 56, 56), attn_backend=attn_backend, dtype=dtype,
                                   mlp_style=mlp_style),
            vae=VAEConfig(latent_channels=16, dtype=dtype),
            lm=LMConfig.mistral_small(dtype=dtype),
            max_length=512,
        )
    raise ValueError(f"Unknown FLUX.2 preset {name!r}")


class Flux2Adapter(Flux1KontextAdapter):
    """FLUX.2: Mistral conditioning and multi-reference image editing."""

    #: the preset a model id that is not "tiny" takes when ``variant`` is unset
    default_variant = "flux2"
    #: the prompt rewriter (``use_caption_upsampler``); None: prompts as given
    caption_upsampler = None

    def _variant(self) -> str:
        ma = self.model_args
        return getattr(ma, "variant", None) or (
            "tiny" if ma.model_name_or_path in ("", "tiny") else self.default_variant)

    def load_models(self) -> None:
        ma = self.model_args
        preset = _preset(self._variant(), ma.attn_backend, ma.inference_dtype,
                         mlp_style=getattr(ma, "mlp_style", None) or "gelu_tanh")
        path = ma.model_name_or_path
        for key, sub, fn in (("transformer", "transformer", flux_transformer_overrides_from_config),
                             ("lm", "text_encoder", lm_overrides_from_config),
                             ("vae", "vae", image_vae_overrides_from_config)):
            preset[key] = apply_config_json_overrides(preset[key], path, sub, fn)
        if self.training_args.enable_gradient_checkpointing or ma.enable_gradient_checkpointing_override:
            preset["transformer"] = dataclasses.replace(preset["transformer"], remat=True)
        self.max_length = preset["max_length"]
        components = {"transformer": (preset["transformer"], FluxTransformer),
                      "vae": (preset["vae"], AutoencoderKL),
                      "text_encoder": (preset["lm"], LMEncoder)}
        self.component_configs = {comp: cfg for comp, (cfg, _) in components.items()}
        wanted = getattr(ma, "load_components", None)
        seed = self.training_args.seed
        self.modules = {
            comp: build_module(lambda: cls(cfg), self.device, self.inference_dtype,
                               make_generator(self.device, "flux2_init", seed, comp))
            for comp, (cfg, cls) in components.items() if not wanted or comp in set(wanted)
        }
        self.tokenizer = load_tokenizer(path, "tokenizer", preset["lm"].vocab_size, self.max_length,
                                        eos_token_id=2, pad_token_id=0)
        self.latent_channels = preset["vae"].latent_channels
        self.vae_downscale = preset["vae"].downscale
        # the same decoder generates, so the upsampler loads nothing; it
        # holds the module, and so reads the weights an import copies in
        if getattr(ma, "use_caption_upsampler", False) and "text_encoder" in self.modules:
            self.caption_upsampler = LMCaptionUpsampler(
                self.modules["text_encoder"], self.tokenizer,
                max_new_tokens=int(getattr(ma, "caption_max_new_tokens", 24)),
                max_length=min(self.max_length, 96))

    def weight_maps(self):
        return flux2_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # JAX flux2.py:81-100: the transformer's renames, and the check of
        # the double blocks' FFN form before the import
        tcfg = self.component_configs["transformer"]
        guard = functools.partial(check_flux2_mlp_style, mlp_style=tcfg.mlp_style)
        return {"transformer": ComponentImport("transformer", FLUX2_TRANSFORMER_RENAMES, guard),
                "text_encoder": ComponentImport("text_encoder"),
                "vae": ComponentImport("vae")}

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str], **_) -> Dict[str, torch.Tensor]:
        """Prompts (rewritten first under ``use_caption_upsampler``) →
        ``prompt_embeds`` (B, max_length, LM width), the LM's final states
        of the padded ids in fp32, and ``pooled_prompt_embeds`` (B, LM
        width), their mean over the mask's positions; device tensors."""
        if isinstance(prompts, str):
            prompts = [prompts]
        prompts = list(prompts)
        if self.caption_upsampler is not None:
            prompts = self.caption_upsampler(prompts)
        if "text_encoder" not in self.modules:
            raise RuntimeError("text_encoder was not loaded (load_components); cannot encode prompts")
        enc = self.tokenizer(prompts, max_length=self.max_length)
        to_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)
        mask = to_dev(enc["attention_mask"])
        emb = self.modules["text_encoder"](to_dev(enc["input_ids"]), mask).float()
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1).float()
        return {"prompt_embeds": emb, "pooled_prompt_embeds": (emb * mask[..., None].float()).sum(dim=1) / denom}


class Flux2KleinAdapter(Flux2Adapter):
    """FLUX.2-Klein: the distilled small variant, the ``klein`` preset."""

    default_variant = "klein"
