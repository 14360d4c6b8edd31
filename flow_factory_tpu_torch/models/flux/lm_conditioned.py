"""Packed-latent text-to-image conditioned on a causal LM, with true CFG.

The base of the Qwen-Image, Qwen-Image-Edit-Plus and Z-Image adapters (the
JAX package writes each out over ``Flux1Adapter``): FLUX.1's packing, ids,
dynamic shift and rollout, with

* an LM's final states as the only conditioning (``encode_prompt``), the
  HashTokenizer standing in for the Qwen tokenizers;
* the preset's components self-configured from ``<model_name_or_path>/
  {transformer,text_encoder,vae}/config.json`` where present (a directory
  with ``transformer/config.json`` holding ``{"num_layers": N}`` runs the
  model at depth N), their safetensors imported where present (each
  family's ``pretrained_component_maps``), and remat on under
  ``enable_gradient_checkpointing``;
* CFG by a doubled batch, the negatives first, the negative embeddings
  riding the embeds of the rollout and every replay
  (``negative_prompt_embeds`` on each sample).

A family gives its preset (``_preset``), its components (``_components``),
its transformer's config.json translator, the transformer's call
(``_transformer_args``), and its own negative-prompt rules in
``preprocess_func`` and ``inference``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ...samples import T2ISample
from ...utils.base import make_generator
from ...utils.model_config import (
    apply_config_json_overrides,
    image_vae_overrides_from_config,
    lm_overrides_from_config,
)
from ...utils.tokenizer import load_tokenizer
from ..layers import build_module
from ..text_encoders import LMEncoder
from ..vae import AutoencoderKL
from .adapter import Flux1Adapter


class LMConditionedAdapter(Flux1Adapter):
    sample_class = T2ISample
    embed_keys = ("prompt_embeds", "negative_prompt_embeds", "img_ids", "txt_ids")
    #: the preset a model id that is not "tiny" takes when ``variant`` is unset
    default_variant: str = ""
    #: the random-init generator's tag
    init_tag: str = ""
    #: the transformer's config.json translator
    transformer_overrides_fn: Callable[[Dict[str, Any]], Dict[str, Any]] = staticmethod(lambda cfg: {})

    def _preset(self, variant: str, attn_backend: str, dtype: str) -> Dict[str, Any]:
        raise NotImplementedError

    def _components(self, preset: Dict[str, Any]) -> Dict[str, Tuple[Any, Callable[[Any], torch.nn.Module]]]:
        """The family's components besides the VAE and the LM: {name: (config, module class)}."""
        raise NotImplementedError

    def load_models(self) -> None:
        ma = self.model_args
        variant = getattr(ma, "variant", None) or (
            "tiny" if ma.model_name_or_path in ("", "tiny") else self.default_variant)
        preset = self._preset(variant, ma.attn_backend, ma.inference_dtype)
        path = ma.model_name_or_path
        for key, sub, fn in (("transformer", "transformer", type(self).transformer_overrides_fn),
                             ("lm", "text_encoder", lm_overrides_from_config),
                             ("vae", "vae", image_vae_overrides_from_config)):
            preset[key] = apply_config_json_overrides(preset[key], path, sub, fn)
        if self.training_args.enable_gradient_checkpointing or ma.enable_gradient_checkpointing_override:
            preset["transformer"] = dataclasses.replace(preset["transformer"], remat=True)
        self.max_length = preset["max_length"]
        components = {"vae": (preset["vae"], AutoencoderKL), "text_encoder": (preset["lm"], LMEncoder),
                      **self._components(preset)}
        self.component_configs = {comp: cfg for comp, (cfg, _) in components.items()}
        wanted = getattr(ma, "load_components", None)
        seed = self.training_args.seed
        self.modules = {
            comp: build_module(lambda: cls(cfg), self.device, self.inference_dtype,
                               make_generator(self.device, self.init_tag, seed, comp))
            for comp, (cfg, cls) in components.items() if not wanted or comp in set(wanted)
        }
        self.tokenizer = load_tokenizer(path, "tokenizer", preset["lm"].vocab_size, self.max_length,
                                        eos_token_id=2, pad_token_id=0)
        self.latent_channels = preset["vae"].latent_channels
        self.vae_downscale = preset["vae"].downscale

    # ------------------------------------------------------------------
    # Prompt encoding: the LM's final states
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str], **_) -> Dict[str, torch.Tensor]:
        """Prompts → ``prompt_embeds`` (B, max_length, LM width) fp32 on the
        device: the LM's final states of the padded ids, pad rows included."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if "text_encoder" not in self.modules:
            raise RuntimeError("text_encoder was not loaded (load_components); cannot encode prompts")
        enc = self.tokenizer(list(prompts), max_length=self.max_length)
        to_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)
        return {"prompt_embeds": self.modules["text_encoder"](to_dev(enc["input_ids"]),
                                                              to_dev(enc["attention_mask"])).float()}

    def _encode_negatives(self, prompts: Sequence[str], negative_prompt, default: str) -> Dict[str, np.ndarray]:
        """The stage-1 cache of prompts and negatives, host fp32."""
        neg = list(negative_prompt) if negative_prompt else [default] * len(prompts)
        return {"prompt_embeds": self.encode_prompt(prompts)["prompt_embeds"].cpu().numpy(),
                "negative_prompt_embeds": self.encode_prompt(neg)["prompt_embeds"].cpu().numpy()}

    # ------------------------------------------------------------------
    # Velocity: true CFG, the negatives first in the doubled batch
    # ------------------------------------------------------------------
    def _transformer_args(self, x, t, ctx, img_ids, txt_ids) -> tuple:
        raise NotImplementedError

    def _transformer_call(self, params, x, t, ctx, img_ids, txt_ids) -> torch.Tensor:
        """The transformer on one batch: on ``params`` when given, else on
        its own weights."""
        model = self.modules["transformer"]
        args = self._transformer_args(x, t, ctx, img_ids, txt_ids)
        return functional_call(model, params, args) if params else model(*args)

    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        dt = self.component_configs["transformer"].compute_dtype
        img_ids, txt_ids = embeds["img_ids"], embeds["txt_ids"]
        img_ids = img_ids[0] if img_ids.ndim == 3 else img_ids
        txt_ids = txt_ids[0] if txt_ids.ndim == 3 else txt_ids

        def fwd(x, tt, ctx):
            return self._transformer_call(params, x.to(dt), tt, ctx, img_ids, txt_ids).float()

        if do_cfg and "negative_prompt_embeds" in embeds:
            v = fwd(torch.cat([latents, latents]), torch.cat([t, t]),
                    torch.cat([embeds["negative_prompt_embeds"], embeds["prompt_embeds"]]))
            v_uncond, v_cond = v.chunk(2)
            return v_uncond + guidance_scale * (v_cond - v_uncond)
        return fwd(latents, t, embeds["prompt_embeds"])

    def _rollout_with_negatives(self, negative_embeds, extra: Dict[str, Any], do_cfg: bool,
                                **kwargs) -> List[T2ISample]:
        """FLUX.1's rollout with the negatives ``extra["negative_prompt_embeds"]``
        in every step's embeds under ``do_cfg``; each sample keeps its row of
        ``negative_embeds`` (when given) as ``negative_prompt_embeds``."""
        kwargs.pop("pooled_prompt_embeds", None)  # no pooled stream
        samples = super().inference(extra_embeds=extra, do_cfg_override=do_cfg, **kwargs)
        for i, s in enumerate(samples):
            s.extra_kwargs.pop("negative_prompt_embeds", None)
            if negative_embeds is not None:
                s.negative_prompt_embeds = np.asarray(
                    negative_embeds[i].cpu() if torch.is_tensor(negative_embeds) else negative_embeds[i], np.float32)
                s._unique_id = None
        return samples
