"""SD3.5 adapter: encode → rollout → decode, and the no-grad replay.

Port of ``flow_factory_tpu/models/sd3/adapter.py``:

* text encoding concatenates the CLIP-L and CLIP-G penultimate states,
  zero-pads them to the T5 width and appends the T5 states along the sequence;
  the pooled embedding is the two CLIP projections concatenated;
* the velocity doubles the batch for classifier-free guidance in
  ``[uncond, cond]`` order;
* the schedule uses the resolution-dependent dynamic shift (mu from the
  image-token count);
* every component is random-initialised from the seed directly on the
  adapter's device in the inference dtype; a local diffusers-layout
  ``model_name_or_path`` then self-configures each component from its
  ``config.json`` and imports its safetensors (no weights are downloaded);
* the LoRA is merged once per rollout; the transformer runs on the merged
  weights through ``functional_call``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ...samples import T2ISample
from ...utils.base import make_generator
from ...utils.checkpoint import ComponentImport
from ...utils.model_config import (
    apply_config_json_overrides,
    clip_text_overrides_from_config,
    image_vae_overrides_from_config,
    sd3_transformer_overrides_from_config,
    t5_overrides_from_config,
)
from ...utils.tokenizer import load_tokenizer
from ...utils.trajectory import build_store_maps
from ...utils.weights import sd35_component_maps
from ..abc import BaseAdapter
from ..layers import build_module
from ..text_encoders import CLIPTextConfig, CLIPTextEncoder, T5Config, T5Encoder
from ..vae import AutoencoderKL, VAEConfig
from .transformer import MMDiTConfig, SD3Transformer


def _preset(name: str, attn_backend: str, inference_dtype: str) -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=MMDiTConfig.tiny(context_dim=48, pooled_dim=40, attn_backend=attn_backend,
                                         dtype=inference_dtype),
            vae=VAEConfig.tiny(dtype=inference_dtype),
            clip_l=CLIPTextConfig.tiny(hidden_dim=16, num_heads=2, projection_dim=16, dtype=inference_dtype),
            clip_g=CLIPTextConfig.tiny(hidden_dim=24, num_heads=2, projection_dim=24, dtype=inference_dtype),
            t5=T5Config.tiny(hidden_dim=48, num_heads=2, head_dim=8, dtype=inference_dtype),
            t5_max_length=16,
            clip_max_length=8,
        )
    if name in ("medium", "sd3.5-medium", "large", "sd3.5-large"):
        large = "large" in name
        transformer = (MMDiTConfig.sd3_5_large if large else MMDiTConfig.sd3_5_medium)(
            attn_backend=attn_backend, dtype=inference_dtype)
        return dict(
            transformer=transformer,
            vae=VAEConfig.sd3(dtype=inference_dtype),
            clip_l=CLIPTextConfig.clip_l(dtype=inference_dtype),
            clip_g=CLIPTextConfig.clip_g(dtype=inference_dtype),
            t5=T5Config.xxl(dtype=inference_dtype),
            t5_max_length=256,
            clip_max_length=77,
        )
    raise ValueError(f"Unknown SD3.5 preset {name!r}")


class SD35Adapter(BaseAdapter):
    sample_class = T2ISample
    embed_keys = ("prompt_embeds", "pooled_prompt_embeds",
                  "negative_prompt_embeds", "negative_pooled_prompt_embeds")

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------
    def load_models(self) -> None:
        ma = self.model_args
        variant = getattr(ma, "variant", None) or (
            "tiny" if ma.model_name_or_path in ("", "tiny") else "medium")
        preset = _preset(variant, ma.attn_backend, ma.inference_dtype)
        for key, sub, fn in (("transformer", "transformer", sd3_transformer_overrides_from_config),
                             ("clip_l", "text_encoder", clip_text_overrides_from_config),
                             ("clip_g", "text_encoder_2", clip_text_overrides_from_config),
                             ("t5", "text_encoder_3", t5_overrides_from_config),
                             ("vae", "vae", image_vae_overrides_from_config)):
            preset[key] = apply_config_json_overrides(preset[key], ma.model_name_or_path, sub, fn)
        if self.training_args.enable_gradient_checkpointing or ma.enable_gradient_checkpointing_override:
            preset["transformer"] = dataclasses.replace(preset["transformer"], remat=True)
        self.t5_max_length = preset["t5_max_length"]
        self.clip_max_length = preset["clip_max_length"]
        self.component_configs = {
            "transformer": preset["transformer"],
            "vae": preset["vae"],
            "text_encoder": preset["clip_l"],
            "text_encoder_2": preset["clip_g"],
            "text_encoder_3": preset["t5"],
        }
        factories = {
            "transformer": lambda: SD3Transformer(preset["transformer"]),
            "vae": lambda: AutoencoderKL(preset["vae"]),
            "text_encoder": lambda: CLIPTextEncoder(preset["clip_l"]),
            "text_encoder_2": lambda: CLIPTextEncoder(preset["clip_g"]),
            "text_encoder_3": lambda: T5Encoder(preset["t5"]),
        }
        wanted = getattr(ma, "load_components", None)
        seed = self.training_args.seed
        self.modules = {
            comp: build_module(make, self.device, self.inference_dtype,
                               make_generator(self.device, "sd35_init", seed, comp))
            for comp, make in factories.items() if not wanted or comp in set(wanted)
        }

        clip_bos = 1 if variant == "tiny" else 49406
        self.tokenizer = load_tokenizer(
            ma.model_name_or_path, "tokenizer", preset["clip_l"].vocab_size, self.clip_max_length,
            eos_token_id=preset["clip_l"].eos_token_id, bos_token_id=clip_bos)
        self.tokenizer_2 = load_tokenizer(
            ma.model_name_or_path, "tokenizer_2", preset["clip_g"].vocab_size, self.clip_max_length,
            eos_token_id=preset["clip_g"].eos_token_id, bos_token_id=clip_bos)
        self.tokenizer_3 = load_tokenizer(
            ma.model_name_or_path, "tokenizer_3", preset["t5"].vocab_size, self.t5_max_length,
            eos_token_id=1, pad_token_id=0)
        self.latent_channels = preset["vae"].latent_channels
        self.vae_downscale = preset["vae"].downscale

    def weight_maps(self):
        return sd35_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # the diffusers names throughout (JAX sd3/adapter.py:90-124)
        return {comp: ComponentImport(comp) for comp in
                ("transformer", "text_encoder", "text_encoder_2", "text_encoder_3", "vae")}

    def scheduler_defaults(self) -> Dict[str, Any]:
        return dict(use_dynamic_shifting=True)

    # ------------------------------------------------------------------
    # Prompt encoding
    # ------------------------------------------------------------------
    def _ids(self, tokenizer, prompts: Sequence[str], max_length: int) -> torch.Tensor:
        ids = tokenizer(list(prompts), max_length=max_length)["input_ids"]
        return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Prompts → fp32 device tensors ``prompt_embeds`` (B, L, D_t5) and
        ``pooled_prompt_embeds`` (B, P)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        missing = [k for k in ("text_encoder", "text_encoder_2", "text_encoder_3") if k not in self.modules]
        if missing:
            raise RuntimeError(f"Text encoders {missing} were not loaded (load_components); "
                               "cannot encode prompts")
        out_l = self.modules["text_encoder"](self._ids(self.tokenizer, prompts, self.clip_max_length))
        out_g = self.modules["text_encoder_2"](self._ids(self.tokenizer_2, prompts, self.clip_max_length))
        t5_emb = self.modules["text_encoder_3"](self._ids(self.tokenizer_3, prompts, self.t5_max_length))
        clip_emb = torch.cat([out_l.penultimate_hidden_state, out_g.penultimate_hidden_state], dim=-1)
        clip_emb = F.pad(clip_emb, (0, t5_emb.shape[-1] - clip_emb.shape[-1]))
        prompt_embeds = torch.cat([clip_emb, t5_emb.to(clip_emb.dtype)], dim=1)
        pooled = torch.cat([out_l.pooled, out_g.pooled], dim=-1)
        return {"prompt_embeds": prompt_embeds.float(), "pooled_prompt_embeds": pooled.float()}

    def preprocess_func(self, batch: Dict[str, Any], **_) -> Dict[str, np.ndarray]:
        """The dataset's stage-1 cache: prompt and negative-prompt embeddings
        as host fp32 numpy (JAX ``sd3/adapter.py:292``)."""
        out: Dict[str, np.ndarray] = {}
        prompts = batch.get("prompt")
        if prompts is not None:
            host = lambda enc: {k: v.cpu().numpy() for k, v in enc.items()}
            out.update(host(self.encode_prompt(prompts)))
            neg = host(self.encode_prompt(batch.get("negative_prompt") or [""] * len(prompts)))
            out["negative_prompt_embeds"] = neg["prompt_embeds"]
            out["negative_pooled_prompt_embeds"] = neg["pooled_prompt_embeds"]
        return out

    # ------------------------------------------------------------------
    # Velocity
    # ------------------------------------------------------------------
    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        model = self.modules["transformer"]
        dt = self.component_configs["transformer"].compute_dtype
        run = lambda *args: functional_call(model, params, args) if params else model(*args)
        if do_cfg:
            v = run(
                torch.cat([latents, latents]).to(dt),
                torch.cat([t, t]),
                torch.cat([embeds["negative_prompt_embeds"], embeds["prompt_embeds"]]),
                torch.cat([embeds["negative_pooled_prompt_embeds"], embeds["pooled_prompt_embeds"]]),
            )
            v_uncond, v_cond = v.float().chunk(2)
            return v_uncond + guidance_scale * (v_cond - v_uncond)
        return run(latents.to(dt), t, embeds["prompt_embeds"], embeds["pooled_prompt_embeds"]).float()

    # ------------------------------------------------------------------
    # Rollout → samples
    # ------------------------------------------------------------------
    def latent_shape(self, height: int, width: int) -> Tuple[int, int, int]:
        return (height // self.vae_downscale, width // self.vae_downscale, self.latent_channels)

    @torch.no_grad()
    def inference(
        self,
        prompt: Optional[Sequence[str]] = None,
        prompt_embeds=None,
        pooled_prompt_embeds=None,
        negative_prompt: Optional[Sequence[str]] = None,
        negative_prompt_embeds=None,
        negative_pooled_prompt_embeds=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        compute_log_prob: bool = True,
        trajectory_indices: Optional[Any] = "all",
        seed: Optional[int] = None,
        generator: Optional[Union[torch.Generator, Sequence[torch.Generator]]] = None,
        x0: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        trainable=None,
        store_means: bool = False,
        decode: bool = True,
        **_,
    ) -> List[T2ISample]:
        """Full rollout → host-resident samples with trajectories and log-probs.

        Noise comes from ``generator`` (default: seeded from ``seed``; one
        per row for per-prompt eval noise, :meth:`initial_latents`); ``x0``
        and per-step ``noise`` replace its draws when given. The LoRA of
        ``trainable`` (default: the live tree) is merged once, here."""
        ta = self.training_args
        height = height or ta.height
        width = width or ta.width
        T = num_inference_steps or ta.num_inference_steps
        g = float(ta.guidance_scale if guidance_scale is None else guidance_scale)
        do_cfg = g > 1.0

        if prompt_embeds is None:
            enc = self.encode_prompt(list(prompt))
            prompt_embeds, pooled_prompt_embeds = enc["prompt_embeds"], enc["pooled_prompt_embeds"]
        if do_cfg and negative_prompt_embeds is None:
            neg = list(negative_prompt) if negative_prompt is not None else [""] * len(prompt_embeds)
            enc = self.encode_prompt(neg)
            negative_prompt_embeds = enc["prompt_embeds"]
            negative_pooled_prompt_embeds = enc["pooled_prompt_embeds"]
        embeds = {"prompt_embeds": self._on_device(prompt_embeds),
                  "pooled_prompt_embeds": self._on_device(pooled_prompt_embeds)}
        if do_cfg:
            embeds["negative_prompt_embeds"] = self._on_device(negative_prompt_embeds)
            embeds["negative_pooled_prompt_embeds"] = self._on_device(negative_pooled_prompt_embeds)
        B = embeds["prompt_embeds"].shape[0]

        # schedule: mu from the image-token count (dynamic shifting)
        h, w, c = self.latent_shape(height, width)
        p = self.component_configs["transformer"].patch_size
        timesteps = self.scheduler.set_timesteps(T, seq_len=(h // p) * (w // p))
        sigmas = self.scheduler.sigmas
        noise_levels = self.scheduler.get_noise_levels()
        dynamics = "ODE" if self.scheduler.is_eval else self.scheduler.dynamics_type
        maps = build_store_maps(trajectory_indices, T)

        if generator is None:
            generator = make_generator(self.device, "rollout", ta.seed if seed is None else seed)
        x0, generator = self.initial_latents((B, h, w, c), generator, x0)

        params = self.merged_params(self.velocity_component, trainable)
        x_final, lat_buf, lp_buf, mean_buf = self.rollout_compute(
            x0, embeds, g, sigmas, timesteps, noise_levels,
            maps.latent_store_slot, maps.logprob_store_slot, generator, noise, params,
            do_cfg=do_cfg, compute_log_prob=compute_log_prob, dynamics_type=dynamics,
            num_latent_slots=maps.num_latent_slots, num_logprob_slots=maps.num_logprob_slots,
            store_means=store_means,
        )
        images = self.decode_latents(x_final) if decode else [None] * B

        # host copies, once per rollout
        lat_np = lat_buf.float().cpu().numpy()  # (S, B, h, w, c)
        lp_np = lp_buf.cpu().numpy()  # (L, B)
        mean_np = mean_buf.float().cpu().numpy() if mean_buf is not None else None
        host = {k: v.cpu().numpy() for k, v in embeds.items()}
        ts_np = np.asarray(timesteps, np.float32)
        samples: List[T2ISample] = []
        for i in range(B):
            extra = {
                "sigmas": np.asarray(sigmas, np.float32),
                "noise_levels": np.asarray(noise_levels, np.float32),
                "guidance_scale": g,
                "pooled_prompt_embeds": host["pooled_prompt_embeds"][i],
            }
            if do_cfg:
                extra["negative_pooled_prompt_embeds"] = host["negative_pooled_prompt_embeds"][i]
            if mean_np is not None:
                extra["next_latents_mean"] = mean_np[:, i]
            samples.append(self.sample_class(
                timesteps=ts_np,
                all_latents=lat_np[:, i],
                latent_index_map=maps.latent_index_map,
                log_probs=lp_np[:, i] if compute_log_prob else None,
                log_prob_index_map=maps.logprob_index_map,
                height=height,
                width=width,
                image=images[i],
                prompt=prompt[i] if prompt is not None else None,
                prompt_embeds=host["prompt_embeds"][i],
                negative_prompt_embeds=host["negative_prompt_embeds"][i] if do_cfg else None,
                extra_kwargs=extra,
            ))
        return samples

    # ------------------------------------------------------------------
    # Decoding
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, fetch: bool = True):
        """(B, h, w, c) latents → (B, 3, H, W) float images in [0, 1]; host
        numpy when ``fetch``, else the device tensor."""
        z = latents.float().permute(0, 3, 1, 2)
        img = self.modules["vae"].decode(z)
        img = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
        return img.cpu().numpy() if fetch else img
