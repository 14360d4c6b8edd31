"""FLUX.1 adapter (port of ``flow_factory_tpu/models/flux/adapter.py``).

Text → image with packed 2x2 latents and ``latent_image_ids`` for RoPE,
the guidance embedded in the transformer instead of a CFG batch doubling,
T5-XXL context plus the CLIP-L pooled vector as conditioning, and the
resolution-dependent dynamic shift of the sigma schedule (mu from the
image-token count, base 0.5 and max 1.15 over 256-4096 tokens). Every
component is random-initialised from the seed directly on the adapter's
device in the inference dtype, or configured and imported from a local
diffusers-layout checkpoint; the LoRA is merged once per rollout and the
transformer runs on the merged weights through ``functional_call``.
FLUX.1-Kontext builds on this adapter (``kontext.py``), and so do the
LM-conditioned families with true CFG (``lm_conditioned.py``: Qwen-Image,
Edit-Plus, Z-Image); FLUX.2 and Klein build on Kontext (``flux2.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from ...samples import T2ISample
from ...utils.base import make_generator
from ...utils.checkpoint import FLUX1_TRANSFORMER_RENAMES, ComponentImport, fuse_flux_single_block_qkv_mlp
from ...utils.model_config import (
    apply_config_json_overrides,
    clip_text_overrides_from_config,
    flux_transformer_overrides_from_config,
    image_vae_overrides_from_config,
    t5_overrides_from_config,
)
from ...utils.tokenizer import load_tokenizer
from ...utils.trajectory import build_store_maps
from ...utils.weights import flux1_component_maps
from ..abc import BaseAdapter
from ..layers import build_module
from ..text_encoders import CLIPTextConfig, CLIPTextEncoder, T5Config, T5Encoder
from ..vae import AutoencoderKL, VAEConfig
from .transformer import FluxConfig, FluxTransformer

#: LoRA targets (JAX ``FLUX_LORA_TARGETS``, ``flux/adapter.py:31-35``) over
#: the port's names: every double-block attention projection and FFN linear
#: (the gated FFN's ``linear_in``/``linear_out`` too), and the single
#: blocks' fused ``linear1``/``linear2``
FLUX_LORA_TARGETS = (
    r".*transformer_blocks\.\d+\.attn\.(to_q|to_k|to_v|to_out\.0|add_q_proj|add_k_proj|add_v_proj|to_add_out)"
    r"\.weight$",
    r".*transformer_blocks\.\d+\.(ff|ff_context)\.(net\.0\.proj|net\.2|linear_in|linear_out)\.weight$",
    r".*single_transformer_blocks\.\d+\.(linear1|linear2)\.weight$",
)


def _preset(name: str, attn_backend: str, dtype: str) -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=FluxConfig.tiny(attn_backend=attn_backend, dtype=dtype),
            vae=VAEConfig.tiny(latent_channels=4, dtype=dtype),
            clip_l=CLIPTextConfig.tiny(hidden_dim=16, num_heads=2, projection_dim=16, dtype=dtype),
            t5=T5Config.tiny(hidden_dim=48, num_heads=2, head_dim=8, dtype=dtype),
            t5_max_length=16,
            clip_max_length=8,
        )
    if name in ("dev", "flux1-dev", "schnell"):
        return dict(
            transformer=FluxConfig.flux1_dev(attn_backend=attn_backend, dtype=dtype,
                                             guidance_embeds=(name != "schnell")),
            vae=VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159, dtype=dtype),
            clip_l=CLIPTextConfig.clip_l(dtype=dtype),
            t5=T5Config.xxl(dtype=dtype),
            t5_max_length=512,
            clip_max_length=77,
        )
    raise ValueError(f"Unknown FLUX preset {name!r}")


class Flux1Adapter(BaseAdapter):
    sample_class = T2ISample
    default_target_patterns = FLUX_LORA_TARGETS
    embed_keys = ("prompt_embeds", "pooled_prompt_embeds", "img_ids", "txt_ids")

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------
    def load_models(self) -> None:
        ma = self.model_args
        variant = getattr(ma, "variant", None) or (
            "tiny" if ma.model_name_or_path in ("", "tiny") else "dev")
        preset = _preset(variant, ma.attn_backend, ma.inference_dtype)
        for key, sub, fn in (("transformer", "transformer", flux_transformer_overrides_from_config),
                             ("clip_l", "text_encoder", clip_text_overrides_from_config),
                             ("t5", "text_encoder_2", t5_overrides_from_config),
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
            "text_encoder_2": preset["t5"],
        }
        factories = {
            "transformer": lambda: FluxTransformer(preset["transformer"]),
            "vae": lambda: AutoencoderKL(preset["vae"]),
            "text_encoder": lambda: CLIPTextEncoder(preset["clip_l"]),
            "text_encoder_2": lambda: T5Encoder(preset["t5"]),
        }
        wanted = getattr(ma, "load_components", None)
        seed = self.training_args.seed
        self.modules = {
            comp: build_module(make, self.device, self.inference_dtype,
                               make_generator(self.device, "flux_init", seed, comp))
            for comp, make in factories.items() if not wanted or comp in set(wanted)
        }
        clip_bos = 1 if variant == "tiny" else 49406
        self.tokenizer = load_tokenizer(
            ma.model_name_or_path, "tokenizer", preset["clip_l"].vocab_size, self.clip_max_length,
            eos_token_id=preset["clip_l"].eos_token_id, bos_token_id=clip_bos)
        self.tokenizer_2 = load_tokenizer(
            ma.model_name_or_path, "tokenizer_2", preset["t5"].vocab_size, self.t5_max_length,
            eos_token_id=1, pad_token_id=0)
        self.latent_channels = preset["vae"].latent_channels
        self.vae_downscale = preset["vae"].downscale

    def weight_maps(self):
        return flux1_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # JAX flux/adapter.py:70-105: the single blocks' four projections
        # fused into linear1 first
        fuse = functools.partial(fuse_flux_single_block_qkv_mlp,
                                 num_single=self.component_configs["transformer"].num_single_blocks)
        return {"transformer": ComponentImport("transformer", FLUX1_TRANSFORMER_RENAMES, fuse),
                **{comp: ComponentImport(comp) for comp in ("text_encoder", "text_encoder_2", "vae")}}

    def scheduler_defaults(self) -> Dict[str, Any]:
        # FLUX dynamic shifting (diffusers FluxPipeline defaults)
        return dict(use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15, base_image_seq_len=256,
                    max_image_seq_len=4096)

    # ------------------------------------------------------------------
    # Packing: 2x2 latent patches as tokens, (0, row, col) ids for RoPE
    # ------------------------------------------------------------------
    @staticmethod
    def pack_latents(x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, c) → (B, h/2·w/2, 4c)."""
        B, h, w, c = x.shape
        x = x.reshape(B, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (h // 2) * (w // 2), 4 * c)

    @staticmethod
    def unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(B, h/2·w/2, 4c) → (B, h, w, c)."""
        B, L, C = x.shape
        c = C // 4
        x = x.reshape(B, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, h, w, c)

    @staticmethod
    def latent_image_ids(h: int, w: int) -> np.ndarray:
        """(h/2·w/2, 3) [0, row, col] coordinates for RoPE."""
        rows, cols = h // 2, w // 2
        ids = np.zeros((rows, cols, 3), np.float32)
        ids[..., 1] = np.arange(rows)[:, None]
        ids[..., 2] = np.arange(cols)[None, :]
        return ids.reshape(rows * cols, 3)

    # ------------------------------------------------------------------
    # Prompt encoding: T5 context + CLIP-L pooled
    # ------------------------------------------------------------------
    def _ids(self, tokenizer, prompts: Sequence[str], max_length: int) -> torch.Tensor:
        ids = tokenizer(list(prompts), max_length=max_length)["input_ids"]
        return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Prompts → fp32 device tensors ``prompt_embeds`` (B, L_t5, D_t5), the
        T5 states, and ``pooled_prompt_embeds`` (B, P), CLIP-L's pooled
        projection."""
        if isinstance(prompts, str):
            prompts = [prompts]
        missing = [k for k in ("text_encoder", "text_encoder_2") if k not in self.modules]
        if missing:
            raise RuntimeError(f"Text encoders {missing} were not loaded (load_components); "
                               "cannot encode prompts")
        clip = self.modules["text_encoder"](self._ids(self.tokenizer, prompts, self.clip_max_length))
        t5 = self.modules["text_encoder_2"](self._ids(self.tokenizer_2, prompts, self.t5_max_length))
        return {"prompt_embeds": t5.float(), "pooled_prompt_embeds": clip.pooled.float()}

    def preprocess_func(self, batch: Dict[str, Any], **_) -> Dict[str, np.ndarray]:
        """The dataset's stage-1 cache: the prompt embeddings as host fp32 numpy."""
        out: Dict[str, np.ndarray] = {}
        if batch.get("prompt") is not None:
            out.update({k: v.cpu().numpy() for k, v in self.encode_prompt(batch["prompt"]).items()})
        return out

    # ------------------------------------------------------------------
    # Velocity: embedded guidance, no CFG batch doubling
    # ------------------------------------------------------------------
    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        model = self.modules["transformer"]
        dt = self.component_configs["transformer"].compute_dtype
        B = latents.shape[0]
        guidance = torch.full((B,), float(guidance_scale), dtype=torch.float32, device=latents.device)
        # ids may arrive stacked per sample (the same for every row)
        img_ids, txt_ids = embeds["img_ids"], embeds["txt_ids"]
        img_ids = img_ids[0] if img_ids.ndim == 3 else img_ids
        txt_ids = txt_ids[0] if txt_ids.ndim == 3 else txt_ids
        args = (latents.to(dt), t, embeds["prompt_embeds"], embeds.get("pooled_prompt_embeds"), img_ids, txt_ids,
                guidance)
        v = functional_call(model, params, args) if params else model(*args)
        return v.float()

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
        extra_embeds: Optional[Dict[str, Any]] = None,
        do_cfg_override: Optional[bool] = None,
        **_,
    ) -> List[T2ISample]:
        """Full rollout → host-resident samples with packed trajectories
        (B, L, 4c), log-probs and images (3, H, W) in [0, 1]. Noise comes
        from ``generator`` (default: seeded from ``seed``; one per row for
        per-prompt eval noise); ``x0`` (B, h, w, c), drawn unpacked as the
        JAX adapter draws it, and per-step packed ``noise`` replace its
        draws when given. The LoRA of ``trainable`` (default: the live tree)
        is merged once, here. ``extra_embeds`` ({key: (B, ...)}) join the
        embeds every step's velocity reads, and each sample keeps its row of
        them in ``extra_kwargs`` (Kontext's condition tokens).
        ``do_cfg_override`` turns on the velocity's CFG batch (the true-CFG
        families: their negatives ride ``extra_embeds``)."""
        ta = self.training_args
        height = height or ta.height
        width = width or ta.width
        T = num_inference_steps or ta.num_inference_steps
        g = float(ta.guidance_scale if guidance_scale is None else guidance_scale)

        if prompt_embeds is None:
            enc = self.encode_prompt(list(prompt))
            prompt_embeds, pooled_prompt_embeds = enc["prompt_embeds"], enc.get("pooled_prompt_embeds")
        h, w, c = self.latent_shape(height, width)
        txt_len = prompt_embeds.shape[1]
        img_ids = self.latent_image_ids(h, w)
        txt_ids = np.zeros((txt_len, 3), np.float32)
        embeds = {"prompt_embeds": self._on_device(prompt_embeds), "img_ids": self._on_device(img_ids),
                  "txt_ids": self._on_device(txt_ids)}
        if pooled_prompt_embeds is not None:
            embeds["pooled_prompt_embeds"] = self._on_device(pooled_prompt_embeds)
        extra_embeds = {k: self._on_device(v) for k, v in (extra_embeds or {}).items()}
        embeds.update(extra_embeds)
        B = embeds["prompt_embeds"].shape[0]

        timesteps = self.scheduler.set_timesteps(T, seq_len=(h // 2) * (w // 2))
        sigmas = self.scheduler.sigmas
        noise_levels = self.scheduler.get_noise_levels()
        dynamics = "ODE" if self.scheduler.is_eval else self.scheduler.dynamics_type
        maps = build_store_maps(trajectory_indices, T)

        if generator is None:
            generator = make_generator(self.device, "rollout", ta.seed if seed is None else seed)
        x0, generator = self.initial_latents((B, h, w, c), generator, x0)
        x0 = self.pack_latents(x0)

        params = self.merged_params(self.velocity_component, trainable)
        x_final, lat_buf, lp_buf, mean_buf = self.rollout_compute(
            x0, embeds, g, sigmas, timesteps, noise_levels,
            maps.latent_store_slot, maps.logprob_store_slot, generator, noise, params,
            do_cfg=bool(do_cfg_override), compute_log_prob=compute_log_prob, dynamics_type=dynamics,
            num_latent_slots=maps.num_latent_slots, num_logprob_slots=maps.num_logprob_slots,
            store_means=store_means,
        )
        del params
        images = self.decode_latents(x_final, height=height, width=width) if decode else [None] * B

        # host copies, once per rollout
        lat_np = lat_buf.float().cpu().numpy()  # (S, B, L, 4c)
        lp_np = lp_buf.cpu().numpy()
        mean_np = mean_buf.float().cpu().numpy() if mean_buf is not None else None
        host = {k: v.cpu().numpy() for k, v in embeds.items()}
        ts_np = np.asarray(timesteps, np.float32)
        samples: List[T2ISample] = []
        for i in range(B):
            extra = {
                "sigmas": np.asarray(sigmas, np.float32),
                "noise_levels": np.asarray(noise_levels, np.float32),
                "guidance_scale": g,
                "img_ids": img_ids,
                "txt_ids": txt_ids,
            }
            if pooled_prompt_embeds is not None:
                extra["pooled_prompt_embeds"] = host["pooled_prompt_embeds"][i]
            extra.update({k: host[k][i] for k in extra_embeds})
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
                extra_kwargs=extra,
            ))
        return samples

    # ------------------------------------------------------------------
    # Decoding
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, height: Optional[int] = None, width: Optional[int] = None,
                       fetch: bool = True):
        """Packed (B, L, 4c) latents → (B, 3, H, W) float images in [0, 1];
        host numpy when ``fetch``, else the device tensor."""
        ta = self.training_args
        h, w, _ = self.latent_shape(height or ta.height, width or ta.width)
        z = self.unpack_latents(latents.float(), h, w).permute(0, 3, 1, 2)
        img = self.modules["vae"].decode(z)
        img = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
        return img.cpu().numpy() if fetch else img
