"""Wan 2.1 text→video adapter (port of ``flow_factory_tpu/models/wan/t2v.py``).

5-D latents (B, T, H, W, C), UMT5 text conditioning (the 512 padded token
embeddings as they come out of the encoder, with no attention mask, as the
JAX package keeps them), true-CFG batch doubling in ``[uncond, cond]``
order, and the UniPC-SDE scheduler: the rollout and replay steps are the
FlowMatch-Euler SDE ones, an eval rollout runs the UniPC predictor-corrector
(``rollout_compute``). Every component is random-initialised from the seed
directly on the adapter's device in the inference dtype; the LoRA is merged
once per rollout and the transformer runs on the merged weights through
``functional_call``. Not ported, and raising if asked for: the Wan2.2 MoE
(``transformer_2``, ``boundary_ratio``, ``guidance_scale_2``), the Wan2.2
presets, the I2V image stream and the chunked decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from ...samples import T2VSample
from ...utils.base import make_generator
from ...utils.tokenizer import load_tokenizer
from ...utils.trajectory import build_store_maps
from ...utils.weights import wan_t2v_component_maps
from ..abc import BaseAdapter
from ..layers import build_module
from ..text_encoders import T5Config, T5Encoder
from .transformer import WanConfig, WanTransformer
from .video_vae import VideoVAE, VideoVAEConfig

#: LoRA targets (JAX ``wan/t2v.py:32-35``) over diffusers names: every
#: attention projection and both FFN linears of every block
WAN_LORA_TARGETS = (
    r".*blocks\.\d+\.(attn1|attn2)\.(to_q|to_k|to_v|to_out\.0)\.weight$",
    r".*blocks\.\d+\.ffn\.net\.(0\.proj|2)\.weight$",
)


def _preset(name: str, attn_backend: str, dtype: str) -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=WanConfig.tiny(attn_backend=attn_backend, dtype=dtype, context_dim=32),
            vae=VideoVAEConfig.tiny(latent_channels=16, dtype=dtype),
            t5=T5Config.tiny(hidden_dim=32, num_heads=2, head_dim=8, dtype=dtype),
            t5_max_length=16,
        )
    if name in ("1.3b", "wan2.1-1.3b", "t2v-1.3b", "14b", "wan2.1-14b"):
        big = name.startswith("14") or name == "wan2.1-14b"
        return dict(
            transformer=(WanConfig.wan21_14b if big else WanConfig.wan21_1_3b)(
                attn_backend=attn_backend, dtype=dtype),
            vae=VideoVAEConfig.wan(dtype=dtype),
            t5=T5Config.umt5_xxl(dtype=dtype),
            t5_max_length=512,
        )
    if name in ("wan2.2-a14b", "a14b", "wan2.2-ti2v-5b", "ti2v-5b", "5b"):
        raise NotImplementedError(f"the Wan2.2 preset {name!r} is not ported yet")
    raise ValueError(f"Unknown Wan preset {name!r}")


class WanT2VAdapter(BaseAdapter):
    sample_class = T2VSample
    default_target_patterns = WAN_LORA_TARGETS
    default_scheduler = "unipc"
    embed_keys = ("prompt_embeds", "negative_prompt_embeds")

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------
    def load_models(self) -> None:
        ma = self.model_args
        if getattr(ma, "boundary_ratio", None) or getattr(self.training_args, "guidance_scale_2", None):
            raise NotImplementedError("the Wan2.2 MoE (boundary_ratio, guidance_scale_2) is not ported yet")
        variant = getattr(ma, "variant", None) or (
            "tiny" if ma.model_name_or_path in ("", "tiny") else "1.3b")
        preset = _preset(variant, ma.attn_backend, ma.inference_dtype)
        if self.training_args.enable_gradient_checkpointing or ma.enable_gradient_checkpointing_override:
            preset["transformer"] = dataclasses.replace(preset["transformer"], remat=True)
        self.t5_max_length = preset["t5_max_length"]
        self.component_configs = {
            "transformer": preset["transformer"],
            "vae": preset["vae"],
            "text_encoder": preset["t5"],
        }
        factories = {
            "transformer": lambda: WanTransformer(preset["transformer"]),
            "vae": lambda: VideoVAE(preset["vae"]),
            "text_encoder": lambda: T5Encoder(preset["t5"]),
        }
        wanted = getattr(ma, "load_components", None)
        seed = self.training_args.seed
        self.modules = {
            comp: build_module(make, self.device, self.inference_dtype,
                               make_generator(self.device, "wan_init", seed, comp))
            for comp, make in factories.items() if not wanted or comp in set(wanted)
        }
        self.tokenizer = load_tokenizer(ma.model_name_or_path, "tokenizer", preset["t5"].vocab_size,
                                        self.t5_max_length, eos_token_id=1, pad_token_id=0)
        vcfg: VideoVAEConfig = preset["vae"]
        self.latent_channels = vcfg.latent_channels
        self.vae_spatial_down = vcfg.spatial_down
        self.vae_temporal_down = vcfg.temporal_down

    def weight_maps(self):
        return wan_t2v_component_maps(self.component_configs)

    def scheduler_defaults(self) -> Dict[str, Any]:
        # Wan: a static flow shift (no resolution-dependent mu)
        return dict(shift=float(getattr(self.training_args, "flow_shift", 3.0)))

    # ------------------------------------------------------------------
    # Prompt encoding
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Prompts → ``prompt_embeds`` (B, 512, 4096) fp32 on the device: the
        UMT5 states of the padded ids, pad positions included."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if "text_encoder" not in self.modules:
            raise RuntimeError("text_encoder was not loaded (load_components); cannot encode prompts")
        ids = self.tokenizer(list(prompts), max_length=self.t5_max_length)["input_ids"]
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return {"prompt_embeds": self.modules["text_encoder"](ids).float()}

    def preprocess_func(self, batch: Dict[str, Any], **_) -> Dict[str, np.ndarray]:
        """The dataset's stage-1 cache: prompt and negative-prompt embeddings
        as host fp32 numpy."""
        out: Dict[str, np.ndarray] = {}
        prompts = batch.get("prompt")
        if prompts is not None:
            out["prompt_embeds"] = self.encode_prompt(prompts)["prompt_embeds"].cpu().numpy()
            neg = batch.get("negative_prompt") or [""] * len(prompts)
            out["negative_prompt_embeds"] = self.encode_prompt(neg)["prompt_embeds"].cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # Velocity
    # ------------------------------------------------------------------
    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        model = self.modules["transformer"]
        dt = self.component_configs["transformer"].compute_dtype
        run = lambda *args: functional_call(model, params, args) if params else model(*args)
        if do_cfg:
            ctx = torch.cat([embeds["negative_prompt_embeds"], embeds["prompt_embeds"]]).to(dt)
            v = run(torch.cat([latents, latents]).to(dt), torch.cat([t, t]), ctx).float()
            v_uncond, v_cond = v.chunk(2)
            return v_uncond + guidance_scale * (v_cond - v_uncond)
        return run(latents.to(dt), t, embeds["prompt_embeds"].to(dt)).float()

    # ------------------------------------------------------------------
    # Rollout → samples
    # ------------------------------------------------------------------
    def latent_shape(self, height: int, width: int, num_frames: int) -> Tuple[int, int, int, int]:
        """Wan frame convention: T_latent = 1 + ceil((T − 1) / temporal_down)."""
        t = 1 + -(-(max(num_frames, 1) - 1) // self.vae_temporal_down)
        return (t, height // self.vae_spatial_down, width // self.vae_spatial_down, self.latent_channels)

    @torch.no_grad()
    def inference(
        self,
        prompt: Optional[Sequence[str]] = None,
        prompt_embeds=None,
        negative_prompt: Optional[Sequence[str]] = None,
        negative_prompt_embeds=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
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
    ) -> List[T2VSample]:
        """Full rollout → host-resident samples with trajectories, log-probs
        and videos (T, C, H, W) in [0, 1]. Noise comes from ``generator``
        (default: seeded from ``seed``; one per row for per-prompt eval
        noise, :meth:`initial_latents`); ``x0`` and per-step ``noise``
        replace its draws when given. In eval mode the scheduler's UniPC
        predictor-corrector runs and the log-probs are zeros."""
        ta = self.training_args
        height = height or ta.height
        width = width or ta.width
        num_frames = num_frames or int(getattr(ta, "num_frames", 5))
        T = num_inference_steps or ta.num_inference_steps
        g = float(ta.guidance_scale if guidance_scale is None else guidance_scale)
        do_cfg = g > 1.0

        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(list(prompt))["prompt_embeds"]
        if do_cfg and negative_prompt_embeds is None:
            neg = list(negative_prompt) if negative_prompt is not None else [""] * len(prompt_embeds)
            negative_prompt_embeds = self.encode_prompt(neg)["prompt_embeds"]
        embeds = {"prompt_embeds": self._on_device(prompt_embeds)}
        if do_cfg:
            embeds["negative_prompt_embeds"] = self._on_device(negative_prompt_embeds)
        B = embeds["prompt_embeds"].shape[0]

        shape = self.latent_shape(height, width, num_frames)
        timesteps = self.scheduler.set_timesteps(T)
        sigmas = self.scheduler.sigmas
        noise_levels = self.scheduler.get_noise_levels()
        dynamics = "ODE" if self.scheduler.is_eval else self.scheduler.dynamics_type
        maps = build_store_maps(trajectory_indices, T)

        if generator is None:
            generator = make_generator(self.device, "rollout", ta.seed if seed is None else seed)
        x0, generator = self.initial_latents((B, *shape), generator, x0)

        params = self.merged_params(self.velocity_component, trainable)
        x_final, lat_buf, lp_buf, mean_buf = self.rollout_compute(
            x0, embeds, g, sigmas, timesteps, noise_levels,
            maps.latent_store_slot, maps.logprob_store_slot, generator, noise, params,
            do_cfg=do_cfg, compute_log_prob=compute_log_prob, dynamics_type=dynamics,
            num_latent_slots=maps.num_latent_slots, num_logprob_slots=maps.num_logprob_slots,
            store_means=store_means,
        )
        videos = self.decode_latents(x_final, num_frames=num_frames) if decode else [None] * B

        # host copies, once per rollout
        lat_np = lat_buf.float().cpu().numpy()  # (S, B, T, h, w, c)
        lp_np = lp_buf.cpu().numpy()
        mean_np = mean_buf.float().cpu().numpy() if mean_buf is not None else None
        host = {k: v.cpu().numpy() for k, v in embeds.items()}
        ts_np = np.asarray(timesteps, np.float32)
        samples: List[T2VSample] = []
        for i in range(B):
            extra = {
                "sigmas": np.asarray(sigmas, np.float32),
                "noise_levels": np.asarray(noise_levels, np.float32),
                "guidance_scale": g,
                "num_frames": num_frames,
            }
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
                video=videos[i],
                prompt=prompt[i] if prompt is not None else None,
                prompt_embeds=host["prompt_embeds"][i],
                negative_prompt_embeds=host["negative_prompt_embeds"][i] if do_cfg else None,
                extra_kwargs=extra,
            ))
        return samples

    # ------------------------------------------------------------------
    # Decoding and encoding
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, num_frames: Optional[int] = None, fetch: bool = True):
        """(B, Tl, h, w, c) latents → (B, T, C, H, W) videos in [0, 1]; host
        numpy when ``fetch``, else the device tensor."""
        if getattr(self.model_args, "vae_decode_chunk", 0) or latents.shape[1] > 16:
            raise NotImplementedError("the chunked video decode (clips past 16 latent frames) is not ported yet")
        video = self.modules["vae"].decode(latents.float(), num_frames)  # (B, C, T, H, W)
        video = torch.clamp(video.float() / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 1, 3, 4)
        return video.cpu().numpy() if fetch else video

    @torch.no_grad()
    def encode_video(self, videos) -> np.ndarray:
        """(B, T, C, H, W) in [0, 1] → latents (B, Tl, h, w, c), host numpy
        (the posterior mean)."""
        v = self._on_device(videos).permute(0, 2, 1, 3, 4) * 2.0 - 1.0
        return self.modules["vae"].encode(v).float().cpu().numpy()
