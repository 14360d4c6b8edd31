"""Wan 2.x text→video adapter (port of ``flow_factory_tpu/models/wan/t2v.py``).

5-D latents (B, T, H, W, C), UMT5 text conditioning (the 512 padded token
embeddings as they come out of the encoder, with no attention mask, as the
JAX package keeps them), true-CFG batch doubling in ``[uncond, cond]``
order, and the UniPC-SDE scheduler: the rollout and replay steps are the
FlowMatch-Euler SDE ones, an eval rollout runs the UniPC predictor-corrector
(``rollout_compute``). Every component is random-initialised from the seed
directly on the adapter's device in the inference dtype, or configured and
imported from a local diffusers-layout checkpoint; the LoRA is merged
once per rollout and the transformer runs on the merged weights through
``functional_call``.

Wan2.2-A14B's temporal MoE (``boundary_ratio``): two experts of one
geometry, ``transformer`` for the low-noise steps and ``transformer_2`` for
t ≥ boundary_ratio · 1000 (compared in fp32, as JAX's ``lax.cond`` does),
each with its own LoRA, and ``guidance_scale_2`` the low-noise expert's CFG
scale. The step's expert is chosen on the host from the timestep the
rollout, the replay and the trainer already hold (:meth:`step_params`), and
an expert's LoRA is merged the first time a call routes to it, so a grad
step merges (and differentiates) the routed expert only: the other one's
LoRA gets zero gradients, as under ``lax.cond``. Long clips decode in
chunks (``VideoVAE.decode_chunked``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from ...samples import T2VSample
from ...utils.base import make_generator
from ...utils.checkpoint import ComponentImport
from ...utils.model_config import (
    apply_config_json_overrides,
    t5_overrides_from_config,
    wan_transformer_overrides_from_config,
    wan_vae_overrides_from_config,
)
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
    """The JAX package's presets (``wan/t2v.py:38-84``)."""
    umt5 = dict(t5=T5Config.umt5_xxl(dtype=dtype), t5_max_length=512)
    if name == "tiny":
        return dict(
            transformer=WanConfig.tiny(attn_backend=attn_backend, dtype=dtype, context_dim=32),
            vae=VideoVAEConfig.tiny(latent_channels=16, dtype=dtype),
            t5=T5Config.tiny(hidden_dim=32, num_heads=2, head_dim=8, dtype=dtype),
            t5_max_length=16,
            boundary_ratio=None,
        )
    if name in ("1.3b", "wan2.1-1.3b", "t2v-1.3b", "14b", "wan2.1-14b"):
        big = name.startswith("14") or name == "wan2.1-14b"
        return dict(transformer=(WanConfig.wan21_14b if big else WanConfig.wan21_1_3b)(
            attn_backend=attn_backend, dtype=dtype), vae=VideoVAEConfig.wan(dtype=dtype), boundary_ratio=None, **umt5)
    if name in ("wan2.2-a14b", "a14b"):
        return dict(transformer=WanConfig.wan21_14b(attn_backend=attn_backend, dtype=dtype),
                    vae=VideoVAEConfig.wan(dtype=dtype), boundary_ratio=0.875, **umt5)  # high-noise expert above t 875
    if name in ("wan2.2-ti2v-5b", "ti2v-5b", "5b"):
        # a dense 5B DiT over the 48-channel 16x16x4 VAE; its TI2V
        # conditioning (expand_timesteps) lives in the I2V adapter
        return dict(transformer=WanConfig(in_channels=48, out_channels=48, hidden_dim=3072, ffn_dim=14336,
                                          num_heads=24, num_layers=30, axes_dim=(44, 42, 42),
                                          attn_backend=attn_backend, dtype=dtype),
                    vae=VideoVAEConfig.wan22_5b(dtype=dtype), boundary_ratio=None, **umt5)
    raise ValueError(f"Unknown Wan preset {name!r}")


def _overridden(cfg, overrides):
    """A config with a YAML override dict applied (lists become tuples)."""
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list) else v for k, v in dict(overrides).items()})


class Routed(NamedTuple):
    """One step's expert: its module name, its effective weights, and
    whether it is the high-noise expert (CFG at ``guidance_scale``)."""

    component: str
    params: Dict[str, torch.Tensor]
    high: bool


class WanExperts:
    """The MoE's one kind of effective weights, for the trained, the frozen
    and the reference policies alike: each expert's merge of ``trainable``
    (``{}``: no LoRA, the frozen experts) made the first time a step routes
    to it, then kept for the rest of the call (a rollout merges each expert
    at most once). :meth:`WanT2VAdapter.step_params` routes it."""

    def __init__(self, adapter: "WanT2VAdapter", trainable):
        self._adapter, self._trainable, self._merged = adapter, trainable, {}

    def __getitem__(self, component: str) -> Dict[str, torch.Tensor]:
        if component not in self._merged:
            self._merged[component] = self._adapter.merge_component(component, self._trainable)
        return self._merged[component]


class WanT2VAdapter(BaseAdapter):
    sample_class = T2VSample
    default_target_patterns = WAN_LORA_TARGETS
    default_scheduler = "unipc"
    embed_keys = ("prompt_embeds", "negative_prompt_embeds")
    #: the MoE's reads of row 0's timestep from the device to route a call
    #: that came with no host timestep (:meth:`_velocity`), counted for every
    #: Wan adapter as the kernel wrappers count their launches; the rollout,
    #: the replay and every trainer's grad step give the host value
    route_reads = 0

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------
    def load_models(self) -> None:
        ma = self.model_args
        variant = getattr(ma, "variant", None) or (
            "tiny" if ma.model_name_or_path in ("", "tiny") else "1.3b")
        preset = _preset(variant, ma.attn_backend, ma.inference_dtype)
        # a checkpoint directory's config.json files first (JAX wan/t2v.py:131-158:
        # the DiT, UMT5, and the VAE's graph and latent normalisation) ...
        path = ma.model_name_or_path
        tcfg = apply_config_json_overrides(preset["transformer"], path, "transformer",
                                           wan_transformer_overrides_from_config)
        declared_width = tcfg.in_channels != preset["transformer"].in_channels
        preset["t5"] = apply_config_json_overrides(preset["t5"], path, "text_encoder", t5_overrides_from_config)
        if self.training_args.enable_gradient_checkpointing or ma.enable_gradient_checkpointing_override:
            tcfg = dataclasses.replace(tcfg, remat=True)
        preset["vae"] = apply_config_json_overrides(preset["vae"], path, "vae", wan_vae_overrides_from_config)
        # ... then the explicit config knobs win (JAX :161-174): e.g. Wan 2.2's
        # `vae_overrides`, or a depth cut at full width, `transformer_overrides:
        # {num_layers: 8}`
        preset["vae"] = _overridden(preset["vae"], getattr(ma, "vae_overrides", None))
        tcfg = _overridden(tcfg, getattr(ma, "transformer_overrides", None))
        tcfg = self.transformer_config(tcfg, preset["vae"], declared_width)
        self.t5_max_length = preset["t5_max_length"]
        self.boundary_ratio = getattr(ma, "boundary_ratio", None) or preset["boundary_ratio"]
        self.component_configs = {
            "transformer": tcfg,
            "vae": preset["vae"],
            "text_encoder": preset["t5"],
        }
        factories = {
            "transformer": lambda: WanTransformer(tcfg),
            "vae": lambda: VideoVAE(preset["vae"]),
            "text_encoder": lambda: T5Encoder(preset["t5"]),
        }
        if self.boundary_ratio is not None:  # the high-noise expert, initialised from its own generator
            factories["transformer_2"] = lambda: WanTransformer(tcfg)
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

    def transformer_config(self, cfg: WanConfig, vae: VideoVAEConfig, declared_width: bool = False) -> WanConfig:
        """The DiT's config from the preset's (the conditioned adapters widen
        it, unless a checkpoint's config.json declared another input width,
        ``declared_width``)."""
        return cfg

    @property
    def is_moe(self) -> bool:
        return self.boundary_ratio is not None and "transformer_2" in self.modules

    @property
    def trainable_components(self) -> Tuple[str, ...]:
        # the MoE trains both experts (JAX wan/t2v.py:233-240)
        comps = super().trainable_components
        return ("transformer", "transformer_2") if self.is_moe and comps == ("transformer",) else comps

    def weight_maps(self):
        return wan_t2v_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # the diffusers names throughout, each MoE expert from its own
        # subfolder (JAX wan/t2v.py:93-121)
        return {comp: ComponentImport(comp) for comp in ("transformer", "transformer_2", "text_encoder", "vae")}

    def merged_params(self, component: str, trainable=None):
        """The MoE gives both experts (JAX ``merged_params``, ``wan/t2v.py:328-335``),
        merged lazily, ``trainable={}`` the frozen ones; otherwise the
        component's merge."""
        if component == "transformer" and self.is_moe:
            return WanExperts(self, self.trainable if trainable is None else trainable)
        return super().merged_params(component, trainable)

    def routes_high(self, t: float) -> bool:
        """Whether timestep ``t`` goes to the high-noise expert: t ≥
        boundary_ratio · 1000, both in fp32."""
        return bool(np.float32(t) >= np.float32(self.boundary_ratio * 1000.0))

    def step_params(self, params, t_host):
        if isinstance(params, WanExperts) and t_host is not None:
            high = self.routes_high(t_host)
            comp = "transformer_2" if high else "transformer"
            return Routed(comp, params[comp], high)
        return params

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
        """``params``: the dense transformer's effective weights, or on the
        MoE a :class:`Routed` expert, or its :class:`WanExperts` where the
        caller had no host timestep: then row 0's t (with per-frame t, its
        largest) is read from the device, as JAX routes."""
        if isinstance(params, WanExperts):
            WanT2VAdapter.route_reads += 1
            t0 = t[0] if t.ndim == 1 else t[0].max()
            params = self.step_params(params, float(t0))
        if isinstance(params, Routed):
            comp, params, high = params
        elif self.is_moe:
            raise TypeError("the MoE's velocity takes its experts (merged_params) or one routed expert "
                            f"(step_params), not {type(params).__name__}")
        else:
            comp, high = "transformer", True
        model = self.modules[comp]
        dt = self.component_configs["transformer"].compute_dtype
        img = embeds.get("image_embeds")  # Wan2.1 I2V's CLIP tokens, cast at use like the text context

        def run(x, tt, ctx, img):
            args = (x, tt, ctx) if img is None else (x, tt, ctx, img.to(dt))
            return functional_call(model, params, args) if params else model(*args)

        if do_cfg:
            ctx = torch.cat([embeds["negative_prompt_embeds"], embeds["prompt_embeds"]]).to(dt)
            img2 = None if img is None else torch.cat([img, img])  # the image context is not CFG-dropped
            v = run(torch.cat([latents, latents]).to(dt), torch.cat([t, t]), ctx, img2).float()
            v_uncond, v_cond = v.chunk(2)
            g2 = getattr(self.training_args, "guidance_scale_2", None)
            if self.is_moe and g2 is not None and not high:  # the low-noise expert's own CFG scale
                guidance_scale = float(g2)
            return v_uncond + guidance_scale * (v_cond - v_uncond)
        return run(latents.to(dt), t, embeds["prompt_embeds"].to(dt), img).float()

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
        extra_embeds: Optional[Dict[str, Any]] = None,
        **_,
    ) -> List[T2VSample]:
        """Full rollout → host-resident samples with trajectories, log-probs
        and videos (T, C, H, W) in [0, 1]. Noise comes from ``generator``
        (default: seeded from ``seed``; one per row for per-prompt eval
        noise, :meth:`initial_latents`); ``x0`` and per-step ``noise``
        replace its draws when given. In eval mode the scheduler's UniPC
        predictor-corrector runs and the log-probs are zeros.
        ``extra_embeds`` ({key: (B, ...)}) join the embeds every step's
        velocity reads, and each sample keeps its row of them in
        ``extra_kwargs`` (the I2V/V2V ``cond_latents``)."""
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
        extra_embeds = {k: self._on_device(v) for k, v in (extra_embeds or {}).items()}
        embeds.update(extra_embeds)
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
                **{k: host[k][i] for k in extra_embeds},
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
        numpy when ``fetch``, else the device tensor. ``model.vae_decode_chunk``
        latent frames at a time (8 past 16 latent frames), with 8 of left
        context: the same frames, less activation memory."""
        chunk = int(getattr(self.model_args, "vae_decode_chunk", 0) or 0)
        if not chunk and latents.shape[1] > 16:
            chunk = 8
        vae = self.modules["vae"]
        latents = self._on_device(latents)
        video = vae.decode_chunked(latents, chunk, 8, num_frames) if chunk else vae.decode(latents, num_frames)
        video = torch.clamp(video.float() / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 1, 3, 4)
        return video.cpu().numpy() if fetch else video

    @torch.no_grad()
    def encode_video(self, videos) -> np.ndarray:
        """(B, T, C, H, W) in [0, 1] → latents (B, Tl, h, w, c), host numpy
        (the posterior mean)."""
        v = self._on_device(videos).permute(0, 2, 1, 3, 4) * 2.0 - 1.0
        return self.modules["vae"].encode(v).float().cpu().numpy()
