"""LTX-2 text→audio-video adapter (port of ``flow_factory_tpu/models/ltx2/t2av.py``).

A dual-stream transformer (video and audio token streams), Gemma3 text
conditioning through two connector projections, and two schedules: the
video stream takes the FlowMatch-Euler SDE step with a log-prob, the audio
stream an ODE step on the audio scheduler's own sigma grid. Both stored
streams round through the storage dtype, and the rollout continues from the
very latents it stores, so a replay that feeds the stored audio latent of
the same slot beside the video latent gives the rollout's log-prob bit for
bit (:attr:`trajectory_batch_keys`).

Guidance (``_joint_velocity``): CFG by batch doubling in ``[uncond, cond]``
order; with ``stg_scale`` > 0 (and STG blocks) or ``modality_scale`` > 1
the terms compose in x0 space, with one forward that skips the STG blocks
and one with the cross-modal attentions off. Decode: the LTX video VAE
(timestep-conditioned, with the ``decode_timestep`` / ``decode_noise_scale``
model knobs), and the audio VAE's mel decoder then the HiFi-GAN vocoder.

Every component is random-initialised from the seed directly on the
adapter's device in the inference dtype, or configured and imported from a
local diffusers-layout checkpoint. Under ``use_prompt_enhancer`` the
rollout's prompts are rewritten by the Gemma3 LM itself before they are
encoded (``text_encoders/caption.py``, with the enhancer's own template).
The decoupled trainers train on the tree of both streams
(:attr:`decoupled_latent_keys`), one joint pass giving both leaves
(:meth:`training_velocity_tree`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ...samples import T2AVSample
from ...scheduler.flow_match_euler import (
    FlowMatchEulerSDE,
    convert_velocity_to_x0,
    convert_x0_to_velocity,
    sde_step,
)
from ...utils.base import make_generator
from ...utils.checkpoint import (
    LTX2_AUDIO_VAE_RENAMES,
    LTX2_TRANSFORMER_RENAMES,
    LTX_VIDEO_VAE_RENAMES,
    ComponentImport,
    hifigan_vocoder_preprocess,
    pop_ltx_vae_latent_stats,
)
from ...utils.model_config import (
    apply_config_json_overrides,
    lm_overrides_from_config,
    load_component_config,
    ltx2_audio_vae_overrides_from_config,
    ltx2_transformer_overrides_from_config,
    ltx_video_vae_overrides_from_config,
)
from ...utils.tokenizer import load_tokenizer
from ...utils.trajectory import build_store_maps
from ...utils.weights import ltx2_component_maps
from ..abc import BaseAdapter
from ..layers import build_module
from ..text_encoders.caption import LMCaptionUpsampler
from ..text_encoders.lm import LMConfig, LMEncoder
from .audio import AudioVAE, AudioVAEConfig
from .transformer import LTX2Config, LTX2Transformer
from .video_vae import LTXVideoVAE, LTXVideoVAEConfig

#: LoRA targets (JAX ``ltx2/t2av.py:48-52``) over the port's names: the four
#: projections of the six attentions and both linears of the two FFNs, 28 a block
LTX2_LORA_TARGETS = (
    r".*transformer_blocks\.\d+\.(attn1|audio_attn1|attn2|audio_attn2|audio_to_video_attn|video_to_audio_attn)"
    r"\.(to_q|to_k|to_v|to_out\.0)\.weight$",
    r".*transformer_blocks\.\d+\.(ff|audio_ff)\.net\.(0\.proj|2)\.weight$",
)


def _preset(name: str, attn_backend: str, dtype: str) -> Dict[str, Any]:
    if name == "tiny":
        return dict(
            transformer=LTX2Config.tiny(attn_backend=attn_backend, dtype=dtype),
            video_vae=LTXVideoVAEConfig.tiny(latent_channels=16, dtype=dtype),
            audio_vae=AudioVAEConfig.tiny(dtype=dtype),
            lm=LMConfig.tiny(hidden_dim=32, dtype=dtype),
            max_length=16,
        )
    if name == "ltx2":
        return dict(
            transformer=LTX2Config.ltx2(attn_backend=attn_backend, dtype=dtype, video_channels=128,
                                        audio_channels=128),
            video_vae=LTXVideoVAEConfig.ltx2(dtype=dtype),
            audio_vae=AudioVAEConfig.ltx2(latent_channels=128, dtype=dtype),
            lm=LMConfig.gemma3(dtype=dtype),
            max_length=512,
        )
    raise ValueError(f"Unknown LTX-2 preset {name!r}")


class LTX2T2AVAdapter(BaseAdapter):
    sample_class = T2AVSample
    default_target_patterns = LTX2_LORA_TARGETS
    embed_keys = ("prompt_embeds", "negative_prompt_embeds", "video_ids", "audio_ids")
    trajectory_batch_keys = {"audio_latents": "audio_all_latents"}

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------
    def load_models(self) -> None:
        ma = self.model_args
        variant = getattr(ma, "variant", None) or ("tiny" if ma.model_name_or_path in ("", "tiny") else "ltx2")
        preset = _preset(variant, ma.attn_backend, ma.inference_dtype)
        path = ma.model_name_or_path
        for key, sub, fn in (("transformer", "transformer", ltx2_transformer_overrides_from_config),
                             ("audio_vae", "audio_vae", ltx2_audio_vae_overrides_from_config),
                             ("lm", "text_encoder", lm_overrides_from_config),
                             ("video_vae", "vae", ltx_video_vae_overrides_from_config)):
            preset[key] = apply_config_json_overrides(preset[key], path, sub, fn)
        # the VAEs' latent widths are the transformer's token widths (JAX
        # ltx2/t2av.py:160-176): where they differ, a VAE config.json that
        # declares its width wins, else the transformer's does; the
        # connectors read the LM's hidden states
        for tx_field, key, sub in (("video_channels", "video_vae", "vae"), ("audio_channels", "audio_vae", "audio_vae")):
            tx_w, vae_w = getattr(preset["transformer"], tx_field), preset[key].latent_channels
            if tx_w == vae_w:
                continue
            vae_json = load_component_config(path, sub) if path and os.path.isdir(path) else None
            if vae_json and vae_json.get("latent_channels") is not None:
                preset["transformer"] = dataclasses.replace(preset["transformer"], **{tx_field: vae_w})
            else:
                preset[key] = dataclasses.replace(preset[key], latent_channels=tx_w)
        preset["transformer"] = dataclasses.replace(preset["transformer"], context_dim=preset["lm"].hidden_dim)
        if self.training_args.enable_gradient_checkpointing or ma.enable_gradient_checkpointing_override:
            preset["transformer"] = dataclasses.replace(preset["transformer"], remat=True)
        self.max_length = preset["max_length"]
        self.component_configs = {
            "transformer": preset["transformer"],
            "vae": preset["video_vae"],
            "audio_vae": preset["audio_vae"],
            "text_encoder": preset["lm"],
        }
        factories = {
            "transformer": lambda: LTX2Transformer(preset["transformer"]),
            "vae": lambda: LTXVideoVAE(preset["video_vae"]),
            "audio_vae": lambda: AudioVAE(preset["audio_vae"]),
            "text_encoder": lambda: LMEncoder(preset["lm"]),
        }
        wanted = getattr(ma, "load_components", None)
        seed = self.training_args.seed
        self.modules = {
            comp: build_module(make, self.device, self.inference_dtype,
                               make_generator(self.device, "ltx2_init", seed, comp))
            for comp, make in factories.items() if not wanted or comp in set(wanted)
        }
        self.tokenizer = load_tokenizer(ma.model_name_or_path, "tokenizer", preset["lm"].vocab_size,
                                        self.max_length, eos_token_id=2, pad_token_id=0)
        vcfg: LTXVideoVAEConfig = preset["video_vae"]
        self.video_latent_channels = vcfg.latent_channels
        self.audio_latent_channels = preset["audio_vae"].latent_channels
        self.vae_spatial_down = vcfg.spatial_down
        self.vae_temporal_down = vcfg.temporal_down
        self.audio_cfg: AudioVAEConfig = preset["audio_vae"]
        # the audio stream's own scheduler: ODE on its own sigma grid
        self.audio_scheduler = FlowMatchEulerSDE(noise_level=0.0, dynamics_type="ODE", seed=self.scheduler_args.seed)
        # the LLM prompt enhancer (JAX ltx2/t2av.py:273-283): a greedy rewrite
        # through the conditioning decoder itself
        self.prompt_enhancer = None
        if getattr(ma, "use_prompt_enhancer", False) and "text_encoder" in self.modules:
            self.prompt_enhancer = LMCaptionUpsampler(
                self.modules["text_encoder"], self.tokenizer,
                template="Expand into a cinematic audio-video scene description: {prompt}\n",
                max_new_tokens=int(getattr(ma, "caption_max_new_tokens", 24)),
                max_length=min(self.max_length, 96))

    def weight_maps(self):
        return ltx2_component_maps(self.component_configs)

    def pretrained_component_maps(self):
        # JAX ltx2/t2av.py:84-135: the video VAE's latent statistics become
        # its config; the audio VAE takes its vocoder from a HiFi-GAN
        # generator checkpoint in vocoder/
        return {"transformer": ComponentImport("transformer", LTX2_TRANSFORMER_RENAMES),
                "text_encoder": ComponentImport("text_encoder"),
                "vae": ComponentImport("vae", LTX_VIDEO_VAE_RENAMES, self._vae_latent_stats),
                "audio_vae": ComponentImport("vocoder", LTX2_AUDIO_VAE_RENAMES, hifigan_vocoder_preprocess)}

    def _vae_latent_stats(self, sd):
        """A video VAE state dict without its ``latents_mean``/``latents_std``,
        which go into the VAE's config."""
        sd, mean, std = pop_ltx_vae_latent_stats(sd)
        if mean is not None and std is not None:
            cfg = dataclasses.replace(self.component_configs["vae"], latents_mean=mean, latents_std=std)
            self.component_configs["vae"] = self.modules["vae"].cfg = cfg
        return sd

    @property
    def decoupled_latent_keys(self) -> Dict[str, str]:
        """Both streams (JAX ``models/abc.py:355-366``): the video latents and
        the audio trajectory of :attr:`trajectory_batch_keys`, each a leaf of
        the decoupled losses' latent tree (:meth:`training_velocity_tree`)."""
        return {"latents": "all_latents", **self.trajectory_batch_keys}

    # ------------------------------------------------------------------
    # Prompt encoding
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Prompts → ``prompt_embeds`` (B, max_length, LM width) fp32 on the
        device: the LM's final states of the padded ids, pad rows included."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if "text_encoder" not in self.modules:
            raise RuntimeError("text_encoder was not loaded (load_components); cannot encode prompts")
        enc = self.tokenizer(list(prompts), max_length=self.max_length)
        to_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)
        emb = self.modules["text_encoder"](to_dev(enc["input_ids"]), to_dev(enc["attention_mask"]))
        return {"prompt_embeds": emb.float()}

    def enhance_prompt(self, prompts: Sequence[str]) -> List[str]:
        """The prompts rewritten by :attr:`prompt_enhancer`, or as given
        without one (JAX ``enhance_prompt``: the rollout's prompts only, not
        the preprocessing's)."""
        return list(self.prompt_enhancer(prompts)) if self.prompt_enhancer is not None else list(prompts)

    def preprocess_func(self, batch: Dict[str, Any], **_) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        prompts = batch.get("prompt")
        if prompts is not None:
            out["prompt_embeds"] = self.encode_prompt(prompts)["prompt_embeds"].cpu().numpy()
            neg = batch.get("negative_prompt") or [""] * len(prompts)
            out["negative_prompt_embeds"] = self.encode_prompt(neg)["prompt_embeds"].cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------
    def video_token_geometry(self, height: int, width: int, num_frames: int) -> Tuple[int, int, int]:
        """(Tl, h, w): T_latent = 1 + ceil((T − 1) / temporal_down)."""
        tl = 1 + -(-(max(num_frames, 1) - 1) // self.vae_temporal_down)
        return tl, height // self.vae_spatial_down, width // self.vae_spatial_down

    def audio_token_count(self, duration_frames: int) -> int:
        """Audio tokens of a clip of ``duration_frames`` video frames at 24 fps."""
        acfg = self.audio_cfg
        samples = int(duration_frames / 24.0 * acfg.sample_rate) + acfg.n_fft
        mel_frames = max(1, (samples - acfg.n_fft) // acfg.hop + 1)
        return max(1, mel_frames // acfg.temporal_down)

    @staticmethod
    def _video_ids(tl: int, h: int, w: int) -> np.ndarray:
        tt = np.repeat(np.arange(tl), h * w)
        hh = np.tile(np.repeat(np.arange(h), w), tl)
        ww = np.tile(np.arange(w), tl * h)
        return np.stack([tt, hh, ww], axis=-1).astype(np.float32)

    @staticmethod
    def _audio_ids(la: int, tl: int) -> np.ndarray:
        t = np.linspace(0, max(tl - 1, 0), la)
        return np.stack([t, np.zeros(la), np.zeros(la)], axis=-1).astype(np.float32)

    # ------------------------------------------------------------------
    # Velocity: CFG, STG and modality isolation composed in x0 space
    # ------------------------------------------------------------------
    @property
    def stg_scale(self) -> float:
        return float(getattr(self.training_args, "stg_scale", 0.0))

    @property
    def stg_blocks(self) -> Tuple[int, ...]:
        b = getattr(self.training_args, "spatio_temporal_guidance_blocks", None)
        return tuple(b) if b else ()

    @property
    def modality_scale(self) -> float:
        return float(getattr(self.training_args, "modality_scale", 1.0))

    @property
    def per_token_time(self) -> bool:
        """The exact per-token I2AV timestep embedding (YAML ``per_token_time``);
        off, a binary conditioning mask interpolates the t and t=0 modulations."""
        return bool(getattr(self.training_args, "per_token_time", False))

    def token_mask(self, embeds: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """Conditioned video tokens (``cond_mask`` > 0) never step and stay out
        of the log-prob."""
        cm = embeds.get("cond_mask")
        return None if cm is None else (cm <= 0.0).float()

    def _joint_velocity(self, params, v_lat, a_lat, t, embeds, guidance_scale: float, do_cfg: bool):
        """(video, audio) fp32 velocities of the guided prediction."""
        model = self.modules["transformer"]
        dt = self.component_configs["transformer"].compute_dtype
        vid_ids, aud_ids = embeds["video_ids"], embeds["audio_ids"]
        vid_ids = vid_ids[0] if vid_ids.ndim == 3 else vid_ids
        aud_ids = aud_ids[0] if aud_ids.ndim == 3 else aud_ids
        cond_mask = embeds.get("cond_mask")

        def fwd(v, a, tt, ctx, skip=(), isolate=False):
            cm = cond_mask
            if cm is not None and v.shape[0] == 2 * cm.shape[0]:  # CFG doubling
                cm = torch.cat([cm, cm])
            args = (v.to(dt), a.to(dt))
            if cm is not None and self.per_token_time:
                # every video token embeds its own t·(1 − mask)
                args += (tt[:, None] * (1.0 - cm[..., 0]), ctx, vid_ids, aud_ids)
                kw = dict(skip_blocks=skip, audio_timestep=tt, isolate_modalities=isolate)
            else:
                args += (tt, ctx, vid_ids, aud_ids)
                kw = dict(skip_blocks=skip, isolate_modalities=isolate, video_cond_mask=cm)
            vv, va = functional_call(model, params, args, kw) if params else model(*args, **kw)
            return vv.float(), va.float()

        pos_ctx = embeds["prompt_embeds"]
        if do_cfg:
            ctx = torch.cat([embeds["negative_prompt_embeds"], pos_ctx])
            vv, va = fwd(torch.cat([v_lat, v_lat]), torch.cat([a_lat, a_lat]), torch.cat([t, t]), ctx)
            vv_u, vv_c = vv.chunk(2)
            va_u, va_c = va.chunk(2)
        else:
            vv_c, va_c = fwd(v_lat, a_lat, t, pos_ctx)
            vv_u = va_u = None

        do_stg = self.stg_scale > 0.0 and len(self.stg_blocks) > 0
        do_iso = self.modality_scale > 1.0
        if not (do_stg or do_iso):
            if do_cfg:
                return vv_u + guidance_scale * (vv_c - vv_u), va_u + guidance_scale * (va_c - va_u)
            return vv_c, va_c

        sigma = (t / 1000.0).reshape(-1, 1, 1)
        v_x0 = convert_velocity_to_x0(vv_c, v_lat, sigma)
        a_x0 = convert_velocity_to_x0(va_c, a_lat, sigma)
        v_delta, a_delta = torch.zeros_like(v_x0), torch.zeros_like(a_x0)
        if do_cfg:
            v_delta = v_delta + (guidance_scale - 1.0) * (v_x0 - convert_velocity_to_x0(vv_u, v_lat, sigma))
            a_delta = a_delta + (guidance_scale - 1.0) * (a_x0 - convert_velocity_to_x0(va_u, a_lat, sigma))
        if do_stg:
            sv, sa = fwd(v_lat, a_lat, t, pos_ctx, skip=self.stg_blocks)
            v_delta = v_delta + self.stg_scale * (v_x0 - convert_velocity_to_x0(sv, v_lat, sigma))
            a_delta = a_delta + self.stg_scale * (a_x0 - convert_velocity_to_x0(sa, a_lat, sigma))
        if do_iso:
            iv, ia = fwd(v_lat, a_lat, t, pos_ctx, isolate=True)
            v_delta = v_delta + (self.modality_scale - 1.0) * (v_x0 - convert_velocity_to_x0(iv, v_lat, sigma))
            a_delta = a_delta + (self.modality_scale - 1.0) * (a_x0 - convert_velocity_to_x0(ia, a_lat, sigma))
        return (convert_x0_to_velocity(v_x0 + v_delta, v_lat, sigma),
                convert_x0_to_velocity(a_x0 + a_delta, a_lat, sigma))

    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg, params=None) -> torch.Tensor:
        """The video velocity of a stored transition: the audio stream comes
        from ``embeds["audio_latents"]``, the stored audio latent of the same
        slot."""
        return self._joint_velocity(params, latents, embeds["audio_latents"], t, embeds, guidance_scale, do_cfg)[0]

    def training_velocity_tree(self, trainable, batch: Dict[str, Any], params=None) -> Dict[str, torch.Tensor]:
        """Both streams' velocities at (latents, audio_latents, timestep)."""
        embeds = {k: batch[k] for k in self.embed_keys if k in batch}
        do_cfg = "negative_prompt_embeds" in embeds and bool(batch.get("do_cfg", True))
        if params is None:
            params = self.merged_params(self.velocity_component, trainable)
        vv, va = self._joint_velocity(params, batch["latents"], batch["audio_latents"], batch["timestep"], embeds,
                                      float(batch.get("guidance_scale", self.training_args.guidance_scale)), do_cfg)
        return {"latents": vv, "audio_latents": va}

    # ------------------------------------------------------------------
    # The joint rollout
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _joint_rollout(self, v0, a0, embeds, guidance_scale, v_sigmas, a_sigmas, timesteps, noise_levels,
                       maps, generator, noise, params, *, do_cfg: bool, compute_log_prob: bool,
                       dynamics_type: str):
        """Per step one transformer call gives both velocities; the video
        stream takes the SDE step (its log-prob over the generated tokens),
        the audio stream the ODE step on its own grid. Both are stored at the
        storage dtype in slot-mapped buffers (the garbage slot dropped)."""
        B, st = v0.shape[0], self.storage_dtype
        dev = v0.device
        sigma_max = float(v_sigmas[1]) if len(v_sigmas) > 1 else 0.999
        token_mask = self.token_mask(embeds)
        nl = maps.num_latent_slots
        v_buf = torch.zeros((nl + 1, *v0.shape), dtype=st, device=dev)
        a_buf = torch.zeros((nl + 1, *a0.shape), dtype=st, device=dev)
        v_buf[int(maps.latent_store_slot[0])] = v0.to(st)
        a_buf[int(maps.latent_store_slot[0])] = a0.to(st)
        lp_buf = torch.zeros((maps.num_logprob_slots + 1, B), dtype=torch.float32, device=dev)
        v, a = v0, a0
        for i in range(len(timesteps)):
            t = torch.full((B,), float(timesteps[i]), dtype=torch.float32, device=dev)
            vel_v, vel_a = self._joint_velocity(params, v, a, t, embeds, guidance_scale, do_cfg)
            out_v = sde_step(vel_v, v, float(v_sigmas[i]), float(v_sigmas[i + 1]), dynamics_type=dynamics_type,
                             noise_level=float(noise_levels[i]), generator=generator,
                             noise=None if noise is None else noise[i], compute_log_prob=compute_log_prob,
                             storage_dtype=st, sigma_max=sigma_max, token_mask=token_mask)
            out_a = sde_step(vel_a, a, float(a_sigmas[i]), float(a_sigmas[i + 1]), dynamics_type="ODE",
                             compute_log_prob=False, storage_dtype=st)
            slot = int(maps.latent_store_slot[i + 1])
            v_buf[slot] = out_v.next_latents.to(st)
            a_buf[slot] = out_a.next_latents.to(st)
            if compute_log_prob:
                lp_buf[int(maps.logprob_store_slot[i])] = out_v.log_prob
            v, a = out_v.next_latents, out_a.next_latents
        return v, a, v_buf[:-1], a_buf[:-1], lp_buf[:-1]

    def initial_latents_av(self, B: int, Lv: int, La: int, generator: torch.Generator, x0=None):
        """x0 of both streams (``x0`` = (video, audio) when given, else drawn:
        the video (B, Lv, Cv) first, then the audio (B, La, Ca))."""
        if x0 is None:
            v0 = torch.randn((B, Lv, self.video_latent_channels), generator=generator, device=self.device)
            a0 = torch.randn((B, La, self.audio_latent_channels), generator=generator, device=self.device)
        else:
            v0, a0 = (self._on_device(x) for x in x0)
        return v0, a0

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
        generator: Optional[torch.Generator] = None,
        x0: Optional[Tuple[Any, Any]] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        trainable=None,
        decode: bool = True,
        extra_embeds: Optional[Dict[str, Any]] = None,
        **_,
    ) -> List[T2AVSample]:
        """Joint rollout → host-resident samples: the video trajectory and
        log-probs, the audio trajectory (``audio_all_latents``), the decoded
        video (T, C, H, W) in [0, 1] and waveform (1, N) in [−1, 1]. ``x0``
        (video, audio) and the per-step video ``noise`` replace the
        generator's draws when given."""
        ta = self.training_args
        height, width = height or ta.height, width or ta.width
        num_frames = num_frames or int(getattr(ta, "num_frames", 5))
        T = num_inference_steps or ta.num_inference_steps
        g = float(ta.guidance_scale if guidance_scale is None else guidance_scale)
        do_cfg = g > 1.0

        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(self.enhance_prompt(list(prompt)))["prompt_embeds"]
        if do_cfg and negative_prompt_embeds is None:
            neg = list(negative_prompt) if negative_prompt is not None else [""] * len(prompt_embeds)
            negative_prompt_embeds = self.encode_prompt(neg)["prompt_embeds"]
        tl, h, w = self.video_token_geometry(height, width, num_frames)
        La = self.audio_token_count(num_frames)
        video_ids, audio_ids = self._video_ids(tl, h, w), self._audio_ids(La, tl)
        embeds = {"prompt_embeds": self._on_device(prompt_embeds), "video_ids": self._on_device(video_ids),
                  "audio_ids": self._on_device(audio_ids)}
        if do_cfg:
            embeds["negative_prompt_embeds"] = self._on_device(negative_prompt_embeds)
        for k, v in (extra_embeds or {}).items():
            embeds[k] = self._on_device(v)
        B = embeds["prompt_embeds"].shape[0]

        timesteps = self.scheduler.set_timesteps(T)
        v_sigmas = self.scheduler.sigmas
        self.audio_scheduler.set_timesteps(T)
        a_sigmas = self.audio_scheduler.sigmas
        noise_levels = self.scheduler.get_noise_levels()
        dynamics = "ODE" if self.scheduler.is_eval else self.scheduler.dynamics_type
        maps = build_store_maps(trajectory_indices, T)

        if generator is None:
            generator = make_generator(self.device, "rollout", ta.seed if seed is None else seed)
        v0, a0 = self.initial_latents_av(B, tl * h * w, La, generator, x0)
        if "cond_tokens" in embeds and "cond_mask" in embeds:  # I2AV: plant the conditioning tokens
            cmb = (embeds["cond_mask"] > 0.0).float()
            v0 = v0 * (1.0 - cmb) + embeds["cond_tokens"] * cmb
        v0, a0 = self.cast_latents(v0), self.cast_latents(a0)

        params = self.merged_params(self.velocity_component, trainable)
        v_fin, a_fin, v_buf, a_buf, lp_buf = self._joint_rollout(
            v0, a0, embeds, g, v_sigmas, a_sigmas, timesteps, noise_levels, maps, generator, noise, params,
            do_cfg=do_cfg, compute_log_prob=compute_log_prob, dynamics_type=dynamics)
        if decode:
            videos = self.decode_latents(v_fin, tl=tl, h=h, w=w, num_frames=num_frames)
            audios = self.decode_audio(a_fin)
        else:
            videos = audios = [None] * B

        v_np, a_np = v_buf.float().cpu().numpy(), a_buf.float().cpu().numpy()
        lp_np = lp_buf.cpu().numpy()
        host = {k: embeds[k].cpu().numpy() for k in ("prompt_embeds", "negative_prompt_embeds") if k in embeds}
        ts_np = np.asarray(timesteps, np.float32)
        samples: List[T2AVSample] = []
        for i in range(B):
            extra = {
                "sigmas": np.asarray(v_sigmas, np.float32),
                "audio_sigmas": np.asarray(a_sigmas, np.float32),
                "noise_levels": np.asarray(noise_levels, np.float32),
                "guidance_scale": g,
                "audio_all_latents": a_np[:, i],
                "video_ids": video_ids,
                "audio_ids": audio_ids,
                "num_frames": num_frames,
            }
            samples.append(self.sample_class(
                timesteps=ts_np,
                all_latents=v_np[:, i],
                latent_index_map=maps.latent_index_map,
                log_probs=lp_np[:, i] if compute_log_prob else None,
                log_prob_index_map=maps.logprob_index_map,
                height=height,
                width=width,
                video=videos[i],
                audio=audios[i],
                audio_sample_rate=self.audio_cfg.sample_rate,
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
    def decode_latents(self, latents: torch.Tensor, tl: int, h: int, w: int, num_frames: int) -> np.ndarray:
        """Video tokens (B, Lv, Cv) → (B, T, C, H, W) in [0, 1]; a
        timestep-conditioned decoder takes ``decode_timestep`` and mixes
        ``decode_noise_scale`` of fresh noise (from a generator seeded by
        the seed) into the latents first (both 0 by default)."""
        t_dec = float(getattr(self.model_args, "decode_timestep", None) or 0.0)
        dns = getattr(self.model_args, "decode_noise_scale", None)
        dns = t_dec if dns is None else float(dns)
        z5 = latents.float().reshape(latents.shape[0], tl, h, w, latents.shape[-1])
        ts = None
        if self.component_configs["vae"].timestep_conditioning:
            if dns > 0.0:
                gen = make_generator(self.device, "ltx2_decode", self.training_args.seed)
                z5 = (1.0 - dns) * z5 + dns * torch.randn(z5.shape, generator=gen, device=z5.device)
            ts = torch.full((z5.shape[0],), t_dec, dtype=torch.float32, device=z5.device)
        video = self.modules["vae"].decode(z5, num_frames, ts)
        video = torch.clamp(video.float() / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 1, 3, 4)
        return video.cpu().numpy()

    @torch.no_grad()
    def decode_audio(self, latents: torch.Tensor) -> np.ndarray:
        """Audio tokens (B, La, Ca) → waveforms (B, 1, N) in [−1, 1]."""
        return self.modules["audio_vae"].decode(latents.float()).float().cpu().numpy()
