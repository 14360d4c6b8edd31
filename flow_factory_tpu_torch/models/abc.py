"""Adapter base: rollout loop and no-grad replay shared by every model family.

Port of ``flow_factory_tpu/models/abc.py``. An adapter holds ``nn.Module``
components on one explicit device, the host-side scheduler, and two device
paths that run the SAME math:

* :meth:`BaseAdapter._rollout_impl` — the denoise loop: velocity, then
  :func:`sde_step`, writing each step into preallocated slot-mapped buffers
  (one extra garbage slot takes the positions that are not stored);
* :meth:`BaseAdapter._forward_impl` — one stored transition replayed without
  gradients, through the same velocity and step math and the same
  storage-dtype round trip, so ``exp(new_lp - old_lp) == 1`` exactly.

LoRA, EMA and the training forward come with the training slice.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..samples import BaseSample
from ..scheduler.flow_match_euler import FlowMatchEulerSDE, sde_step
from ..utils.base import resolve_device
from ..utils.weights import load_component


class BaseAdapter(ABC):
    """Adapter = model modules + scheduler + the rollout and replay paths."""

    sample_class = BaseSample

    def __init__(self, config, device=None):
        self.config = config
        self.model_args = config.model_args
        self.scheduler_args = config.scheduler_args
        self.training_args = config.training_args
        self.device = resolve_device(device)
        self.inference_dtype = getattr(torch, self.model_args.inference_dtype)
        self._mode = "train"
        #: the model's ``nn.Module`` components, e.g. {'transformer': SD3Transformer}
        self.modules: Dict[str, torch.nn.Module] = {}
        #: configs per component
        self.component_configs: Dict[str, Any] = {}
        self.load_models()
        self.scheduler = self.load_scheduler()

    # ------------------------------------------------------------------
    # Model surface
    # ------------------------------------------------------------------
    @abstractmethod
    def load_models(self) -> None:
        """Populate ``self.modules`` / ``self.component_configs``."""

    @abstractmethod
    def _velocity(self, latents, t, embeds, guidance_scale, do_cfg) -> torch.Tensor:
        """Velocity prediction (fp32) for latents (B, ...) at timesteps t (B,)."""

    def scheduler_defaults(self) -> Dict[str, Any]:
        """Per-model sigma-schedule knobs (shift, dynamic shifting...)."""
        return {}

    def load_scheduler(self) -> FlowMatchEulerSDE:
        sa = self.scheduler_args
        if sa.scheduler_type not in (None, "flow_match_euler"):
            raise NotImplementedError(f"scheduler {sa.scheduler_type!r} is not ported yet")
        return FlowMatchEulerSDE(
            noise_level=sa.noise_level,
            sde_steps=sa.sde_steps,
            num_sde_steps=sa.num_sde_steps,
            seed=sa.seed,
            dynamics_type=sa.dynamics_type,
            **self.scheduler_defaults(),
        )

    def load_state_dicts(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load per-component state dicts (e.g. from :mod:`..utils.weights`), strictly."""
        for comp, sd in state_dicts.items():
            load_component(self.modules[comp], sd)

    # ------------------------------------------------------------------
    # Mode management
    # ------------------------------------------------------------------
    @property
    def mode(self) -> str:
        return self._mode

    def train(self) -> None:
        self._mode = "train"
        self.scheduler.train()

    def eval(self) -> None:
        self._mode = "eval"
        self.scheduler.eval()

    def rollout(self) -> None:
        self._mode = "rollout"
        self.scheduler.rollout()

    # ------------------------------------------------------------------
    # Rollout + replay
    # ------------------------------------------------------------------
    @property
    def storage_dtype(self) -> torch.dtype:
        return self.training_args.storage_dtype

    def cast_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Storage-dtype round trip — the train-inference consistency guard."""
        return latents.to(self.storage_dtype).float()

    @torch.no_grad()
    def _rollout_impl(
        self,
        x0: torch.Tensor,
        embeds: Dict[str, torch.Tensor],
        guidance_scale: float,
        sigmas: np.ndarray,
        timesteps: np.ndarray,
        noise_levels: np.ndarray,
        latent_store_slot: np.ndarray,
        logprob_store_slot: np.ndarray,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        *,
        do_cfg: bool,
        compute_log_prob: bool,
        dynamics_type: str,
        num_latent_slots: int,
        num_logprob_slots: int,
        store_means: bool = False,
    ):
        """The denoise loop with selective storage into slot-mapped buffers.

        ``noise`` (one tensor per step) replaces the generator's draws — the
        tests feed the noise the JAX package drew. Returns
        (x_final, latent buffer, log-prob buffer, mean buffer or None), the
        garbage slot dropped."""
        B = x0.shape[0]
        st = self.storage_dtype
        sigma_max = float(sigmas[1]) if len(sigmas) > 1 else 0.999
        lat_buf = torch.zeros((num_latent_slots + 1, *x0.shape), dtype=st, device=x0.device)
        lat_buf[int(latent_store_slot[0])] = x0.to(st)
        lp_buf = torch.zeros((num_logprob_slots + 1, B), dtype=torch.float32, device=x0.device)
        mean_buf = torch.zeros_like(lat_buf) if store_means else None

        x = x0
        for i in range(len(timesteps)):
            t = torch.full((B,), float(timesteps[i]), dtype=torch.float32, device=x.device)
            v = self._velocity(x, t, embeds, guidance_scale, do_cfg)
            out = sde_step(
                v, x, float(sigmas[i]), float(sigmas[i + 1]),
                dynamics_type=dynamics_type,
                noise_level=float(noise_levels[i]),
                generator=generator,
                noise=None if noise is None else noise[i],
                compute_log_prob=compute_log_prob,
                storage_dtype=st,
                sigma_max=sigma_max,
            )
            slot = int(latent_store_slot[i + 1])
            lat_buf[slot] = out.next_latents.to(st)
            if compute_log_prob:
                lp_buf[int(logprob_store_slot[i])] = out.log_prob
            if mean_buf is not None:
                mean_buf[slot] = out.next_latents_mean.to(st)
            x = out.next_latents
        return x, lat_buf[:-1], lp_buf[:-1], (mean_buf[:-1] if store_means else None)

    @torch.no_grad()
    def _forward_impl(
        self,
        latents: torch.Tensor,
        next_latents: Optional[torch.Tensor],
        timestep: torch.Tensor,
        sigma,
        sigma_next,
        noise_level,
        embeds: Dict[str, torch.Tensor],
        guidance_scale: float,
        sigma_max,
        generator: Optional[torch.Generator] = None,
        *,
        do_cfg: bool,
        compute_log_prob: bool,
        dynamics_type: str,
    ):
        """Single-step replay (or sample) forward — the rollout's math path."""
        v = self._velocity(latents, timestep, embeds, guidance_scale, do_cfg)
        return sde_step(
            v, latents, sigma, sigma_next,
            dynamics_type=dynamics_type,
            noise_level=noise_level,
            generator=generator,
            next_latents=next_latents,
            compute_log_prob=compute_log_prob,
            storage_dtype=self.storage_dtype,
            sigma_max=sigma_max,
        )

    def replay_log_probs(self, samples: List[BaseSample], steps: Optional[Sequence[int]] = None
                         ) -> Dict[int, torch.Tensor]:
        """Replay stored transitions of a rollout batch without gradients.

        Every sample must come from one rollout (shared schedule and index
        maps); the batch is replayed whole, step by step, as it was rolled
        out. ``steps`` defaults to every step with a stored log-prob and
        both latents. Returns {step: (B,) new log-probs}."""
        first = samples[0]
        lat_map, lp_map = first.latent_index_map, first.log_prob_index_map
        if steps is None:
            steps = [i for i in range(len(first.timesteps))
                     if lp_map[i] >= 0 and lat_map[i] >= 0 and lat_map[i + 1] >= 0]
        dev = self.device
        stack = lambda key: torch.from_numpy(np.stack([s.extra_kwargs[key] for s in samples])).to(dev)
        embeds = {"prompt_embeds": torch.from_numpy(np.stack([s.prompt_embeds for s in samples])).to(dev),
                  "pooled_prompt_embeds": stack("pooled_prompt_embeds")}
        do_cfg = first.negative_prompt_embeds is not None
        if do_cfg:
            embeds["negative_prompt_embeds"] = torch.from_numpy(
                np.stack([s.negative_prompt_embeds for s in samples])).to(dev)
            embeds["negative_pooled_prompt_embeds"] = stack("negative_pooled_prompt_embeds")
        sigmas = first.extra_kwargs["sigmas"]
        noise_levels = first.extra_kwargs["noise_levels"]
        latents = torch.from_numpy(np.stack([s.all_latents for s in samples])).to(dev)
        B = len(samples)
        full = lambda value: torch.full((B,), float(value), dtype=torch.float32, device=dev)
        out: Dict[int, torch.Tensor] = {}
        for i in steps:
            # contiguous like the rollout's own tensors: equal layouts keep
            # every reduction in the same order, hence the same bits
            res = self._forward_impl(
                latents[:, lat_map[i]].contiguous(), latents[:, lat_map[i + 1]].contiguous(),
                full(first.timesteps[i]),
                full(sigmas[i]), full(sigmas[i + 1]), full(noise_levels[i]), embeds,
                float(first.extra_kwargs["guidance_scale"]),
                full(sigmas[1] if len(sigmas) > 1 else 0.999),
                do_cfg=do_cfg, compute_log_prob=True,
                dynamics_type=self.scheduler.dynamics_type,
            )
            out[int(i)] = res.log_prob
        return out
