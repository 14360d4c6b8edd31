"""GRPO / GRPO-Guard trainer (port of ``flow_factory_tpu/trainers/grpo.py``).

Rollout with per-step log-probs on the SDE-step subset → group-relative
advantages → PPO-clipped ratio loss replayed per train timestep, the
gradients summed in fp32 until ``gradient_accumulation_steps`` steps, then
one optimizer step. The rollout batches run one after another (no pipelined
``PendingRollout`` yet). A preemption request is honoured before each
rollout batch and each micro-batch.

GRPO-Guard stores the rollout's ``next_latents_mean``, re-weights the ratio
by ``s = sqrt(−dt)·σ_t`` and replaces the noise term with the mean-drift MSE.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..parallel.dist import get_data_rank, reduce_loss_info
from ..samples import BaseSample, stack_samples
from ..utils.base import derive_seed, make_generator
from ..utils.trajectory import compute_trajectory_indices
from .abc import BaseTrainer

logger = logging.getLogger(__name__)


class GRPOTrainer(BaseTrainer):
    use_guard: bool = False  # GRPOGuardTrainer flips this

    # ------------------------------------------------------------------
    # Rollout sampling
    # ------------------------------------------------------------------
    def sample(self, epoch: int) -> List[BaseSample]:
        ta = self.training_args
        self.adapter.rollout()
        self.reward_buffer.clear()
        traj_indices = compute_trajectory_indices(self.scheduler.train_timesteps, ta.num_inference_steps)
        self.train_loader.set_epoch(epoch)
        rank = get_data_rank()
        for b, batch in enumerate(self.train_loader):
            self.check_preempt()
            samples = self.adapter.inference(
                prompt=batch["prompt"],
                prompt_embeds=batch.get("prompt_embeds"),
                pooled_prompt_embeds=batch.get("pooled_prompt_embeds"),
                negative_prompt_embeds=batch.get("negative_prompt_embeds"),
                negative_pooled_prompt_embeds=batch.get("negative_pooled_prompt_embeds"),
                compute_log_prob=True,
                trajectory_indices=traj_indices,
                generator=make_generator(self.adapter.device, "rollout", ta.seed, epoch, rank, b),
                store_means=self.use_guard,
                **self.condition_kwargs(batch),
            )
            self.reward_buffer.add_samples(samples)
        self.adapter.train()
        return self.reward_buffer.samples

    # ------------------------------------------------------------------
    # Optimization
    # ------------------------------------------------------------------
    def _micro_batches(self, n: int, epoch: int) -> List[np.ndarray]:
        """Shuffled micro-batch indices over (inner epoch × micro-batch); the
        remainder is cycle-padded so every sample contributes."""
        ta, B = self.training_args, self.micro_batch_size
        schedule: List[np.ndarray] = []
        for inner in range(ta.num_inner_epochs):
            perm = np.random.default_rng(derive_seed("shuffle", ta.seed, epoch, inner)).permutation(n)
            if len(perm) % B:
                perm = np.concatenate([perm, perm[: B - len(perm) % B]])
            schedule.extend(perm[s : s + B] for s in range(0, len(perm) - B + 1, B))
        return schedule

    def _stage(self, mb: List[BaseSample]) -> Dict[str, Any]:
        """Stack a micro-batch on the host and move it to the device."""
        dev = self.adapter.device
        batch_np = stack_samples(mb)
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        return dict(
            all_latents=to_dev(batch_np["all_latents"]),
            old_lps=to_dev(batch_np["log_probs"]),
            adv=to_dev(np.asarray([s.extra_kwargs["advantage"] for s in mb])),
            embeds={k: to_dev(batch_np[k]) for k in self.adapter.embed_keys
                    if batch_np.get(k) is not None},
            means=(to_dev(batch_np["next_latents_mean"])
                   if self.use_guard and "next_latents_mean" in batch_np else None),
            traj={bk: to_dev(batch_np[sk]) for bk, sk in self.adapter.trajectory_batch_keys.items()
                  if batch_np.get(sk) is not None},
        )

    def grad_step_batches(self, samples: List[BaseSample], epoch: int) -> Iterator[Dict[str, Any]]:
        """The device batch of every grad step of an epoch, in order: each
        shuffled micro-batch replayed at each train timestep it stored."""
        ta, sched, dev = self.training_args, self.scheduler, self.adapter.device
        train_steps = np.asarray(sched.train_timesteps)
        sigmas = np.asarray(sched.sigmas, np.float32)
        timesteps = np.asarray(sched.timesteps, np.float32)
        noise_levels = np.asarray(sched.get_noise_levels(), np.float32)
        B = self.micro_batch_size
        full = lambda value: torch.full((B,), float(value), dtype=torch.float32, device=dev)
        for idxs in self._micro_batches(len(samples), epoch):
            self.check_preempt()
            mb = [samples[int(i)] for i in idxs]
            s = self._stage(mb)
            lat_map, lp_map = mb[0].latent_index_map, mb[0].log_prob_index_map
            guidance = float(mb[0].extra_kwargs.get("guidance_scale", ta.guidance_scale))
            for t_idx in train_steps:
                t_idx = int(t_idx)
                li, lni, lpi = int(lat_map[t_idx]), int(lat_map[t_idx + 1]), int(lp_map[t_idx])
                if li < 0 or lni < 0 or lpi < 0:
                    logger.warning("train step %d not in stored trajectory; skipping", t_idx)
                    continue
                # contiguous like the rollout's own tensors: equal layouts keep
                # every reduction in the same order, hence the same bits
                batch = dict(
                    latents=s["all_latents"][:, li].contiguous(),
                    next_latents=s["all_latents"][:, lni].contiguous(),
                    guidance_scale=guidance,
                    sigma_max=full(sigmas[1]),
                    old_log_prob=s["old_lps"][:, lpi],
                    advantage=s["adv"],
                    timestep=full(timesteps[t_idx]),
                    timestep_host=float(timesteps[t_idx]),  # for a model that routes on it (Wan2.2's MoE)
                    sigma=full(sigmas[t_idx]),
                    sigma_next=full(sigmas[t_idx + 1]),
                    noise_level=full(noise_levels[t_idx]),
                    **s["embeds"],
                )
                if s["means"] is not None:
                    batch["rollout_mean"] = s["means"][:, lni].contiguous()
                for bk, arr in s["traj"].items():  # e.g. LTX-2's audio latents of the same slot
                    batch[bk] = arr[:, li].contiguous()
                yield batch

    def optimize(self, samples: List[BaseSample], epoch: int) -> Dict[str, float]:
        ta = self.training_args
        ref_trainable = self.adapter.ref_trainable() if float(getattr(ta, "kl_beta", 0.0)) > 0 else None
        infos: List[Dict[str, Any]] = []
        for batch in self.grad_step_batches(samples, epoch):
            _, aux = self.backward_step(batch, ref_trainable)
            infos.append(aux)  # device scalars, read once at the end of the phase
            if self._accum_count >= ta.gradient_accumulation_steps:
                infos[-1]["train/grad_norm"] = self.apply_accumulated()
        if self._accum_count > 0:  # flush a remainder: the optimizer always steps
            infos[-1]["train/grad_norm"] = self.apply_accumulated()
        if not infos:
            return {}
        keys = set().union(*infos)
        return reduce_loss_info({k: [float(i[k]) for i in infos if k in i] for k in keys})

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------
    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The PPO-clip loss of one micro-batch at one timestep and its aux
        metrics (JAX ``_grad_fn``, ``trainers/grpo.py:294-361``)."""
        ta = self.training_args
        clip_lo, clip_hi = ta.clip_range
        adv_lo, adv_hi = ta.adv_clip_range
        kl_beta = float(getattr(ta, "kl_beta", 0.0))
        out = self.adapter.training_forward(trainable, batch, compute_log_prob=True)
        new_lp, old_lp = out.log_prob, batch["old_log_prob"]
        adv = torch.clamp(batch["advantage"], adv_lo, adv_hi)
        if self.use_guard:
            # ratio = exp((new − old)·s + mse/(2s)), s = sqrt(−dt)·σ_t: the
            # per-step Gaussian exponent normalised, the mean drift in place
            # of the noise realisation
            scale = (torch.sqrt(-out.dt) * out.std_dev_t).reshape(new_lp.shape[0], -1)[:, 0]
            scale = torch.clamp(scale, min=1e-8)
            drift = out.next_latents_mean - batch["rollout_mean"]
            drift_mse = torch.mean(drift.reshape(drift.shape[0], -1) ** 2, dim=-1)
            ratio = torch.exp((new_lp - old_lp) * scale + drift_mse / (2.0 * scale))
        else:
            ratio = torch.exp(new_lp - old_lp)

        unclipped = -adv * ratio
        clipped = -adv * torch.clamp(ratio, 1.0 + clip_lo, 1.0 + clip_hi)
        pg_loss = torch.mean(torch.maximum(unclipped, clipped))
        loss = pg_loss
        r = ratio.detach()
        aux = {
            "train/loss": pg_loss.detach(),
            "train/ratio_mean": torch.mean(r),
            "train/ratio_max": torch.max(r),
            "train/ratio_min": torch.min(r),
            "train/clip_frac": torch.mean(((r < 1.0 + clip_lo) | (r > 1.0 + clip_hi)).float()),
            "train/approx_kl": torch.mean((new_lp.detach() - old_lp) ** 2) * 0.5,
        }
        if kl_beta > 0.0 and ref_trainable is not None:
            with torch.no_grad():
                ref_out = self.adapter.training_forward(ref_trainable, batch, compute_log_prob=False)
            if getattr(ta, "kl_type", "x-based") == "v-based":
                kl = torch.mean((out.noise_pred - ref_out.noise_pred) ** 2)
            else:  # x-based: next-latents-mean MSE
                kl = torch.mean((out.next_latents_mean - ref_out.next_latents_mean) ** 2)
            loss = loss + kl_beta * kl
            aux["train/kl"] = kl.detach()
        aux["train/total_loss"] = loss.detach()
        return loss, aux


class GRPOGuardTrainer(GRPOTrainer):
    """GRPO-Guard: σ-normalised ratios and rollout-mean drift replay."""

    use_guard = True
