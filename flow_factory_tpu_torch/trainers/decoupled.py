"""Shared scaffolding of the decoupled trainers (port of
``flow_factory_tpu/trainers/decoupled.py``; DPO, NFT, AWM, CRD and DGPO).

Decoupled: the training timesteps are drawn fresh by a ``TimeSampler``
instead of replaying the rollout's SDE steps, and only the final (clean)
latent of each rollout is kept (``trajectory_indices=[-1]``, no log-probs).
The rollout batches run one after another (no pipelined ``PendingRollout``
yet); a preemption request is honoured before each rollout batch and each
micro-batch. A trainer yields the device batch of each grad step from
``grad_step_batches`` and computes its loss in ``loss_fn``; ``optimize``
sums the gradients and steps the optimizer every
``gradient_accumulation_steps`` grad steps, calling
``after_optimizer_step`` after each step.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.dist import get_data_rank, get_world_size, reduce_loss_info
from ..samples import BaseSample, stack_samples
from ..utils.base import derive_seed, make_generator
from ..utils.noise_schedule import TimeSampler
from .abc import BaseTrainer


def rank_seed_parts() -> Tuple[int, ...]:
    """The data rank as a part of a grad step's noise seed above one
    replica, so that each replica's rows draw their own noise; none at one,
    where the seeds stay those of a one-process run. The timesteps stay the
    same on every replica: row 0's routes a step (Wan2.2's experts) as JAX
    routes the global batch by its row 0, and every rank must gather the
    same expert's fsdp slices."""
    return (get_data_rank(),) if get_world_size() > 1 else ()


def uncfg(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` without its negative embeds: the velocity runs without CFG."""
    return {k: v for k, v in batch.items() if not k.startswith("negative_")}


class DecoupledTrainer(BaseTrainer):
    #: whether rollouts need per-step log-probs (none of the decoupled ones do)
    rollout_compute_log_prob = False

    # ------------------------------------------------------------------
    # Rollout: store only the final latent
    # ------------------------------------------------------------------
    def sample(self, epoch: int, trainable: Optional[Dict[str, Any]] = None) -> List[BaseSample]:
        """The epoch's rollouts under ``trainable`` (default: the live tree)."""
        ta = self.training_args
        self.adapter.rollout()
        self.reward_buffer.clear()
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
                compute_log_prob=self.rollout_compute_log_prob,
                trajectory_indices=[-1],
                generator=make_generator(self.adapter.device, "rollout", ta.seed, epoch, rank, b),
                trainable=trainable,
                **self.condition_kwargs(batch),
            )
            self.reward_buffer.add_samples(samples)
        self.adapter.train()
        return self.reward_buffer.samples

    # ------------------------------------------------------------------
    # Optimization
    # ------------------------------------------------------------------
    def grad_step_batches(self, samples: List[BaseSample], epoch: int) -> Iterator[Dict[str, Any]]:
        """The device batch of every grad step of an epoch, in order."""
        raise NotImplementedError

    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, aux metrics) of one grad step's batch."""
        raise NotImplementedError

    def optimize(self, samples: List[BaseSample], epoch: int) -> Dict[str, float]:
        ta = self.training_args
        ref_trainable = self.reference_trainable() if ta.requires_ref_model else None
        infos: List[Dict[str, Any]] = []
        for batch in self.grad_step_batches(samples, epoch):
            _, aux = self.backward_step(batch, ref_trainable)
            infos.append(aux)  # device scalars, read once at the end of the phase
            if self._accum_count >= ta.gradient_accumulation_steps:
                infos[-1]["train/grad_norm"] = self.apply_accumulated()
                self.after_optimizer_step()
        if self._accum_count > 0:  # flush a remainder: the optimizer always steps
            infos[-1]["train/grad_norm"] = self.apply_accumulated()
            self.after_optimizer_step()
        return self.aggregate_infos(infos)

    def after_optimizer_step(self) -> None:
        """What a trainer does after each optimizer step (DGPO blends its
        ``ema_ref`` snapshot)."""

    # ------------------------------------------------------------------
    # Fresh timestep sampling (the TimeSampler dispatch)
    # ------------------------------------------------------------------
    def sample_timesteps(self, batch_size: int, seed: int) -> np.ndarray:
        """(num_train_timesteps, B) scheduler-scale timesteps."""
        ta = self.training_args
        strategy = getattr(ta, "time_sampling_strategy", getattr(ta, "weighting_scheme", "logit_normal"))
        T = ta.get_num_train_timesteps(self.config)
        if strategy == "logit_normal":
            return TimeSampler.logit_normal_shifted(
                batch_size=batch_size, num_timesteps=T, timestep_range=ta.timestep_range,
                logit_mean=getattr(ta, "logit_mean", 0.0), logit_std=getattr(ta, "logit_std", 1.0),
                time_shift=getattr(ta, "time_shift", 3.0), stratified=True, seed=seed)
        if strategy == "uniform":
            return TimeSampler.uniform(batch_size=batch_size, num_timesteps=T, timestep_range=ta.timestep_range,
                                       time_shift=getattr(ta, "time_shift", 1.0), seed=seed)
        if strategy.startswith("discrete"):
            # discrete draws from the rollout scheduler's grid
            if self.scheduler.timesteps is None:
                self.scheduler.set_timesteps(ta.num_inference_steps, seq_len=256)
            return TimeSampler.discrete(
                batch_size=batch_size, num_train_timesteps=T, scheduler_timesteps=self.scheduler.timesteps,
                timestep_range=ta.timestep_range, include_init=strategy != "discrete_wo_init",
                force_init=strategy == "discrete_with_init", seed=seed)
        raise ValueError(f"Unknown time sampling strategy {strategy!r}")

    def timesteps(self, t: np.ndarray) -> Dict[str, Any]:
        """A grad step's (B,) timesteps drawn on the host: ``timestep`` on the
        device and ``timestep_host``, row 0's value as a host float, by which
        a model that routes on the timestep (Wan2.2's MoE) picks its expert
        with no read from the device (JAX routes on row 0's t)."""
        t = np.ascontiguousarray(t, dtype=np.float32)
        return {"timestep": torch.from_numpy(t).to(self.adapter.device), "timestep_host": float(t[0])}

    # ------------------------------------------------------------------
    # Micro-batches
    # ------------------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.adapter.device)

    def iter_micro_batches(self, samples: List[BaseSample], epoch: int, inner: int
                           ) -> Iterator[Tuple[List[BaseSample], Dict[str, Any]]]:
        """Shuffled micro-batches of ``samples`` (the remainder cycle-padded
        so every sample contributes), each stacked on the host with its clean
        latents and embeds moved to the device."""
        B = self.micro_batch_size
        rng = np.random.default_rng(derive_seed("shuffle", self.training_args.seed, epoch, inner))
        perm = rng.permutation(len(samples))
        if len(perm) % B:
            perm = np.concatenate([perm, perm[: B - len(perm) % B]])
        for s in range(0, len(perm) - B + 1, B):
            self.check_preempt()
            yield self.stage_micro_batch([samples[int(i)] for i in perm[s : s + B]])

    def stage_micro_batch(self, mb: List[BaseSample]) -> Tuple[List[BaseSample], Dict[str, Any]]:
        """``mb`` stacked on the host, its clean latents and embeds moved to
        the device."""
        bn = stack_samples(mb)
        bn["__staged_clean__"] = self.clean_latent_tree(bn)
        bn["__staged_embeds__"] = self.batch_embeds(bn)
        return mb, bn

    def batch_embeds(self, batch_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The adapter's embed keys of a stacked batch, fp32 on the device."""
        if "__staged_embeds__" in batch_np:
            return batch_np["__staged_embeds__"]
        return {k: self._to_device(batch_np[k]) for k in self.adapter.embed_keys
                if batch_np.get(k) is not None}

    def clean_latent_tree(self, batch_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The final (clean) latents of every stream of
        ``decoupled_latent_keys``: {batch key: (B, ...)}. A stream the batch
        lacks raises: dropped, it would leave every loss without a word."""
        if "__staged_clean__" in batch_np:
            return batch_np["__staged_clean__"]
        keys = self.adapter.decoupled_latent_keys
        missing = sorted(sk for sk in keys.values() if batch_np.get(sk) is None)
        if missing:
            raise KeyError(f"the samples carry no {missing}, a latent stream of {type(self.adapter).__name__}'s "
                           f"decoupled_latent_keys {keys}")
        return {bk: self._to_device(batch_np[sk][:, -1]) for bk, sk in keys.items()}

    # ------------------------------------------------------------------
    # Latent trees: each stream a leaf for the forward; the losses reduce
    # over their flattened concatenation in sorted-key order
    # ------------------------------------------------------------------
    @staticmethod
    def noised_latents(clean: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x_t = (1−σ)·x1 + σ·ε with σ = t/1000 (linear flow interpolation)."""
        sigma = (t / 1000.0).reshape(-1, *([1] * (clean.ndim - 1)))
        return (1.0 - sigma) * clean + sigma * noise

    @staticmethod
    def tree_normal(generator: torch.Generator, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Independent N(0, 1) fp32 draws per leaf from ``generator``, in
        sorted-key order (the JAX package folds its key per leaf; the bits
        differ, so the tests feed both packages the same noise)."""
        return {k: torch.randn(tree[k].shape, generator=generator, device=tree[k].device, dtype=torch.float32)
                for k in sorted(tree)}

    @classmethod
    def tree_noised(cls, clean: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor],
                    t: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: cls.noised_latents(clean[k], noise[k], t) for k in clean}

    @staticmethod
    def tree_flat(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, Σ leaf sizes): the leaves concatenated in sorted-key order."""
        ks = sorted(tree)
        B = tree[ks[0]].shape[0]
        return torch.cat([tree[k].reshape(B, -1) for k in ks], dim=1)

    @staticmethod
    def aggregate_infos(infos: List[Dict[str, Any]]) -> Dict[str, float]:
        """The grad steps' metrics (device scalars, read here once) reduced
        over the phase."""
        if not infos:
            return {}
        keys = set().union(*infos)
        return reduce_loss_info({k: [float(i[k]) for i in infos if k in i] for k in keys})

    def ref_params(self, ref_trainable: Optional[Dict[str, Any]]):
        """Effective weights of the reference policy (:meth:`merged_params`):
        the merge of the empty tree, i.e. the frozen weights, when
        ``ref_trainable`` is None, the LoRA case, since the zero LoRA's merge
        ``(W.float() + 0).to(W.dtype)`` is W bit for bit and needs no second
        copy of the targeted weights (on Wan2.2's MoE both frozen experts,
        routed per step as the trained ones are); else the reference tree
        merged."""
        ad = self.adapter
        return ad.merged_params(ad.velocity_component, {} if ref_trainable is None else ref_trainable)

    def reference_trainable(self) -> Optional[Dict[str, Any]]:
        """The reference policy's tree for :meth:`ref_params`: None for LoRA
        (the zero LoRA), the frozen snapshot for full finetuning."""
        return None if self.adapter.is_lora else self.adapter.ref_trainable()

    def noised_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """``batch`` with each stream's x_t at the batch's timestep."""
        return {**batch, **self.tree_noised(batch["clean"], batch["noise"], batch["timestep"])}

    def frozen_velocity(self, trainable, fwd: Dict[str, Any]) -> torch.Tensor:
        """The flattened velocity of a policy that takes no gradient:
        ``trainable`` merged (None: the frozen weights, see :meth:`ref_params`)."""
        with torch.no_grad():
            params = self.ref_params(trainable)
            return self.tree_flat(self.adapter.training_velocity_tree(None, fwd, params=params))


class OldPolicyTrainer(DecoupledTrainer):
    """The decoupled trainers that hold the current policy against an old
    policy (NFT, AWM: the sampling policy; CRD: its ``_crd_old`` snapshot):
    the rollout under the EMA weights when ``off_policy`` is set (JAX
    ``nft.py:35-38``, ``awm.py:51-54``); per micro-batch, T fresh timesteps
    and noise draws and at each the old policy's velocity without gradients,
    reduced by :meth:`old_policy` into the grad step's ``old_key`` entry;
    then T grad steps."""

    #: the grad-step batch key of the precomputed old-policy quantity
    old_key: str = ""
    #: the tag of the timestep and noise seeds (``<tag>_t``, ``<tag>_noise``)
    tag: str = ""
    #: whether the old policy's forward runs with CFG over the negative embeds
    old_policy_cfg: bool = True

    def sample(self, epoch: int, trainable: Optional[Dict[str, Any]] = None) -> List[BaseSample]:
        if getattr(self.training_args, "off_policy", False):
            trainable = self.sampling_trainable()
        return super().sample(epoch, trainable=trainable)

    def sampling_trainable(self) -> Dict[str, Any]:
        """The sampling policy's tree: the EMA weights when ``off_policy``
        is set (and EMA is on), else the live tree."""
        if getattr(self.training_args, "off_policy", False):
            return self.adapter.ema_trainable
        return self.adapter.trainable

    def old_policy_params(self) -> Dict[str, torch.Tensor]:
        """Effective weights of the old policy (called without gradients):
        the sampling policy's tree merged."""
        return self.adapter.merged_params(self.adapter.velocity_component, self.sampling_trainable())

    def old_policy(self, old_v: Dict[str, torch.Tensor], batch: Dict[str, Any]) -> Any:
        """What a grad step compares with, from the old policy's velocity
        tree at the step's batch."""
        raise NotImplementedError

    def micro_batches(self, samples: List[BaseSample], epoch: int, inner: int
                      ) -> Iterator[Tuple[int, List[BaseSample], Dict[str, Any]]]:
        """(seed index, samples, staged batch) of each micro-batch: the
        shuffled ones of :meth:`iter_micro_batches`, numbered in order."""
        for bi, (mb, bn) in enumerate(self.iter_micro_batches(samples, epoch, inner)):
            yield bi, mb, bn

    def grad_step_batches(self, samples: List[BaseSample], epoch: int) -> Iterator[Dict[str, Any]]:
        """Per micro-batch: the old-policy quantity at each of the T
        timesteps (one LoRA merge for the T forwards, no gradients), then the
        batch of each of the T grad steps."""
        ta, ad, dev = self.training_args, self.adapter, self.adapter.device
        T = ta.get_num_train_timesteps(self.config)
        for inner in range(ta.num_inner_epochs):
            for bi, mb, bn in self.micro_batches(samples, epoch, inner):
                clean = self.clean_latent_tree(bn)
                base = dict(clean=clean,
                            advantage=torch.tensor([s.extra_kwargs["advantage"] for s in mb], dtype=torch.float32,
                                                   device=dev),
                            guidance_scale=float(mb[0].extra_kwargs.get("guidance_scale", ta.guidance_scale)),
                            **self.batch_embeds(bn))
                all_t = self.sample_timesteps(len(mb), derive_seed(f"{self.tag}_t", ta.seed, epoch, inner, bi))
                steps = []
                with torch.no_grad():
                    params = self.old_policy_params()
                    for t_idx in range(T):
                        gen = make_generator(dev, f"{self.tag}_noise", ta.seed, epoch, inner, bi, t_idx,
                                             *rank_seed_parts())
                        batch = dict(base, noise=self.tree_normal(gen, clean), **self.timesteps(all_t[t_idx]))
                        fwd = self.noised_batch(batch)
                        old_v = ad.training_velocity_tree(None, fwd if self.old_policy_cfg else uncfg(fwd),
                                                          params=params)
                        batch[self.old_key] = self.old_policy(old_v, batch)
                        steps.append(batch)
                    del params
                yield from steps
