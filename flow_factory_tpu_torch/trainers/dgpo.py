"""DGPO trainer — group-level preference optimization (port of
``flow_factory_tpu/trainers/dgpo.py``).

Per inner epoch, T timesteps shared by every row; per shuffled micro-batch,
noise shared by the rows of a prompt group (seeded by its unique id), then
per timestep t:

    x_t  = (1−σ)·x1 + σ·ε_g,  v* = ε_g − x1
    dsm  = ‖v_θ(x_t) − v*‖²  (per sample, without CFG)
    pref = adv·β·(sg(dsm) − ref_dsm)/K
    w_g  = σ(Σ_group pref)   (no gradient)
    L    = mean(w_g · adv · dsm)   (+ KL to the reference)

``ref_dsm`` is the reference policy's (or, with ``use_ema_ref``, the
``ema_ref`` snapshot's) error; with ``clip_dsm``/``clip_kl`` a row whose
ratio exp(old_dsm − dsm) to the ``ema_ref`` policy leaves the clip range
takes no gradient through the DSM or KL term. The KL's teacher runs with
CFG at ``kl_cfg`` when that is above 1 and negative embeds are present.
The snapshot and reference velocities are computed per micro-batch without
gradients (one merge of the snapshot for its T forwards); the group sums are
a fixed-order reduction over a (G, B) one-hot, so they are deterministic on
the card; over a mesh they are summed over the data axes, since
``group_distributed`` puts K/W rows of every group on each replica (every
replica numbers the groups alike: its index sequence is the same).
``ema_ref`` is blended toward the live weights after every optimizer step
with decay ``min(max_decay, ramp_rate·step)``; past ``switch_ema_ref``
steps the rollout samples under it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..samples import BaseSample
from ..utils.base import derive_seed, make_generator
from .decoupled import DecoupledTrainer, uncfg

#: the last part of the shared timesteps' and the shared noise's seeds
_TAG_SHARED_T = 1
_TAG_SHARED_NOISE = 2


def per_sample_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) mean squared difference of each row."""
    d = (a - b).reshape(a.shape[0], -1)
    return torch.mean(d * d, dim=-1)


def group_sums(x: torch.Tensor, group_ids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(G,) sums of ``x`` over the rows of each group: the (G, B) one-hot
    product reduced along B in a fixed order (an atomic ``index_add_``
    would add in no fixed order on the card)."""
    onehot = group_ids[None, :] == torch.arange(num_groups, device=x.device)[:, None]
    return torch.sum(onehot.to(x.dtype) * x[None, :], dim=1)


class DGPOTrainer(DecoupledTrainer):
    EMA_REF = "ema_ref"

    def __init__(self, config, adapter):
        super().__init__(config, adapter)
        ta = self.training_args
        self.requires_ema_ref = bool(ta.clip_dsm or ta.clip_kl or ta.use_ema_ref)
        if self.requires_ema_ref:
            self.adapter.add_named_parameters(self.EMA_REF)
        if ta.requires_ref_model:
            self.adapter.init_ref_parameters()

    # ------------------------------------------------------------------
    # The sampling policy and the ema_ref snapshot
    # ------------------------------------------------------------------
    def sampling_trainable(self) -> Optional[Dict[str, Any]]:
        """``ema_ref`` past ``switch_ema_ref`` optimizer steps, else the EMA
        weights under ``off_policy``, else None (the live tree)."""
        ta = self.training_args
        if self.requires_ema_ref and self.global_step > ta.switch_ema_ref:
            return self.adapter.get_named_parameters(self.EMA_REF)
        if ta.off_policy and self.adapter.ema is not None:
            return self.adapter.ema_trainable
        return None

    def sample(self, epoch: int, trainable=None) -> List[BaseSample]:
        return super().sample(epoch, trainable=self.sampling_trainable())

    def after_optimizer_step(self) -> None:
        if self.requires_ema_ref:
            ta = self.training_args
            decay = min(float(ta.ema_ref_max_decay), float(ta.ema_ref_ramp_rate) * self.global_step)
            self.adapter.update_named_parameters(self.EMA_REF, blend=decay)

    # ------------------------------------------------------------------
    # Shared timesteps, shared noise, groups
    # ------------------------------------------------------------------
    def shared_timesteps(self, epoch: int, inner: int) -> np.ndarray:
        """(T,) timesteps of an inner epoch, the same for every row."""
        return self.sample_timesteps(1, derive_seed(self.training_args.seed, epoch, inner, _TAG_SHARED_T))[:, 0]

    def shared_noise(self, mb: List[BaseSample], clean: Dict[str, torch.Tensor], epoch: int, inner: int
                     ) -> Dict[str, torch.Tensor]:
        """Noise per unique id, for every stream: one generator per id,
        seeded by (seed, epoch, inner, the id's first 16 hex digits), drawn
        in sorted stream order; rows of one id get the same noise."""
        dev, seed = self.adapter.device, self.training_args.seed
        per_uid: Dict[str, Dict[str, torch.Tensor]] = {}
        for s in mb:
            if s.unique_id not in per_uid:
                gen = make_generator(dev, seed, epoch, inner, int(s.unique_id[:16], 16), _TAG_SHARED_NOISE)
                per_uid[s.unique_id] = {k: torch.randn(clean[k].shape[1:], generator=gen, device=dev,
                                                       dtype=torch.float32) for k in sorted(clean)}
        return {k: torch.stack([per_uid[s.unique_id][k] for s in mb]) for k in clean}

    @staticmethod
    def group_ids(mb: List[BaseSample]) -> Tuple[List[int], int]:
        """Each row's group number, groups numbered in first-seen order, and
        the number of groups."""
        order: Dict[str, int] = {}
        ids = [order.setdefault(s.unique_id, len(order)) for s in mb]
        return ids, len(order)

    # ------------------------------------------------------------------
    # Grad steps
    # ------------------------------------------------------------------
    def grad_step_batches(self, samples: List[BaseSample], epoch: int) -> Iterator[Dict[str, Any]]:
        """Per shuffled micro-batch and shared timestep, the grad step's
        batch with the ``ema_ref`` and reference velocities (no gradients;
        one merge of ``ema_ref`` for the micro-batch's T forwards, taken
        before its grad steps as the JAX trainer takes the snapshot)."""
        ta, ad, dev = self.training_args, self.adapter, self.adapter.device
        T = ta.get_num_train_timesteps(self.config)
        for inner in range(ta.num_inner_epochs):
            shared_t = self.shared_timesteps(epoch, inner)
            for bi, (mb, bn) in enumerate(self.iter_micro_batches(samples, epoch, inner)):
                clean = self.clean_latent_tree(bn)
                adv = torch.tensor([s.extra_kwargs["advantage"] for s in mb], dtype=torch.float32, device=dev)
                ids, num_groups = self.group_ids(mb)
                if ta.use_shared_noise:
                    noise = self.shared_noise(mb, clean, epoch, inner)
                else:
                    noise = self.tree_normal(make_generator(dev, "dgpo_noise", ta.seed, epoch, inner, bi), clean)
                base = dict(clean=clean, noise=noise, advantage=torch.clamp(adv, *ta.adv_clip_range),
                            group_ids=torch.tensor(ids, device=dev), num_groups=num_groups, guidance_scale=1.0,
                            **self.batch_embeds(bn))
                steps = []
                with torch.no_grad():
                    old = (ad.merged_params(ad.velocity_component, ad.get_named_parameters(self.EMA_REF))
                           if self.requires_ema_ref else None)
                    for t_idx in range(T):
                        t = np.full((len(mb),), shared_t[t_idx], dtype=np.float32)
                        steps.append(self.with_frozen_velocities(dict(base, **self.timesteps(t)), old))
                    del old
                yield from steps

    def with_frozen_velocities(self, batch: Dict[str, Any], old_params: Optional[Dict[str, torch.Tensor]]
                               ) -> Dict[str, Any]:
        """``batch`` with ``old_v``, the velocity without CFG on
        ``old_params`` (the merged ``ema_ref``; None: none), and ``ref_v``,
        the reference policy's, under CFG at ``kl_cfg`` when that is above 1
        and the batch has negative embeds, when the loss needs it."""
        ta, ad = self.training_args, self.adapter
        fwd = self.noised_batch(batch)
        out = dict(batch)
        if old_params is not None:
            with torch.no_grad():
                out["old_v"] = self.tree_flat(ad.training_velocity_tree(None, uncfg(fwd), params=old_params))
        if ta.kl_beta > 0 or not ta.use_ema_ref:
            cfg_teacher = ta.kl_cfg > 1.0 and "negative_prompt_embeds" in fwd
            out["ref_v"] = self.frozen_velocity(self.reference_trainable(),
                                                {**fwd, "guidance_scale": float(ta.kl_cfg)} if cfg_teacher
                                                else uncfg(fwd))
        return out

    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The DGPO loss of one micro-batch at one timestep and its aux
        metrics (JAX ``_grad_fn``, ``trainers/dgpo.py:177-270``), on the
        frozen velocities of :meth:`with_frozen_velocities`."""
        ta = self.training_args
        beta, K = float(ta.dpo_beta), float(ta.group_size)
        clip_lo, clip_hi = ta.clip_range
        kl_beta = float(ta.kl_beta)
        fwd = self.noised_batch(batch)
        target = self.tree_flat(batch["noise"]) - self.tree_flat(batch["clean"])
        model_v = self.tree_flat(self.adapter.training_velocity_tree(trainable, uncfg(fwd)))
        dsm = per_sample_mse(model_v, target)
        old_v, ref_v = batch.get("old_v"), batch.get("ref_v")
        ref_dsm = per_sample_mse(old_v if ta.use_ema_ref else ref_v, target)
        adv = batch["advantage"]

        should_clip = None
        if (ta.clip_dsm or ta.clip_kl) and old_v is not None:
            ratio = torch.exp(-dsm.detach() + per_sample_mse(old_v, target))
            should_clip = torch.where(adv > 0, ratio > 1.0 + clip_hi, ratio < 1.0 + clip_lo)
            if ta.clip_dsm:
                dsm = torch.where(should_clip, dsm.detach(), dsm)

        pref = adv * beta * (dsm.detach() - ref_dsm) / K
        sums = group_sums(pref, batch["group_ids"], batch["num_groups"])
        if self.adapter.mesh is not None:  # a group's rows lie on every replica (group_distributed)
            from ..parallel.mesh import data_all_reduce_

            sums = data_all_reduce_(sums, self.adapter.mesh)
        group_w = torch.sigmoid(sums)[batch["group_ids"]]
        loss = torch.mean(group_w * adv * dsm)
        aux = {
            "train/loss": loss.detach(),
            "train/dsm_mean": torch.mean(dsm.detach()),
            "train/group_weight_mean": torch.mean(group_w),
            "train/pref_mean": torch.mean(pref),
        }
        if should_clip is not None:
            aux["train/clip_ratio"] = torch.mean(should_clip.float())
        if kl_beta > 0:
            kl = per_sample_mse(model_v, ref_v)
            if ta.clip_kl and should_clip is not None:
                kl = torch.where(should_clip, kl.detach(), kl)
            loss = loss + kl_beta * torch.mean(kl)
            aux["train/kl"] = torch.mean(kl.detach())
        aux["train/total_loss"] = loss.detach()
        return loss, aux
