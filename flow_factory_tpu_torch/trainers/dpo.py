"""Diffusion-DPO trainer (port of ``flow_factory_tpu/trainers/dpo.py``).

Pairs are formed per prompt group from the advantage argmax (chosen) and
argmin (rejected); the loss is the flow-matching DPO objective

    err(θ, x) = MSE(v_θ(x_t, t), ε − x0)      ε shared by chosen and rejected
    loss = −log σ(−β/2 · [(err_w(θ) − err_w(ref)) − (err_l(θ) − err_l(ref))])

with fresh timesteps per pair batch from ``TimeSampler`` and the reference
policy the zero LoRA (or the frozen snapshot of full finetuning). The
reference errors are computed first, without gradients, on the frozen
weights; then one LoRA merge serves both θ forwards of the step. Above one
data-parallel process the pairs are formed on the gathered samples
(``distributed_k_repeat``: groups span processes) and strided by rank, or
locally and cycle-padded to the widest rank's count, so that every rank
runs as many grad steps.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.dist import get_data_rank, get_world_size, host_allgather_objects
from ..samples import BaseSample, stack_samples
from ..utils.base import derive_seed, make_generator
from .decoupled import DecoupledTrainer, rank_seed_parts

logger = logging.getLogger(__name__)


class DPOTrainer(DecoupledTrainer):
    # ------------------------------------------------------------------
    # Pairs
    # ------------------------------------------------------------------
    @staticmethod
    def _pairs_from_advantages(samples: List[BaseSample]):
        """Per group (chosen, rejected) by advantage argmax/argmin, groups in
        the order they first appear; groups of one and groups whose
        advantages all tie give no pair."""
        groups: Dict[str, List[BaseSample]] = {}
        for s in samples:
            groups.setdefault(s.unique_id, []).append(s)
        pairs = []
        for members in groups.values():
            if len(members) < 2:
                continue
            advs = np.asarray([m.extra_kwargs["advantage"] for m in members])
            if advs.max() - advs.min() < 1e-9:
                continue  # degenerate group: no preference signal
            pairs.append((members[int(advs.argmax())], members[int(advs.argmin())]))
        return pairs

    def _form_pairs(self, samples: List[BaseSample]):
        """Pair formation, and with ``distributed_k_repeat`` over several
        processes the gathered global pair list's stride for this process,
        cycle-padded to the widest stride (JAX ``_form_pairs``)."""
        ws = get_world_size()
        distributed = ws > 1 and self.config.data_args.sampler_type == "distributed_k_repeat"
        if not distributed:
            pairs = self._pairs_from_advantages(samples)
            stat_pairs = pairs
            if ws > 1:
                pairs = self._align_pair_counts(pairs, ws)
        else:
            gathered = host_allgather_objects(list(samples))
            all_pairs = self._pairs_from_advantages([s for rank_list in gathered for s in rank_list])
            n = len(all_pairs)
            if n and n < ws:
                raise RuntimeError(
                    f"DPO (distributed_k_repeat): need at least one pair per process; got {n} pairs over "
                    f"{ws} processes. Increase unique prompts per epoch or use sampler_type group_contiguous.")
            mine = all_pairs[get_data_rank()::ws]
            stat_pairs = mine
            target = -(-n // ws) if n else 0
            if mine and len(mine) < target:
                mine = (mine * target)[:target]
            pairs = mine
        self._pair_metrics = self._pair_stats(stat_pairs, ws)
        return pairs

    @staticmethod
    def _align_pair_counts(pairs, ws: int):
        """Cycle-pad the local pairs to the widest process's count; a process
        with none pads with a template pair of the first non-empty one."""
        counts = [c for lst in host_allgather_objects([len(pairs)]) for c in lst]
        max_cnt = max(counts)
        if max_cnt == 0:
            return pairs
        if min(counts) == 0:
            templates = host_allgather_objects([pairs[0]] if pairs else [])
            if not pairs:
                return [next(lst[0] for lst in templates if lst)] * max_cnt
        if len(pairs) < max_cnt:
            pairs = (pairs * max_cnt)[:max_cnt]
        return pairs

    @staticmethod
    def _pair_stats(stat_pairs, ws: int) -> Dict[str, float]:
        """Pair statistics over the unpadded pairs (summed over processes)."""
        n = len(stat_pairs)
        ca = np.asarray([p[0].extra_kwargs["advantage"] for p in stat_pairs], np.float64)
        ra = np.asarray([p[1].extra_kwargs["advantage"] for p in stat_pairs], np.float64)
        local = np.array([float(n), ca.sum() if n else 0.0, ra.sum() if n else 0.0], np.float64)
        total = np.sum([row for lst in host_allgather_objects([local]) for row in lst], axis=0) if ws > 1 else local
        out = {"train/dpo_num_pairs": float(total[0])}
        if total[0] > 0:
            out["train/dpo_chosen_adv_mean"] = float(total[1] / total[0])
            out["train/dpo_rejected_adv_mean"] = float(total[2] / total[0])
            out["train/dpo_adv_margin_mean"] = float((total[1] - total[2]) / total[0])
        return out

    # ------------------------------------------------------------------
    # Optimization
    # ------------------------------------------------------------------
    def grad_step_batches(self, samples: List[BaseSample], epoch: int):
        """The device batch of every grad step of an epoch, in order: the
        pairs shuffled, cut into micro-batches (the last cycle-padded), each
        at ``num_train_timesteps`` fresh timesteps with one noise draw shared
        by its chosen and rejected latents."""
        ta, dev = self.training_args, self.adapter.device
        pairs = self._form_pairs(samples)
        if not pairs:
            logger.warning("DPO: no usable pairs this epoch")
            return
        T = ta.get_num_train_timesteps(self.config)
        B = max(1, min(self.micro_batch_size, len(pairs)))
        for inner in range(ta.num_inner_epochs):
            perm = np.random.default_rng(derive_seed("dpo_shuffle", ta.seed, epoch, inner)).permutation(len(pairs))
            for start in range(0, len(pairs), B):
                self.check_preempt()
                chunk = [pairs[i] for i in perm[start : start + B]]
                if len(chunk) < B:  # cycle to keep the micro-batch whole
                    chunk = chunk + [pairs[perm[i % len(perm)]] for i in range(B - len(chunk))]
                chosen, rejected = [c for c, _ in chunk], [r for _, r in chunk]
                cb, rb = stack_samples(chosen), stack_samples(rejected)
                chosen_lat, rejected_lat = self.clean_latent_tree(cb), self.clean_latent_tree(rb)
                embeds = self.batch_embeds(cb)
                all_t = self.sample_timesteps(len(chunk), derive_seed("dpo_t", ta.seed, epoch, inner, start))
                for t_idx in range(T):
                    gen = make_generator(dev, "dpo_noise", ta.seed, epoch, inner, start, t_idx, *rank_seed_parts())
                    yield dict(
                        chosen=chosen_lat,
                        rejected=rejected_lat,
                        noise=self.tree_normal(gen, chosen_lat),  # shared ε across the pair
                        **self.timesteps(all_t[t_idx]),
                        guidance_scale=float(chosen[0].extra_kwargs.get("guidance_scale", ta.guidance_scale)),
                        **embeds,
                    )

    def optimize(self, samples: List[BaseSample], epoch: int) -> Dict[str, float]:
        out = super().optimize(samples, epoch)
        out.update(getattr(self, "_pair_metrics", {}))
        return out

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------
    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The DPO loss of one pair micro-batch at one timestep and its aux
        metrics (JAX ``_grad_fn``, ``trainers/dpo.py:232-271``): ``tw``/``tl``
        take gradients, ``rw``/``rl`` (the reference policy, see
        :meth:`ref_params`) run under ``no_grad``, the JAX stop_gradient."""
        beta = float(self.training_args.beta)
        ad = self.adapter
        t, noise = batch["timestep"], batch["noise"]
        xw = self.tree_noised(batch["chosen"], noise, t)
        xl = self.tree_noised(batch["rejected"], noise, t)
        noise_f = self.tree_flat(noise)
        target_w = noise_f - self.tree_flat(batch["chosen"])
        target_l = noise_f - self.tree_flat(batch["rejected"])

        def err(params, x_tree, target):
            v = self.tree_flat(ad.training_velocity_tree(None, {**batch, **x_tree}, params=params))
            d = v - target
            return torch.mean(d * d, dim=-1)

        with torch.no_grad():  # first, so that no θ graph is alive beside its weights
            ref = self.ref_params(ref_trainable)
            rw, rl = err(ref, xw, target_w), err(ref, xl, target_l)
            del ref
        params = ad.merged_params(ad.velocity_component, trainable)
        tw, tl = err(params, xw, target_w), err(params, xl, target_l)

        inside = -0.5 * beta * ((tw - rw) - (tl - rl))
        loss = -torch.mean(F.logsigmoid(inside))
        implicit_w = (-0.5 * beta * (tw - rw)).detach()
        implicit_l = (-0.5 * beta * (tl - rl)).detach()
        aux = {
            "train/loss": loss.detach(),
            "train/theta_w_err": torch.mean(tw.detach()),
            "train/theta_l_err": torch.mean(tl.detach()),
            "train/implicit_acc": torch.mean((implicit_w > implicit_l).float()),
            "train/implicit_margin": torch.mean(implicit_w - implicit_l),
        }
        return loss, aux
