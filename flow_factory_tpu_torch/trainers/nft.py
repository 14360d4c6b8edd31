"""DiffusionNFT trainer (port of ``flow_factory_tpu/trainers/nft.py``).

The rollout keeps only the final latent, under the EMA weights when
``off_policy`` is set. Per micro-batch: the old velocity of the sampling
policy at T fresh (t, ε), without gradients, then T grad steps of the
contrastive loss under the current policy:

    v⁺ = β·v_new + (1−β)·v_old          v⁻ = (1+β)·v_old − β·v_new
    x0(v) = x_t − σ·v
    L = [ r·‖x0(v⁺)−x1‖²/w⁺ + (1−r)·‖x0(v⁻)−x1‖²/w⁻ ] / β · adv_hi
    r = clamp(adv/(2·adv_hi) + ½, 0, 1)   (the advantage as a reward in [0, 1])

with per-sample mean-abs normalisers w (no gradient) and an optional
v-space KL against the reference policy. The noise comes from generators
seeded by ``derive_seed``; its bits differ from the JAX package's keys, so
the tests feed both packages the same noise.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .decoupled import OldPolicyTrainer


def normalized_mse(x0_pred: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """(B,) mean of (x0_pred − clean)² / w per sample, w the per-sample mean
    |x0_pred − clean| (at least 1e-5), taken without gradient."""
    B = clean.shape[0]
    diff = x0_pred - clean
    w = torch.clamp(torch.mean(torch.abs(diff.detach()).reshape(B, -1), dim=-1), min=1e-5)
    d = diff ** 2 / w.reshape(-1, *([1] * (clean.ndim - 1)))
    return torch.mean(d.reshape(B, -1), dim=-1)


class NFTTrainer(OldPolicyTrainer):
    old_key, tag = "old_v", "nft"

    def old_policy(self, old_v: Dict[str, torch.Tensor], batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return old_v

    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The NFT loss of one micro-batch at one timestep and its aux
        metrics (JAX ``_grad_fn``, ``trainers/nft.py:118-163``); the
        reference velocity first, without gradients."""
        ta = self.training_args
        beta = float(ta.nft_beta)
        _, adv_hi = ta.adv_clip_range
        kl_beta = float(getattr(ta, "kl_beta", 0.0))
        fwd = self.noised_batch(batch)
        ref_v = self.frozen_velocity(ref_trainable, fwd) if kl_beta > 0 else None
        new_v = self.tree_flat(self.adapter.training_velocity_tree(trainable, fwd))
        clean, noise, old_v = (self.tree_flat(batch[k]) for k in ("clean", "noise", "old_v"))
        sigma = (batch["timestep"] / 1000.0).reshape(-1, 1)
        x_t = (1.0 - sigma) * clean + sigma * noise

        adv = torch.clamp(batch["advantage"], *ta.adv_clip_range)
        r = torch.clamp((adv / adv_hi) / 2.0 + 0.5, 0.0, 1.0)
        pos = beta * new_v + (1.0 - beta) * old_v
        neg = (1.0 + beta) * old_v - beta * new_v
        pos_loss = normalized_mse(x_t - sigma * pos, clean)
        neg_loss = normalized_mse(x_t - sigma * neg, clean)
        loss = torch.mean((r * pos_loss + (1.0 - r) * neg_loss) / beta) * adv_hi
        aux = {
            "train/loss": loss.detach(),
            "train/positive_loss": torch.mean(pos_loss.detach()),
            "train/negative_loss": torch.mean(neg_loss.detach()),
            "train/reward_r_mean": torch.mean(r),
        }
        if ref_v is not None:
            kl = torch.mean((new_v - ref_v) ** 2)
            loss = loss + kl_beta * kl
            aux["train/kl"] = kl.detach()
        aux["train/total_loss"] = loss.detach()
        return loss, aux
