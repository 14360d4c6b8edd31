"""AWM (Advantage-Weighted Matching) trainer (port of
``flow_factory_tpu/trainers/awm.py``).

The "log-prob" is a weighted negative matching loss:

    lp = −mean((v_θ(x_t, t) − (ε − x1))²)   weighted by
        Uniform | ·σ | ·σ² | huber: −(√(−lp + 1e−10) − 1e−5)·σ |
        ghuber: −((−lp + ε)^p − ε^p)·σ/p

The loss is the PPO-clipped ratio of the current policy's weighted
log-prob to the sampling policy's, precomputed per micro-batch, plus
optional v-space KLs against the reference policy and the EMA weights.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .decoupled import OldPolicyTrainer


def weighted_log_prob(v_pred: torch.Tensor, target: torch.Tensor, t: torch.Tensor, weighting: str,
                      ghuber_power: float) -> torch.Tensor:
    """(B,) weighted matching log-prob (JAX ``awm.py:31``)."""
    d = (v_pred.float() - target.float()) ** 2
    lp = -torch.mean(d.reshape(d.shape[0], -1), dim=-1)
    sigma = torch.clamp(t / 1000.0, 0.0, 1.0)
    if weighting == "Uniform":
        return lp
    if weighting == "t":
        return lp * sigma
    if weighting == "t**2":
        return lp * sigma ** 2
    if weighting == "huber":
        return -(torch.sqrt(-lp + 1e-10) - 1e-5) * sigma
    if weighting == "ghuber":
        eps = 1e-10
        return -(((-lp + eps) ** ghuber_power) - eps ** ghuber_power) * sigma / ghuber_power
    raise ValueError(f"Unknown AWM weighting {weighting!r}")


class AWMTrainer(OldPolicyTrainer):
    old_key, tag = "old_log_prob", "awm"

    def _log_prob(self, v_flat: torch.Tensor, batch: Dict[str, Any]) -> torch.Tensor:
        ta = self.training_args
        target = self.tree_flat(batch["noise"]) - self.tree_flat(batch["clean"])
        return weighted_log_prob(v_flat, target, batch["timestep"], ta.awm_weighting, ta.ghuber_power)

    def old_policy(self, old_v: Dict[str, torch.Tensor], batch: Dict[str, Any]) -> torch.Tensor:
        return self._log_prob(self.tree_flat(old_v), batch)

    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The AWM loss of one micro-batch at one timestep and its aux
        metrics (JAX ``_grad_fn``, ``trainers/awm.py:141-182``); the
        reference and EMA velocities first, without gradients."""
        ta = self.training_args
        clip_lo, clip_hi = ta.clip_range
        kl_beta = float(getattr(ta, "kl_beta", 0.0))
        ema_kl_beta = float(getattr(ta, "ema_kl_beta", 0.0))
        fwd = self.noised_batch(batch)
        ref_v = self.frozen_velocity(ref_trainable, fwd) if kl_beta > 0 else None
        ema_on = ema_kl_beta > 0 and self.adapter.ema is not None
        ema_v = self.frozen_velocity(self.adapter.ema_trainable, fwd) if ema_on else None
        v = self.tree_flat(self.adapter.training_velocity_tree(trainable, fwd))
        lp = self._log_prob(v, batch)

        ratio = torch.exp(lp - batch["old_log_prob"])
        adv = torch.clamp(batch["advantage"], *ta.adv_clip_range)
        unclipped = -adv * ratio
        clipped = -adv * torch.clamp(ratio, 1.0 + clip_lo, 1.0 + clip_hi)
        loss = torch.mean(torch.maximum(unclipped, clipped))
        r = ratio.detach()
        aux = {
            "train/loss": loss.detach(),
            "train/ratio_mean": torch.mean(r),
            "train/clip_frac": torch.mean(((r < 1.0 + clip_lo) | (r > 1.0 + clip_hi)).float()),
            "train/matching_lp": torch.mean(lp.detach()),
        }
        if ref_v is not None:
            kl = torch.mean((v - ref_v) ** 2)
            loss = loss + kl_beta * kl
            aux["train/kl"] = kl.detach()
        if ema_v is not None:
            ekl = torch.mean((v - ema_v) ** 2)
            loss = loss + ema_kl_beta * ekl
            aux["train/ema_kl"] = ekl.detach()
        aux["train/total_loss"] = loss.detach()
        return loss, aux
