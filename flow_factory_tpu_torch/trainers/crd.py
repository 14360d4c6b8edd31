"""CRD trainer — Centered Reward Distillation (port of
``flow_factory_tpu/trainers/crd.py``).

Two named parameter snapshots of the adapter, blended toward the current
weights once an epoch on ``"start-startval-slope-endval"`` schedules:

    _crd_old      — the implicit reward's anchor     (old_model_decay)
    _crd_sampling — the rollout policy               (sampling_model_decay)

Per micro-batch (in sample order, cycle-padded) the old policy's velocity
without CFG at T fresh (t, ε), without gradients; then per timestep the
implicit reward ``r_θ = −(‖v_θ−v*‖² − ‖v_old−v*‖²)`` (optionally each term
over its mean |error|, ``adaptive_logp``) is matched against the advantages
mapped to [0, 1], both centered under uniform, hard positive/negative-pool or
softmax(adv/T) weights (``weight_temp`` < 0, = 0, > 0), by an MSE or a BCE
loss; plus an optional v-space KL to the reference (CFG'd by ``kl_cfg``,
optionally weighted by the reward, ``reward_adaptive_kl``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple, Union

import torch

from ..parallel.dist import get_world_size
from ..samples import BaseSample
from .decoupled import OldPolicyTrainer, uncfg

# (start_step, start_value, slope, end_value)
_DECAY_PRESETS = {
    0: (0, 0.0, 0.0, 0.0),
    1: (0, 0.0, 0.001, 0.5),
    2: (75, 0.0, 0.0075, 0.999),
    3: (0, 1.0, 0.0, 1.0),
    4: (0, 0.0, 0.02, 0.99),
    5: (0, 0.0, 0.01, 0.5),
    6: (0, 0.0, 0.0075, 0.999),
    "none": (0, 0.0, 0.0, 0.0),
    "slow": (0, 0.0, 0.001, 0.5),
    "medium": (75, 0.0, 0.0075, 0.999),
    "offline": (0, 1.0, 0.0, 1.0),
    "fast": (0, 0.0, 0.02, 0.99),
    "moderate": (0, 0.0, 0.01, 0.5),
}


def compute_decay(step: int, decay_type: Union[str, int, float]) -> float:
    """The decay at ``step`` of a preset (its key, a numeric string read as
    that int), a float (returned as is) or a ``'start-val-slope-end'``
    schedule; anything else raises ``ValueError``."""
    if isinstance(decay_type, str):
        try:
            decay_type = int(decay_type)
        except ValueError:
            pass
    if isinstance(decay_type, float):
        return decay_type
    if decay_type in _DECAY_PRESETS:
        start_step, start_value, slope, end_value = _DECAY_PRESETS[decay_type]
    elif isinstance(decay_type, str) and "-" in decay_type:
        parts = decay_type.split("-")
        if len(parts) != 4:
            raise ValueError(f"Decay string must be 'start_step-start_value-slope-end_value', got {decay_type!r}")
        start_step, start_value, slope, end_value = (int(float(parts[0])), float(parts[1]), float(parts[2]),
                                                     float(parts[3]))
    else:
        raise ValueError(f"Invalid decay_type {decay_type!r}")
    if step < start_step:
        return start_value
    return min(start_value + (step - start_step) * slope, end_value)


@torch.no_grad()
def centering_weights(adv: torch.Tensor, adv01: torch.Tensor, weight_temp: float) -> Tuple[torch.Tensor, ...]:
    """The centering weights (no gradient): uniform (``weight_temp`` < 0);
    the softmax of ``adv01`` over the positive and over the negative rows,
    each uniform when its pool is empty (= 0); the softmax of ±adv01/T
    (> 0). An empty pool's masked softmax is NaN, which ``where`` drops."""
    n = adv01.shape[0]
    uniform = torch.full((n,), 1.0 / n, dtype=adv01.dtype, device=adv01.device)
    if weight_temp < 0:
        return (uniform,)
    if weight_temp == 0:
        return tuple(torch.where(mask.any(), torch.softmax(adv01.masked_fill(~mask, float("-inf")), dim=0), uniform)
                     for mask in (adv > 0, adv < 0))
    return torch.softmax(adv01 / weight_temp, dim=0), torch.softmax(-adv01 / weight_temp, dim=0)


class CRDTrainer(OldPolicyTrainer):
    OLD = "_crd_old"
    SAMPLING = "_crd_sampling"
    old_key, tag, old_policy_cfg = "old_v", "crd", False

    def __init__(self, config, adapter):
        if get_world_size() > 1:
            raise NotImplementedError(
                f"CRD over {get_world_size()} data-parallel replicas: its centering weights are a softmax over the "
                "GLOBAL micro-batch, and the port's replicas hold its rows apart (ROADMAP Queue 1 item 24)")
        super().__init__(config, adapter)
        self.adapter.add_named_parameters(self.OLD)
        self.adapter.add_named_parameters(self.SAMPLING)
        self.adapter.init_ref_parameters()

    # ------------------------------------------------------------------
    # The snapshots
    # ------------------------------------------------------------------
    def sample(self, epoch: int, trainable=None) -> List[BaseSample]:
        return super().sample(epoch, trainable=self.adapter.get_named_parameters(self.SAMPLING))

    def _blend(self, name: str, decay: float) -> None:
        if decay <= 0.0:
            self.adapter.set_named_parameters(name)
        elif decay < 1.0:
            self.adapter.update_named_parameters(name, blend=decay)

    def update_snapshots(self) -> None:
        """Each snapshot moved by its schedule at ``global_step``: set to the
        live tree at decay ≤ 0, kept at ≥ 1, else blended."""
        ta = self.training_args
        self._blend(self.OLD, compute_decay(self.global_step, ta.old_model_decay))
        self._blend(self.SAMPLING, compute_decay(self.global_step, ta.sampling_model_decay))

    def optimize(self, samples: List[BaseSample], epoch: int) -> Dict[str, float]:
        out = super().optimize(samples, epoch)
        self.update_snapshots()
        return out

    # ------------------------------------------------------------------
    # Micro-batches and the old policy
    # ------------------------------------------------------------------
    def micro_batches(self, samples: List[BaseSample], epoch: int, inner: int
                      ) -> Iterator[Tuple[int, List[BaseSample], Dict[str, Any]]]:
        """The micro-batches in sample order (a prompt's group stays
        together, which the centering wants), the remainder cycle-padded,
        each seeded by its first index as the JAX trainer seeds it."""
        B = self.micro_batch_size
        idx = list(range(len(samples)))
        if idx and len(idx) % B:
            idx += idx[: B - len(idx) % B]
        for start in range(0, len(idx) - B + 1, B):
            self.check_preempt()
            yield (start, *self.stage_micro_batch([samples[i] for i in idx[start : start + B]]))

    def old_policy_params(self) -> Dict[str, torch.Tensor]:
        """The ``_crd_old`` snapshot merged, or the reference policy's
        weights without ``use_old_for_loss``."""
        if self.training_args.use_old_for_loss:
            return self.adapter.merged_params(self.adapter.velocity_component,
                                              self.adapter.get_named_parameters(self.OLD))
        return self.ref_params(self.reference_trainable())

    def old_policy(self, old_v: Dict[str, torch.Tensor], batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return old_v

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------
    def loss_fn(self, trainable, batch: Dict[str, Any], ref_trainable=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The CRD loss of one micro-batch at one timestep and its aux
        metrics (JAX ``_grad_fn``, ``trainers/crd.py:184-294``); the
        reference velocity first, without gradients."""
        ta = self.training_args
        crd_beta, weight_temp = float(ta.crd_beta), float(ta.weight_temp)
        adv_lo, adv_hi = ta.adv_clip_range
        kl_beta, kl_cfg = float(ta.kl_beta), float(ta.kl_cfg)
        fwd = self.noised_batch(batch)
        ref_v = None
        if kl_beta > 0:
            cfg_teacher = kl_cfg > 1.0 and "negative_prompt_embeds" in fwd
            ref_v = self.frozen_velocity(ref_trainable, {**fwd, "guidance_scale": kl_cfg} if cfg_teacher
                                         else uncfg(fwd))
        v = self.tree_flat(self.adapter.training_velocity_tree(trainable, uncfg(fwd)))
        old_v = self.tree_flat(batch["old_v"])
        target = self.tree_flat(batch["noise"]) - self.tree_flat(batch["clean"])

        if ta.adaptive_logp:
            wt = torch.clamp(torch.mean(torch.abs(v.detach() - target), dim=-1), min=1e-5).reshape(-1, 1)
            wo = torch.clamp(torch.mean(torch.abs(old_v - target), dim=-1), min=1e-5).reshape(-1, 1)
            r_theta_map = -((v - target) ** 2 / wt - (old_v - target) ** 2 / wo)
        else:
            r_theta_map = -((v - target) ** 2 - (old_v - target) ** 2)
        r_theta = torch.mean(r_theta_map, dim=-1)

        adv = torch.clamp(batch["advantage"], adv_lo, adv_hi)
        adv01 = torch.clamp((adv / adv_hi) / 2.0 + 0.5, 0.0, 1.0)

        def centered_loss(w: torch.Tensor) -> torch.Tensor:
            rc = adv01 - torch.sum(adv01 * w)
            rtc = r_theta - torch.sum(r_theta.detach() * w)
            if ta.crd_loss_type == "bce":
                logits = crd_beta * rtc
                targets = torch.sigmoid(rc)
                return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
                                  + torch.log1p(torch.exp(-torch.abs(logits))))
            return torch.mean((crd_beta * rtc - rc) ** 2)

        weights = centering_weights(adv, adv01, weight_temp)
        if len(weights) == 1:
            ori = centered_loss(weights[0])
        else:
            ori = 0.5 * centered_loss(weights[0]) + 0.5 * centered_loss(weights[1])
        loss = ori * adv_hi / max(crd_beta, 1e-8)
        aux = {
            "train/loss": loss.detach(),
            "train/unweighted_policy_loss": ori.detach(),
            "train/r_theta_mean": torch.mean(r_theta.detach()),
        }
        if ref_v is not None:
            kl = torch.mean((v - ref_v) ** 2, dim=-1)
            if ta.reward_adaptive_kl:
                min_coef = 1e-4 / max(kl_beta, 1e-8)
                loss = loss + kl_beta * torch.mean((min_coef + adv01 * (1 - min_coef)) * kl)
            else:
                loss = loss + kl_beta * torch.mean(kl)
            aux["train/kl"] = torch.mean(kl.detach())
            aux["train/old_deviate"] = torch.mean((v.detach() - old_v) ** 2)
        aux["train/total_loss"] = loss.detach()
        return loss, aux
