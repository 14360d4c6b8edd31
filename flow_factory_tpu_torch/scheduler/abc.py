"""SDE scheduler interfaces (port of ``flow_factory_tpu/scheduler/abc.py``).

The step math is a plain function (`sde_step` in ``flow_match_euler.py``)
shared by the rollout loop and the replay forward; the class layer only holds
host-side schedule state (sigmas/timesteps, the per-epoch SDE-step subset,
train/eval mode).
"""
from __future__ import annotations

from typing import Literal, NamedTuple, Optional

import torch

DynamicsType = Literal["Flow-SDE", "Dance-SDE", "CPS", "ODE"]


class SDEStepOutput(NamedTuple):
    """Output of a single SDE denoise step.

      next_latents:       x_{t+1} in fp32 (round-tripped through the storage
                          dtype when freshly sampled).
      next_latents_mean:  Gaussian mean of the transition kernel (fp32).
      std_dev_t:          per-step diffusion scale sigma_t (fp32, broadcast shape).
      dt:                 signed step size sigma_{t+1} - sigma_t (negative).
      log_prob:           (B,) per-sample log-probability, mean-reduced over
                          non-batch dims; zeros for ODE.
      noise_pred:         the velocity that produced this step (fp32).
    """

    next_latents: torch.Tensor
    next_latents_mean: torch.Tensor
    std_dev_t: torch.Tensor
    dt: torch.Tensor
    log_prob: Optional[torch.Tensor]
    noise_pred: torch.Tensor
