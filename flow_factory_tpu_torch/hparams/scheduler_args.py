"""Scheduler configuration group (reference schema: ``hparams/scheduler_args.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional

from .abc import ArgABC


@dataclass(kw_only=True)
class SchedulerArguments(ArgABC):
    dynamics_type: Literal["Flow-SDE", "Dance-SDE", "CPS", "ODE"] = field(default="Flow-SDE")
    noise_level: float = field(default=0.7)
    num_sde_steps: Optional[int] = field(default=None)
    sde_steps: Optional[List[int]] = field(default=None)
    seed: int = field(default=42)
    scheduler_type: Optional[str] = field(default=None)  # None → adapter default
    # UniPC eval-mode knobs (diffusers parity): predictor-corrector order 1-3
    # and the final-steps order taper
    solver_order: int = field(default=2)
    lower_order_final: bool = field(default=True)
