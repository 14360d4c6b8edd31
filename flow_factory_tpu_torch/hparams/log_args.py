"""Logging configuration group (reference schema: ``hparams/log_args.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional

from .abc import ArgABC


@dataclass(kw_only=True)
class LogArguments(ArgABC):
    run_name: Optional[str] = field(default=None)
    project: str = field(default="Flow-Factory-TPU")
    logging_backend: Literal["wandb", "swanlab", "tensorboard", "none"] = field(default="none")
    save_dir: str = field(default="saves/")
    save_freq: int = field(default=0)
    save_model_only: bool = field(default=True)
    # TPU pods receive SIGTERM on maintenance/preemption events; when set the
    # trainer checkpoints full training state at the next safe step boundary
    # and exits cleanly (resume re-runs the interrupted epoch from its start —
    # samplers are seed-deterministic per epoch).
    save_on_preempt: bool = field(default=True)
    log_train_samples: int = field(default=30)
    verbose: bool = field(default=True)
