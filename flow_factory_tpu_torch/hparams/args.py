"""Top-level Arguments: YAML → typed config with geometry alignment.

Behavior-compatible re-implementation of the reference's config resolution
pipeline (``hparams/args.py:101-437``):

1. ``_resolve_scheduler_sde_defaults`` — fill null sde_steps/num_sde_steps.
2. ``_resolve_sampler_type`` — auto / DGPO-force / async-reward override.
3. ``_align_batch_geometry`` — round ``unique_sample_num_per_epoch`` (and for
   group_distributed also ``group_size``) to sampler divisibility constraints,
   then recompute ``num_batches_per_epoch`` / ``gradient_accumulation_steps``.
4. ``_adjust_gradient_accumulation`` — multiply by the per-timestep loss count.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, Optional

from .abc import ArgABC
from .data_args import DataArguments
from .log_args import LogArguments
from .model_args import ModelArguments
from .reward_args import MultiRewardArguments
from .scheduler_args import SchedulerArguments
from .training_args import EvaluationArguments, TrainingArguments, resolve_training_args
from ..parallel.dist import get_world_size

logger = logging.getLogger(__name__)


@dataclass
class Arguments:
    data_args: DataArguments
    model_args: ModelArguments
    scheduler_args: SchedulerArguments
    training_args: TrainingArguments
    eval_args: EvaluationArguments
    log_args: LogArguments
    reward_args: MultiRewardArguments
    eval_reward_args: Optional[MultiRewardArguments] = None

    # Launch-level knobs (kept for schema parity with the reference CLI)
    launcher: str = "torch"
    config_file: Optional[str] = None
    num_processes: Optional[int] = None
    main_process_port: int = 29500
    mixed_precision: str = "bf16"

    def __post_init__(self):
        if self.log_args.run_name is None:
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            self.log_args.run_name = (
                f"{self.model_args.model_type}_{self.model_args.finetune_type}_"
                f"{self.training_args.trainer_type}_{ts}"
            )
        self._resolve_scheduler_sde_defaults()
        self._resolve_sampler_type()
        self._align_batch_geometry()
        self._adjust_gradient_accumulation()
        if not self.training_args.offload_samples_to_cpu:
            # samples are ALWAYS host-resident (the rollout copies its
            # buffers to host numpy once); the knob only exists for config
            # compatibility and cannot be turned off.
            logger.warning(
                "offload_samples_to_cpu=false is ignored: rollout samples are "
                "always stored host-side (see samples/samples.py)."
            )

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "Arguments":
        cfg = dict(cfg or {})
        train = dict(cfg.get("train", {}))
        eval_rewards = cfg.get("eval_rewards")
        args = cls(
            data_args=DataArguments.from_dict(cfg.get("data", {})),
            model_args=ModelArguments.from_dict(cfg.get("model", {})),
            scheduler_args=SchedulerArguments.from_dict(cfg.get("scheduler", {})),
            training_args=resolve_training_args(train),
            eval_args=EvaluationArguments.from_dict(cfg.get("eval", {})),
            log_args=LogArguments.from_dict(cfg.get("log", {})),
            reward_args=MultiRewardArguments.from_list(cfg.get("rewards", [])),
            eval_reward_args=(
                MultiRewardArguments.from_list(eval_rewards) if eval_rewards else None
            ),
            launcher=cfg.get("launcher", "torch"),
            config_file=cfg.get("config_file"),
            num_processes=cfg.get("num_processes"),
            main_process_port=cfg.get("main_process_port", 29500),
            mixed_precision=cfg.get("mixed_precision", "bf16"),
        )
        return args

    @classmethod
    def load_from_yaml(cls, path: str) -> "Arguments":
        import yaml  # only the YAML loader needs it; chip runs build configs in Python

        with open(os.path.expanduser(path)) as f:
            cfg = yaml.safe_load(f) or {}
        return cls.from_dict(cfg)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "launcher": self.launcher,
            "config_file": self.config_file,
            "num_processes": self.num_processes,
            "main_process_port": self.main_process_port,
            "mixed_precision": self.mixed_precision,
            "data": self.data_args.to_dict(),
            "model": self.model_args.to_dict(),
            "scheduler": self.scheduler_args.to_dict(),
            "train": self.training_args.to_dict(),
            "eval": self.eval_args.to_dict(),
            "log": self.log_args.to_dict(),
            "rewards": self.reward_args.to_list(),
            "eval_rewards": self.eval_reward_args.to_list() if self.eval_reward_args else None,
        }

    # ------------------------------------------------------------------
    # Resolution pipeline
    # ------------------------------------------------------------------
    def _resolve_scheduler_sde_defaults(self) -> None:
        sched = self.scheduler_args
        if sched.dynamics_type == "ODE":
            return
        n_inf = self.training_args.num_inference_steps
        if sched.sde_steps is None:
            sched.sde_steps = list(range(max(0, n_inf - 1)))
        if sched.num_sde_steps is None:
            sched.num_sde_steps = len(sched.sde_steps)
        if sched.num_sde_steps <= 0:
            raise ValueError(
                "scheduler.num_sde_steps must be positive after resolving nulls; "
                f"got num_sde_steps={sched.num_sde_steps!r}, sde_steps={sched.sde_steps!r}"
            )

    def _resolve_sampler_type(self) -> None:
        all_configs = list(self.reward_args or [])
        if self.eval_reward_args:
            all_configs += list(self.eval_reward_args)
        self._has_async_rewards = any(getattr(c, "async_reward", False) for c in all_configs)

        ta = self.training_args
        user_choice = self.data_args.sampler_type
        trainer_type = str(ta.trainer_type).lower()

        if (
            user_choice in {"distributed_k_repeat", "group_distributed"}
            and self._has_async_rewards
            and trainer_type != "dgpo"
        ):
            logger.warning(
                "Async rewards require 'group_contiguous' sampler; overriding %r.", user_choice
            )
            self.data_args.sampler_type = "group_contiguous"

        if user_choice == "auto" and trainer_type != "dgpo":
            world_size = get_world_size(self.model_args.tensor_size)
            m = ta.unique_sample_num_per_epoch
            groups_per_rank_ok = m % world_size == 0
            local_batch_tiling_ok = (
                (m // world_size) * ta.group_size % ta.per_device_batch_size == 0
            )
            if not groups_per_rank_ok and local_batch_tiling_ok:
                self.data_args.sampler_type = "distributed_k_repeat"
            else:
                self.data_args.sampler_type = "group_contiguous"

        if trainer_type == "dgpo" and self.data_args.sampler_type != "group_distributed":
            logger.warning(
                "DGPO requires sampler_type='group_distributed'; overriding %r.",
                self.data_args.sampler_type,
            )
            self.data_args.sampler_type = "group_distributed"

    # -- alignment ---------------------------------------------------------
    @staticmethod
    def _round_up_to_step(value: int, step: int) -> int:
        return ((value + step - 1) // step) * step

    def _base_unique_sample_step(self) -> int:
        ta = self.training_args
        sample_num_per_iteration = get_world_size(self.model_args.tensor_size) * ta.per_device_batch_size
        base = sample_num_per_iteration // math.gcd(ta.group_size, sample_num_per_iteration)
        if not ta._manual_gradient_accumulation_steps:
            base *= ta.gradient_step_per_epoch
        return base

    def _align_batch_geometry(self) -> None:
        sampler_type = self.data_args.sampler_type
        ta = self.training_args
        world_size = get_world_size(self.model_args.tensor_size)

        if sampler_type == "distributed_k_repeat":
            step = self._base_unique_sample_step()
        elif sampler_type == "group_contiguous":
            step = math.lcm(self._base_unique_sample_step(), world_size)
        elif sampler_type == "group_distributed":
            self._align_group_size_for_group_distributed()
            step = self._base_unique_sample_step()
        else:
            raise ValueError(f"Unknown sampler_type={sampler_type!r}")

        new_m = self._round_up_to_step(ta.unique_sample_num_per_epoch, step)
        if new_m != ta.unique_sample_num_per_epoch:
            logger.warning(
                "%s: adjusted unique_sample_num_per_epoch %d → %d to satisfy sampler divisibility",
                sampler_type, ta.unique_sample_num_per_epoch, new_m,
            )
            ta.unique_sample_num_per_epoch = new_m

        # recompute derived quantities
        sample_num_per_iteration = world_size * ta.per_device_batch_size
        ta.num_batches_per_epoch = (
            ta.unique_sample_num_per_epoch * ta.group_size
        ) // sample_num_per_iteration
        if not ta._manual_gradient_accumulation_steps:
            ta.gradient_accumulation_steps = ta.compute_gradient_accumulation_steps(
                ta.num_batches_per_epoch
            )

    def _align_group_size_for_group_distributed(self) -> None:
        """group_distributed needs ``group_size % W == 0`` and
        ``(W * per_device_batch_size) % group_size == 0``; pick the smallest
        valid ``group_size = W * d`` with ``d`` a divisor of
        per_device_batch_size and ``d >= ceil(K / W)``."""
        ta = self.training_args
        if ta.group_size <= 0:
            raise ValueError(f"group_size must be positive, got {ta.group_size}")
        world_size = get_world_size(self.model_args.tensor_size)
        pdbs = ta.per_device_batch_size
        sample_num_per_iteration = world_size * pdbs
        if ta.group_size > sample_num_per_iteration:
            # the reference ALIGNS geometry to the current world rather than
            # refusing (args.py:185-391): a config written for an 8-chip pod
            # still runs on fewer chips with a clamped (warned) group size
            logger.warning(
                "group_distributed: clamping group_size %d → %d "
                "(num_replicas %d × per_device_batch_size %d)",
                ta.group_size, sample_num_per_iteration, world_size, pdbs,
            )
            ta.group_size = sample_num_per_iteration
        min_copies = -(-ta.group_size // world_size)
        best = pdbs
        i = 1
        while i * i <= pdbs:
            if pdbs % i == 0:
                for d in (i, pdbs // i):
                    if min_copies <= d < best:
                        best = d
            i += 1
        new_group_size = world_size * best
        if new_group_size != ta.group_size:
            logger.warning(
                "group_distributed: auto-adjusting group_size %d → %d (W=%d, B=%d)",
                ta.group_size, new_group_size, world_size, pdbs,
            )
            ta.group_size = new_group_size

    def _adjust_gradient_accumulation(self) -> None:
        ta = self.training_args
        if not ta._manual_gradient_accumulation_steps:
            ta.gradient_accumulation_steps *= ta.get_num_train_timesteps(self)
        else:
            logger.info(
                "gradient_accumulation_steps manually set to %d; gradient_step_per_epoch ignored.",
                ta.gradient_accumulation_steps,
            )
