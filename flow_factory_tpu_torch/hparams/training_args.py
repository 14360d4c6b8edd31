"""Training/evaluation configuration groups + per-algorithm subclasses.

Schema-compatible with the reference (``hparams/training_args.py``): the same
YAML keys resolve to the same semantics. Per-algorithm subclasses carry the
``requires_ref_model`` / ``get_num_train_timesteps`` /
``compute_gradient_accumulation_steps`` hooks that drive geometry alignment.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Literal, Optional, Tuple, Union

from .abc import ArgABC
from ..parallel.dist import get_world_size

logger = logging.getLogger(__name__)


def _standardize_resolution(resolution, height, width):
    if not resolution:
        resolution = (512, 512)
    elif isinstance(resolution, (list, tuple)):
        if len(resolution) == 1:
            resolution = (resolution[0], resolution[0])
        else:
            resolution = (resolution[0], resolution[1])
    else:
        resolution = (resolution, resolution)
    if height is not None:
        resolution = (height, resolution[1])
    if width is not None:
        resolution = (resolution[0], width)
    return resolution


def _standardize_clip_range(value, name: str) -> Tuple[float, float]:
    if not isinstance(value, (tuple, list)):
        return (-abs(value), abs(value))
    assert value[0] < value[1], f"`{name}` lower bound must be < upper bound, got {value}."
    return (float(value[0]), float(value[1]))


def _standardize_timestep_range(value: Union[float, Tuple[float, float]]) -> Tuple[float, float]:
    if not isinstance(value, (list, tuple)):
        result = (0.0, float(value))
    else:
        result = (float(value[0]), float(value[1]))
    assert 0 <= result[0] < result[1] <= 1.0, (
        f"`timestep_range` must satisfy 0 <= start < end <= 1, got {result}"
    )
    return result


# ============================================================================
# Evaluation
# ============================================================================

@dataclass(kw_only=True)
class EvaluationArguments(ArgABC):
    resolution: Union[int, tuple, list] = field(default=512)
    height: Optional[int] = field(default=None)
    width: Optional[int] = field(default=None)
    per_device_batch_size: int = field(default=8)
    seed: Optional[int] = field(default=42)
    guidance_scale: float = field(default=4.5)
    num_inference_steps: int = field(default=28)
    eval_freq: int = field(default=10)

    def __post_init__(self):
        self.resolution = _standardize_resolution(self.resolution, self.height, self.width)
        self.height, self.width = self.resolution


# ============================================================================
# Base training arguments
# ============================================================================

@dataclass(kw_only=True)
class TrainingArguments(ArgABC):
    trainer_type: str = field(default="grpo")

    # Geometry
    resolution: Union[int, tuple, list] = field(default=512)
    height: Optional[int] = field(default=None)
    width: Optional[int] = field(default=None)
    max_epochs: Optional[int] = field(default=None)
    per_device_batch_size: int = field(default=8)
    gradient_step_per_epoch: int = field(default=1)
    max_grad_norm: float = field(default=1.0)
    gradient_accumulation_steps: Union[int, str] = field(default="auto")
    num_inner_epochs: int = field(default=1)
    group_size: int = field(default=16)
    unique_sample_num_per_epoch: int = field(default=48)
    num_inference_steps: int = field(default=10)
    guidance_scale: float = field(default=4.5)
    seed: int = field(default=42)

    # Optimizer
    learning_rate: Optional[float] = field(default=3e-4)
    adam_weight_decay: float = field(default=1e-4)
    adam_betas: Tuple[float, float] = field(default=(0.9, 0.999))
    adam_epsilon: float = field(default=1e-8)

    # Memory levers
    enable_gradient_checkpointing: bool = field(default=False)
    # always-on (samples are host numpy by construction);
    # accepted for reference-config compatibility, warns if set false
    offload_samples_to_cpu: bool = field(default=True)
    latent_storage_dtype: Optional[Literal["bf16", "fp16", "fp32"]] = field(default="fp16")
    #: dispatched-but-unfetched rollout batches kept in flight during the
    #: sample phase. 2 keeps the device fed while batch b-2's buffers ride
    #: the wire (measured: 64-sample epoch 86.1 → 59.5 s on v5e through the
    #: relay) at the cost of one extra batch of trajectory buffers in HBM;
    #: drop to 1 for memory-tight video geometries. Env FFT_PIPELINE_DEPTH
    #: overrides for experiments.
    pipeline_depth: int = field(default=2)

    # EMA
    ema_decay: float = field(default=0.0)
    ema_update_interval: int = field(default=1)
    ema_device: str = field(default="cuda")  # accepted for schema parity
    ema_decay_schedule: Literal[
        "constant", "power", "linear", "piecewise_linear", "cosine", "warmup_cosine"
    ] = field(default="constant")

    # Derived (filled by geometry alignment)
    num_batches_per_epoch: int = field(default=0)

    def __post_init__(self):
        self.resolution = _standardize_resolution(self.resolution, self.height, self.width)
        self.height, self.width = self.resolution

        world_size = get_world_size()
        sample_num_per_iteration = world_size * self.per_device_batch_size
        self.num_batches_per_epoch = (
            (self.unique_sample_num_per_epoch * self.group_size)
            // max(1, sample_num_per_iteration)
        )
        if self.gradient_accumulation_steps == "auto":
            self._manual_gradient_accumulation_steps = False
            self.gradient_accumulation_steps = self.compute_gradient_accumulation_steps(
                self.num_batches_per_epoch
            )
        else:
            self._manual_gradient_accumulation_steps = True
            self.gradient_accumulation_steps = int(self.gradient_accumulation_steps)
            if self.gradient_accumulation_steps < 1:
                raise ValueError("`gradient_accumulation_steps` must be >= 1")

        self.adam_betas = (float(self.adam_betas[0]), float(self.adam_betas[1]))
        if self.learning_rate is None:
            self.learning_rate = 1e-4
            logger.info("`learning_rate` not set; defaulting to %s", self.learning_rate)

    # -- hooks --------------------------------------------------------------
    def compute_gradient_accumulation_steps(self, num_batches_per_epoch: int) -> int:
        return max(1, num_batches_per_epoch // self.gradient_step_per_epoch)

    def get_num_train_timesteps(self, args: Any) -> int:
        return 1

    @property
    def requires_ref_model(self) -> bool:
        return getattr(self, "kl_beta", 0) > 0.0

    def get_preprocess_guidance_scale(self) -> float:
        return self.guidance_scale

    @property
    def storage_dtype(self):
        import torch

        return {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32, None: torch.float32}[
            self.latent_storage_dtype
        ]


# ============================================================================
# Algorithm-specific subclasses
# ============================================================================

@dataclass(kw_only=True)
class GRPOTrainingArguments(TrainingArguments):
    """GRPO / GRPO-Guard (coupled paradigm)."""

    global_std: bool = field(default=True)
    advantage_aggregation: Literal["sum", "gdpo"] = field(default="gdpo")
    clip_range: Union[float, Tuple[float, float]] = field(default=(-1e-4, 1e-4))
    adv_clip_range: Union[float, Tuple[float, float]] = field(default=(-5.0, 5.0))
    kl_type: Literal["v-based", "x-based"] = field(default="x-based")
    kl_beta: float = field(default=0.0)
    ref_param_device: str = field(default="cuda")

    def __post_init__(self):
        super().__post_init__()
        self.clip_range = _standardize_clip_range(self.clip_range, "clip_range")
        self.adv_clip_range = _standardize_clip_range(self.adv_clip_range, "adv_clip_range")

    def get_num_train_timesteps(self, args: Any) -> int:
        # ODE dynamics leaves num_sde_steps unresolved (no stochastic steps);
        # fall back to 1 so grad-accum stays well-defined.
        return args.scheduler_args.num_sde_steps or 1


@dataclass(kw_only=True)
class NFTTrainingArguments(TrainingArguments):
    """DiffusionNFT (decoupled paradigm)."""

    global_std: bool = field(default=True)
    advantage_aggregation: Literal["sum", "gdpo"] = field(default="gdpo")
    nft_beta: float = field(default=1.0)
    off_policy: bool = field(default=False)
    adv_clip_range: Union[float, Tuple[float, float]] = field(default=(-5.0, 5.0))
    kl_type: Literal["v-based"] = field(default="v-based")
    kl_beta: float = field(default=0.0)
    ref_param_device: str = field(default="cuda")
    num_train_timesteps: int = field(default=4)
    time_sampling_strategy: Literal[
        "uniform", "logit_normal", "discrete", "discrete_with_init", "discrete_wo_init"
    ] = field(default="logit_normal")
    time_shift: float = field(default=3.0)
    timestep_range: Union[float, Tuple[float, float]] = field(default=0.99)

    def __post_init__(self):
        super().__post_init__()
        self.adv_clip_range = _standardize_clip_range(self.adv_clip_range, "adv_clip_range")
        self.timestep_range = _standardize_timestep_range(self.timestep_range)

    def get_num_train_timesteps(self, args: Any) -> int:
        return self.num_train_timesteps


@dataclass(kw_only=True)
class AWMTrainingArguments(TrainingArguments):
    """Advantage-Weighted Matching."""

    global_std: bool = field(default=True)
    advantage_aggregation: Literal["sum", "gdpo"] = field(default="gdpo")
    ema_kl_beta: float = field(default=0.0)
    awm_weighting: str = field(default="Uniform")
    ghuber_power: float = field(default=1.0)
    off_policy: bool = field(default=False)
    clip_range: Union[float, Tuple[float, float]] = field(default=(-1e-2, 1e-2))
    adv_clip_range: Union[float, Tuple[float, float]] = field(default=(-5.0, 5.0))
    kl_type: Literal["v-based"] = field(default="v-based")
    kl_beta: float = field(default=0.0)
    ref_param_device: str = field(default="cuda")
    num_train_timesteps: int = field(default=4)
    time_sampling_strategy: Literal[
        "uniform", "logit_normal", "discrete", "discrete_with_init", "discrete_wo_init"
    ] = field(default="logit_normal")
    time_shift: float = field(default=3.0)
    timestep_range: Union[float, Tuple[float, float]] = field(default=0.99)

    def __post_init__(self):
        super().__post_init__()
        self.clip_range = _standardize_clip_range(self.clip_range, "clip_range")
        self.adv_clip_range = _standardize_clip_range(self.adv_clip_range, "adv_clip_range")
        self.timestep_range = _standardize_timestep_range(self.timestep_range)

    def get_num_train_timesteps(self, args: Any) -> int:
        return self.num_train_timesteps

    @property
    def requires_ref_model(self) -> bool:
        return self.kl_beta > 0.0


@dataclass(kw_only=True)
class DPOTrainingArguments(TrainingArguments):
    """Diffusion-DPO (decoupled; pairs from per-group argmax/argmin advantage)."""

    beta: float = field(default=2000.0)
    ref_param_device: str = field(default="cuda")
    global_std: bool = field(default=True)
    advantage_aggregation: Literal["sum", "gdpo"] = field(default="gdpo")
    weighting_scheme: Literal["logit_normal", "uniform"] = field(default="logit_normal")
    logit_mean: float = field(default=0.0)
    logit_std: float = field(default=1.0)
    num_train_timesteps: int = field(default=1)
    time_shift: float = field(default=1.0)
    timestep_range: Union[float, Tuple[float, float]] = field(default=0.99)

    def __post_init__(self):
        super().__post_init__()
        self.timestep_range = _standardize_timestep_range(self.timestep_range)
        if not self.num_train_timesteps or self.num_train_timesteps <= 0:
            self.num_train_timesteps = max(
                1, int(self.num_inference_steps * (self.timestep_range[1] - self.timestep_range[0]))
            )

    @property
    def requires_ref_model(self) -> bool:
        return True

    def compute_gradient_accumulation_steps(self, num_batches_per_epoch: int) -> int:
        # Pair formation consumes K: the optimize loop iterates over
        # M/world_size pairs, not M*K samples.
        world_size = get_world_size()
        pairs_per_rank = self.unique_sample_num_per_epoch // max(1, world_size)
        optimize_batches = pairs_per_rank // max(1, self.per_device_batch_size)
        return max(1, optimize_batches // self.gradient_step_per_epoch)

    def get_num_train_timesteps(self, args: Any) -> int:
        return self.num_train_timesteps


@dataclass(kw_only=True)
class DGPOTrainingArguments(GRPOTrainingArguments):
    """DGPO — group-level preference optimization."""

    dpo_beta: float = field(default=1.0)
    use_shared_noise: bool = field(default=True)
    clip_dsm: bool = field(default=False)
    clip_kl: bool = field(default=False)
    switch_ema_ref: int = field(default=0)
    off_policy: bool = field(default=False)
    kl_cfg: float = field(default=1.0)
    use_ema_ref: bool = field(default=False)
    ema_ref_max_decay: float = field(default=0.999)
    ema_ref_ramp_rate: float = field(default=1.0)
    ema_ref_device: str = field(default="cuda")
    num_train_timesteps: int = field(default=4)
    time_sampling_strategy: Literal[
        "uniform", "logit_normal", "discrete", "discrete_with_init", "discrete_wo_init"
    ] = field(default="logit_normal")
    time_shift: float = field(default=3.0)
    timestep_range: Union[float, Tuple[float, float]] = field(default=0.99)

    def __post_init__(self):
        super().__post_init__()
        self.timestep_range = _standardize_timestep_range(self.timestep_range)

    def get_num_train_timesteps(self, args: Any) -> int:
        return self.num_train_timesteps

    @property
    def requires_ref_model(self) -> bool:
        return True

    def get_preprocess_guidance_scale(self) -> float:
        # Negative prompts may be needed for the KL-CFG teacher even when
        # sampling CFG is off.
        return max(self.guidance_scale, self.kl_cfg)


@dataclass(kw_only=True)
class CRDTrainingArguments(TrainingArguments):
    """Contrastive Reward Distillation."""

    global_std: bool = field(default=True)
    advantage_aggregation: Literal["sum", "gdpo"] = field(default="gdpo")
    crd_beta: float = field(default=1.0)
    crd_loss_type: Literal["mse", "bce"] = field(default="mse")
    use_old_for_loss: bool = field(default=True)
    adaptive_logp: bool = field(default=False)
    weight_temp: float = field(default=0.0)
    old_model_decay: Union[str, float] = field(default="0-0.9-0-0.9")
    sampling_model_decay: Union[str, float, int] = field(default=0)
    adv_clip_range: Union[float, Tuple[float, float]] = field(default=(-5.0, 5.0))
    kl_type: Literal["v-based"] = field(default="v-based")
    kl_beta: float = field(default=0.0)
    kl_cfg: float = field(default=1.0)
    reward_adaptive_kl: bool = field(default=False)
    ref_param_device: str = field(default="cuda")
    num_train_timesteps: int = field(default=4)
    time_sampling_strategy: Literal[
        "uniform", "logit_normal", "discrete", "discrete_with_init", "discrete_wo_init"
    ] = field(default="logit_normal")
    time_shift: float = field(default=3.0)
    timestep_range: Union[float, Tuple[float, float]] = field(default=0.99)

    def __post_init__(self):
        super().__post_init__()
        self.adv_clip_range = _standardize_clip_range(self.adv_clip_range, "adv_clip_range")
        self.timestep_range = _standardize_timestep_range(self.timestep_range)

    def get_num_train_timesteps(self, args: Any) -> int:
        return self.num_train_timesteps

    def get_preprocess_guidance_scale(self) -> float:
        return max(self.guidance_scale, self.kl_cfg)


TRAINING_ARGS_BY_TRAINER = {
    "grpo": GRPOTrainingArguments,
    "grpo_guard": GRPOTrainingArguments,
    "grpo-guard": GRPOTrainingArguments,
    "nft": NFTTrainingArguments,
    "awm": AWMTrainingArguments,
    "dpo": DPOTrainingArguments,
    "dgpo": DGPOTrainingArguments,
    "crd": CRDTrainingArguments,
}


def resolve_training_args(train_dict: dict) -> TrainingArguments:
    trainer_type = str(train_dict.get("trainer_type", "grpo")).lower()
    cls = TRAINING_ARGS_BY_TRAINER.get(trainer_type, GRPOTrainingArguments)
    return cls.from_dict(train_dict)
