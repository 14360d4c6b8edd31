from .abc import ArgABC
from .args import Arguments
from .data_args import DataArguments
from .log_args import LogArguments
from .model_args import ModelArguments
from .reward_args import MultiRewardArguments, RewardArguments
from .scheduler_args import SchedulerArguments
from .training_args import (
    AWMTrainingArguments,
    CRDTrainingArguments,
    DGPOTrainingArguments,
    DPOTrainingArguments,
    EvaluationArguments,
    GRPOTrainingArguments,
    NFTTrainingArguments,
    TrainingArguments,
    resolve_training_args,
)

__all__ = [
    "ArgABC",
    "Arguments",
    "DataArguments",
    "LogArguments",
    "ModelArguments",
    "MultiRewardArguments",
    "RewardArguments",
    "SchedulerArguments",
    "EvaluationArguments",
    "TrainingArguments",
    "GRPOTrainingArguments",
    "NFTTrainingArguments",
    "AWMTrainingArguments",
    "DPOTrainingArguments",
    "DGPOTrainingArguments",
    "CRDTrainingArguments",
    "resolve_training_args",
]
