from .abc import BaseRewardModel, GroupwiseRewardModel, PointwiseRewardModel
from .models import MyReward
from .loader import MultiRewardLoader
from .registry import load_reward_models, resolve_reward_class
from .reward_processor import RewardBuffer, RewardProcessor

__all__ = ["BaseRewardModel", "PointwiseRewardModel", "GroupwiseRewardModel", "MyReward",
           "MultiRewardLoader", "RewardBuffer", "RewardProcessor", "load_reward_models",
           "resolve_reward_class"]
