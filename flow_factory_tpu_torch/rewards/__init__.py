from .abc import BaseRewardModel, GroupwiseRewardModel, PointwiseRewardModel
from .models import MyReward
from .registry import load_reward_models, resolve_reward_class
from .reward_processor import RewardProcessor

__all__ = ["BaseRewardModel", "PointwiseRewardModel", "GroupwiseRewardModel", "MyReward",
           "RewardProcessor", "load_reward_models", "resolve_reward_class"]
