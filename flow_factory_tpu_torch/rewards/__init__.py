from .abc import BaseRewardModel, GroupwiseRewardModel, PointwiseRewardModel
from .clip_native import NativeCLIPReward
from .models import MyGroupReward, MyReward
from .loader import MultiRewardLoader
from .registry import load_reward_models, resolve_reward_class
from .reward_processor import RewardBuffer, RewardProcessor

__all__ = ["BaseRewardModel", "PointwiseRewardModel", "GroupwiseRewardModel", "MyReward", "MyGroupReward",
           "NativeCLIPReward", "MultiRewardLoader", "RewardBuffer", "RewardProcessor", "load_reward_models",
           "resolve_reward_class"]
