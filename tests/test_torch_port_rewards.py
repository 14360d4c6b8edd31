"""PyTorch port, the reward registry (fault F17): every reward name of the
JAX registry that the port lacks raises ``NotImplementedError`` with its
reason, ``MyReward`` resolves, and a name in neither registry raises
``KeyError``."""
import re

import pytest


def test_unported_reward_names_raise_with_their_reason():
    from flow_factory_tpu.rewards.registry import _REWARD_REGISTRY as JAX_REWARDS

    from flow_factory_tpu_torch.rewards.registry import _REWARD_REGISTRY, resolve_reward_class

    reasons = {"MyGroupReward": "item 6", "PickScoreNative": "item 6", "CLIPNative": "item 6",
               "PickScore": "local weights", "PickScoreRank": "local weights", "CLIPScore": "local weights",
               "OCR": "not installed", "CLAP": "local weights", "ImageBind": "not installed"}
    unported = sorted(set(JAX_REWARDS) - set(_REWARD_REGISTRY))
    assert len(unported) == len(JAX_REWARDS) - 1
    for name in unported:
        with pytest.raises(NotImplementedError, match=re.escape(reasons.get(name, "server"))):
            resolve_reward_class(name)


def test_ported_and_unknown_reward_names():
    from flow_factory_tpu_torch.rewards.models import MyReward
    from flow_factory_tpu_torch.rewards.registry import resolve_reward_class

    assert resolve_reward_class("MyReward") is MyReward
    with pytest.raises(KeyError, match="PickScor"):
        resolve_reward_class("PickScor")
