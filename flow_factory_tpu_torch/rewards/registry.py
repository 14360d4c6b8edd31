"""Reward model registry of the port: config name → ``module:Class``.
Reward names of the JAX package that are not ported raise
``NotImplementedError`` with the reason; a name in neither registry raises
``KeyError``."""
from __future__ import annotations

import importlib
from typing import Type

_REWARD_REGISTRY = {
    "MyReward": "flow_factory_tpu_torch.rewards.models:MyReward",
    "MyGroupReward": "flow_factory_tpu_torch.rewards.models:MyGroupReward",
    "PickScoreNative": "flow_factory_tpu_torch.rewards.clip_native:NativeCLIPReward",
    "CLIPNative": "flow_factory_tpu_torch.rewards.clip_native:NativeCLIPReward",
}
_LOCAL_WEIGHTS = "it needs local weights or a package that is not installed (ROADMAP Queue 1 item 6, not queued)"
_SERVER = "it needs a reward server (ROADMAP Queue 1 item 6, not queued)"
#: the JAX registry's other names (``flow_factory_tpu/rewards/registry.py``)
_NOT_PORTED = {
    **{name: _LOCAL_WEIGHTS for name in ("PickScore", "PickScoreRank", "CLIPScore", "OCR", "CLAP", "ImageBind")},
    **{name: _SERVER for name in ("Remote", "MyRewardRemote", "RemoteGroup", "MyGroupRewardRemote",
                                  "VLLMEvaluate", "RationalRewardT2I", "RationalRewardEdit", "vllm_evaluate",
                                  "rational_rewards_t2i", "rational_rewards_edit")},
}


def resolve_reward_class(name: str) -> Type:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"reward_model {name!r} is not ported: {_NOT_PORTED[name]}")
    target = _REWARD_REGISTRY.get(name, name)
    if ":" in target:
        module_name, cls_name = target.split(":")
    elif "." in target:
        module_name, cls_name = target.rsplit(".", 1)
    else:
        raise KeyError(f"Unknown reward_model {name!r}; known: {sorted(_REWARD_REGISTRY)}")
    return getattr(importlib.import_module(module_name), cls_name)


def load_reward_models(reward_args) -> list:
    """One reward model instance per configured entry."""
    return [resolve_reward_class(entry.reward_model)(entry) for entry in reward_args or []]
