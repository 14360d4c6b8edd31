"""Reward model registry of the port: config name → ``module:Class``."""
from __future__ import annotations

import importlib
from typing import Type

_REWARD_REGISTRY = {
    "MyReward": "flow_factory_tpu_torch.rewards.models:MyReward",
}


def resolve_reward_class(name: str) -> Type:
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
