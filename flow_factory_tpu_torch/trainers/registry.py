"""Trainer registry of the port: config ``trainer_type`` → trainer class,
imported lazily; unknown keys may be a dotted path ``pkg.module:ClassName``.
GRPO, GRPO-Guard, DPO, NFT and AWM are ported; DGPO and CRD raise
(ROADMAP Queue 1 item 5)."""
from __future__ import annotations

import importlib
from typing import Type

_TRAINER_REGISTRY = {
    "grpo": "flow_factory_tpu_torch.trainers.grpo:GRPOTrainer",
    "grpo_guard": "flow_factory_tpu_torch.trainers.grpo:GRPOGuardTrainer",
    "grpo-guard": "flow_factory_tpu_torch.trainers.grpo:GRPOGuardTrainer",
    "dpo": "flow_factory_tpu_torch.trainers.dpo:DPOTrainer",
    "nft": "flow_factory_tpu_torch.trainers.nft:NFTTrainer",
    "awm": "flow_factory_tpu_torch.trainers.awm:AWMTrainer",
}
_NOT_PORTED = ("dgpo", "crd")


def resolve_trainer_class(trainer_type: str) -> Type:
    key = str(trainer_type).lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(f"trainer {trainer_type!r} is not ported yet (ROADMAP Queue 1 item 5)")
    target = _TRAINER_REGISTRY.get(key, trainer_type)
    if ":" in target:
        module_name, cls_name = target.split(":")
    elif "." in target:
        module_name, cls_name = target.rsplit(".", 1)
    else:
        raise KeyError(f"Unknown trainer_type {trainer_type!r}; known: {sorted(_TRAINER_REGISTRY)}")
    return getattr(importlib.import_module(module_name), cls_name)
