"""Trainer registry of the port: config ``trainer_type`` → trainer class,
imported lazily; unknown keys may be a dotted path ``pkg.module:ClassName``.
Every trainer of the JAX package is ported: GRPO, GRPO-Guard, DPO, NFT, AWM,
DGPO and CRD."""
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
    "dgpo": "flow_factory_tpu_torch.trainers.dgpo:DGPOTrainer",
    "crd": "flow_factory_tpu_torch.trainers.crd:CRDTrainer",
}


def resolve_trainer_class(trainer_type: str) -> Type:
    target = _TRAINER_REGISTRY.get(str(trainer_type).lower(), trainer_type)
    if ":" in target:
        module_name, cls_name = target.split(":")
    elif "." in target:
        module_name, cls_name = target.rsplit(".", 1)
    else:
        raise KeyError(f"Unknown trainer_type {trainer_type!r}; known: {sorted(_TRAINER_REGISTRY)}")
    return getattr(importlib.import_module(module_name), cls_name)
