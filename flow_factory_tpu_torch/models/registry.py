"""Model adapter registry of the port: config ``model_type`` → adapter class,
imported lazily; unknown keys may be a dotted path ``pkg.module:ClassName``."""
from __future__ import annotations

import importlib
from typing import Dict, Type

_MODEL_ADAPTER_REGISTRY: Dict[str, str] = {
    "sd3-5": "flow_factory_tpu_torch.models.sd3.adapter:SD35Adapter",
    "sd3.5": "flow_factory_tpu_torch.models.sd3.adapter:SD35Adapter",
}


def resolve_adapter_class(model_type: str) -> Type:
    target = _MODEL_ADAPTER_REGISTRY.get(model_type, model_type)
    if ":" in target:
        module_name, cls_name = target.split(":")
    elif "." in target:
        module_name, cls_name = target.rsplit(".", 1)
    else:
        raise KeyError(f"Unknown model_type {model_type!r}; known: {sorted(_MODEL_ADAPTER_REGISTRY)}")
    return getattr(importlib.import_module(module_name), cls_name)
