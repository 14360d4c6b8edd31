"""Model adapter registry of the port: config ``model_type`` → adapter class,
imported lazily; unknown keys may be a dotted path ``pkg.module:ClassName``.
Every model type of the JAX package's registry is ported; a model type
listed in ``_NOT_PORTED`` would raise ``NotImplementedError`` with its
reason."""
from __future__ import annotations

import importlib
from typing import Dict, Type

_MODEL_ADAPTER_REGISTRY: Dict[str, str] = {
    "sd3-5": "flow_factory_tpu_torch.models.sd3.adapter:SD35Adapter",
    "sd3.5": "flow_factory_tpu_torch.models.sd3.adapter:SD35Adapter",
    "wan2-t2v": "flow_factory_tpu_torch.models.wan.t2v:WanT2VAdapter",
    "wan21": "flow_factory_tpu_torch.models.wan.t2v:WanT2VAdapter",
    "wan22": "flow_factory_tpu_torch.models.wan.t2v:WanT2VAdapter",
    "wan2-i2v": "flow_factory_tpu_torch.models.wan.i2v:WanI2VAdapter",
    "wan2-v2v": "flow_factory_tpu_torch.models.wan.v2v:WanV2VAdapter",
    "flux1": "flow_factory_tpu_torch.models.flux.adapter:Flux1Adapter",
    "flux1-kontext": "flow_factory_tpu_torch.models.flux.kontext:Flux1KontextAdapter",
    "ltx2-t2av": "flow_factory_tpu_torch.models.ltx2.t2av:LTX2T2AVAdapter",
    "ltx2-i2av": "flow_factory_tpu_torch.models.ltx2.i2av:LTX2I2AVAdapter",
    "qwen-image": "flow_factory_tpu_torch.models.qwen_image.adapter:QwenImageAdapter",
    "qwen-image-edit-plus": "flow_factory_tpu_torch.models.qwen_image.edit_plus:QwenImageEditPlusAdapter",
    "z-image": "flow_factory_tpu_torch.models.z_image.adapter:ZImageAdapter",
    "flux2": "flow_factory_tpu_torch.models.flux.flux2:Flux2Adapter",
    "flux2-klein": "flow_factory_tpu_torch.models.flux.flux2:Flux2KleinAdapter",
}
_NOT_PORTED: Dict[str, str] = {}


def resolve_adapter_class(model_type: str) -> Type:
    if model_type in _NOT_PORTED:
        raise NotImplementedError(f"model_type {model_type!r} is not ported yet: {_NOT_PORTED[model_type]}")
    target = _MODEL_ADAPTER_REGISTRY.get(model_type, model_type)
    if ":" in target:
        module_name, cls_name = target.split(":")
    elif "." in target:
        module_name, cls_name = target.rsplit(".", 1)
    else:
        raise KeyError(f"Unknown model_type {model_type!r}; known: {sorted(_MODEL_ADAPTER_REGISTRY)}")
    return getattr(importlib.import_module(module_name), cls_name)
