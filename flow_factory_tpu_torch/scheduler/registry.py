"""Scheduler registry: scheduler name → SDE scheduler class (port of
``flow_factory_tpu/scheduler/registry.py``). Keys are the port's scheduler
names plus the diffusers class-name aliases the reference YAML configs use."""
from __future__ import annotations

from typing import Dict, Type

from .flow_match_euler import FlowMatchEulerSDE
from .unipc import UniPCSDEScheduler

_SCHEDULER_REGISTRY: Dict[str, type] = {
    "flow_match_euler": FlowMatchEulerSDE,
    "flowmatcheulerdiscretescheduler": FlowMatchEulerSDE,
    "flowmatcheulerdiscrete": FlowMatchEulerSDE,
    "unipc": UniPCSDEScheduler,
    "unipcmultistepscheduler": UniPCSDEScheduler,
    "unipcmultistep": UniPCSDEScheduler,
}


def get_scheduler_class(name: str) -> Type[FlowMatchEulerSDE]:
    key = name.lower()
    if key not in _SCHEDULER_REGISTRY:
        raise KeyError(f"Unknown scheduler {name!r}. Registered: {sorted(_SCHEDULER_REGISTRY)}")
    return _SCHEDULER_REGISTRY[key]
