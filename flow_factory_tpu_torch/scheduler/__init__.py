from .abc import DynamicsType, SDEStepOutput
from .flow_match_euler import (
    FlowMatchEulerSDE,
    build_flow_match_sigmas,
    calculate_shift,
    sde_step,
)

__all__ = [
    "DynamicsType",
    "SDEStepOutput",
    "FlowMatchEulerSDE",
    "build_flow_match_sigmas",
    "calculate_shift",
    "sde_step",
]
