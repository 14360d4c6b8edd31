from .abc import DynamicsType, SDEStepOutput
from .flow_match_euler import (
    FlowMatchEulerSDE,
    build_flow_match_sigmas,
    calculate_shift,
    sde_step,
)
from .registry import get_scheduler_class
from .unipc import UniPCCarry, UniPCSDEScheduler, compute_unipc_orders, init_unipc_carry, unipc_eval_step

__all__ = [
    "DynamicsType",
    "SDEStepOutput",
    "FlowMatchEulerSDE",
    "UniPCCarry",
    "UniPCSDEScheduler",
    "build_flow_match_sigmas",
    "calculate_shift",
    "compute_unipc_orders",
    "get_scheduler_class",
    "init_unipc_carry",
    "sde_step",
    "unipc_eval_step",
]
