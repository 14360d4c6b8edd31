"""LoRA as a separate trainable tree merged into the frozen weights.

Port of ``flow_factory_tpu/models/lora.py``. The LoRA of a component lives
apart from its frozen ``nn.Module`` as ``{module_path: {"lora_A", "lora_B"}}``
in PEFT layout — ``lora_A`` (r, in), ``lora_B`` (out, r) — so PEFT
checkpoints load with no key map. The effective weight is computed, not
stored in the module:
``W_eff = (W.float() + (alpha/r)·(B@A)).to(W.dtype)`` (the transpose of the
JAX package's flax-layout ``a@b``), and the module runs on it through
``torch.func.functional_call``. So:

* the reference policy is the same merge with the LoRA tree zeroed,
* EMA and snapshots are extra copies of the small LoRA tree,
* the optimizer holds state for LoRA leaves only,
* one merge code path serves the rollout (once per rollout, no grad) and
  the training forward (per step, with grad), so both give the same bits.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Sequence

import torch

LoraTree = Dict[str, Dict[str, torch.Tensor]]

#: the JAX package's DEFAULT_TARGET_PATTERNS over the port's diffusers names
DEFAULT_TARGET_PATTERNS = (
    r".*attn.*\.(to_q|to_k|to_v|to_out\.0|add_q_proj|add_k_proj|add_v_proj|to_add_out)\.weight$",
    r".*attn2.*\.(to_q|to_k|to_v|to_out\.0)\.weight$",
    r".*\.(ff|ff_context)\.net\.(0\.proj|2)\.weight$",
)


def resolve_target_paths(module: torch.nn.Module,
                         target_patterns: Optional[Sequence[str]] = None) -> List[str]:
    """Module paths of every 2-D weight whose parameter name matches a target
    pattern, sorted."""
    patterns = [re.compile(p) for p in (target_patterns or DEFAULT_TARGET_PATTERNS)]
    return sorted(name[: -len(".weight")] for name, p in module.named_parameters()
                  if name.endswith(".weight") and p.ndim == 2 and any(r.match(name) for r in patterns))


def init_lora(module: torch.nn.Module, rank: int, generator: torch.Generator,
              target_patterns: Optional[Sequence[str]] = None,
              dtype: torch.dtype = torch.float32) -> LoraTree:
    """LoRA tree over the targeted weights: ``lora_A`` ~ N(0, 1/fan_in), drawn
    from ``generator`` in sorted path order, and ``lora_B`` = 0 (identity at
    step 0, the PEFT convention). Leaves require grad, on the module's device."""
    paths = resolve_target_paths(module, target_patterns)
    if not paths:
        raise ValueError("No LoRA target parameters matched the given patterns")
    tree: LoraTree = {}
    for path in paths:
        w = module.get_parameter(f"{path}.weight")
        fan_out, fan_in = w.shape
        a = torch.randn((rank, fan_in), generator=generator, device=w.device, dtype=torch.float32)
        tree[path] = {
            "lora_A": (a / math.sqrt(fan_in)).to(dtype).requires_grad_(),
            "lora_B": torch.zeros((fan_out, rank), device=w.device, dtype=dtype).requires_grad_(),
        }
    return tree


def zero_like_lora(lora: LoraTree) -> LoraTree:
    return {path: {k: torch.zeros_like(v, requires_grad=False) for k, v in ab.items()}
            for path, ab in lora.items()}


def merge_weight(weight: torch.Tensor, lora_A: torch.Tensor, lora_B: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """``(W.float() + scale·(B@A)).to(W.dtype)`` — differentiable in A and B."""
    delta = torch.matmul(lora_B.float(), lora_A.float()) * scale
    return (weight.float() + delta).to(weight.dtype)


def merge_lora(module: torch.nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]],
               scale: float) -> Dict[str, torch.Tensor]:
    """Effective weights ``{'<path>.weight': W_eff}`` of the LoRA-targeted
    parameters, for ``functional_call(module, merged, ...)``; ``scale`` =
    alpha / rank (PEFT's ``lora_alpha / r``)."""
    return {f"{path}.weight": merge_weight(module.get_parameter(f"{path}.weight"),
                                           ab["lora_A"], ab["lora_B"], scale)
            for path, ab in lora.items()}


def lora_param_count(lora: LoraTree) -> int:
    return sum(v.numel() for ab in lora.values() for v in ab.values())
