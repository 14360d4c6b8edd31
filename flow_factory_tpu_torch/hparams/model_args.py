"""Model configuration group (reference schema: ``hparams/model_args.py``).

``attn_backend`` selects between the plain PyTorch attention and the port's
hand-written flash kernel (replacing diffusers' flash-attention dispatch,
reference ``models/abc.py:782-798``); ``fsdp_size`` / ``tensor_size`` select
mesh parallelism declaratively (replacing accelerate/DeepSpeed config files).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional, Union

from .abc import ArgABC


@dataclass(kw_only=True)
class ModelArguments(ArgABC):
    model_name_or_path: str = field(default="")
    model_type: str = field(default="sd3-5")
    finetune_type: Literal["full", "lora"] = field(default="lora")
    lora_rank: int = field(default=32)
    lora_alpha: int = field(default=64)
    target_modules: Union[str, List[str]] = field(default="default")
    resume_path: Optional[str] = field(default=None)
    resume_type: Optional[Literal["lora", "full", "state"]] = field(default=None)

    # dtypes: trainable params in master dtype; frozen components in
    # inference dtype (reference mixed-precision policy, models/abc.py:800-856)
    master_dtype: str = field(default="float32")
    inference_dtype: str = field(default="bfloat16")

    # attention backend: 'auto'/'flash' → the CUDA kernel on a CUDA tensor, plain torch on CPU
    attn_backend: Literal["auto", "native", "flash", "hybrid", "splash"] = field(default="auto")

    # mesh parallelism (declarative replacement for deepspeed/fsdp yaml configs)
    fsdp_size: int = field(default=1)
    tensor_size: int = field(default=1)

    enable_gradient_checkpointing_override: Optional[bool] = field(default=None)

    # real-weight loads: fail loudly (with the full unmatched-key list) if a
    # key map does not cover the checkpoint, instead of silently keeping
    # random init for the uncovered leaves. Parity runs force this on.
    strict_import: bool = field(default=False)
