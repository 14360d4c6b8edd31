"""Hand-written Hopper kernels and their plain PyTorch versions."""
from .attention import (
    dot_product_attention,
    native_attention,
    qknorm_attention_plain,
    qknorm_dot_product_attention,
    qknorm_flash_attention,
)
from .norms import (
    adaln_modulate,
    fused_layernorm,
    ln_mul_add,
    residual_gate_modulate,
    residual_gate_modulate_rows,
    rms_modulate,
)

#: every kernel wrapper of the port; each carries a ``launches`` counter
KERNEL_WRAPPERS = {
    "qknorm_flash_fwd": qknorm_flash_attention,
    "ln_mul_add": ln_mul_add,
    "residual_gate_modulate": residual_gate_modulate_rows,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
