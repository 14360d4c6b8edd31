"""Hand-written Hopper kernels and their plain PyTorch versions."""
from .attention import (
    dot_product_attention,
    flash_attention,
    flash_attention_plain,
    flash_backward,
    flash_backward_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
    native_attention,
    qknorm_attention_plain,
    qknorm_dot_product_attention,
    qknorm_flash_attention,
)
from .norms import (
    adaln_modulate,
    fused_layernorm,
    ln_mul_add,
    ln_mul_add_backward,
    residual_gate_modulate,
    residual_gate_modulate_backward,
    residual_gate_modulate_rows,
    rms_modulate,
)

#: every kernel wrapper of the port; each carries a ``launches`` counter
KERNEL_WRAPPERS = {
    "qknorm_flash_fwd": qknorm_flash_attention,
    "flash_fwd": flash_attention,
    "flash_bwd_dq": flash_bwd_dq,
    "flash_bwd_dkv": flash_bwd_dkv,
    "ln_mul_add": ln_mul_add,
    "residual_gate_modulate": residual_gate_modulate_rows,
    "ln_mul_add_backward": ln_mul_add_backward,
    "residual_gate_modulate_backward": residual_gate_modulate_backward,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
