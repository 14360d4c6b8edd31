"""Norm-and-modulate ops: kernels K5 and K6 (Triton) and their plain versions.

Port of ``flow_factory_tpu/ops/norms.py``.

* K5 :func:`ln_mul_add` replaces the TPU kernel ``_ln_mul_add_kernel``
  (``norms.py:93``): a no-affine LayerNorm (flax fast variance
  ``max(0, E[x^2] - E[x]^2)``, eps inside the rsqrt) or RMSNorm with fp32
  stats, then ``* mul + add``; ``fold`` gives the flax affine order.
* K6 :func:`residual_gate_modulate` replaces ``_rgm_kernel`` (``norms.py:300``):
  ``x_new = x + gate * branch`` and ``x_mod = LN_fp32(x_new) * mul + add``,
  emitting both.

What bounds them on an H100: each is one pass over (B, S, D) rows with a
row reduction and elementwise work and no tensor-core product — a few FLOP
per byte, far below the ~295 FLOP/byte ridge — so the bound is memory
(3.35 TB/s). Design: one Triton program per row, the whole D=1536 row held in
registers (BLOCK_D = next power of two, masked), so each input byte is read
once and each output byte written once; stats and modulation stay in fp32.

On a CPU tensor the wrappers compute the plain versions (``_native_*``, the
JAX package's ``_native_ln_mul_add`` / ``_native_residual_gate_modulate``);
on a CUDA tensor they launch the kernel (counted in ``<wrapper>.launches``)
or raise. The TPU's ``FFT_FUSED_NORMS``/``FFT_RGM`` A/B switches are not
ported: on CUDA the kernels always run.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

_DEFAULT_EPS = 1e-6
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_D = 16384


def _bcast(m: torch.Tensor, B: int) -> torch.Tensor:
    """Canonicalise a modulation operand to contiguous fp32 (B, S_or_1, D)."""
    if m.ndim == 1:
        m = m[None, None, :].expand(B, 1, m.shape[-1])
    elif m.ndim == 2:
        m = m[:, None, :]
    return m.float().contiguous()


def _native_ln_mul_add(x, mul, add, eps, out_dtype, fold, rms=False):
    """fold=False: ((x - mu) * r) * mul + add (AdaLN order); fold=True: the flax
    affine order (x - mu) * (r * mul) + add; rms=True: no-affine RMSNorm."""
    x32 = x.float()
    if rms:
        r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
        return (x32 * r * mul + add).to(out_dtype)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(x32 * x32, dim=-1, keepdim=True) - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    if fold:
        out = (x32 - mean) * (r * mul) + add
    else:
        out = (x32 - mean) * r * mul + add
    return out.to(out_dtype)


def _native_residual_gate_modulate(x, branch, gate, mul, add, eps, out_dtype):
    """``x + gate[:, None, :].to(x.dtype) * branch`` then the no-fold LN path."""
    x_new = x + gate[:, None, :].to(x.dtype) * branch
    x_mod = _native_ln_mul_add(x_new, mul, add, eps, out_dtype, fold=False)
    return x_new, x_mod


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    """Import Triton and define both kernels on first launch (never at module
    import: the CPU tests import this module without Triton)."""
    global triton, tl, round_bf16  # jitted kernels resolve these as module globals
    import triton
    import triton.language as tl

    @triton.jit
    def ln_mul_add_kernel(x_ptr, mul_ptr, add_ptr, out_ptr, S, D, mod_sb, mod_ss, eps,
                          FOLD: tl.constexpr, RMS: tl.constexpr, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // S
        cols = tl.arange(0, BLOCK_D)
        live = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=live, other=0.0).to(tl.float32)
        mrow = b * mod_sb + (row % S) * mod_ss
        mul = tl.load(mul_ptr + mrow + cols, mask=live, other=0.0)
        add = tl.load(add_ptr + mrow + cols, mask=live, other=0.0)
        if RMS:
            r = tl.rsqrt(tl.sum(x * x, axis=0) / D + eps)
            out = x * r * mul + add
        else:
            mean = tl.sum(x, axis=0) / D
            var = tl.maximum(tl.sum(x * x, axis=0) / D - mean * mean, 0.0)
            r = tl.rsqrt(var + eps)
            if FOLD:
                out = (x - mean) * (r * mul) + add
            else:
                out = (x - mean) * r * mul + add
        tl.store(out_ptr + row * D + cols, out.to(out_ptr.dtype.element_ty), mask=live)

    @triton.jit
    def round_bf16(v):
        """fp32 → the fp32 value of its round-to-nearest-even bf16, in integer
        ops the compiler can neither fold away nor fuse into an fma."""
        bits = v.to(tl.uint32, bitcast=True)
        bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
        return bits.to(tl.float32, bitcast=True)

    @triton.jit
    def rgm_kernel(x_ptr, br_ptr, gate_ptr, mul_ptr, add_ptr, xn_ptr, xm_ptr, S, D, eps,
                   BF16: tl.constexpr, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // S
        cols = tl.arange(0, BLOCK_D)
        live = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=live, other=0.0).to(tl.float32)
        br = tl.load(br_ptr + row * D + cols, mask=live, other=0.0).to(tl.float32)
        g = tl.load(gate_ptr + b * D + cols, mask=live, other=0.0)
        if BF16:
            # round where PyTorch eager rounds — the gate, the product, the
            # sum, each to bf16 — so x_new equals the plain version bit for bit
            x32 = round_bf16(x + round_bf16(round_bf16(g) * br))
        else:
            x32 = (x + g.to(xn_ptr.dtype.element_ty).to(tl.float32) * br).to(
                xn_ptr.dtype.element_ty).to(tl.float32)
        tl.store(xn_ptr + row * D + cols, x32.to(xn_ptr.dtype.element_ty), mask=live)
        mean = tl.sum(x32, axis=0) / D
        var = tl.maximum(tl.sum(x32 * x32, axis=0) / D - mean * mean, 0.0)
        r = tl.rsqrt(var + eps)
        mul = tl.load(mul_ptr + b * D + cols, mask=live, other=0.0)
        add = tl.load(add_ptr + b * D + cols, mask=live, other=0.0)
        xm = (x32 - mean) * r * mul + add
        tl.store(xm_ptr + row * D + cols, xm.to(xm_ptr.dtype.element_ty), mask=live)

    return ln_mul_add_kernel, rgm_kernel


def _launch_config(D: int) -> Tuple[int, int]:
    block = 1 << (D - 1).bit_length()
    return block, max(1, min(16, block // 256))


def _check_rows(name: str, x: torch.Tensor, out_dtype) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, S, D) tensor; got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtypes {x.dtype} -> {out_dtype} not in {_KERNEL_DTYPES}")
    if x.shape[-1] > _MAX_D:
        raise ValueError(f"{name}: D={x.shape[-1]} exceeds {_MAX_D}")


def _check_mod(name: str, m: torch.Tensor, x: torch.Tensor, per_token_ok: bool) -> None:
    B, S, D = x.shape
    shapes = ((B, 1, D), (B, S, D)) if per_token_ok else ((B, 1, D),)
    if (m.device != x.device or m.dtype != torch.float32 or not m.is_contiguous()
            or tuple(m.shape) not in shapes):
        raise ValueError(f"{name}: modulation operand must be contiguous fp32 in {shapes} on "
                         f"{x.device}; got {m.dtype} {tuple(m.shape)} on {m.device}")


def ln_mul_add(x, mul, add, eps: float, out_dtype, fold: bool, rms: bool = False):
    """K5. ``mul``/``add``: fp32 (B, 1, D) or (B, S, D)."""
    if x.device.type == "cpu":
        return _native_ln_mul_add(x, mul, add, eps, out_dtype, fold, rms)
    _check_rows("ln_mul_add", x, out_dtype)
    _check_mod("ln_mul_add", mul, x, True)
    _check_mod("ln_mul_add", add, x, True)
    if mul.shape != add.shape:
        raise ValueError(f"ln_mul_add: mul {tuple(mul.shape)} and add {tuple(add.shape)} differ")
    B, S, D = x.shape
    out = torch.empty((B, S, D), dtype=out_dtype, device=x.device)
    if x.numel():
        kernel, _ = _triton_kernels()
        block, warps = _launch_config(D)
        per_token = mul.shape[1] != 1
        with torch.cuda.device(x.device):
            kernel[(B * S,)](x, mul, add, out, S, D, mul.shape[1] * D, D if per_token else 0,
                             float(eps), FOLD=bool(fold), RMS=bool(rms), BLOCK_D=block,
                             num_warps=warps)
        ln_mul_add.launches += 1
    return out


ln_mul_add.launches = 0


def residual_gate_modulate_rows(x, branch, gate, mul, add, eps: float, out_dtype):
    """K6. x/branch (B, S, D); gate (B, D) fp32; mul/add (B, 1, D) fp32."""
    if x.device.type == "cpu":
        return _native_residual_gate_modulate(x, branch, gate, mul, add, eps, out_dtype)
    name = "residual_gate_modulate"
    _check_rows(name, x, out_dtype)
    if branch.shape != x.shape or branch.dtype != x.dtype or not branch.is_contiguous():
        raise ValueError(f"{name}: branch must match x's shape and dtype and be contiguous")
    B, S, D = x.shape
    if gate.dtype != torch.float32 or tuple(gate.shape) != (B, D) or not gate.is_contiguous():
        raise ValueError(f"{name}: gate must be contiguous fp32 ({B}, {D}); got "
                         f"{gate.dtype} {tuple(gate.shape)}")
    _check_mod(name, mul, x, False)
    _check_mod(name, add, x, False)
    x_new = torch.empty_like(x)
    x_mod = torch.empty((B, S, D), dtype=out_dtype, device=x.device)
    if x.numel():
        _, kernel = _triton_kernels()
        block, warps = _launch_config(D)
        with torch.cuda.device(x.device):
            kernel[(B * S,)](x, branch, gate, mul, add, x_new, x_mod, S, D, float(eps),
                             BF16=x.dtype == torch.bfloat16, BLOCK_D=block, num_warps=warps)
        residual_gate_modulate_rows.launches += 1
    return x_new, x_mod


residual_gate_modulate_rows.launches = 0


def adaln_modulate(x, shift, scale, eps: float = _DEFAULT_EPS, out_dtype=None):
    """``modulate(LayerNorm_noaffine_fp32(x), shift, scale)`` in one pass.

    shift/scale: (D,), (B, D), (B, 1, D) or per-token (B, S, D)."""
    B = x.shape[0]
    mul = 1.0 + _bcast(scale, B)
    add = _bcast(shift, B)
    return ln_mul_add(x, mul, add, eps, out_dtype or x.dtype, fold=False)


def fused_layernorm(x, weight, bias, eps: float = _DEFAULT_EPS, out_dtype=None):
    """Affine fp32 LayerNorm (flax ``nn.LayerNorm`` semantics), one pass."""
    B = x.shape[0]
    return ln_mul_add(x, _bcast(weight, B), _bcast(bias, B), eps, out_dtype or x.dtype, fold=True)


def rms_modulate(x, shift, scale, eps: float = _DEFAULT_EPS, out_dtype=None):
    """``modulate(RMSNorm_noaffine_fp32(x), shift, scale)`` in one pass."""
    B = x.shape[0]
    mul = 1.0 + _bcast(scale, B)
    add = _bcast(shift, B)
    return ln_mul_add(x, mul, add, eps, out_dtype or x.dtype, fold=False, rms=True)


def residual_gate_modulate(
    x: torch.Tensor,
    branch: torch.Tensor,
    gate: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    eps: float = _DEFAULT_EPS,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x_new = x + gate * branch; x_mod = modulate(LN_fp32(x_new), shift, scale)``.

    x/branch: (B, S, D); gate/shift/scale: (B, D) (AdaLN chunks)."""
    B = x.shape[0]
    mul = 1.0 + _bcast(scale, B)
    add = _bcast(shift, B)
    return residual_gate_modulate_rows(x, branch, gate.float().contiguous(), mul, add, eps,
                                       out_dtype or x.dtype)
