"""Attention ops: the fused qk-norm flash kernel (K1) and its plain version.

Port of ``flow_factory_tpu/ops/attention.py``. All shapes are (B, H, S, D).

* :func:`qknorm_flash_attention` is the wrapper of the CUDA C++ kernel in
  ``csrc/qknorm_flash_fwd.cu`` (it replaces the TPU kernels
  ``_flash_fwd_single_kernel_qkn``/``_flash_fwd_kernel_qkn``). On a CPU tensor
  it computes :func:`qknorm_attention_plain`; on a CUDA tensor it launches the
  kernel or raises — there is no fallback.
* :func:`qknorm_attention_plain` composes :func:`_rms_scale` with
  :func:`native_attention`, the JAX package's plain path
  (``attention.py:206-213`` and ``:70-84``).

Backends (``model.attn_backend``): ``auto``/``flash``/``splash`` take the
kernel on CUDA, ``native`` is the explicit plain path on any device,
``hybrid`` and ``ring`` are not ported yet and raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_KERNEL_HEAD_DIM = 64
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def native_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Reference einsum attention, fp32 softmax, output in q.dtype.

    Products of q.dtype values are exact in fp32, so upcasting before the
    matmul equals the JAX ``preferred_element_type=float32`` contraction."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _rms_scale(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMS-norm x scale: ``x32 * (rsqrt(mean(x^2) + eps) * g)``; ``g``
    broadcasts against the trailing (S, D) axes. Returns fp32."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return x32 * (torch.rsqrt(var + eps) * g.float())


def qknorm_attention_plain(q, k, v, gq, gk, scale: float, eps: float, return_lse: bool = False):
    """Plain version of K1: per-position RMS qk-norm, then native attention."""
    qn = _rms_scale(q, gq, eps).to(q.dtype)
    kn = _rms_scale(k, gk, eps).to(k.dtype)
    return native_attention(qn, kn, v, scale=scale, return_lse=return_lse)


def _check_kernel_inputs(q, k, v, gq, gk) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and gq.device == q.device and gk.device == q.device):
        raise ValueError("qknorm_flash_attention: q, k, v, gq, gk must be on one CUDA device")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"qknorm_flash_attention: q/k/v must share a dtype in "
                        f"{list(_KERNEL_DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"qknorm_flash_attention: expected q (B,H,Sq,D), k/v (B,H,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"qknorm_flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D != _KERNEL_HEAD_DIM:
        raise ValueError(f"qknorm_flash_attention: head dim {D}; the kernel takes {_KERNEL_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("qknorm_flash_attention: the head dim of q, k and v must be contiguous")
    for name, g, S in (("gq", gq, Sq), ("gk", gk, k.shape[2])):
        if g.dtype != torch.float32 or tuple(g.shape) != (S, D) or not g.is_contiguous():
            raise ValueError(f"qknorm_flash_attention: {name} must be a contiguous fp32 ({S}, {D}) "
                             f"map; got {g.dtype} {tuple(g.shape)}")
    # the bf16 variant moves 16-byte vectors (8 elements)
    if q.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("qknorm_flash_attention: bf16 q, k, v need 16-byte aligned pointers and "
                         "(B, H, S) strides")
    if any(g.data_ptr() % 16 for g in (gq, gk)):
        raise ValueError("qknorm_flash_attention: gq and gk need 16-byte aligned pointers")


def _launch_kernel(q, k, v, gq, gk, scale: float, eps: float):
    from .cuda_build import load

    lib = load("qknorm_flash_fwd")
    fn = lib.qknorm_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    # O is written head-interleaved, (B, S, H, D) in memory, so the output
    # projection reads it without a transpose copy; the view is (B, H, S, D)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), gq.data_ptr(), gk.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D, strides,
                 float(scale * _LOG2E), float(eps), _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        msg = lib.qknorm_flash_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"qknorm_flash_fwd launch failed: {msg(err).decode()} ({err})")
    return out, lse


def qknorm_flash_attention(q, k, v, gq, gk, scale: float, eps: float, return_lse: bool = False):
    """K1: flash attention with the q/k RMS-norm fused in.

    ``gq`` (Sq, D) / ``gk`` (Sk, D) are fp32 per-position scale maps. Returns O
    in q.dtype, and the natural-log lse (B, H, Sq) fp32 when asked. CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    ``qknorm_flash_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return qknorm_attention_plain(q, k, v, gq, gk, scale, eps, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"qknorm_flash_attention: unsupported device {q.device}")
    _check_kernel_inputs(q, k, v, gq, gk)
    out, lse = _launch_kernel(q, k, v, gq, gk, scale, eps)
    qknorm_flash_attention.launches += 1
    return (out, lse) if return_lse else out


qknorm_flash_attention.launches = 0


def qknorm_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gq: torch.Tensor,
    gk: torch.Tensor,
    scale: Optional[float] = None,
    eps: float = 1e-6,
    backend: str = "auto",
    return_lse: bool = False,
):
    """RMS qk-norm immediately followed by attention (no RoPE in between).

    ``gq``/``gk``: per-position (S, D) fp32 maps (piecewise-constant over the
    MMDiT joint sequence) or plain (D,) scales."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    gq = gq.float().expand(q.shape[2], q.shape[3]).contiguous()
    gk = gk.float().expand(k.shape[2], k.shape[3]).contiguous()
    if backend in ("auto", "flash", "splash"):
        return qknorm_flash_attention(q, k, v, gq, gk, float(scale), float(eps), return_lse)
    if backend == "native":
        return qknorm_attention_plain(q, k, v, gq, gk, float(scale), float(eps), return_lse)
    if backend in ("hybrid", "ring"):
        raise NotImplementedError(f"attention backend {backend!r} is not ported yet")
    raise ValueError(f"Unknown attention backend {backend!r}")


def dot_product_attention(q, k, v, scale: Optional[float] = None, mask=None, backend: str = "auto"):
    """Attention without a qk-norm. Only the plain path exists so far: the
    plain flash kernel (K3) is not ported, so a CUDA tensor on a flash-class
    backend raises instead of silently running the plain version."""
    if backend == "native" or (backend in ("auto", "flash", "splash") and q.device.type == "cpu"):
        return native_attention(q, k, v, scale=scale, mask=mask)
    if backend in ("auto", "flash", "splash", "hybrid", "ring"):
        raise NotImplementedError(
            f"attention backend {backend!r} on {q.device.type}: the plain flash kernel is not ported yet")
    raise ValueError(f"Unknown attention backend {backend!r}")


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int) -> int:
    """Matmul FLOPs of one attention forward (QK^T and PV)."""
    return 4 * B * H * Sq * Sk * D
