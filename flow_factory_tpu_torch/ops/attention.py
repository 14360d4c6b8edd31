"""Attention ops: the fused qk-norm flash kernel (K1), the plain flash
forward (K3), the flash backward kernels (K2a, K2b) and their plain versions.

Port of ``flow_factory_tpu/ops/attention.py``. All shapes are (B, H, S, D).

* :func:`qknorm_flash_attention` is the wrapper of the CUDA C++ kernel in
  ``csrc/qknorm_flash_fwd.cu`` (it replaces the TPU kernels
  ``_flash_fwd_single_kernel_qkn``/``_flash_fwd_kernel_qkn``). On a CPU tensor
  it computes :func:`qknorm_attention_plain`; on a CUDA tensor it launches the
  kernel through :class:`_QKNormFlash`, whose backward
  (:func:`qknorm_flash_backward`, the JAX package's ``_qknorm_flash_bwd``)
  recomputes the normalised q/k, runs K2a and K2b and chains the norm's VJP —
  there is no fallback.
* :func:`flash_bwd_dq` / :func:`flash_bwd_dkv` wrap the CUDA C++ kernels in
  ``csrc/flash_bwd.cu`` (the TPU kernels ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``); :func:`flash_backward` runs both, or
  :func:`flash_backward_plain` (the JAX ``_flash_backward`` step by step) on
  a CPU tensor.
* :func:`flash_attention` wraps the CUDA C++ kernel in ``csrc/flash_fwd.cu``
  (K3, the TPU kernels ``_flash_fwd_kernel``/``_flash_fwd_single_kernel``)
  through :class:`_Flash`, whose backward is
  :func:`flash_backward` as the JAX ``_flash_attention`` custom VJP's is. Its
  plain version :func:`flash_attention_plain` is the JAX ``_flash_forward``
  step by step; a CPU tensor takes it.
* :data:`KERNEL_ADMISSION` says which (dtype, head dim) pairs each kernel
  has a variant for (:func:`admitted`): bf16 at 64 (K1) or 64 and 128, fp32
  at 16, 64 and 128. Every wrapper reads it; any other pair raises on a
  CUDA tensor.
* :func:`qknorm_attention_plain` composes :func:`_rms_scale` with
  :func:`native_attention`, the JAX package's plain path
  (``attention.py:206-213`` and ``:70-84``).

Backends (``model.attn_backend``): :func:`attention_route` is the JAX
``dot_product_attention`` rule (``attention.py:955-975``) on the port.
``auto`` without a mask takes K3 on CUDA at head dim 256 or less and
:func:`native_attention` on the CPU (the JAX package's ``auto`` off the TPU)
or above head dim 256; ``auto`` with a mask is ``native`` on every device; ``flash``/``splash`` take K3 (its plain version
on a CPU tensor, what the JAX package's Pallas kernel computes in interpret
mode off the TPU) and raise on a mask on every device; ``native`` is the
plain path on any device; ``ring`` runs self-attention on the ring of the
mesh's tensor axis (``ring_attention.py``: every hop K3 forward, K2
backward) and anything else as ``flash`` does (JAX ``_ring_dispatch``, whose
fallback off the TPU is ``native``); ``hybrid`` (:func:`hybrid_attention`,
JAX ``attention.py:838-884``) runs :func:`native_attention` forward and
recomputes (O, lse) with K3 in its backward, which then runs K2a and K2b,
and runs as ``flash`` where the score tensor passes
:data:`NATIVE_SCORE_BYTES_LIMIT`; it raises on a mask on every device. The
qk-norm attention has no mask: its flash-class backends take K1 up to head
dim 256 (:func:`qknorm_fused`); above it, and under ``ring`` and ``hybrid``,
the RMS scale is composed with the backend's dispatch, as the JAX package
composes it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from .norms import grads_where_needed

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32_HEAD_DIMS = (16, 64, 128)
#: the (dtype, head dim) pairs each attention kernel has a variant for: bf16
#: on the tensor cores at the head dims of the bf16 models (SD3.5's 64 for
#: K1; 64 and 128 for K3 and K2), fp32 on the CUDA cores at the head dims of
#: the JAX presets (16 at every tiny preset, 64, 128). The Pallas kernels take
#: the input dtype at any head dim up to 256 (JAX ``_flash_forward`` :268,
#: ``_flash_backward`` :708); any pair not here raises on a CUDA tensor.
KERNEL_ADMISSION = {
    "K1": {torch.bfloat16: (64,), torch.float32: _F32_HEAD_DIMS},
    "K3": {torch.bfloat16: (64, 128), torch.float32: _F32_HEAD_DIMS},
    "K2a": {torch.bfloat16: (64, 128), torch.float32: _F32_HEAD_DIMS},
    "K2b": {torch.bfloat16: (64, 128), torch.float32: _F32_HEAD_DIMS},
}


def admitted(kernel: str, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether ``kernel`` (a key of :data:`KERNEL_ADMISSION`) has a variant
    for ``dtype`` at ``head_dim``."""
    return head_dim in KERNEL_ADMISSION[kernel].get(dtype, ())


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


def _check_heads(name: str, kernel: str, q, k, v, *q_like) -> None:
    """Checks shared by K1, K2 and K3: q (B, H, Sq, D), k/v (B, H, Sk, D) and
    any ``q_like`` (O, dO) tensors of q's shape, on one CUDA device in one
    dtype and at a head dim that ``kernel`` admits (:data:`KERNEL_ADMISSION`),
    the head dim contiguous; the bf16 variants move 16-byte vectors, so their
    pointers and (B, H, S) strides must keep 16-byte alignment."""
    heads = (q, k, v, *q_like)
    dtypes = list(KERNEL_ADMISSION[kernel])
    if not (q.is_cuda and all(t.device == q.device for t in heads)):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if q.dtype not in dtypes or any(t.dtype != q.dtype for t in heads):
        raise TypeError(f"{name}: operands must share a dtype in {list(dtypes)}; "
                        f"got {[t.dtype for t in heads]}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (B,H,Sq,D), k/v (B,H,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D or any(t.shape != q.shape for t in q_like):
        raise ValueError(f"{name}: shapes disagree: {[tuple(t.shape) for t in heads]}")
    if not admitted(kernel, q.dtype, D):
        raise ValueError(f"{name}: head dim {D} in {q.dtype}; the kernel takes "
                         f"{list(KERNEL_ADMISSION[kernel][q.dtype])}")
    if any(t.stride(-1) != 1 for t in heads):
        raise ValueError(f"{name}: the head dim of every operand must be contiguous")
    if q.dtype == torch.bfloat16 and not all(_vector_aligned(t) for t in heads):
        raise ValueError(f"{name}: bf16 operands need 16-byte aligned pointers and (B, H, S) strides")


def _vector_aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _check_kernel_inputs(q, k, v, gq, gk) -> None:
    _check_heads("qknorm_flash_attention", "K1", q, k, v)
    Sq, D = q.shape[2], q.shape[3]
    for name, g, S in (("gq", gq, Sq), ("gk", gk, k.shape[2])):
        if (g.device != q.device or g.dtype != torch.float32 or tuple(g.shape) != (S, D)
                or not g.is_contiguous()):
            raise ValueError(f"qknorm_flash_attention: {name} must be a contiguous fp32 ({S}, {D}) "
                             f"map on {q.device}; got {g.dtype} {tuple(g.shape)} on {g.device}")
    if any(g.data_ptr() % 16 for g in (gq, gk)):
        raise ValueError("qknorm_flash_attention: gq and gk need 16-byte aligned pointers")


def _raise_on_error(lib, err: int, name: str, error_fn: str) -> None:
    if err != 0:
        msg = getattr(lib, error_fn)
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: {msg(err).decode()} ({err})")


def _head_interleaved(B: int, H: int, S: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) view of (B, S, H, D) memory: what the head merge
    (and the head split's backward) reads without a transpose copy."""
    return torch.empty((B, S, H, D), dtype=like.dtype, device=like.device).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _c_function(lib: str, name: str, argtypes: tuple):
    """``name`` of the library built from ``csrc/<lib>.cu``, its types set
    once: a wrapper call then pays only for the call."""
    from .cuda_build import load

    fn = getattr(load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype``, as the JAX launchers' ``q * (scale * _LOG2E)``
    rounds the weakly typed constant to q's dtype."""
    return float(torch.tensor(x, dtype=dtype))


_PTR, _INT, _FLOAT, _I64S = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)
_K1_ARGS = (_PTR,) * 7 + (_INT,) * 5 + (_I64S, _I64S, _PTR, _FLOAT, _FLOAT, _INT, _PTR)
_K3_ARGS = (_PTR,) * 5 + (_INT,) * 5 + (_I64S, _I64S, _FLOAT, _INT, _PTR)


def _launch_kernel(q, k, v, gq, gk, scale: float, eps: float):
    fn = _c_function("qknorm_flash_fwd", "qknorm_flash_fwd", _K1_ARGS)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    # O is written head-interleaved, (B, S, H, D) in memory, so the output
    # projection reads it without a transpose copy; the view is (B, H, S, D)
    out = _head_interleaved(B, H, Sq, D, q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # bf16: the kernel's pre-pass writes the normalised keys to kn, which its
    # wgmma kernel reads by TMA; the fp32 variant reads k itself
    kn = torch.empty((B, H, Sk, D), dtype=q.dtype, device=q.device) if q.dtype == torch.bfloat16 else None
    strides = _strides4(q, k, v, out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), gq.data_ptr(), gk.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D, strides,
                 None if kn is None else _fwd_tma_args(q, kn, v), None if kn is None else kn.data_ptr(),
                 float(scale * _LOG2E), float(eps), _KERNEL_DTYPES[q.dtype], stream)
    if err:
        from .cuda_build import load

        _raise_on_error(load("qknorm_flash_fwd"), err, "qknorm_flash_fwd", "qknorm_flash_error_string")
    return out, lse


def qknorm_flash_backward(q, k, v, gq, gk, out, lse, dout, scale: float, eps: float, needs):
    """The backward of K1 (JAX ``_qknorm_flash_bwd``, ``attention.py:540-550``):
    recompute the normalised q and k with the plain norm, run K2a and K2b on
    them (their plain versions on a CPU tensor), and chain the norm's VJP.
    ``needs`` flags which of (q, k, v, gq, gk) want a gradient; returns
    (dq, dk, dv, dgq, dgk) with None for the rest."""
    need_q, need_k, need_v, need_gq, need_gk = needs
    with torch.enable_grad():
        qd, gqd = q.detach().requires_grad_(need_q), gq.detach().requires_grad_(need_gq)
        kd, gkd = k.detach().requires_grad_(need_k), gk.detach().requires_grad_(need_gk)
        qn = _rms_scale(qd, gqd, eps).to(q.dtype)
        kn = _rms_scale(kd, gkd, eps).to(k.dtype)
    if not (dout.stride(-1) == 1 and (dout.dtype != torch.bfloat16 or _vector_aligned(dout))):
        dout = dout.contiguous()  # the kernels read dO in place when its layout allows
    dqn, dkn, dv = flash_backward(qn.detach(), kn.detach(), v, out, lse, dout, scale)
    dq, dgq = grads_where_needed(qn, (qd, gqd), (need_q, need_gq), dqn)
    dk, dgk = grads_where_needed(kn, (kd, gkd), (need_k, need_gk), dkn)
    return dq, dk, dv if need_v else None, dgq, dgk


class _QKNormFlash(torch.autograd.Function):
    """K1 with the JAX package's custom VJP: the forward launches K1 and keeps
    q, k, v, the scale maps, O and the natural-log lse; the backward is
    :func:`qknorm_flash_backward`. lse is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, gq, gk, scale: float, eps: float):
        out, lse = _launch_kernel(q, k, v, gq, gk, scale, eps)
        qknorm_flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, gq, gk, out, lse)
        ctx.scale, ctx.eps = scale, eps
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        return (*qknorm_flash_backward(*ctx.saved_tensors, dout, ctx.scale, ctx.eps,
                                       ctx.needs_input_grad[:5]), None, None)


def qknorm_flash_attention(q, k, v, gq, gk, scale: float, eps: float, return_lse: bool = False):
    """K1: flash attention with the q/k RMS-norm fused in.

    ``gq`` (Sq, D) / ``gk`` (Sk, D) are fp32 per-position scale maps. Returns O
    in q.dtype, and the natural-log lse (B, H, Sq) fp32 when asked. CPU tensors
    take the plain version (autograd differentiates it); CUDA tensors launch
    the kernel (counted in ``qknorm_flash_attention.launches``) through
    :class:`_QKNormFlash`, so gradients run K2a and K2b, or raise."""
    if q.device.type == "cpu":
        return qknorm_attention_plain(q, k, v, gq, gk, scale, eps, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"qknorm_flash_attention: unsupported device {q.device}")
    _check_kernel_inputs(q, k, v, gq, gk)
    out, lse = _QKNormFlash.apply(q, k, v, gq, gk, float(scale), float(eps))
    return (out, lse) if return_lse else out


qknorm_flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Flash backward: K2a (dq) and K2b (dk, dv)
# ---------------------------------------------------------------------------

def _bwd_prologue(q, out, lse, dout):
    """dO in q's dtype, Δ = rowsum(dO∘O) in fp32 and the base-2 lse
    (JAX ``_flash_backward``, ``attention.py:711-717``). O is promoted to fp32
    inside the product, so no fp32 copy of it is made: the same products and
    sums, one pass over memory fewer."""
    dout = dout.to(q.dtype)
    delta = torch.sum(dout.float() * out, dim=-1)
    return dout, delta, (lse * _LOG2E).contiguous()


def _prescaled_q(q, scale: float):
    """q·(scale·log2e) in q's dtype, the constant rounded to q's dtype first —
    the JAX launcher multiplies by a weakly typed Python float (:716)."""
    return q * torch.tensor(scale * _LOG2E, dtype=q.dtype, device=q.device)


def _bwd_probs_and_ds(qs, k, v, dout, lse2, delta):
    """p = exp2(min(s − lse2, 0)) and ds = p∘(dO vᵀ − Δ), both fp32."""
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(s - lse2[..., None], max=0.0))
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, dout, lse2, delta, scale: float):
    """Plain version of K2a (JAX ``_flash_bwd_dq_kernel``): dq = scale·Σ ds·k
    with ds rounded to k's dtype, fp32 accumulation, in q's dtype."""
    _, ds = _bwd_probs_and_ds(_prescaled_q(q, scale), k, v, dout, lse2, delta)
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse2, delta, scale: float):
    """Plain version of K2b (JAX ``_flash_bwd_dkv_kernel``): dk = ln2·Σ dsᵀq̃
    with ds rounded to q's dtype, dv = Σ pᵀdO with p rounded to dO's dtype."""
    qs = _prescaled_q(q, scale)
    p, ds = _bwd_probs_and_ds(qs, k, v, dout, lse2, delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qs.float()) * _LN2
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, out, lse, dout, scale: float):
    """Plain version of K2a + K2b: the JAX ``_flash_backward`` (:708-785) step
    by step. ``lse`` is the forward's natural-log lse; returns (dq, dk, dv)."""
    dout, delta, lse2 = _bwd_prologue(q, out, lse, dout)
    return (flash_bwd_dq_plain(q, k, v, dout, lse2, delta, scale),
            *flash_bwd_dkv_plain(q, k, v, dout, lse2, delta, scale))


def _check_bwd_inputs(name, kernel, q, k, v, dout, lse2, delta) -> None:
    _check_heads(name, kernel, q, k, v, dout)
    B, H, Sq, _ = q.shape
    for what, t in (("lse2", lse2), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous fp32 ({B}, {H}, {Sq}) on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


#: CUtensorMapDataType of the element types the TMA path takes
_TMA_DTYPES = {torch.bfloat16: 9}  # CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
_TMA_BOX_ROWS = 64  # the rows of one streamed or resident tile of K2a/K2b
#: K2a/K2b's box at both head dims: 64 columns (one 128-byte swizzle line) by
#: 64 rows, so a 128-wide head arrives as two boxes a tile (``csrc/flash_bwd.cu``)
_BWD_TMA_BOX = (64, _TMA_BOX_ROWS)
#: the boxes (columns, rows) of the forward kernels' maps, by head dim: q's
#: and k/v's, a 64-column (128-byte, one swizzle line) half of a q tile of
#: 128 rows or of a key tile, 128 keys at head dim 64 and 64 at 128
#: (``csrc/flash_fwd_wgmma.cuh``); head dim 128 takes two halves a tile
_FWD_TMA_BOXES = {64: ((64, 128), (64, 128)), 128: ((64, 128), (64, 64))}


def tma_geometry(t: torch.Tensor, box: Optional[Tuple[int, int]] = None) -> Tuple[int, ...]:
    """The TMA geometry of a (B, H, S, D) view, as the 4-D tensor maps of
    ``csrc/hopper.cuh`` take it: the global dims innermost first (D, S, H,
    B), the byte strides of S, H and B, the box (cols, rows, 1, 1) and the
    CUtensorMapDataType — 12 integers. ``box`` is (cols, rows), by default
    (D, 64), K2a/K2b's tiles; cols must divide D and span at most 128 bytes
    (the 128-byte swizzle), so a 128-wide head arrives as two 64-column
    boxes. The view is read in place, whatever the order of its strides; TMA
    needs every byte stride to be a multiple of 16, so another stride
    raises."""
    stride = t.stride()
    if t.ndim != 4 or stride[3] != 1 or t.dtype not in _TMA_DTYPES:
        raise ValueError(f"tma_geometry: expected a (B, H, S, D) view with a contiguous head dim in "
                         f"{list(_TMA_DTYPES)}; got {t.dtype} {tuple(t.shape)} strides {stride}")
    B, H, S, D = tuple(t.shape)  # unpacking the torch.Size itself is several times slower
    es = t.element_size()
    cols, rows = (D, _TMA_BOX_ROWS) if box is None else box
    if D % cols or cols * es > 128 or not 0 < rows <= 256:
        raise ValueError(f"tma_geometry: box {cols} x {rows} does not tile head dim {D} in 128-byte lines "
                         f"of at most 256 rows")
    strides = (stride[2] * es, stride[1] * es, stride[0] * es)
    if strides[0] % 16 or strides[1] % 16 or strides[2] % 16:
        raise ValueError(f"tma_geometry: byte strides (S, H, B) {strides} must be multiples of 16")
    return (D, S, H, B) + strides + (cols, rows, 1, 1, _TMA_DTYPES[t.dtype])


_I64X12, _I64X36 = ctypes.c_longlong * 12, ctypes.c_longlong * 36


def _strides4(q, k, v, out):
    """The (b, h, s) element strides of q, k, v and O, as the forward kernels
    take them."""
    return _I64X12(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3] + out.stride()[:3]))


def _fwd_tma_args(q, k, v):
    """The 3 x 12 geometry values of q, k and v for the bf16 forward kernels
    (K1, K3)."""
    q_box, kv_box = _FWD_TMA_BOXES[q.shape[-1]]
    return _I64X36(*(tma_geometry(q, q_box) + tma_geometry(k, kv_box) + tma_geometry(v, kv_box)))


def _tma_args(q, k, v, dout):
    """The 4 x 12 geometry values of q, k, v and dO for the bf16 kernels
    (head dim 64 or 128), each a map of 64 x 64 boxes; None (a null pointer)
    for the fp32 variant."""
    if q.dtype != torch.bfloat16:
        return None
    return (ctypes.c_longlong * 48)(*(g for t in (q, k, v, dout) for g in tma_geometry(t, _BWD_TMA_BOX)))


def _bwd_kernel_args(q, k, v, dout, lse2, delta):
    B, H, Sq, D = q.shape
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse2.data_ptr(),
            delta.data_ptr()], [B, H, Sq, k.shape[2], D]


def flash_bwd_dq(q, k, v, dout, lse2, delta, scale: float):
    """K2a: dq (B, H, Sq, D) in q's dtype, head-interleaved in memory.

    ``lse2`` is the forward's lse times log2(e) and ``delta`` = rowsum(dO∘O),
    both fp32 (B, H, Sq) contiguous; q is pre-scaled inside the kernel. bf16
    (head dim 64 or 128) takes a wgmma kernel, whose operands arrive by TMA
    from the maps :func:`tma_geometry` describes; fp32 (head dim 16, 64 or
    128) an FMA kernel. CPU tensors take
    :func:`flash_bwd_dq_plain`; CUDA tensors launch the kernel (counted in
    ``flash_bwd_dq.launches``) or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse2, delta, scale)
    _check_bwd_inputs("flash_bwd_dq", "K2a", q, k, v, dout, lse2, delta)
    from .cuda_build import load

    lib = load("flash_bwd")
    fn = lib.flash_bwd_dq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    B, H, Sq, D = q.shape
    dq = _head_interleaved(B, H, Sq, D, q)
    ptrs, dims = _bwd_kernel_args(q, k, v, dout, lse2, delta)
    strides = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, dout, dq) for s in t.stride()[:3]))
    qmul = _rounded(scale * _LOG2E, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, dq.data_ptr(), *dims, strides, _tma_args(q, k, v, dout), qmul, float(scale),
                 _KERNEL_DTYPES[q.dtype], stream)
    _raise_on_error(lib, err, "flash_bwd_dq", "flash_bwd_error_string")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse2, delta, scale: float):
    """K2b: (dk, dv) (B, H, Sk, D) in k's / v's dtype, head-interleaved in
    memory. Arguments as :func:`flash_bwd_dq`. CPU tensors take
    :func:`flash_bwd_dkv_plain`; CUDA tensors launch the kernel (counted in
    ``flash_bwd_dkv.launches``) or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse2, delta, scale)
    _check_bwd_inputs("flash_bwd_dkv", "K2b", q, k, v, dout, lse2, delta)
    from .cuda_build import load

    lib = load("flash_bwd")
    fn = lib.flash_bwd_dkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    B, H, Sk, D = k.shape
    dk, dv = _head_interleaved(B, H, Sk, D, k), _head_interleaved(B, H, Sk, D, v)
    ptrs, dims = _bwd_kernel_args(q, k, v, dout, lse2, delta)
    strides = (ctypes.c_longlong * 18)(*(s for t in (q, k, v, dout, dk, dv) for s in t.stride()[:3]))
    qmul = _rounded(scale * _LOG2E, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, strides, _tma_args(q, k, v, dout), qmul,
                 _KERNEL_DTYPES[q.dtype], stream)
    _raise_on_error(lib, err, "flash_bwd_dkv", "flash_bwd_error_string")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, out, lse, dout, scale: float):
    """Flash-attention backward, (dq, dk, dv), from the forward's O and
    natural-log lse: the prologue (Δ, base-2 lse) in PyTorch as the JAX package
    leaves it to XLA, then K2a and K2b — or their plain versions on a CPU
    tensor."""
    dout, delta, lse2 = _bwd_prologue(q, out, lse, dout)
    dq = flash_bwd_dq(q, k, v, dout, lse2, delta, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse2, delta, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# K3: the plain flash forward
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, scale: Optional[float] = None, return_lse: bool = False):
    """Plain version of K3: the JAX ``_flash_forward`` (:268-341) step by
    step — q pre-scaled by scale·log2e in q's dtype (:279), base-2 logits in
    fp32, exp2 against the row max, p rounded to v's dtype before PV with
    fp32 accumulation, O = acc / l in q's dtype, natural-log lse = m·ln2 +
    ln l. The card holds the kernel against it; :func:`dot_product_attention`
    runs it for ``flash``/``splash`` on a CPU tensor, as the JAX package runs
    its Pallas kernel in interpret mode off the TPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(_prescaled_q(q, scale).float(), k.float().transpose(-1, -2))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    if return_lse:
        return out, (m * _LN2 + torch.log(l))[..., 0]
    return out


def _launch_flash(q, k, v, scale: float):
    fn = _c_function("flash_fwd", "flash_fwd", _K3_ARGS)
    B, H, Sq, D = q.shape
    out = _head_interleaved(B, H, Sq, D, q)  # the head merge reads it without a copy
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides4(q, k, v, out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tma = _fwd_tma_args(q, k, v) if q.dtype == torch.bfloat16 else None  # fp32 reads through its strides
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B, H, Sq, k.shape[2], D, strides, tma, _rounded(scale * _LOG2E, q.dtype),
                 _KERNEL_DTYPES[q.dtype], stream)
    if err:
        from .cuda_build import load

        _raise_on_error(load("flash_fwd"), err, "flash_fwd", "flash_fwd_error_string")
    return out, lse


def flash_forward(q, k, v, scale: float):
    """K3 without autograd: (O, natural-log lse) of one launch, counted in
    ``flash_attention.launches`` — what ring attention runs a hop; a CPU
    tensor takes :func:`flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, return_lse=True)
    _check_heads("flash_attention", "K3", q, k, v)
    out, lse = _launch_flash(q, k, v, scale)
    flash_attention.launches += 1
    return out, lse


class _Flash(torch.autograd.Function):
    """K3 with the JAX ``_flash_attention`` custom VJP (:788-804): the forward
    launches K3 and keeps q, k, v, O and the natural-log lse; the backward is
    :func:`flash_backward` (K2a/K2b at K3's dtype and head dim)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = _launch_flash(q, k, v, scale)
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if not (dout.stride(-1) == 1 and _vector_aligned(dout)):
            dout = dout.contiguous()  # the kernels read dO in place when its layout allows
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None, return_lse: bool = False):
    """K3: non-causal flash attention. q (B, H, Sq, D), k/v (B, H, Sk, D) in
    bf16 at D 64 or 128, or in fp32 at D 16, 64 or 128
    (:data:`KERNEL_ADMISSION`); returns O in q's dtype (head-interleaved in
    memory) and, when asked, the natural-log lse (B, H, Sq) fp32. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel (counted in
    ``flash_attention.launches``) through :class:`_Flash`, or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_heads("flash_attention", "K3", q, k, v)
    out, lse = _Flash.apply(q, k, v, float(scale))
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Hybrid: the plain forward, K3's recompute and K2 in the backward
# ---------------------------------------------------------------------------

#: score-tensor bytes (B·H·Sq·Sk x q's item size) above which ``hybrid`` runs
#: as ``flash``: the plain forward would hold the whole score tensor (JAX
#: ``XLA_SCORE_BYTES_LIMIT``, ``attention.py:844``)
NATIVE_SCORE_BYTES_LIMIT = 8 * 1024 ** 3


def score_bytes(q: torch.Tensor, k: torch.Tensor) -> int:
    """B·H·Sq·Sk x q's item size: the bytes of one score tensor in q's dtype."""
    B, H, Sq, _ = q.shape
    return B * H * Sq * k.shape[2] * q.element_size()


class _Hybrid(torch.autograd.Function):
    """The JAX ``_hybrid_attention`` custom VJP (:853-864): the forward is
    :func:`native_attention` (what XLA's fused attention computes outside
    any Pallas kernel) and keeps q, k and v alone, no score tensor; the
    backward recomputes (O, natural-log lse) with K3 (:func:`flash_forward`)
    and runs :func:`flash_backward` on them, Δ from K3's O. On a CPU tensor
    both are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return native_attention(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        out, lse = flash_forward(q, k, v, ctx.scale)
        if q.is_cuda and not (dout.stride(-1) == 1 and _vector_aligned(dout)):
            dout = dout.contiguous()  # the kernels read dO in place when its layout allows
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def hybrid_attention(q, k, v, scale: Optional[float] = None):
    """The ``hybrid`` backend (JAX ``hybrid_attention``, :867-884): the
    plain forward, K3 and K2 in the backward, through :class:`_Hybrid`;
    above :data:`NATIVE_SCORE_BYTES_LIMIT` of scores, :func:`flash_attention`.
    On a CUDA tensor it takes what K3 and K2 take (:data:`KERNEL_ADMISSION`)
    and raises on anything else."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if score_bytes(q, k) > NATIVE_SCORE_BYTES_LIMIT:
        return flash_attention(q, k, v, scale=scale)
    if q.device.type == "cuda":
        _check_heads("hybrid_attention", "K3", q, k, v)
    elif q.device.type != "cpu":
        raise ValueError(f"hybrid_attention: unsupported device {q.device}")
    return _Hybrid.apply(q, k, v, float(scale))


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
    MMDiT joint sequence) or plain (D,) scales. Where :func:`qknorm_fused`
    holds it runs K1; elsewhere the RMS scale is composed with the backend's
    dispatch (JAX :590-594): above head dim 256 ``auto`` is then native
    attention, as in JAX, and ``flash`` K3."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    gq = gq.float().expand(q.shape[2], q.shape[3]).contiguous()
    gk = gk.float().expand(k.shape[2], k.shape[3]).contiguous()
    if qknorm_fused(backend, q.shape[-1]):
        return qknorm_flash_attention(q, k, v, gq, gk, float(scale), float(eps), return_lse)
    if backend == "native":
        return qknorm_attention_plain(q, k, v, gq, gk, float(scale), float(eps), return_lse)
    if backend not in ("auto", "flash", "splash", "ring", "hybrid"):
        raise ValueError(f"Unknown attention backend {backend!r}")
    if return_lse and backend in ("ring", "hybrid"):
        raise NotImplementedError(f"attention backend {backend!r} with its lse is not ported yet")
    qn = _rms_scale(q, gq, eps).to(q.dtype)
    kn = _rms_scale(k, gk, eps).to(k.dtype)
    if not return_lse:
        return dot_product_attention(qn, kn, v, scale=float(scale), backend=backend)
    if attention_route(backend, False, q.device.type, q.shape[-1]) == "native":
        return native_attention(qn, kn, v, scale=float(scale), return_lse=True)
    return flash_attention(qn, kn, v, scale=float(scale), return_lse=True)


def qknorm_fused(backend: str, head_dim: int) -> bool:
    """Whether :func:`qknorm_dot_product_attention` runs K1: a flash-class
    backend at head dim 256 or less (JAX ``fused_qknorm_eligible``,
    ``attention.py:556-561``). JAX also asks for the TPU; here the device is
    K1's wrapper's to read: on a CPU tensor it runs its plain version, which
    is the composition itself (the RMS scale, then native attention)."""
    return backend in ("auto", "flash", "splash") and head_dim <= 256


def attention_route(backend: str, masked: bool, device_type: str, head_dim: int, scores: int = 0) -> str:
    """What :func:`dot_product_attention` runs for ``backend``, a mask or
    none, on a tensor of ``device_type`` with ``head_dim`` and ``scores``
    bytes of score tensor (:func:`score_bytes`): ``"native"``
    (:func:`native_attention`), ``"flash"`` (:func:`flash_attention`: K3 on
    CUDA, its plain version on the CPU), ``"hybrid"`` (:func:`hybrid_attention`)
    or ``"ring"`` (:func:`_ring_dispatch`), or the error the call raises. The
    JAX rule (``attention.py:955-975``) with CUDA in the TPU's place:
    ``auto`` is ``flash`` on the accelerator without a mask at head dim 256
    or less and ``native`` otherwise (on every device with a mask);
    ``splash`` is ``flash``; ``hybrid`` is ``flash`` above
    :data:`NATIVE_SCORE_BYTES_LIMIT` of scores (:880-883); ``flash``,
    ``hybrid`` and ``ring`` with a mask raise on every device."""
    if backend == "native":
        return "native"
    if backend == "auto":
        return "native" if masked or device_type == "cpu" or head_dim > 256 else "flash"
    if backend in ("flash", "splash", "hybrid", "ring"):
        name = "flash" if backend == "splash" else backend
        if masked:
            raise NotImplementedError(f"{name} backend does not take a dense mask; use 'native'")
        if name == "hybrid" and scores > NATIVE_SCORE_BYTES_LIMIT:
            return "flash"
        return name
    raise ValueError(f"Unknown attention backend {backend!r}")


#: installed by the adapter when ``attn_backend: ring`` runs under a mesh: the
#: process group of the mesh's ``tensor`` axis, the ring's sequence axis
_RING_CONTEXT: dict = {"group": None, "size": 1}


def set_ring_context(group, size: int) -> None:
    """The ring's process group and its size (JAX ``set_ring_context``); a
    size of 1 or no group removes it."""
    _RING_CONTEXT["group"] = group if size > 1 else None
    _RING_CONTEXT["size"] = size if group is not None else 1


def _ring_dispatch(q, k, v, scale):
    """JAX ``_ring_dispatch`` (:916-939): self-attention whose sequence the
    ring's size divides rides the ring (``ops/ring_attention.py``); anything
    else, or no ring, runs what ``flash`` runs — K3 on CUDA, its plain
    version on the CPU."""
    n, group = _RING_CONTEXT["size"], _RING_CONTEXT["group"]
    if group is None or n <= 1 or q.shape[2] % n or k.shape[2] % n or q.shape[2] != k.shape[2]:
        return flash_attention(q, k, v, scale=scale)
    from .ring_attention import ring_self_attention

    return ring_self_attention(q, k, v, group, scale)


def dot_product_attention(q, k, v, scale: Optional[float] = None, mask=None, backend: str = "auto"):
    """Attention without a qk-norm (JAX ``dot_product_attention``, :942),
    routed by :func:`attention_route`. On a CUDA tensor K3 takes what
    :data:`KERNEL_ADMISSION` lists and raises on anything else: there is no
    silent native."""
    route = attention_route(backend, mask is not None, q.device.type, q.shape[-1], score_bytes(q, k))
    if route == "native":
        return native_attention(q, k, v, scale=scale, mask=mask)
    if route == "ring":
        return _ring_dispatch(q, k, v, scale)
    if route == "hybrid":
        return hybrid_attention(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int) -> int:
    """Matmul FLOPs of one attention forward (QK^T and PV)."""
    return 4 * B * H * Sq * Sk * D
