"""Norm-and-modulate ops: kernels K5 and K6 (Triton), their backward kernels,
and the plain versions of all four.

Port of ``flow_factory_tpu/ops/norms.py``.

* K5 :func:`ln_mul_add` replaces the TPU kernel ``_ln_mul_add_kernel``
  (``norms.py:93``): a no-affine LayerNorm (flax fast variance
  ``max(0, E[x^2] - E[x]^2)``, eps inside the rsqrt) or RMSNorm with fp32
  stats, then ``* mul + add``; ``fold`` gives the flax affine order. Its
  backward :func:`ln_mul_add_backward` is the counterpart of the JAX custom
  VJP ``_fused_ln_mul_add_bwd`` (``norms.py:158``).
* K6 :func:`residual_gate_modulate_rows` replaces ``_rgm_kernel``
  (``norms.py:300``): ``x_new = x + gate * branch`` and
  ``x_mod = LN_fp32(x_new) * mul + add``, emitting both. Its backward
  :func:`residual_gate_modulate_backward` is the counterpart of
  ``_rgm_fused_bwd`` (``norms.py:358``).

The JAX backwards are the VJP of the plain composition, which XLA fuses into
a few passes; eager PyTorch has no such fusion, so here each backward is a
hand-written kernel, held to a closed-form plain backward
(``_native_*_backward``) that writes the same VJP out in PyTorch ops.

What bounds them on an H100: each is one pass over (B, S, D) rows with row
reductions and elementwise work and no tensor-core product, a few FLOP per
byte against a ridge of ~295, so the bound is memory (3.35 TB/s). Design: a
program takes a chunk of rows of one sample, holds the sample's modulation
vectors (and K6's gate) in registers for all of them, and streams its rows
with the next row's loads in flight; each row is one register block of
``next_pow2(D)`` lanes. The number of rows a program takes follows from
B * S and each kernel's target count of programs (``_CONFIG``); the row's
reduction order follows from D alone (block and warps), so a row gives the
same bits whatever the batch (rollout under CFG against replay and
training). The backward kernels
recompute the row's fp32 stats (K6 also x_new, with the forward's roundings),
write dx (and K6's dbranch) rounded once, and sum the per-sample column
gradients (dmul, dadd, K6's dgate) in fp32 over the program's rows into
partials of shape (B, chunks, D), which a second small launch adds up in a
fixed order: no float atomics, so two launches give the same bits. All four
kernels compile without fma contraction, so each rounds where eager PyTorch
rounds; what differs from the plain versions is the order of the sums.

On a CPU tensor the wrappers compute the plain versions, through the same
autograd Functions as on the card (plain forward, plain backward); on a CUDA
tensor they launch the kernels (each counted in ``<wrapper>.launches``) or
raise. The TPU's ``FFT_FUSED_NORMS``/``FFT_RGM`` A/B switches are not ported:
on CUDA the kernels always run.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

_DEFAULT_EPS = 1e-6
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_D = 16384
#: per kernel: the lanes of a row that one warp takes, and the programs a
#: launch aims at over the B * S rows (multiples of an H100's 132 SMs), as a
#: sweep on the card chose them (``chip_smoke.py --norms . --sweep``)
_CONFIG = {"ln_mul_add": (512, 132 * 32), "ln_mul_add_bwd": (256, 132 * 8), "rgm": (256, 132 * 8),
           "rgm_bwd": (512, 132 * 32)}
#: at most this many programs where a backward writes partial column sums:
#: their bytes grow with the chunks
_SUM_PROGRAMS = 132 * 8
#: chunks of partial column sums a reduction program adds at once
_SUM_CHUNKS = 16


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


def _ln_stats(x32, eps, rms):
    """The plain forward's fp32 row stats: ``(r, x_hat, raw)``, ``raw`` the
    unclamped fast variance (None for RMS)."""
    if rms:
        r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
        return r, x32 * r, None
    mean = torch.mean(x32, dim=-1, keepdim=True)
    raw = torch.mean(x32 * x32, dim=-1, keepdim=True) - mean * mean
    r = torch.rsqrt(torch.clamp(raw, min=0.0) + eps)
    return r, (x32 - mean) * r, raw


def _ln_dx(g32, mul, r, xhat, raw):
    """fp32 input gradient of ``norm(x) * mul``: with g_hat = g * mul,
    ``r * (g_hat - mean(g_hat) - x_hat * mean(g_hat * x_hat))``; RMS (``raw``
    None) has no mean(g_hat) term. Where the fast variance was clamped
    (``raw < 0``) the x_hat term drops: torch.clamp passes the gradient at
    equality and stops it below (JAX's ``jnp.maximum`` halves it at a tie)."""
    gh = g32 * mul
    proj = torch.mean(gh * xhat, dim=-1, keepdim=True)
    if raw is None:
        return r * (gh - xhat * proj)
    proj = torch.where(raw >= 0, proj, torch.zeros_like(proj))
    return r * (gh - torch.mean(gh, dim=-1, keepdim=True) - xhat * proj)


def _native_ln_mul_add_backward(x, mul, g, eps, rms, needs):
    """The VJP of :func:`_native_ln_mul_add` in closed form: ``(dx, dmul,
    dadd)``, None where ``needs`` is unset. dx is rounded once to x's dtype;
    dmul = sum g * x_hat and dadd = sum g over the rows a modulation row
    covers (none for a per-token one). fold and no-fold share these terms."""
    x32, g32 = x.float(), g.float()
    r, xhat, raw = _ln_stats(x32, eps, rms)
    dx = _ln_dx(g32, mul, r, xhat, raw).to(x.dtype) if needs[0] else None
    dmul = (g32 * xhat).sum_to_size(mul.shape).to(mul.dtype) if needs[1] else None
    dadd = g32.sum_to_size(mul.shape) if needs[2] else None
    return dx, dmul, dadd


def _native_residual_gate_modulate_backward(x, branch, gate, mul, g_new, g_mod, eps, needs):
    """The VJP of :func:`_native_residual_gate_modulate` in closed form:
    ``(dx, dbranch, dgate, dmul, dadd)``, None where ``needs`` is unset. With
    the total x_new cotangent t = g_new + LN_bwd(g_mod) in fp32: dx = t,
    dbranch = t * gate (the gate rounded to x's dtype, as the forward rounds
    it), dgate = sum_s t * branch rounded once to x's dtype (its cotangent's
    dtype in the composition), dmul and dadd as in K5."""
    gate_c = gate[:, None, :].to(x.dtype)
    r, xhat, raw = _ln_stats((x + gate_c * branch).float(), eps, False)
    gm = g_mod.float()
    dx = dbranch = dgate = None
    if any(needs[:3]):
        t = g_new.float() + _ln_dx(gm, mul, r, xhat, raw)
        dx = t.to(x.dtype) if needs[0] else None
        dbranch = (t * gate_c.float()).to(x.dtype) if needs[1] else None
        dgate = (t * branch.float()).sum(1).to(x.dtype).to(gate.dtype) if needs[2] else None
    dmul = (gm * xhat).sum_to_size(mul.shape) if needs[3] else None
    dadd = gm.sum_to_size(mul.shape) if needs[4] else None
    return dx, dbranch, dgate, dmul, dadd


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    """Import Triton and define the kernels on first launch (never at module
    import: the CPU tests import this module without Triton)."""
    global triton, tl, round_bf16, round_as, row_stats  # jitted kernels resolve these as module globals
    import triton
    import triton.language as tl

    @triton.jit
    def round_bf16(v):
        """fp32 → the fp32 value of its round-to-nearest-even bf16, in integer
        ops the compiler can neither fold away nor fuse into an fma."""
        bits = v.to(tl.uint32, bitcast=True)
        bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
        return bits.to(tl.float32, bitcast=True)

    @triton.jit
    def round_as(v, like_ptr, BF16: tl.constexpr):
        """fp32 → the fp32 value of ``v`` rounded to ``like_ptr``'s element type."""
        if BF16:
            out = round_bf16(v)
        else:
            out = v.to(like_ptr.dtype.element_ty).to(tl.float32)
        return out

    @triton.jit
    def row_stats(x, inv_d, eps, RMS: tl.constexpr):
        """One fp32 row's ``(x - mean or x, r, raw fast variance)``, each op
        as the plain version does it (mean = sum * (1/D), as torch's)."""
        if RMS:
            xc = x
            raw = tl.sum(x * x, axis=0) * inv_d
            r = tl.rsqrt(raw + eps)
        else:
            mean = tl.sum(x, axis=0) * inv_d
            raw = tl.sum(x * x, axis=0) * inv_d - mean * mean
            r = tl.rsqrt(tl.maximum(raw, 0.0) + eps)
            xc = x - mean
        return xc, r, raw

    @triton.jit(do_not_specialize=["S", "rows"])
    def ln_mul_add_kernel(x_ptr, mul_ptr, add_ptr, out_ptr, S, D, rows, inv_d, eps,
                          FOLD: tl.constexpr, RMS: tl.constexpr, PER_TOKEN: tl.constexpr,
                          BLOCK_D: tl.constexpr):
        b = tl.program_id(1).to(tl.int64)
        s0 = tl.program_id(0) * rows
        n = tl.minimum(rows, S - s0)
        cols = tl.arange(0, BLOCK_D)
        live = cols < D
        row0 = (b * S + s0) * D
        if not PER_TOKEN:  # the sample's vectors, once for all its rows here
            mul = tl.load(mul_ptr + b * D + cols, mask=live, other=0.0)
            add = tl.load(add_ptr + b * D + cols, mask=live, other=0.0)
        x_next = tl.load(x_ptr + row0 + cols, mask=live, other=0.0)
        for i in range(n):
            off = row0 + i * D
            x = x_next.to(tl.float32)
            x_next = tl.load(x_ptr + off + D + cols, mask=live & (i + 1 < n), other=0.0)
            if PER_TOKEN:
                mul = tl.load(mul_ptr + off + cols, mask=live, other=0.0)
                add = tl.load(add_ptr + off + cols, mask=live, other=0.0)
            xc, r, raw = row_stats(x, inv_d, eps, RMS)
            if FOLD:
                out = xc * (r * mul) + add
            else:
                out = xc * r * mul + add
            tl.store(out_ptr + off + cols, out.to(out_ptr.dtype.element_ty), mask=live)

    @triton.jit(do_not_specialize=["S", "rows", "chunks"])
    def ln_mul_add_bwd_kernel(x_ptr, mul_ptr, g_ptr, dx_ptr, dmod_ptr, S, D, rows, chunks, plane, inv_d, eps,
                              RMS: tl.constexpr, PER_TOKEN: tl.constexpr, NEED_DX: tl.constexpr,
                              NEED_DMOD: tl.constexpr, BLOCK_D: tl.constexpr):
        chunk = tl.program_id(0)
        b = tl.program_id(1).to(tl.int64)
        s0 = chunk * rows
        n = tl.minimum(rows, S - s0)
        cols = tl.arange(0, BLOCK_D)
        live = cols < D
        row0 = (b * S + s0) * D
        if NEED_DX:
            if not PER_TOKEN:
                mul = tl.load(mul_ptr + b * D + cols, mask=live, other=0.0)
        acc_m = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_a = tl.zeros([BLOCK_D], dtype=tl.float32)
        x_next = tl.load(x_ptr + row0 + cols, mask=live, other=0.0)
        g_next = tl.load(g_ptr + row0 + cols, mask=live, other=0.0)
        for i in range(n):
            off = row0 + i * D
            x = x_next.to(tl.float32)
            g = g_next.to(tl.float32)
            more = live & (i + 1 < n)
            x_next = tl.load(x_ptr + off + D + cols, mask=more, other=0.0)
            g_next = tl.load(g_ptr + off + D + cols, mask=more, other=0.0)
            xc, r, raw = row_stats(x, inv_d, eps, RMS)
            xhat = xc * r
            if NEED_DX:
                if PER_TOKEN:
                    mul = tl.load(mul_ptr + off + cols, mask=live, other=0.0)
                gh = g * mul
                if RMS:
                    dx = r * (gh - xhat * (tl.sum(gh * xhat, axis=0) * inv_d))
                else:  # the clamp passes the gradient at 0 and stops it below
                    proj = tl.where(raw >= 0.0, tl.sum(gh * xhat, axis=0) * inv_d, 0.0)
                    dx = r * (gh - tl.sum(gh, axis=0) * inv_d - xhat * proj)
                tl.store(dx_ptr + off + cols, dx.to(dx_ptr.dtype.element_ty), mask=live)
            if NEED_DMOD:
                if PER_TOKEN:
                    tl.store(dmod_ptr + off + cols, g * xhat, mask=live)
                    tl.store(dmod_ptr + plane + off + cols, g, mask=live)
                else:
                    acc_m += g * xhat
                    acc_a += g
        if NEED_DMOD:
            if not PER_TOKEN:
                part = (b * chunks + chunk) * D
                tl.store(dmod_ptr + part + cols, acc_m, mask=live)
                tl.store(dmod_ptr + plane + part + cols, acc_a, mask=live)

    @triton.jit(do_not_specialize=["S", "rows"])
    def rgm_kernel(x_ptr, br_ptr, gate_ptr, mul_ptr, add_ptr, xn_ptr, xm_ptr, S, D, rows, inv_d, eps,
                   BF16: tl.constexpr, BLOCK_D: tl.constexpr):
        b = tl.program_id(1).to(tl.int64)
        s0 = tl.program_id(0) * rows
        n = tl.minimum(rows, S - s0)
        cols = tl.arange(0, BLOCK_D)
        live = cols < D
        row0 = (b * S + s0) * D
        # the gate rounded to x's dtype as eager rounds it, and the sample's
        # modulation vectors: once for all the program's rows
        gate = round_as(tl.load(gate_ptr + b * D + cols, mask=live, other=0.0), xn_ptr, BF16)
        mul = tl.load(mul_ptr + b * D + cols, mask=live, other=0.0)
        add = tl.load(add_ptr + b * D + cols, mask=live, other=0.0)
        x_next = tl.load(x_ptr + row0 + cols, mask=live, other=0.0)
        br_next = tl.load(br_ptr + row0 + cols, mask=live, other=0.0)
        for i in range(n):
            off = row0 + i * D
            x = x_next.to(tl.float32)
            br = br_next.to(tl.float32)
            more = live & (i + 1 < n)
            x_next = tl.load(x_ptr + off + D + cols, mask=more, other=0.0)
            br_next = tl.load(br_ptr + off + D + cols, mask=more, other=0.0)
            # round where eager PyTorch rounds: the product, then the sum
            xn = round_as(x + round_as(gate * br, xn_ptr, BF16), xn_ptr, BF16)
            tl.store(xn_ptr + off + cols, xn.to(xn_ptr.dtype.element_ty), mask=live)
            xc, r, raw = row_stats(xn, inv_d, eps, False)
            xm = xc * r * mul + add
            tl.store(xm_ptr + off + cols, xm.to(xm_ptr.dtype.element_ty), mask=live)

    @triton.jit(do_not_specialize=["S", "rows", "chunks"])
    def rgm_bwd_kernel(x_ptr, br_ptr, gate_ptr, mul_ptr, gn_ptr, gm_ptr, dx_ptr, dbr_ptr, part_ptr,
                       S, D, rows, chunks, plane, inv_d, eps, BF16: tl.constexpr, NEED_T: tl.constexpr,
                       NEED_DX: tl.constexpr, NEED_DBR: tl.constexpr, NEED_DGATE: tl.constexpr,
                       NEED_DMOD: tl.constexpr, BLOCK_D: tl.constexpr):
        chunk = tl.program_id(0)
        b = tl.program_id(1).to(tl.int64)
        s0 = chunk * rows
        n = tl.minimum(rows, S - s0)
        cols = tl.arange(0, BLOCK_D)
        live = cols < D
        row0 = (b * S + s0) * D
        gate = round_as(tl.load(gate_ptr + b * D + cols, mask=live, other=0.0), x_ptr, BF16)
        mul = tl.load(mul_ptr + b * D + cols, mask=live, other=0.0)
        acc_g = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_m = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_a = tl.zeros([BLOCK_D], dtype=tl.float32)
        x_next = tl.load(x_ptr + row0 + cols, mask=live, other=0.0)
        br_next = tl.load(br_ptr + row0 + cols, mask=live, other=0.0)
        gm_next = tl.load(gm_ptr + row0 + cols, mask=live, other=0.0)
        if NEED_T:
            gn_next = tl.load(gn_ptr + row0 + cols, mask=live, other=0.0)
        for i in range(n):
            off = row0 + i * D
            x = x_next.to(tl.float32)
            br = br_next.to(tl.float32)
            gm = gm_next.to(tl.float32)
            more = live & (i + 1 < n)
            x_next = tl.load(x_ptr + off + D + cols, mask=more, other=0.0)
            br_next = tl.load(br_ptr + off + D + cols, mask=more, other=0.0)
            gm_next = tl.load(gm_ptr + off + D + cols, mask=more, other=0.0)
            if NEED_T:
                gn = gn_next.to(tl.float32)
                gn_next = tl.load(gn_ptr + off + D + cols, mask=more, other=0.0)
            # x_new again, with the forward's roundings
            xn = round_as(x + round_as(gate * br, x_ptr, BF16), x_ptr, BF16)
            xc, r, raw = row_stats(xn, inv_d, eps, False)
            xhat = xc * r
            if NEED_T:
                gh = gm * mul
                proj = tl.where(raw >= 0.0, tl.sum(gh * xhat, axis=0) * inv_d, 0.0)
                t = gn + r * (gh - tl.sum(gh, axis=0) * inv_d - xhat * proj)
                if NEED_DX:
                    tl.store(dx_ptr + off + cols, t.to(dx_ptr.dtype.element_ty), mask=live)
                if NEED_DBR:
                    tl.store(dbr_ptr + off + cols, (t * gate).to(dbr_ptr.dtype.element_ty), mask=live)
                if NEED_DGATE:
                    acc_g += t * br
            if NEED_DMOD:
                acc_m += gm * xhat
                acc_a += gm
        part = (b * chunks + chunk) * D
        if NEED_DGATE:
            tl.store(part_ptr + part + cols, acc_g, mask=live)
        if NEED_DMOD:
            tl.store(part_ptr + plane + part + cols, acc_m, mask=live)
            tl.store(part_ptr + 2 * plane + part + cols, acc_a, mask=live)

    @triton.jit(do_not_specialize=["chunks"])
    def sum_chunks_kernel(part_ptr, out_ptr, like_ptr, B, chunks, D, ROUND_FIRST: tl.constexpr,
                          BF16: tl.constexpr, CHUNKS: tl.constexpr, BLOCK: tl.constexpr):
        """out[p, b] = the sum of part[p, b, c] over the chunks c, CHUNKS at a
        time in a fixed order; plane 0 rounded to ``like_ptr``'s type if
        ROUND_FIRST."""
        pb = tl.program_id(0).to(tl.int64)
        cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        live = cols < D
        base = pb * chunks * D
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for c0 in range(0, chunks, CHUNKS):
            c = c0 + tl.arange(0, CHUNKS)
            mask = (c < chunks)[:, None] & live[None, :]
            acc += tl.sum(tl.load(part_ptr + base + c[:, None] * D + cols[None, :], mask=mask, other=0.0),
                          axis=0)
        if ROUND_FIRST:
            acc = tl.where(pb < B, round_as(acc, like_ptr, BF16), acc)
        tl.store(out_ptr + pb * D + cols, acc, mask=live)

    return dict(ln_mul_add=ln_mul_add_kernel, ln_mul_add_bwd=ln_mul_add_bwd_kernel, rgm=rgm_kernel,
                rgm_bwd=rgm_bwd_kernel, sum_chunks=sum_chunks_kernel)


def _launch_config(kernel: str, B: int, S: int, D: int, sums: bool = False) -> Tuple[int, int, int, int]:
    """``(block, warps, rows, chunks)`` of a launch: a row's block and warps
    follow from D alone, and so does its reduction order; the rows a
    program takes follow from B * S (about the kernel's target count of
    programs, at most ``_SUM_PROGRAMS`` where it writes partial ``sums``),
    the chunks of a sample as even as they go."""
    lanes, programs = _CONFIG[kernel]
    programs = min(programs, _SUM_PROGRAMS) if sums else programs
    block = 1 << (D - 1).bit_length()
    rows = max(1, min(S, -(-B * S // programs)))
    chunks = -(-S // rows)
    return block, max(1, min(16, block // lanes)), -(-S // chunks), chunks


def _launch(kernel, grid, *args, **meta):
    with torch.cuda.device(args[0].device):
        kernel[grid](*args, enable_fp_fusion=False, **meta)


def _sum_chunks(part, planes: int, B: int, chunks: int, D: int, round_like=None):
    """(planes, B, D) fp32 sums over the chunks of ``part`` (planes, B,
    chunks, D); plane 0 rounded to ``round_like``'s dtype if given."""
    out = torch.empty((planes, B, D), dtype=torch.float32, device=part.device)
    block = 128
    _launch(_triton_kernels()["sum_chunks"], (planes * B, -(-D // block)), part, out,
            part if round_like is None else round_like, B, chunks, D,
            ROUND_FIRST=round_like is not None and round_like.dtype != torch.float32,
            BF16=round_like is not None and round_like.dtype == torch.bfloat16,
            CHUNKS=_SUM_CHUNKS, BLOCK=block, num_warps=4)
    return out


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


def _check_cotangent(name: str, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if g.shape != x.shape or g.device != x.device or g.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)} on {g.device} does not fit "
                         f"x {tuple(x.shape)} on {x.device}")
    return g.contiguous()


def grads_where_needed(outputs, inputs, needs, cotangents):
    """Gradients of ``outputs`` w.r.t. those ``inputs`` whose ``needs`` is set
    (None for the rest): the tail of the K1 Function's backward."""
    wanted = [x for x, need in zip(inputs, needs) if need]
    if not wanted:
        return (None,) * len(inputs)
    grads = iter(torch.autograd.grad(outputs, wanted, cotangents))
    return tuple(next(grads) if need else None for need in needs)


def _launch_ln_mul_add(x, mul, add, eps, out_dtype, fold, rms):
    B, S, D = x.shape
    out = torch.empty((B, S, D), dtype=out_dtype, device=x.device)
    if x.numel():
        block, warps, rows, chunks = _launch_config("ln_mul_add", B, S, D)
        _launch(_triton_kernels()["ln_mul_add"], (chunks, B), x, mul, add, out, S, D, rows, 1.0 / D, float(eps),
                FOLD=bool(fold), RMS=bool(rms), PER_TOKEN=mul.shape[1] != 1, BLOCK_D=block,
                num_warps=warps)
        ln_mul_add.launches += 1
    return out


def ln_mul_add_backward(x, mul, g, eps: float, rms: bool, needs: Sequence[bool]):
    """K5's backward: ``(dx, dmul, dadd)`` for the cotangent ``g`` of
    ``ln_mul_add(x, mul, add, eps, g.dtype, fold, rms)`` (fold or not), None
    where ``needs`` is unset. A CPU tensor takes the closed-form plain
    backward; a CUDA tensor launches the backward kernel (and, for a (B, 1, D)
    modulation, the chunk sum; one count in ``ln_mul_add_backward.launches``)
    or raises."""
    if x.device.type == "cpu":
        return _native_ln_mul_add_backward(x, mul, g, eps, rms, needs)
    name = "ln_mul_add_backward"
    _check_rows(name, x, x.dtype)
    _check_mod(name, mul, x, True)
    g = _check_cotangent(name, g, x)
    B, S, D = x.shape
    per_token = mul.shape[1] != 1
    need_dmod = bool(needs[1] or needs[2])
    dx = torch.empty_like(x) if needs[0] else None
    dmod = torch.zeros((2, B, S if per_token else 1, D), dtype=torch.float32, device=x.device) \
        if need_dmod and not x.numel() else None
    if x.numel() and (needs[0] or need_dmod):
        block, warps, rows, chunks = _launch_config("ln_mul_add_bwd", B, S, D, need_dmod and not per_token)
        # per token: dmul and dadd themselves; per sample: partial sums a chunk
        part = torch.empty((2, B, S if per_token else chunks, D), dtype=torch.float32, device=x.device) \
            if need_dmod else x
        _launch(_triton_kernels()["ln_mul_add_bwd"], (chunks, B), x, mul, g, x if dx is None else dx, part,
                S, D, rows, chunks, part[0].numel() if need_dmod else 0, 1.0 / D, float(eps), RMS=bool(rms),
                PER_TOKEN=per_token, NEED_DX=bool(needs[0]), NEED_DMOD=need_dmod, BLOCK_D=block,
                num_warps=warps)
        if need_dmod:
            dmod = part if per_token else _sum_chunks(part, 2, B, chunks, D).view(2, B, 1, D)
        ln_mul_add_backward.launches += 1
    return dx, dmod[0] if needs[1] else None, dmod[1] if needs[2] else None


ln_mul_add_backward.launches = 0


class _LnMulAdd(torch.autograd.Function):
    """K5 (its plain version on a CPU tensor); the backward is
    :func:`ln_mul_add_backward` (JAX ``_fused_ln_mul_add_bwd``,
    ``norms.py:158-163``)."""

    @staticmethod
    def forward(ctx, x, mul, add, eps, out_dtype, fold, rms):
        ctx.save_for_backward(x, mul)
        ctx.cfg = (eps, rms)
        if x.device.type == "cpu":
            return _native_ln_mul_add(x, mul, add, eps, out_dtype, fold, rms)
        return _launch_ln_mul_add(x, mul, add, eps, out_dtype, fold, rms)

    @staticmethod
    def backward(ctx, g):
        x, mul = ctx.saved_tensors
        eps, rms = ctx.cfg
        return (*ln_mul_add_backward(x, mul, g, eps, rms, ctx.needs_input_grad[:3]),
                None, None, None, None)


def ln_mul_add(x, mul, add, eps: float, out_dtype, fold: bool, rms: bool = False):
    """K5. ``mul``/``add``: fp32 (B, 1, D) or (B, S, D), of one shape. CPU
    tensors take the plain version, CUDA tensors the kernel, both through
    :class:`_LnMulAdd`."""
    if mul.shape != add.shape:
        raise ValueError(f"ln_mul_add: mul {tuple(mul.shape)} and add {tuple(add.shape)} differ")
    if x.device.type != "cpu":
        _check_rows("ln_mul_add", x, out_dtype)
        _check_mod("ln_mul_add", mul, x, True)
        _check_mod("ln_mul_add", add, x, True)
    return _LnMulAdd.apply(x, mul, add, float(eps), out_dtype, bool(fold), bool(rms))


ln_mul_add.launches = 0


def _launch_rgm(x, branch, gate, mul, add, eps, out_dtype):
    B, S, D = x.shape
    x_new = torch.empty_like(x)
    x_mod = torch.empty((B, S, D), dtype=out_dtype, device=x.device)
    if x.numel():
        block, warps, rows, chunks = _launch_config("rgm", B, S, D)
        _launch(_triton_kernels()["rgm"], (chunks, B), x, branch, gate, mul, add, x_new, x_mod, S, D, rows,
                1.0 / D, float(eps), BF16=x.dtype == torch.bfloat16, BLOCK_D=block,
                num_warps=warps)
        residual_gate_modulate_rows.launches += 1
    return x_new, x_mod


def _check_rgm(name, x, branch, gate, mul) -> None:
    _check_rows(name, x, x.dtype)
    if branch.shape != x.shape or branch.dtype != x.dtype or not branch.is_contiguous():
        raise ValueError(f"{name}: branch must match x's shape and dtype and be contiguous")
    B, S, D = x.shape
    if gate.dtype != torch.float32 or tuple(gate.shape) != (B, D) or not gate.is_contiguous():
        raise ValueError(f"{name}: gate must be contiguous fp32 ({B}, {D}); got "
                         f"{gate.dtype} {tuple(gate.shape)}")
    _check_mod(name, mul, x, False)


def residual_gate_modulate_backward(x, branch, gate, mul, g_new, g_mod, eps: float, needs: Sequence[bool]):
    """K6's backward: ``(dx, dbranch, dgate, dmul, dadd)`` for the cotangents
    of ``residual_gate_modulate_rows``'s (x_new, x_mod), None where ``needs``
    is unset. A CPU tensor takes the closed-form plain backward; a CUDA
    tensor launches the backward kernel (and the chunk sum of dgate, dmul
    and dadd; one count in ``residual_gate_modulate_backward.launches``) or
    raises."""
    if x.device.type == "cpu":
        return _native_residual_gate_modulate_backward(x, branch, gate, mul, g_new, g_mod, eps, needs)
    name = "residual_gate_modulate_backward"
    _check_rgm(name, x, branch, gate, mul)
    if g_new.dtype != x.dtype:
        raise ValueError(f"{name}: the x_new cotangent must be {x.dtype}; got {g_new.dtype}")
    g_new, g_mod = _check_cotangent(name, g_new, x), _check_cotangent(name, g_mod, x)
    B, S, D = x.shape
    dx = torch.empty_like(x) if needs[0] else None
    dbranch = torch.empty_like(x) if needs[1] else None
    need_dmod = bool(needs[3] or needs[4])
    sums = torch.zeros((3, B, D), dtype=torch.float32, device=x.device) \
        if (needs[2] or need_dmod) and not x.numel() else None
    if x.numel() and any(needs):
        block, warps, rows, chunks = _launch_config("rgm_bwd", B, S, D, bool(needs[2]) or need_dmod)
        part = torch.empty((3, B, chunks, D), dtype=torch.float32, device=x.device) \
            if needs[2] or need_dmod else None
        _launch(_triton_kernels()["rgm_bwd"], (chunks, B), x, branch, gate, mul, g_new, g_mod,
                x if dx is None else dx, x if dbranch is None else dbranch, x if part is None else part,
                S, D, rows, chunks, 0 if part is None else part[0].numel(), 1.0 / D, float(eps),
                BF16=x.dtype == torch.bfloat16, NEED_T=any(needs[:3]), NEED_DX=bool(needs[0]), NEED_DBR=bool(needs[1]),
                NEED_DGATE=bool(needs[2]), NEED_DMOD=need_dmod, BLOCK_D=block,
                num_warps=warps)
        if part is not None:
            sums = _sum_chunks(part, 3, B, chunks, D, round_like=x)
        residual_gate_modulate_backward.launches += 1
    return (dx, dbranch, sums[0] if needs[2] else None, sums[1].view(B, 1, D) if needs[3] else None,
            sums[2].view(B, 1, D) if needs[4] else None)


residual_gate_modulate_backward.launches = 0


class _ResidualGateModulate(torch.autograd.Function):
    """K6 (its plain version on a CPU tensor); the backward is
    :func:`residual_gate_modulate_backward` (JAX ``_rgm_fused_bwd``,
    ``norms.py:358-364``)."""

    @staticmethod
    def forward(ctx, x, branch, gate, mul, add, eps, out_dtype):
        ctx.save_for_backward(x, branch, gate, mul)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _native_residual_gate_modulate(x, branch, gate, mul, add, eps, out_dtype)
        return _launch_rgm(x, branch, gate, mul, add, eps, out_dtype)

    @staticmethod
    def backward(ctx, g_new, g_mod):
        return (*residual_gate_modulate_backward(*ctx.saved_tensors, g_new, g_mod, ctx.eps,
                                                 ctx.needs_input_grad[:5]), None, None)


def residual_gate_modulate_rows(x, branch, gate, mul, add, eps: float, out_dtype):
    """K6. x/branch (B, S, D); gate (B, D) fp32; mul/add (B, 1, D) fp32. CPU
    tensors take the plain version, CUDA tensors the kernel, both through
    :class:`_ResidualGateModulate`."""
    if mul.shape != add.shape:
        raise ValueError(f"residual_gate_modulate: mul {tuple(mul.shape)} and add {tuple(add.shape)} differ")
    if x.device.type != "cpu":
        _check_rgm("residual_gate_modulate", x, branch, gate, mul)
        _check_mod("residual_gate_modulate", add, x, False)
    return _ResidualGateModulate.apply(x, branch, gate, mul, add, float(eps), out_dtype)


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
