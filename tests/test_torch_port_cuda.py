"""PyTorch port, on the card: kernels K1, K2a/K2b, K3, K5 and K6 against
their plain versions, gradients through their autograd Functions against
plain autograd, and the no-fallback guards on CUDA tensors.

Marked ``cuda``; every test skips without a CUDA device. On a machine with
an NVIDIA GPU (the suite's conftest imports JAX, which that machine need not
have, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py -q
"""
import math

import pytest
import torch

from flow_factory_tpu_torch.ops import attention as A
from flow_factory_tpu_torch.ops import norms as N

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _k1_tols(ref, dtype):
    """The bars of chip_smoke.py: fp32 differs by summation order only; bf16
    rounds the normalised q once with the softmax scale folded in, which moves
    O by 1-2 bf16 ulp of max|O| (bar: 4 ulp) and lse by <= 3e-3 (bar: 1e-2)."""
    if dtype == torch.float32:
        return 1e-4, 1e-3
    return 4 * _bf16_ulp(ref.float().abs().max().item()), 1e-2


@pytest.mark.parametrize("dtype,S", [
    (torch.bfloat16, 333),   # tensor-core variant, ragged key tail
    (torch.float32, 197),    # FMA variant
])
def test_qknorm_flash_matches_plain(gen, dtype, S):
    q, k, v = (_randn(gen, 2, 3, S, 64, dtype=dtype) for _ in range(3))
    gq = 1.0 + 0.1 * _randn(gen, S, 64)
    gk = 1.0 + 0.1 * _randn(gen, S, 64)
    before = A.qknorm_flash_attention.launches
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, 0.125, 1e-6, return_lse=True)
    ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, 0.125, 1e-6, return_lse=True)
    assert A.qknorm_flash_attention.launches == before + 1
    tol_o, tol_lse = _k1_tols(ref, dtype)
    assert (out.float() - ref.float()).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_lse


def test_qknorm_flash_bars_reject_a_kernel_that_ignores_gamma(gen):
    """Negative control: the plain version with unit gamma maps is not within
    the bars of the kernel run with the random ones."""
    S = 333
    q, k, v = (_randn(gen, 2, 3, S, 64, dtype=torch.bfloat16) for _ in range(3))
    gq = 1.0 + 0.1 * _randn(gen, S, 64)
    gk = 1.0 + 0.1 * _randn(gen, S, 64)
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, 0.125, 1e-6, return_lse=True)
    ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, 0.125, 1e-6, return_lse=True)
    ones = torch.ones_like(gq)
    wrong, wrong_lse = A.qknorm_attention_plain(q, k, v, ones, ones, 0.125, 1e-6, return_lse=True)
    tol_o, tol_lse = _k1_tols(ref, torch.bfloat16)
    assert ((out.float() - wrong.float()).abs().max().item() > tol_o
            or (lse - wrong_lse).abs().max().item() > tol_lse)


def test_qknorm_flash_takes_strided_views_and_is_deterministic(gen):
    """Head-split views (B, S, H, D).transpose(1, 2) give the same bits as
    contiguous copies, and two launches give the same bits."""
    q, k, v = (_randn(gen, 2, 200, 3, 64, dtype=torch.bfloat16).transpose(1, 2) for _ in range(3))
    g = torch.ones(200, 64, device="cuda")
    a = A.qknorm_flash_attention(q, k, v, g, g, 0.125, 1e-6)
    b = A.qknorm_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), g, g, 0.125, 1e-6)
    c = A.qknorm_flash_attention(q, k, v, g, g, 0.125, 1e-6)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("fold,rms,per_token", [(False, False, False), (True, False, False),
                                                (False, True, True)])
def test_ln_mul_add_matches_plain(gen, fold, rms, per_token):
    """One bf16 ulp at the largest output (fp32 stats, another summation order)."""
    x = _randn(gen, 2, 45, 1536, dtype=torch.bfloat16)
    shape = (2, 45 if per_token else 1, 1536)
    mul, add = 1.0 + 0.1 * _randn(gen, *shape), 0.1 * _randn(gen, *shape)
    out = N.ln_mul_add(x, mul, add, 1e-6, torch.bfloat16, fold=fold, rms=rms)
    ref = N._native_ln_mul_add(x, mul, add, 1e-6, torch.bfloat16, fold, rms)
    mag = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** (int(mag).bit_length() - 8)


def test_residual_gate_modulate_x_new_is_bit_exact(gen):
    x, br = (_randn(gen, 2, 45, 1536, dtype=torch.bfloat16) for _ in range(2))
    gate = _randn(gen, 2, 1536)
    mul, add = 1.0 + 0.1 * _randn(gen, 2, 1, 1536), 0.1 * _randn(gen, 2, 1, 1536)
    xn, xm = N.residual_gate_modulate_rows(x, br, gate, mul, add, 1e-6, torch.bfloat16)
    rn, rm = N._native_residual_gate_modulate(x, br, gate, mul, add, 1e-6, torch.bfloat16)
    assert torch.equal(xn, rn)
    mag = rm.float().abs().max().item()
    assert (xm.float() - rm.float()).abs().max().item() <= 2.0 ** (int(mag).bit_length() - 8)


def test_cuda_inputs_the_kernels_do_not_take_raise(gen):
    """No silent fallback: a CUDA tensor the kernel cannot take raises."""
    q = _randn(gen, 1, 2, 16, 32)  # fp32 at head dim 32: no kernel variant
    g = torch.ones(16, 32, device="cuda")
    with pytest.raises(ValueError):
        A.qknorm_flash_attention(q, q, q, g, g, 32 ** -0.5, 1e-6)
    with pytest.raises(ValueError):  # bf16 K1 at head dim 16: only fp32 has it
        q16 = _randn(gen, 1, 2, 16, 16, dtype=torch.bfloat16)
        A.qknorm_flash_attention(q16, q16, q16, g[:, :16], g[:, :16], 0.25, 1e-6)
    # bf16 at an 8-byte offset: the tensor-core variant's 16-byte loads refuse it
    q = _randn(gen, 1 * 2 * 16 * 64 + 4, dtype=torch.bfloat16)[4:].view(1, 2, 16, 64)
    g = torch.ones(16, 64, device="cuda")
    with pytest.raises(ValueError):
        A.qknorm_flash_attention(q, q, q, g, g, 0.125, 1e-6)
    x = _randn(gen, 2, 8, 64).transpose(0, 1)  # not contiguous
    m = torch.ones(8, 1, 64, device="cuda")
    with pytest.raises(ValueError):
        N.ln_mul_add(x, m, m, 1e-6, torch.float32, fold=False)
    y = _randn(gen, 2, 8, 64)
    with pytest.raises(ValueError):
        N.residual_gate_modulate_rows(y, y, torch.ones(2, 64, device="cuda", dtype=torch.float16),
                                      m[:2], m[:2], 1e-6, torch.float32)


# ---------------------------------------------------------------------------
# K2a / K2b: the flash backward
# ---------------------------------------------------------------------------

def _k2_inputs(gen, B, H, Sq, Sk, dtype, strided, D=64):
    """q/k/v/dO in the head-split strided layout (or contiguous; "mixed": q
    and dO contiguous, k and v head-split), O and lse from the plain forward
    of the same inputs."""
    def heads(S, split):
        if split:
            return _randn(gen, B, S, H, D, dtype=dtype).transpose(1, 2)
        return _randn(gen, B, H, S, D, dtype=dtype)

    outer = strided is True
    q, k, v, dout = heads(Sq, outer), heads(Sk, bool(strided)), heads(Sk, bool(strided)), heads(Sq, outer)
    out, lse = A.native_attention(q, k, v, scale=0.125, return_lse=True)
    return q, k, v, out, lse, dout


def _k2_tol(ref, dtype):
    """The bars of chip_smoke.py. fp32: summation order only, 1e-5 relative
    to max|ref|. bf16: p and ds round to bf16 in both versions, but a value
    near a rounding boundary can round the other way after a different
    summation order; half a bf16 ulp of max|ref| seen, bar 2 ulp."""
    mag = ref.float().abs().max().item()
    return 1e-5 * max(mag, 1.0) if dtype == torch.float32 else 2 * _bf16_ulp(mag)


@pytest.mark.parametrize("dtype,Sq,Sk,strided", [
    (torch.bfloat16, 333, 333, True),    # wgmma variant, ragged tail, head-split views
    (torch.bfloat16, 200, 333, False),   # Sq != Sk
    # the wgmma variant's tiles: 64 rows streamed, 128 outer rows a block
    (torch.bfloat16, 64, 64, False),     # one tile each way
    (torch.bfloat16, 63, 65, True),      # one tile - 1 / + 1
    (torch.bfloat16, 65, 63, False),
    (torch.bfloat16, 40, 40, True),      # below one tile
    (torch.bfloat16, 40, 200, "mixed"),  # Sq < one tile < Sk, q/dO contiguous, k/v head-split
    (torch.bfloat16, 200, 40, "mixed"),
    (torch.bfloat16, 128, 128, True),    # one block of outer rows
    (torch.bfloat16, 127, 129, False),   # one block - 1 / + 1
    (torch.bfloat16, 129, 127, True),
    (torch.float32, 197, 130, True),     # FMA variant
])
def test_flash_backward_matches_plain(gen, dtype, Sq, Sk, strided):
    q, k, v, out, lse, dout = _k2_inputs(gen, 2, 3, Sq, Sk, dtype, strided)
    before = (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches)
    got = A.flash_backward(q, k, v, out, lse, dout, 0.125)
    ref = A.flash_backward_plain(q, k, v, out, lse, dout, 0.125)
    torch.cuda.synchronize()
    assert (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        err, tol = (g.float() - r.float()).abs().max().item(), _k2_tol(r, dtype)
        print(f"K2 {dtype} {Sq}x{Sk} {name}: max|d| {err:.3e} tol {tol:.3e}")
        assert g.shape == r.shape and err <= tol, name


def test_flash_backward_bars_reject_wrong_plain_versions(gen):
    """Negative controls: a plain version without Δ, and one without the
    ragged key tail, both miss the kernel by more than the bar."""
    q, k, v, out, lse, dout = _k2_inputs(gen, 2, 3, 333, 333, torch.bfloat16, True)
    dq, dk, _ = A.flash_backward(q, k, v, out, lse, dout, 0.125)
    d32, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    no_delta = A.flash_bwd_dq_plain(q, k, v, d32, lse2, torch.zeros_like(delta), 0.125)
    n = 320  # the last whole key tile of K2a (64 keys)
    no_tail = A.flash_bwd_dq_plain(q, k[:, :, :n], v[:, :, :n], d32, lse2, delta, 0.125)
    tol = _k2_tol(no_delta, torch.bfloat16)
    assert (dq.float() - no_delta.float()).abs().max().item() > tol
    assert (dq.float() - no_tail.float()).abs().max().item() > tol


def test_flash_backward_is_deterministic(gen):
    q, k, v, out, lse, dout = _k2_inputs(gen, 2, 3, 333, 333, torch.bfloat16, True)
    a = A.flash_backward(q, k, v, out, lse, dout, 0.125)
    b = A.flash_backward(q, k, v, out, lse, dout, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_backward_refuses_what_it_does_not_take(gen):
    q, k, v, out, lse, dout = _k2_inputs(gen, 1, 2, 64, 64, torch.bfloat16, False)
    d32, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    with pytest.raises(TypeError):  # mixed dtypes
        A.flash_bwd_dq(q, k.float(), v, d32, lse2, delta, 0.125)
    odd = _randn(gen, 1 * 2 * 64 * 64 + 4, dtype=torch.bfloat16)[4:].view(1, 2, 64, 64)
    with pytest.raises(ValueError):  # 8-byte offset: the 16-byte loads refuse it
        A.flash_bwd_dkv(odd, k, v, d32, lse2, delta, 0.125)
    with pytest.raises(ValueError):  # head dim 32
        A.flash_bwd_dq(q[..., :32], k[..., :32], v[..., :32], d32[..., :32], lse2, delta, 0.125)
    q, k, v, out, lse, dout = _k2_inputs(gen, 1, 2, 64, 64, torch.float32, False, D=32)
    d32, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    for fn in (A.flash_bwd_dq, A.flash_bwd_dkv):
        with pytest.raises(ValueError):  # fp32 at head dim 32: no variant
            fn(q, k, v, d32, lse2, delta, 32 ** -0.5)
        with pytest.raises(TypeError):  # fp16: no variant
            fn(*(t.half() for t in (q, k, v, d32)), lse2, delta, 32 ** -0.5)


def _k2_w_inputs(gen, case):
    """K2 at head dim 128 on the layouts of the Wan blocks: self-attention
    q/k as ``apply_rope`` returns them (contiguous), v a head-split view of its
    projection; cross-attention k/v head-split views of the context
    projections; dO head-interleaved as the head merge's backward hands it
    over. O and lse from K3's forward of the same inputs."""
    B, H, D = 2, 3, 128
    Sq, Sk = (300, 77) if case == "ragged" else (512, 512)
    view = lambda S: _randn(gen, B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    dense = lambda S: _randn(gen, B, H, S, D, dtype=torch.bfloat16)
    q = dense(Sq) if case != "ragged" else view(Sq)
    k = dense(Sk) if case == "wan-self" else view(Sk)
    v = view(Sk)
    dout = view(Sq)
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("case", ["wan-self", "wan-cross", "ragged"])
def test_flash_backward_d128_matches_plain(gen, case):
    """K2a/K2b at head dim 128 (bf16) within 2 bf16 ulp of max|ref| of the
    plain version, one launch each; the ragged case has a 300-row q tail and
    a 77-key tail."""
    q, k, v, out, lse, dout = _k2_w_inputs(gen, case)
    before = (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches)
    got = A.flash_backward(q, k, v, out, lse, dout, 128 ** -0.5)
    ref = A.flash_backward_plain(q, k, v, out, lse, dout, 128 ** -0.5)
    torch.cuda.synchronize()
    assert (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        err, tol = (g.float() - r.float()).abs().max().item(), _k2_tol(r, torch.bfloat16)
        print(f"K2 D128 {case} {name}: max|d| {err:.3e} tol {tol:.3e}")
        assert g.shape == r.shape and g.transpose(1, 2).is_contiguous() and err <= tol, name


def test_flash_backward_d128_is_deterministic_and_rejects_wrong_plain_versions(gen):
    """Two passes give the same bits; a plain version without Δ, and one
    without the 13-key ragged tail (77 = 64 + 13), miss the kernel's dq by
    more than the bar."""
    q, k, v, out, lse, dout = _k2_w_inputs(gen, "ragged")
    scale = 128 ** -0.5
    a = A.flash_backward(q, k, v, out, lse, dout, scale)
    b = A.flash_backward(q, k, v, out, lse, dout, scale)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    d32, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    no_delta = A.flash_bwd_dq_plain(q, k, v, d32, lse2, torch.zeros_like(delta), scale)
    no_tail = A.flash_bwd_dq_plain(q, k[:, :, :64], v[:, :, :64], d32, lse2, delta, scale)
    tol = _k2_tol(A.flash_bwd_dq_plain(q, k, v, d32, lse2, delta, scale), torch.bfloat16)
    assert (a[0].float() - no_delta.float()).abs().max().item() > tol
    assert (a[0].float() - no_tail.float()).abs().max().item() > tol


# K2 at head dim 128 at the edges of its tiles: 128 outer rows a block (two
# warpgroups of 64), 64-row streamed tiles, which both kernels take in halves
# of 32
_K2_D128_EDGES = (32, 63, 64, 65, 127, 128, 129, 193, 257)
_K2_D128_LAYOUTS = ("contiguous", "head-split", "wan-self", "wan-cross")


def _k2_d128_views(gen, B, H, Sq, Sk, layout):
    """q, k, v and dO at head dim 128: contiguous (dO too); head-split (every
    operand a head-split view of a (B, S, H*D) projection); wan-self (q/k
    contiguous as ``apply_rope`` returns them, v a view); wan-cross (q
    contiguous, k/v views of the context projections). dO is head-interleaved,
    as the head merge's backward hands it over, in all but contiguous. O and
    lse from K3's forward."""
    D = 128
    view = lambda S: _randn(gen, B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    dense = lambda S: _randn(gen, B, H, S, D, dtype=torch.bfloat16)
    q = view(Sq) if layout == "head-split" else dense(Sq)
    k = dense(Sk) if layout in ("contiguous", "wan-self") else view(Sk)
    v = dense(Sk) if layout == "contiguous" else view(Sk)
    dout = dense(Sq) if layout == "contiguous" else view(Sq)
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("Sk", _K2_D128_EDGES)
@pytest.mark.parametrize("Sq", _K2_D128_EDGES)
def test_flash_backward_d128_at_the_tile_edges(gen, Sq, Sk):
    """dq, dk and dv within 2 bf16 ulp of max|ref| of the plain versions at
    every pair of edge lengths, the layouts taking turns."""
    layout = _K2_D128_LAYOUTS[(_K2_D128_EDGES.index(Sq) + _K2_D128_EDGES.index(Sk)) % len(_K2_D128_LAYOUTS)]
    q, k, v, out, lse, dout = _k2_d128_views(gen, 2, 3, Sq, Sk, layout)
    got = A.flash_backward(q, k, v, out, lse, dout, 128 ** -0.5)
    ref = A.flash_backward_plain(q, k, v, out, lse, dout, 128 ** -0.5)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        err, tol = (g.float() - r.float()).abs().max().item(), _k2_tol(r, torch.bfloat16)
        print(f"K2 D128 {Sq}x{Sk} {layout} {name}: max|d| {err:.3e} tol {tol:.3e}")
        assert g.shape == r.shape and err <= tol, name


@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_batch_slice_gives_the_bits_of_the_whole_batch(gen, D):
    """Each dq row depends only on its q row and its (b, h)'s keys, each dk/dv
    row on its key and its (b, h)'s q rows, in a fixed order: the first 8 of
    16 batch rows alone give the bits of the whole batch's first 8."""
    q, k, v, out, lse, dout = _k2_inputs(gen, 16, 2, 200, 200, torch.bfloat16, "mixed", D=D)
    whole = A.flash_backward(q, k, v, out, lse, dout, 0.125)  # the scale of _k2_inputs' forward
    part = A.flash_backward(*(t[:8] for t in (q, k, v, out, lse, dout)), 0.125)
    assert all(torch.equal(a, b[:8]) for a, b in zip(part, whole))


# ---------------------------------------------------------------------------
# Autograd through K1, K5 and K6
# ---------------------------------------------------------------------------

def _grads(fn, inputs, weights):
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    return outs, torch.autograd.grad(loss, leaves)


def test_qknorm_flash_records_a_node_and_its_grads_match_plain_autograd(gen):
    """fp32: the K1 Function's gradients (K2a/K2b + the norm VJP) against
    autograd through the plain version: 1e-4 relative to each max."""
    S = 197
    q, k, v = (_randn(gen, 2, 3, S, 64) for _ in range(3))
    gq, gk = 1.0 + 0.1 * _randn(gen, S, 64), 1.0 + 0.1 * _randn(gen, S, 64)
    w = _randn(gen, 2, 3, S, 64)
    kern = lambda *t: A.qknorm_flash_attention(*t, 0.125, 1e-6)
    plain = lambda *t: A.qknorm_attention_plain(*t, 0.125, 1e-6)
    (o,), g_kern = _grads(kern, (q, k, v, gq, gk), (w,))
    _, g_plain = _grads(plain, (q, k, v, gq, gk), (w,))
    assert o.grad_fn is not None
    for name, a, b in zip(("dq", "dk", "dv", "dgq", "dgk"), g_kern, g_plain):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), name


@pytest.mark.parametrize("which", ["ln_mul_add", "rgm"])
def test_norm_kernels_record_a_node_and_grads_match_plain_autograd(gen, which):
    """The K5/K6 backward is the plain composition's VJP, so with a loss
    linear in the outputs the gradients equal plain autograd's (1e-6
    relative, fp32; bf16 inputs take the same path)."""
    x, br = _randn(gen, 2, 45, 1536), _randn(gen, 2, 45, 1536)
    mul, add = 1.0 + 0.1 * _randn(gen, 2, 1, 1536), 0.1 * _randn(gen, 2, 1, 1536)
    gate = _randn(gen, 2, 1536)
    if which == "ln_mul_add":
        kern = lambda x, m, a: N.ln_mul_add(x, m, a, 1e-6, torch.float32, fold=False)
        plain = lambda x, m, a: N._native_ln_mul_add(x, m, a, 1e-6, torch.float32, False)
        inputs, weights = (x, mul, add), (_randn(gen, 2, 45, 1536),)
    else:
        kern = lambda *t: N.residual_gate_modulate_rows(*t, 1e-6, torch.float32)
        plain = lambda *t: N._native_residual_gate_modulate(*t, 1e-6, torch.float32)
        inputs, weights = (x, br, gate, mul, add), (_randn(gen, 2, 45, 1536), _randn(gen, 2, 45, 1536))
    outs, g_kern = _grads(kern, inputs, weights)
    _, g_plain = _grads(plain, inputs, weights)
    assert all(o.grad_fn is not None for o in outs)
    for a, b in zip(g_kern, g_plain):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()


def test_lora_gradients_reach_attention_and_adaln_through_the_kernels(gen):
    """A two-block MMDiT with head dim 64 in bf16 on the card: the LoRA
    gradient of a loss on the velocity through K1/K2/K5/K6 against the plain
    attention and plain norms, every leaf within 5e-2 of its max (bf16
    activations, two roundings of the same math), and every LoRA leaf on the
    attention projections and the AdaLN linears non-zero."""
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import DEFAULT_TARGET_PATTERNS, init_lora, merge_lora
    from flow_factory_tpu_torch.models.sd3.transformer import MMDiTConfig, SD3Transformer

    cfg = MMDiTConfig.tiny(hidden_dim=128, num_heads=2, dtype="bfloat16")
    model = build_module(lambda: SD3Transformer(cfg), torch.device("cuda"), torch.bfloat16, gen)
    patterns = DEFAULT_TARGET_PATTERNS + (r".*\.norm1(_context)?\.linear\.weight$",)
    lora = init_lora(model, 4, gen, patterns)
    for ab in lora.values():  # b != 0, else the gradient of a is zero
        ab["lora_B"].data.normal_(0.0, 0.01, generator=gen)
    x, t = _randn(gen, 2, 16, 16, 16), torch.full((2,), 500.0, device="cuda")
    ctx, pooled = _randn(gen, 2, 12, cfg.context_dim), _randn(gen, 2, cfg.pooled_dim)
    w = _randn(gen, 2, 16, 16, 16)

    def lora_grads():
        leaves = [ab[k] for ab in lora.values() for k in ("lora_A", "lora_B")]
        v = functional_call(model, merge_lora(model, lora, 2.0), (x.bfloat16(), t, ctx, pooled))
        return dict(zip([f"{p}.{k}" for p in lora for k in ("lora_A", "lora_B")],
                        torch.autograd.grad((v.float() * w).sum(), leaves)))

    kern = lora_grads()
    for m in model.modules():
        if hasattr(m, "attn_backend"):
            m.attn_backend = "native"
    ln, rgm = N.ln_mul_add, N.residual_gate_modulate_rows
    N.ln_mul_add = lambda x, m, a, eps, dt, fold, rms=False: N._native_ln_mul_add(x, m, a, eps, dt, fold, rms)
    N.residual_gate_modulate_rows = N._native_residual_gate_modulate
    try:
        plain = lora_grads()
    finally:
        N.ln_mul_add, N.residual_gate_modulate_rows = ln, rgm
    for name, g in kern.items():
        ref = plain[name]
        assert (g - ref).abs().max().item() <= 5e-2 * ref.abs().max().item(), name
        if any(s in name for s in ("attn.to_q", "attn.add_k_proj", "attn2.to_v", "norm1.linear",
                                   "norm1_context.linear")):
            assert g.abs().max().item() > 0, name


# ---------------------------------------------------------------------------
# K3: the plain flash forward
# ---------------------------------------------------------------------------

def _k3_inputs(gen, B, H, Sq, Sk, D, strided):
    def heads(S):
        if strided:  # the head-split view of a (B, S, H*D) projection
            return _randn(gen, B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
        return _randn(gen, B, H, S, D, dtype=torch.bfloat16)
    return heads(Sq), heads(Sk), heads(Sk)


def _k3_errors(out, lse, ref, ref_lse):
    return (out.float() - ref.float()).abs().max().item(), (lse - ref_lse).abs().max().item()


def _k3_tols(ref):
    """K1's bars: 4 bf16 ulp of max|O| on O, 1e-2 on lse. Both versions round
    q·scale·log2e once and p to bf16 before PV; the kernel's online softmax
    rounds p against a running max, which moves O by an ulp or two."""
    return 4 * _bf16_ulp(ref.float().abs().max().item()), 1e-2


@pytest.mark.parametrize("D,Sq,Sk,strided", [
    (128, 512, 512, True),    # Wan self-attention layout (head-split views)
    (128, 300, 77, False),    # ragged q rows and key tail
    (64, 300, 77, True),
    (64, 128, 333, False),
])
def test_flash_fwd_matches_plain(gen, D, Sq, Sk, strided):
    q, k, v = _k3_inputs(gen, 2, 3, Sq, Sk, D, strided)
    before = A.flash_attention.launches
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16 and lse.shape == (2, 3, Sq)
    err_o, err_lse = _k3_errors(out, lse, ref, ref_lse)
    tol_o, tol_lse = _k3_tols(ref)
    print(f"K3 D{D} {Sq}x{Sk}: O {err_o:.3e} (tol {tol_o:.3e}), lse {err_lse:.3e}")
    assert err_o <= tol_o and err_lse <= tol_lse


def test_flash_fwd_bars_reject_wrong_plain_versions(gen):
    """Negative controls: the plain version run on the zero-padded key tail
    as if it were real keys, and one whose logits carry the scale but not
    log2(e) (its exp2 is then not the softmax), both miss the bars."""
    q, k, v = _k3_inputs(gen, 2, 3, 300, 77, 128, True)
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    ref, _ = A.flash_attention_plain(q, k, v, return_lse=True)
    tol_o, tol_lse = _k3_tols(ref)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 128 - 77))
    for wrong in (A.flash_attention_plain(q, pad(k), pad(v), return_lse=True),
                  A.flash_attention_plain(q, k, v, 128 ** -0.5 / A._LOG2E, return_lse=True)):
        err_o, err_lse = _k3_errors(out, lse, *wrong)
        assert err_o > tol_o or err_lse > tol_lse


def test_flash_fwd_is_deterministic_and_reads_views_in_place(gen):
    q, k, v = _k3_inputs(gen, 2, 3, 200, 200, 128, True)
    a = A.flash_attention(q, k, v)
    b = A.flash_attention(q, k, v)
    c = A.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(a, b) and torch.equal(a, c)
    assert a.transpose(1, 2).is_contiguous()  # head-interleaved: the head merge is a view


def test_flash_fwd_refuses_what_it_does_not_take(gen):
    q, k, v = _k3_inputs(gen, 1, 2, 64, 64, 128, False)
    with pytest.raises(TypeError):  # fp16
        A.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # fp32 at head dim 32
        A.flash_attention(*(t[..., :32].float() for t in (q, k, v)))
    q96 = _randn(gen, 1, 2, 64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 96
        A.flash_attention(q96, q96, q96)
    odd = _randn(gen, 1 * 2 * 64 * 128 + 4, dtype=torch.bfloat16)[4:].view(1, 2, 64, 128)
    with pytest.raises(ValueError):  # 8-byte offset: the 16-byte loads refuse it
        A.flash_attention(odd, k, v)
    # the JAX rule: ``auto`` with a dense mask is native attention, ``flash``
    # with one raises; neither launches K3
    mask = torch.rand(64, 64, generator=gen, device="cuda") > 0.3
    before = A.flash_attention.launches
    assert torch.equal(A.dot_product_attention(q, k, v, mask=mask), A.native_attention(q, k, v, mask=mask))
    with pytest.raises(NotImplementedError):
        A.dot_product_attention(q, k, v, mask=mask, backend="flash")
    assert A.flash_attention.launches == before


@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_records_a_node_and_its_grads_match_plain_autograd(gen, D):
    """The _Flash Function's gradients (K2a/K2b on the kernel's O and lse)
    against autograd through the plain version, bf16, at both head dims. The
    Function's backward, as the JAX custom VJP, takes Δ from the
    bf16-rounded O where autograd differentiates the unrounded softmax: the
    plain versions of the two paths differ by 4.5e-3 of each gradient's max
    on the CPU, so the bar is 2e-2."""
    q, k, v = _k3_inputs(gen, 2, 3, 200, 200, D, True)
    w = _randn(gen, 2, 3, 200, D)
    before = A.flash_bwd_dq.launches
    (o,), g_kern = _grads(lambda *t: A.flash_attention(*t), (q, k, v), (w,))
    assert A.flash_bwd_dq.launches == before + 1
    _, g_plain = _grads(lambda *t: A.flash_attention_plain(*t), (q, k, v), (w,))
    assert o.grad_fn is not None
    for name, a, b in zip(("dq", "dk", "dv"), g_kern, g_plain):
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item(), name


# ---------------------------------------------------------------------------
# K1 and K3 at the edges of the wgmma forward's tiles: 128 q rows a block,
# key tiles of 128 (head dim 64) or 64 (head dim 128)
# ---------------------------------------------------------------------------

_FWD_EDGES = [
    (128, 128, "contiguous"),  # one q tile, one key tile at D=64 (two at D=128)
    (127, 129, "head-split"),  # a tile - 1 q rows, + 1 keys
    (129, 127, "mixed"),       # + 1 q rows, - 1 keys; q contiguous, k/v head-split (Wan's cross-attention)
    (64, 64, "contiguous"),    # below a q tile; one 64-key tile at D=128
    (65, 63, "head-split"),    # one key tile - 1 at D=128, + 1 q rows past a half tile
    (1, 1, "mixed"),
    (300, 40, "mixed"),        # Sk < 64: one ragged key tile
    (40, 300, "head-split"),   # Sq < 64 < Sk
    (257, 193, "contiguous"),  # 128 x 2 + 1 q rows, 64 x 3 + 1 keys
]


def _fwd_views(gen, B, H, Sq, Sk, D, layout):
    def heads(S, split):
        if split:  # the head-split view of a (B, S, H*D) projection
            return _randn(gen, B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
        return _randn(gen, B, H, S, D, dtype=torch.bfloat16)
    return heads(Sq, layout == "head-split"), heads(Sk, layout != "contiguous"), heads(Sk, layout != "contiguous")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk,layout", _FWD_EDGES)
def test_flash_fwd_at_the_tile_edges(gen, D, Sq, Sk, layout):
    q, k, v = _fwd_views(gen, 2, 3, Sq, Sk, D, layout)
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    err_o, err_lse = _k3_errors(out, lse, ref, ref_lse)
    tol_o, tol_lse = _k3_tols(ref)
    print(f"K3 D{D} {Sq}x{Sk} {layout}: O {err_o:.3e} (tol {tol_o:.3e}), lse {err_lse:.3e}")
    assert out.shape == ref.shape and err_o <= tol_o and err_lse <= tol_lse


@pytest.mark.parametrize("Sq,Sk,layout", _FWD_EDGES)
def test_qknorm_flash_at_the_tile_edges(gen, Sq, Sk, layout):
    q, k, v = _fwd_views(gen, 2, 3, Sq, Sk, 64, layout)
    gq = 1.0 + 0.1 * _randn(gen, Sq, 64)
    gk = 1.0 + 0.1 * _randn(gen, Sk, 64)
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, 0.125, 1e-6, return_lse=True)
    ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, 0.125, 1e-6, return_lse=True)
    torch.cuda.synchronize()
    tol_o, tol_lse = _k1_tols(ref, torch.bfloat16)
    err_o, err_lse = (out.float() - ref.float()).abs().max().item(), (lse - ref_lse).abs().max().item()
    print(f"K1 {Sq}x{Sk} {layout}: O {err_o:.3e} (tol {tol_o:.3e}), lse {err_lse:.3e}")
    assert out.shape == ref.shape and err_o <= tol_o and err_lse <= tol_lse


@pytest.mark.parametrize("kernel", ["K1", "K3 D64", "K3 D128"])
def test_a_batch_slice_gives_the_bits_of_the_whole_batch(gen, kernel):
    """Each output row depends only on its q row and its (b, h)'s keys in a
    fixed order: the kernel on the first 8 of 16 batch rows gives the bits
    of the first 8 rows of the kernel on all 16 (rollout under CFG against
    replay and training forwards of a part of the batch)."""
    D = 128 if kernel == "K3 D128" else 64
    q, k, v = _fwd_views(gen, 16, 2, 200, 200, D, "head-split")
    if kernel == "K1":
        g = 1.0 + 0.1 * _randn(gen, 200, 64)
        run = lambda *t: A.qknorm_flash_attention(*t, g, g, 0.125, 1e-6, return_lse=True)
    else:
        run = lambda *t: A.flash_attention(*t, return_lse=True)
    out, lse = run(q, k, v)
    part, part_lse = run(q[:8], k[:8], v[:8])
    assert torch.equal(part, out[:8]) and torch.equal(part_lse, lse[:8])


# ---------------------------------------------------------------------------
# K5 / K6 backward kernels, and the forwards' batch slices
# ---------------------------------------------------------------------------

_DT = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


def _norm_case(gen, B, S, D, dtype, out_dtype, per_token=False, k6=False):
    shape = (B, S if per_token else 1, D)
    case = dict(x=_randn(gen, B, S, D, dtype=dtype), mul=1.0 + 0.1 * _randn(gen, *shape),
                add=0.1 * _randn(gen, *shape), g=_randn(gen, B, S, D, dtype=out_dtype))
    if k6:
        case.update(branch=_randn(gen, B, S, D, dtype=dtype), gate=_randn(gen, B, D),
                    g_new=_randn(gen, B, S, D, dtype=dtype))
    return case


def _norm_bar(ref, rel=1e-5):
    """chip_smoke.py's bars against the plain backward: one bf16 ulp of
    max|ref| for bf16 (both round an fp32 value once, from sums in another
    order), else ``rel`` of it (fp16's 2^-11 ulp: 1e-3)."""
    mag = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return _bf16_ulp(mag)
    return (1e-3 if ref.dtype == torch.float16 else rel) * max(mag, 1e-30)


def _k5_backward(c, rms, needs):
    return N.ln_mul_add_backward(c["x"], c["mul"], c["g"], 1e-6, rms, needs)


def _k5_plain_backward(c, rms, needs):
    return N._native_ln_mul_add_backward(c["x"], c["mul"], c["g"], 1e-6, rms, needs)


def _k6_backward(c, needs, plain=False):
    fn = N._native_residual_gate_modulate_backward if plain else N.residual_gate_modulate_backward
    return fn(c["x"], c["branch"], c["gate"], c["mul"], c["g_new"], c["g"], 1e-6, needs)


def _assert_grads_close(got, ref, rounded=()):
    """Each gradient within its bar of the plain backward's, None where the
    plain backward has None; ``rounded``: indices of fp32 gradients rounded to
    another dtype (K6's dgate), held to that dtype's bar."""
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        bar = _norm_bar(b.to(rounded[i]) if i in rounded and rounded[i] is not None else b)
        assert (a.float() - b.float()).abs().max().item() <= bar, i


@pytest.mark.parametrize("x_dt,out_dt,D,fold,rms,per_token", [
    ("bf16", "bf16", 1536, False, False, False),  # the SD3.5-M / Wan AdaLN norms
    ("bf16", "fp32", 1536, False, False, False),  # the Wan head
    ("bf16", "bf16", 1536, True, False, False),   # Wan's affine norm2
    ("fp32", "fp32", 200, True, False, False),    # ragged D, fold
    ("fp32", "fp32", 200, False, True, True),     # RMS, per-token modulation
    ("bf16", "bf16", 1536, False, False, True),   # per-token modulation
    ("fp16", "fp16", 640, False, True, False),
    ("fp32", "bf16", 96, False, False, False),
])
@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False), (False, True, True),
                                   (False, True, False)])
def test_ln_mul_add_backward_matches_plain(gen, x_dt, out_dt, D, fold, rms, per_token, needs):
    """K5's backward kernel against the closed-form plain backward, for each
    variant the forward takes and each subset of gradients (fold and no-fold
    share the backward); one launch counted a call."""
    c = _norm_case(gen, 3, 77, D, _DT[x_dt], _DT[out_dt], per_token)
    before = N.ln_mul_add_backward.launches
    got = _k5_backward(c, rms, needs)
    assert N.ln_mul_add_backward.launches == before + 1
    _assert_grads_close(got, _k5_plain_backward(c, rms, needs))


@pytest.mark.parametrize("dtype", ["bf16", "fp32", "fp16"])
@pytest.mark.parametrize("needs", [(True,) * 5, (True, True, False, False, False),
                                   (False, False, True, True, True), (False, True, False, False, True)])
def test_residual_gate_modulate_backward_matches_plain(gen, dtype, needs):
    """K6's backward kernel against the closed-form plain backward: dx,
    dbranch (x's dtype), dgate (fp32 rounded once to x's dtype), dmul, dadd;
    one launch counted a call."""
    c = _norm_case(gen, 3, 77, 1536, _DT[dtype], _DT[dtype], k6=True)
    before = N.residual_gate_modulate_backward.launches
    got = _k6_backward(c, needs)
    assert N.residual_gate_modulate_backward.launches == before + 1
    _assert_grads_close(got, _k6_backward(c, needs, plain=True), rounded={2: _DT[dtype]})


@pytest.mark.parametrize("which", ["K5", "K6"])
def test_norm_backward_bars_reject_wrong_backwards(gen, which):
    """Negative controls: a backward without the x_hat * mean(g_hat * x_hat)
    term, and one with dmul zeroed, miss the bars the kernel meets."""
    if which == "K5":
        c = _norm_case(gen, 2, 333, 1536, torch.bfloat16, torch.bfloat16)
        got = _k5_backward(c, False, (True,) * 3)
        x32, gm = c["x"].float(), c["g"].float()
        base, dmul_at = 0.0, 1
    else:
        c = _norm_case(gen, 2, 333, 1536, torch.bfloat16, torch.bfloat16, k6=True)
        got = _k6_backward(c, (True,) * 5)
        x32 = (c["x"] + c["gate"][:, None, :].to(torch.bfloat16) * c["branch"]).float()
        gm, base, dmul_at = c["g"].float(), c["g_new"].float(), 3
    r, xhat, raw = N._ln_stats(x32, 1e-6, False)
    wrong = (base + N._ln_dx(gm, c["mul"], r, xhat, torch.full_like(raw, -1.0))).to(torch.bfloat16)
    assert (got[0].float() - wrong.float()).abs().max().item() > _norm_bar(wrong)
    assert got[dmul_at].abs().max().item() > _norm_bar(got[dmul_at])


def test_norm_backwards_are_deterministic(gen):
    """No float atomics: two launches give the same bits, partial sums and
    all."""
    c = _norm_case(gen, 16, 333, 1536, torch.bfloat16, torch.bfloat16, k6=True)
    for run in (lambda: _k5_backward(c, False, (True,) * 3), lambda: _k6_backward(c, (True,) * 5)):
        a, b = run(), run()
        assert all(torch.equal(u, v) for u, v in zip(a, b))


_NORM_EDGES = [(1, 1), (1, 2), (3, 31), (3, 32), (3, 33), (16, 63), (16, 64), (16, 65), (16, 333), (2, 1025)]


@pytest.mark.parametrize("B,S", _NORM_EDGES)
def test_norm_kernels_at_the_chunk_edges(gen, B, S):
    """Row counts at and around the edges of the chunks a program takes
    (``_launch_config``: one row, a ragged last chunk, one chunk a sample): both
    forwards and both backwards against their plain versions."""
    c = _norm_case(gen, B, S, 1536, torch.bfloat16, torch.bfloat16, k6=True)
    out = N.ln_mul_add(c["x"], c["mul"], c["add"], 1e-6, torch.bfloat16, fold=False)
    ref = N._native_ln_mul_add(c["x"], c["mul"], c["add"], 1e-6, torch.bfloat16, False)
    assert (out.float() - ref.float()).abs().max().item() <= _norm_bar(ref)
    xn, xm = N.residual_gate_modulate_rows(c["x"], c["branch"], c["gate"], c["mul"], c["add"], 1e-6,
                                           torch.bfloat16)
    rn, rm = N._native_residual_gate_modulate(c["x"], c["branch"], c["gate"], c["mul"], c["add"], 1e-6,
                                              torch.bfloat16)
    assert torch.equal(xn, rn) and (xm.float() - rm.float()).abs().max().item() <= _norm_bar(rm)
    _assert_grads_close(_k5_backward(c, False, (True,) * 3), _k5_plain_backward(c, False, (True,) * 3))
    _assert_grads_close(_k6_backward(c, (True,) * 5), _k6_backward(c, (True,) * 5, plain=True),
                        rounded={2: torch.bfloat16})


def test_norm_backward_on_constant_and_near_constant_rows(gen):
    """fp32 rows at D=256: constant ones (0.75: sums exact in any order, the
    fast variance exactly 0, x_hat 0) and near-constant ones (2^-6 plus 1e-8
    noise: the fast variance rounds to about +-3e-11, at or below 0 on many
    rows, so r = rsqrt(eps) to 1.5e-5 whatever the sum order): finite, and
    within 1e-4 of the plain backward's max (those rows hold max|dx|)."""
    c = _norm_case(gen, 4, 64, 256, torch.float32, torch.float32, k6=True)
    c["x"][:, 0::4] = 0.75
    c["x"][:, 1::4] = 2.0 ** -6 + 1e-8 * _randn(gen, 4, 16, 256)
    c["branch"][:, 0::4] = c["branch"][:, 1::4] = 0.0
    x32 = c["x"].float()
    raw = (x32 * x32).mean(-1) - x32.mean(-1) ** 2
    assert (raw[:, 1::4] <= 0).any()
    for got, ref, rounded in ((_k5_backward(c, False, (True,) * 3), _k5_plain_backward(c, False, (True,) * 3), {}),
                              (_k6_backward(c, (True,) * 5), _k6_backward(c, (True,) * 5, plain=True), {})):
        for a, b in zip(got, ref):
            assert torch.isfinite(a).all()
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("which", ["K5", "K6"])
def test_norm_forward_batch_slice_gives_the_bits_of_the_whole_batch(gen, which):
    """A row's reduction order follows from D alone, not from the rows a
    program takes (which follow from B * S): the first 4 of 16 batch rows
    alone give the bits of the whole batch's (rollout under CFG against
    replay and training of a part of the batch)."""
    c = _norm_case(gen, 16, 333, 1536, torch.bfloat16, torch.bfloat16, k6=True)
    rows = lambda kernel, B: N._launch_config(kernel, B, 333, 1536)[2]
    assert rows("ln_mul_add", 16) != rows("ln_mul_add", 4) and rows("rgm", 16) != rows("rgm", 4)
    if which == "K5":
        run = lambda n: N.ln_mul_add(c["x"][:n], c["mul"][:n], c["add"][:n], 1e-6, torch.bfloat16, fold=False)
        assert torch.equal(run(4), run(16)[:4])
    else:
        run = lambda n: N.residual_gate_modulate_rows(c["x"][:n], c["branch"][:n], c["gate"][:n], c["mul"][:n],
                                                      c["add"][:n], 1e-6, torch.bfloat16)
        (pn, pm), (wn, wm) = run(4), run(16)
        assert torch.equal(pn, wn[:4]) and torch.equal(pm, wm[:4])


# ---------------------------------------------------------------------------
# The FLUX.1 shapes: K5 at width 3072, K3/K2 at head dim 128 over 1536 tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1024, 512, 1536])
def test_ln_mul_add_at_flux_width_matches_plain(gen, S):
    """K5 at D = 3072 (a 4096 block: 8 warps in the forward, 16 in the
    backward), the FLUX.1 512 px shapes of a B = 2 grad step: the image
    (1024), text (512) and joint (1536) streams. The forward within one bf16
    ulp of max|out| of the plain version, the backward (dx alone, as the grad
    step asks, and every gradient) within chip_smoke.py's bars."""
    c = _norm_case(gen, 2, S, 3072, torch.bfloat16, torch.bfloat16)
    assert N._launch_config("ln_mul_add", 2, S, 3072)[:2] == (4096, 8)
    assert N._launch_config("ln_mul_add_bwd", 2, S, 3072)[:2] == (4096, 16)
    out = N.ln_mul_add(c["x"], c["mul"], c["add"], 1e-6, torch.bfloat16, fold=False)
    ref = N._native_ln_mul_add(c["x"], c["mul"], c["add"], 1e-6, torch.bfloat16, False)
    assert (out.float() - ref.float()).abs().max().item() <= _norm_bar(ref)
    for needs in ((True, False, False), (True, True, True)):
        _assert_grads_close(_k5_backward(c, False, needs), _k5_plain_backward(c, False, needs))


@pytest.mark.parametrize("B,layout", [(2, "joint"), (2, "single"), (8, "joint")])
def test_flash_at_flux_512px_matches_plain(gen, B, layout):
    """K3 and K2a/K2b at the FLUX.1 512 px attention, B H24 S1536 D128 (512
    text + 1024 image tokens): q/k contiguous as RoPE returns them, v the
    concatenated (joint, double blocks) or a head-split view of the single
    blocks' fused (B, S, 21504) projection (single). O and lse within K3's
    bars; the backward (B = 2 only, the grad step's) within K2's."""
    H, S, D = 24, 1536, 128
    q, k = (_randn(gen, B, H, S, D, dtype=torch.bfloat16) for _ in range(2))
    if layout == "single":
        v = _randn(gen, B, S, 3 * H * D + 4 * H * D, dtype=torch.bfloat16)[..., 2 * H * D:3 * H * D]
        v = v.view(B, S, H, D).transpose(1, 2)
    else:
        v = _randn(gen, B, H, S, D, dtype=torch.bfloat16)
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, return_lse=True)
    err_o, err_lse = _k3_errors(out, lse, ref, ref_lse)
    tol_o, tol_lse = _k3_tols(ref)
    assert err_o <= tol_o and err_lse <= tol_lse
    if B != 2:
        return
    dout = _randn(gen, B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    got = A.flash_backward(q, k, v, out, lse, dout, D ** -0.5)
    want = A.flash_backward_plain(q, k, v, out, lse, dout, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - r.float()).abs().max().item() <= _k2_tol(r, torch.bfloat16), name


# ---------------------------------------------------------------------------
# The FLUX.1-Kontext shapes: the joint sequence of 512 text, 1024 target and
# 1024 condition tokens (2560 = 40 tiles of 64) at 512 px
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2048, 512, 2560])
def test_ln_mul_add_at_kontext_widths_matches_plain(gen, S):
    """K5 at D = 3072 at the FLUX.1-Kontext 512 px shapes of a B = 4 grad
    step: the image stream (1024 target + 1024 condition tokens), the text
    (512) and the joint (2560). The forward within one bf16 ulp of max|out|
    of the plain version, the backward within chip_smoke.py's bars."""
    c = _norm_case(gen, 4, S, 3072, torch.bfloat16, torch.bfloat16)
    out = N.ln_mul_add(c["x"], c["mul"], c["add"], 1e-6, torch.bfloat16, fold=False)
    ref = N._native_ln_mul_add(c["x"], c["mul"], c["add"], 1e-6, torch.bfloat16, False)
    assert (out.float() - ref.float()).abs().max().item() <= _norm_bar(ref)
    for needs in ((True, False, False), (True, True, True)):
        _assert_grads_close(_k5_backward(c, False, needs), _k5_plain_backward(c, False, needs))


@pytest.mark.parametrize("B,S,layout", [(4, 2560, "joint"), (4, 2560, "single"), (4, 2560, "padded"),
                                        (2, 2497, "joint")])
def test_flash_at_kontext_2560_matches_plain(gen, B, S, layout):
    """K3 and K2a/K2b at the FLUX.1-Kontext 512 px attention, B H24 S D128:
    q/k contiguous as RoPE returns them, v concatenated (joint), a head-split
    view of the single blocks' fused projection (single), or with the last
    512 condition positions all one row in q, k and v, as the projections of
    the zero tokens that pad a record with fewer references give (padded);
    S 2497 is a 496 px reference (961 condition tokens), a ragged 1-key
    tail. O and lse within K3's bars, the backward within K2's, and the
    backward's two launches give the same bits."""
    H, D = 24, 128
    q, k = (_randn(gen, B, H, S, D, dtype=torch.bfloat16) for _ in range(2))
    if layout == "single":
        v = _randn(gen, B, S, 3 * H * D + 4 * H * D, dtype=torch.bfloat16)[..., 2 * H * D:3 * H * D]
        v = v.view(B, S, H, D).transpose(1, 2)
    else:
        v = _randn(gen, B, H, S, D, dtype=torch.bfloat16)
    if layout == "padded":
        for t in (q, k, v):
            t[:, :, -512:] = t[:, :, -512:-511].clone()
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, return_lse=True)
    err_o, err_lse = _k3_errors(out, lse, ref, ref_lse)
    tol_o, tol_lse = _k3_tols(ref)
    assert err_o <= tol_o and err_lse <= tol_lse
    dout = _randn(gen, B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    got = A.flash_backward(q, k, v, out, lse, dout, D ** -0.5)
    want = A.flash_backward_plain(q, k, v, out, lse, dout, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - r.float()).abs().max().item() <= _k2_tol(r, torch.bfloat16), name
    again = A.flash_backward(q, k, v, out, lse, dout, D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_kernels_launch_from_a_thread_with_no_current_context(gen, kernel):
    """A thread whose first CUDA work is a kernel's launch (an autograd
    worker running the hybrid backend's K3 recompute) holds no current
    context: each entry point binds the device of its q first (F20; without
    it the launch failed with ``invalid argument``)."""
    import threading

    q, k, v = (_randn(gen, 2, 3, 300, 64, dtype=torch.bfloat16) for _ in range(3))
    g = torch.ones(300, 64, device="cuda")
    out, lse = A.flash_attention_plain(q, k, v, 0.125, return_lse=True)
    dout = _randn(gen, 2, 3, 300, 64, dtype=torch.bfloat16)
    run = {"K1": lambda: A.qknorm_flash_attention(q, k, v, g, g, 0.125, 1e-6),
           "K2": lambda: A.flash_backward(q, k, v, out, lse, dout, 0.125),
           "K3": lambda: A.flash_forward(q, k, v, 0.125)}[kernel]
    want = run()
    got, errors = [], []

    def worker():
        try:
            got.append(run())
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert not errors, errors
    flat = lambda x: list(x) if isinstance(x, tuple) else [x]
    assert all(torch.equal(a, b) for a, b in zip(flat(got[0]), flat(want)))


@pytest.mark.parametrize("D,S,strided", [(64, 1357, False), (128, 512, True)])
def test_hybrid_gradients_are_flash_gradients_bit_for_bit(gen, D, S, strided):
    """``hybrid`` on the card: the plain forward within K3's bar of K3's
    plain version, and dq/dk/dv bit-equal to ``flash``'s on the same inputs
    (the same K3 recompute feeds the same K2), K3 launched once, in the
    backward."""
    def heads():
        t = _randn(gen, 2, S, 4, D, dtype=torch.bfloat16).transpose(1, 2) if strided \
            else _randn(gen, 2, 4, S, D, dtype=torch.bfloat16)
        return t.detach().requires_grad_()

    q, k, v = heads(), heads(), heads()
    dout = _randn(gen, 2, S, 4, D, dtype=torch.bfloat16).transpose(1, 2)
    before = A.flash_attention.launches
    out = A.dot_product_attention(q, k, v, backend="hybrid")
    assert A.flash_attention.launches == before
    hybrid = torch.autograd.grad(out, (q, k, v), dout)
    assert A.flash_attention.launches == before + 1
    flash = torch.autograd.grad(A.dot_product_attention(q, k, v, backend="flash"), (q, k, v), dout)
    assert all(torch.equal(a, b) for a, b in zip(hybrid, flash))
    with torch.no_grad():
        ref = A.flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 4 * _bf16_ulp(ref.float().abs().max().item())


# ---------------------------------------------------------------------------
# fp32 at the head dims of the JAX presets: K3, K2a/K2b and K1 at D 16, 64, 128
# ---------------------------------------------------------------------------

def _f32_views(gen, B, H, Sq, Sk, D):
    """q/k contiguous as RoPE or the qk-norm return them, v and dO head-split
    views of (B, S, H*D) projections (the Wan layouts)."""
    q, k = _randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D)
    v = _randn(gen, B, Sk, H, D).transpose(1, 2)
    dout = _randn(gen, B, Sq, H, D).transpose(1, 2)
    return q, k, v, dout


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("Sq,Sk", [(200, 77), (64, 130), (512, 512)])
def test_fp32_flash_matches_plain_at_the_preset_head_dims(gen, D, Sq, Sk):
    """K3 and K2a/K2b in fp32: summation order alone separates them from the
    plain versions (chip_smoke.py's bars: 1e-5 of max|ref| for O and the
    gradients, 1e-5 on lse), with Sq != Sk and ragged key tiles."""
    q, k, v, dout = _f32_views(gen, 2, 3, Sq, Sk, D)
    before = A.flash_attention.launches
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, D ** -0.5, return_lse=True)
    assert A.flash_attention.launches == before + 1 and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-5 * max(ref.abs().max().item(), 1.0)
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * max(ref_lse.abs().max().item(), 1.0)
    got = A.flash_backward(q, k, v, out, lse, dout, D ** -0.5)
    want = A.flash_backward_plain(q, k, v, out, lse, dout, D ** -0.5)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= _k2_tol(w, torch.float32)
    again = A.flash_backward(q, k, v, out, lse, dout, D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", [16, 128])
def test_fp32_qknorm_flash_matches_plain_at_the_preset_head_dims(gen, D):
    q, k, v = (_randn(gen, 2, 3, 197, D) for _ in range(3))
    gq, gk = (1.0 + 0.1 * _randn(gen, 197, D) for _ in range(2))
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, D ** -0.5, 1e-6, return_lse=True)
    ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, D ** -0.5, 1e-6, return_lse=True)
    tol_o, tol_lse = _k1_tols(ref, torch.float32)
    assert (out - ref).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_lse
