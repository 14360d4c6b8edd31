"""PyTorch port, on the card: kernels K1, K5 and K6 against their plain
versions, and the no-fallback guards on CUDA tensors.

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
    q = _randn(gen, 1, 2, 16, 16)  # head dim 16: no kernel variant
    g = torch.ones(16, 16, device="cuda")
    with pytest.raises(ValueError):
        A.qknorm_flash_attention(q, q, q, g, g, 0.25, 1e-6)
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
