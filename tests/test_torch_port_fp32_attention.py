"""PyTorch port, on the CPU: the fp32 attention kernels' plain versions at
the head dims of the JAX presets (16 at every tiny preset, 64 and 128)
against the JAX package's Pallas kernels, run in interpret mode as the JAX
package's own tests run them off the TPU, on the same seeded numpy inputs;
and the admission table that says which (dtype, head dim) pairs each CUDA
kernel takes. On the card ``chip_smoke.py`` holds each kernel to these plain
versions; here the plain versions are held to JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu.ops import attention as J
from flow_factory_tpu_torch.ops import attention as T

#: 128-row blocks in both directions, so every case pads a ragged tail and
#: the longer one runs the multi-block online softmax
BLOCK = 128
#: (Sq, Sk): q rows and keys that differ, a ragged last key block; keys over
#: two blocks, q rows under one
SHAPES = ((200, 77), (77, 256))


def _inputs(seed: int, Sq: int, Sk: int, D: int, B: int = 1, H: int = 2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Sk, D)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("Sq,Sk", SHAPES)
@pytest.mark.parametrize("D", [16, 64, 128])
def test_k3_plain_matches_the_jax_kernel_in_fp32(D, Sq, Sk):
    """``flash_attention_plain`` against JAX ``_flash_forward`` in fp32: O
    within 1e-6 and the natural-log lse (about 5 here) within 2e-6, 4 ulp
    (the two sum in another order, over one softmax against JAX's online
    one; 3.3e-7 and 4.8e-7 seen). The plain version is what the card holds
    the fp32 K3 against."""
    q, k, v, _ = _inputs(D * 1000 + Sq + Sk, Sq, Sk, D)
    scale = D ** -0.5
    out, lse = T.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale, return_lse=True)
    j_out, j_lse = J._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), scale, BLOCK, BLOCK)
    assert out.dtype == torch.float32 and out.shape == j_out.shape and lse.shape == j_lse.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-6, rtol=0)


@pytest.mark.parametrize("Sq,Sk", SHAPES)
@pytest.mark.parametrize("D", [16, 64, 128])
def test_k2_plain_matches_the_jax_kernels_in_fp32(D, Sq, Sk):
    """``flash_backward_plain`` against JAX ``_flash_backward`` (K2a and K2b
    in interpret mode) on the O and lse of the JAX forward: dq, dk and dv
    within 2e-6 of max(max|ref|, 1) (summation order only; at most 6e-7 of
    it seen, dk at D=16)."""
    q, k, v, dout = _inputs(D * 1000 + Sq + Sk + 1, Sq, Sk, D)
    scale = D ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, dout))
    j_out, j_lse = J._flash_forward(jq, jk, jv, scale, BLOCK, BLOCK)
    theirs = J._flash_backward(jq, jk, jv, j_out, j_lse, jdo, scale, BLOCK, BLOCK)
    ours = T.flash_backward_plain(*(torch.from_numpy(np.array(a)) for a in (q, k, v, j_out, j_lse, dout)), scale)
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs):
        ref = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == ref.shape, name
        np.testing.assert_allclose(a.numpy(), ref, atol=2e-6 * max(np.abs(ref).max(), 1.0), rtol=0, err_msg=name)


def test_k1_plain_matches_the_jax_fused_kernel_at_the_tiny_head_dim():
    """``qknorm_attention_plain`` (the RMS scale, then native attention)
    against JAX ``_flash_forward_qkn`` (K1 in interpret mode, the norm
    fused with scale·log2e folded into γq) at head dim 16, the tiny SD3.5's:
    O within 1e-6 and lse within 2e-6 (the fold rounds q otherwise; 2.4e-7
    and 4.8e-7 seen)."""
    q, k, v, _ = _inputs(16, 130, 130, 16)
    rng = np.random.default_rng(17)
    gq, gk = ((1.0 + 0.1 * rng.standard_normal((130, 16))).astype(np.float32) for _ in range(2))
    scale, eps = 16 ** -0.5, 1e-6
    out, lse = T.qknorm_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, gq, gk)), scale, eps,
                                        return_lse=True)
    j_out, j_lse = J._flash_forward_qkn(*(jnp.asarray(a) for a in (q, k, v, gq, gk)), scale, eps, BLOCK, BLOCK)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-6, rtol=0)


#: the pairs with a CUDA kernel: bf16 on the tensor cores at the bf16
#: models' head dims (K1 at SD3.5's 64), fp32 on the CUDA cores at the JAX
#: presets' 16, 64 and 128; fp16 and every other head dim raise
WANT = {("K1", torch.bfloat16): (64,), ("K3", torch.bfloat16): (64, 128), ("K2a", torch.bfloat16): (64, 128),
        ("K2b", torch.bfloat16): (64, 128)}


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("kernel", ["K1", "K3", "K2a", "K2b"])
def test_the_admission_table(kernel, dtype, D):
    """Which (kernel, dtype, head dim) the CUDA wrappers admit: a pure
    function of the three, read by every wrapper, so that K3's forward and
    K2's backward admit the same pairs and the JAX presets' fp32 runs (D 16,
    64, 128) all have kernels."""
    want = (16, 64, 128) if dtype == torch.float32 else WANT.get((kernel, dtype), ())
    assert T.admitted(kernel, dtype, D) == (D in want)
    if kernel == "K3":
        assert all(T.admitted(k2, dtype, D) == T.admitted("K3", dtype, D) for k2 in ("K2a", "K2b"))
