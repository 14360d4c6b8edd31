"""PyTorch port, ops: the plain versions behind kernels K1, K5 and K6 against
the JAX package (its plain compositions and its Pallas kernels in interpret
mode), on the same numpy inputs, in fp32 on the CPU.

The CUDA/Triton kernels themselves run only on the card; ``chip_smoke.py``
holds them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_factory_tpu.ops import attention as jattn
from flow_factory_tpu.ops import norms as jnorms
from flow_factory_tpu_torch.ops import attention as tattn
from flow_factory_tpu_torch.ops import norms as tnorms


def _np(x):
    return np.asarray(x, np.float32)


def _two_stream_map(rng, S, D, split):
    a = 1.0 + 0.1 * rng.standard_normal(D)
    b = 1.0 + 0.1 * rng.standard_normal(D)
    return np.concatenate([np.broadcast_to(a, (split, D)), np.broadcast_to(b, (S - split, D))]).astype(np.float32)


# ---------------------------------------------------------------------------
# K1: qk-norm attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,block_k", [(200, 1024), (300, 128), (77, 128)])
def test_qknorm_attention_plain_matches_jax(S, block_k):
    """Port plain version vs the JAX fused kernel in interpret mode (single
    k-block, multi k-block and a ragged S) and vs the JAX plain composition,
    with a two-stream per-position scale map. Bar: atol 3e-5, the JAX
    package's own kernel-vs-composition bar (tests/test_ops.py); the lse
    to 3e-5 against the natural-log lse of the JAX kernel."""
    rng = np.random.default_rng(S)
    B, H, D = 2, 3, 32
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    gq = _two_stream_map(rng, S, D, 64 if S > 64 else 16)
    gk = _two_stream_map(rng, S, D, 64 if S > 64 else 16)
    scale = D ** -0.5

    out, lse = tattn.qknorm_flash_attention(*map(torch.from_numpy, (q, k, v, gq, gk)), scale, 1e-6,
                                            return_lse=True)
    j_out, j_lse = jattn._flash_forward_qkn(*map(jnp.asarray, (q, k, v, gq, gk)), scale, 1e-6, 128, block_k)
    np.testing.assert_allclose(out.numpy(), _np(j_out), atol=3e-5)
    np.testing.assert_allclose(lse.numpy(), _np(j_lse), atol=3e-5)

    qn = jattn._rms_scale(jnp.asarray(q), jnp.asarray(gq), 1e-6)
    kn = jattn._rms_scale(jnp.asarray(k), jnp.asarray(gk), 1e-6)
    ref = jattn.native_attention(qn, kn, jnp.asarray(v), scale=scale)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=3e-5)


def test_rms_scale_matches_jax():
    """The qk-norm itself: fp32 stats, x * (rsqrt(mean(x^2)+eps) * g); 1e-6."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32) * 3
    g = rng.standard_normal((40, 16)).astype(np.float32)
    ours = tattn._rms_scale(torch.from_numpy(x), torch.from_numpy(g), 1e-6).numpy()
    theirs = _np(jattn._rms_scale(jnp.asarray(x), jnp.asarray(g), 1e-6))
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "flash", "native"])
def test_qknorm_dot_product_attention_backends_on_cpu(backend):
    """Every flash-class backend and 'native' compute the plain version on a
    CPU tensor; (D,) scales broadcast to per-position maps."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 8)).astype(np.float32)) for _ in range(3))
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(8)).astype(np.float32))
    out = tattn.qknorm_dot_product_attention(q, k, v, g, g, backend=backend)
    ref = tattn.qknorm_attention_plain(q, k, v, g.expand(9, 8), g.expand(9, 8), 8 ** -0.5, 1e-6)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("backend", ["hybrid", "ring"])
def test_unported_attention_backends_raise(backend):
    q = torch.zeros(1, 1, 4, 8)
    g = torch.ones(8)
    with pytest.raises(NotImplementedError):
        tattn.qknorm_dot_product_attention(q, q, q, g, g, backend=backend)


def test_native_attention_matches_jax_with_mask():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 7, 8)).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((7, 7), bool))[None, None]
    ours = tattn.native_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask)).numpy()
    theirs = _np(jattn.native_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(ours, theirs, atol=1e-6)


# ---------------------------------------------------------------------------
# K5 / K6: norm + modulate
# ---------------------------------------------------------------------------

B, S, D = 2, 37, 128


def _mods(rng, per_token):
    shape = (B, S, D) if per_token else (B, 1, D)
    mul = (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    add = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    return mul, add


@pytest.mark.parametrize("fold,rms", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("per_token", [False, True])
def test_ln_mul_add_matches_jax(fold, rms, per_token):
    """K5's plain version vs ``_native_ln_mul_add`` (1e-6) and vs the Pallas
    kernel in interpret mode with a padded tail (S=37, block 32; 1e-5, the
    fp32 reduction-order bar) — fold, no-fold and rms, per-sample and
    per-token modulation."""
    rng = np.random.default_rng(10 + 2 * fold + rms + 4 * per_token)
    x = (rng.standard_normal((B, S, D)) * 2 + 0.5).astype(np.float32)
    mul, add = _mods(rng, per_token)
    ours = tnorms.ln_mul_add(torch.from_numpy(x), torch.from_numpy(mul), torch.from_numpy(add),
                             1e-6, torch.float32, fold=fold, rms=rms).numpy()
    native = _np(jnorms._native_ln_mul_add(jnp.asarray(x), jnp.asarray(mul), jnp.asarray(add),
                                           1e-6, jnp.float32, fold, rms))
    np.testing.assert_allclose(ours, native, atol=1e-6, rtol=1e-6)
    pallas = _np(jnorms._ln_mul_add_pallas(jnp.asarray(x), jnp.asarray(mul), jnp.asarray(add),
                                           1e-6, jnp.float32, 32, fold, rms))
    np.testing.assert_allclose(ours, pallas, atol=1e-5)


@pytest.mark.parametrize("fn", ["adaln_modulate", "rms_modulate", "fused_layernorm"])
def test_public_norm_wrappers_match_jax(fn):
    """The public wrappers canonicalise (D,), (B, D) operands as the JAX ones do."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    a = rng.standard_normal((B, D) if fn != "fused_layernorm" else (D,)).astype(np.float32)
    b = rng.standard_normal(a.shape).astype(np.float32)
    ours = getattr(tnorms, fn)(*map(torch.from_numpy, (x, a, b))).numpy()
    theirs = _np(getattr(jnorms, fn)(*map(jnp.asarray, (x, a, b))))
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)


def test_residual_gate_modulate_matches_jax():
    """K6's plain version vs ``_native_residual_gate_modulate`` (1e-6) and the
    Pallas kernel in interpret mode (1e-6 on x_new: XLA may contract
    x + g * b into one fma in fp32; 1e-5 on x_mod)."""
    rng = np.random.default_rng(30)
    x, br = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
    gate = rng.standard_normal((B, D)).astype(np.float32)
    mul, add = _mods(rng, False)
    xn, xm = tnorms.residual_gate_modulate_rows(*map(torch.from_numpy, (x, br, gate, mul, add)),
                                                1e-6, torch.float32)
    jxn, jxm = jnorms._native_residual_gate_modulate(*map(jnp.asarray, (x, br, gate, mul, add)),
                                                     1e-6, jnp.float32)
    np.testing.assert_allclose(xn.numpy(), _np(jxn), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(xm.numpy(), _np(jxm), atol=1e-6, rtol=1e-6)
    pxn, pxm = jnorms._rgm_pallas(*map(jnp.asarray, (x, br, gate, mul, add)), 1e-6, jnp.float32, 32)
    np.testing.assert_allclose(xn.numpy(), _np(pxn), atol=1e-6)
    np.testing.assert_allclose(xm.numpy(), _np(pxm), atol=1e-5)


def test_residual_gate_modulate_bf16_rounds_like_eager():
    """bf16: x_new = x + bf16(bf16(gate) * branch), each rounding where eager
    rounds — equal to the JAX composition bit for bit."""
    rng = np.random.default_rng(31)
    x, br = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
    gate = rng.standard_normal((B, D)).astype(np.float32)
    shift, scale = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    xt, brt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, br))
    xn, xm = tnorms.residual_gate_modulate(xt, brt, *map(torch.from_numpy, (gate, shift, scale)))
    jxn, jxm = jnorms.residual_gate_modulate(jnp.asarray(x, jnp.bfloat16), jnp.asarray(br, jnp.bfloat16),
                                             *map(jnp.asarray, (gate, shift, scale)))
    np.testing.assert_array_equal(xn.float().numpy(), _np(jxn.astype(jnp.float32)))
    # x_mod: fp32 stats in a different reduction order, one bf16 rounding
    np.testing.assert_allclose(xm.float().numpy(), _np(jxm.astype(jnp.float32)), atol=2 ** -5)


def test_cpu_tensors_take_the_plain_path_without_counting():
    """A CPU tensor never counts as a kernel launch."""
    from flow_factory_tpu_torch import ops

    before = ops.launch_counts()
    x = torch.randn(1, 4, 8)
    ops.adaln_modulate(x, torch.zeros(1, 8), torch.zeros(1, 8))
    ops.residual_gate_modulate(x, x, torch.ones(1, 8), torch.zeros(1, 8), torch.zeros(1, 8))
    q = torch.randn(1, 2, 5, 8)
    ops.qknorm_dot_product_attention(q, q, q, torch.ones(8), torch.ones(8))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["attention", "ln_mul_add", "rgm"])
def test_kernel_wrappers_refuse_non_cuda_non_cpu_tensors(wrapper):
    """A tensor that is neither CPU nor CUDA (here: meta) raises instead of
    silently computing the plain version."""
    x = torch.empty(1, 2, 4, 64, device="meta")
    with pytest.raises((ValueError, TypeError)):
        if wrapper == "attention":
            g = torch.empty(4, 64, device="meta")
            tattn.qknorm_flash_attention(x, x, x, g, g, 0.125, 1e-6)
        elif wrapper == "ln_mul_add":
            m = torch.empty(1, 1, 64, device="meta")
            tnorms.ln_mul_add(x[0], m, m, 1e-6, torch.float32, fold=False)
        else:
            m = torch.empty(1, 1, 64, device="meta")
            tnorms.residual_gate_modulate_rows(x[0], x[0], torch.empty(1, 64, device="meta"), m, m,
                                               1e-6, torch.float32)
