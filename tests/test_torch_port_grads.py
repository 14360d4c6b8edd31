"""PyTorch port, gradients through the kernels: the plain flash backward
(K2a/K2b), the K1 backward that chains it with the qk-norm's VJP, and the
K5/K6 backwards, against the JAX package on the same numpy inputs, on the
CPU. The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them here; the CUDA kernels themselves run only on the card
(``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_factory_tpu.ops import attention as jattn
from flow_factory_tpu.ops import norms as jnorms
from flow_factory_tpu_torch.ops import attention as tattn
from flow_factory_tpu_torch.ops import norms as tnorms

SCALE = 64 ** -0.5


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


def _attention_inputs(seed, B, H, Sq, Sk, D=64):
    """q, k, v and dO (or any (B, H, Sq, D) cotangent), numpy fp32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    dout = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,D", [
    pytest.param(130, 130, 64, id="130-130"),
    pytest.param(200, 200, 64, id="200-200"),
    pytest.param(77, 200, 64, id="77-200"),
    pytest.param(300, 77, 128, id="300-77-d128"),   # Wan's head dim, ragged q rows and keys
    pytest.param(130, 200, 128, id="130-200-d128"),
])
def test_flash_backward_plain_matches_jax(dtype, Sq, Sk, D):
    """``flash_backward_plain`` vs JAX ``_flash_backward`` (interpret mode,
    128-row blocks, so every case pads a ragged tail) on dq, dk and dv, at
    head dim 64 (SD3.5) and 128 (Wan). fp32: 1e-6 (summation order only;
    3.6e-7 seen). bf16: both round q·scale·log2e, ds and p to bf16 before
    their products, so an element differs only where a value near a rounding
    boundary rounds the other way after another summation order; the bar is
    1 bf16 ulp of max|ref| (half an ulp seen)."""
    q, k, v, dout = _attention_inputs(Sq * 1000 + Sk, 1, 2, Sq, Sk, D)
    scale = D ** -0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, dout))
    out, lse = tattn.native_attention(tq, tk, tv, scale=scale, return_lse=True)
    ours = tattn.flash_backward_plain(tq, tk, tv, out, lse, tdo, scale)
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    theirs = jattn._flash_backward(as_j(tq), as_j(tk), as_j(tv), as_j(out), jnp.asarray(lse.numpy()),
                                   as_j(tdo), scale, 128, 128)
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs):
        ref = np.asarray(b.astype(jnp.float32))
        assert a.dtype == tdt and a.shape == ref.shape
        tol = 1e-6 if dtype == "float32" else _bf16_ulp(np.abs(ref).max())
        np.testing.assert_allclose(a.float().numpy(), ref, atol=tol, rtol=0, err_msg=name)


def _jax_qknorm_grads(q, k, v, gq, gk, w):
    """jax.grad of sum(O * w) through the JAX package's fused K1 (its custom
    VJP runs the Pallas backward kernels in interpret mode)."""
    loss = lambda *a: jnp.sum(jattn._qknorm_flash(*a, SCALE, 1e-6, 128, 128) * w)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, gq, gk)))


def test_qknorm_attention_gradients_match_jax():
    """The port's ``qknorm_dot_product_attention`` on CPU tensors (autograd
    through the plain version) and its K1 backward, ``qknorm_flash_backward``
    (the plain K2 chained with the norm's VJP, as on the card), against
    jax.grad of the JAX fused K1: dq, dk, dv, dγq, dγk in fp32 within 1e-5
    (1.5e-6 seen; the JAX package's own bar, tests/test_ops.py, is 2e-4)."""
    B, H, S, D = 1, 2, 130, 64
    q, k, v, w = _attention_inputs(11, B, H, S, S)
    rng = np.random.default_rng(12)
    gq = (1.0 + 0.1 * rng.standard_normal((S, D))).astype(np.float32)
    gk = (1.0 + 0.1 * rng.standard_normal((S, D))).astype(np.float32)
    theirs = [np.asarray(g) for g in _jax_qknorm_grads(q, k, v, gq, gk, w)]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, gq, gk)]
    out = tattn.qknorm_dot_product_attention(*leaves, scale=SCALE, eps=1e-6, backend="auto")
    autograd = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)

    tq, tk, tv, tgq, tgk = (torch.from_numpy(a) for a in (q, k, v, gq, gk))
    o, lse = tattn.qknorm_attention_plain(tq, tk, tv, tgq, tgk, SCALE, 1e-6, return_lse=True)
    function_bwd = tattn.qknorm_flash_backward(tq, tk, tv, tgq, tgk, o, lse, torch.from_numpy(w),
                                               SCALE, 1e-6, (True,) * 5)
    for ours in (autograd, function_bwd):
        for name, a, b in zip(("dq", "dk", "dv", "dgq", "dgk"), ours, theirs):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0, err_msg=name)


def test_qknorm_backward_returns_only_what_is_needed():
    """Under LoRA the γ maps need no gradient: the backward returns None for
    them and still gives dq, dk and dv."""
    q, k, v, w = (torch.from_numpy(a) for a in _attention_inputs(3, 1, 1, 70, 70))
    g = torch.ones(70, 64)
    o, lse = tattn.qknorm_attention_plain(q, k, v, g, g, SCALE, 1e-6, return_lse=True)
    grads = tattn.qknorm_flash_backward(q, k, v, g, g, o, lse, w, SCALE, 1e-6,
                                        (True, True, True, False, False))
    assert grads[3] is None and grads[4] is None
    assert all(t.shape == q.shape and torch.isfinite(t).all() for t in grads[:3])


def _norm_case(which, seed=0):
    rng = np.random.default_rng(seed)
    B, S, D = 2, 33, 96
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    mul = (1.0 + 0.1 * rng.standard_normal((B, 1, D))).astype(np.float32)
    add = (0.1 * rng.standard_normal((B, 1, D))).astype(np.float32)
    if which == "rgm":
        branch = rng.standard_normal((B, S, D)).astype(np.float32)
        gate = rng.standard_normal((B, D)).astype(np.float32)
        inputs = (x, branch, gate, mul, add)
        cots = tuple(rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
        jplain = lambda *a: jnorms._native_residual_gate_modulate(*a, 1e-6, jnp.float32)
        tplain = lambda *a: tnorms._native_residual_gate_modulate(*a, 1e-6, torch.float32)
    else:
        fold, rms = {"ln": (False, False), "ln-fold": (True, False), "rms": (False, True)}[which]
        inputs = (x, mul, add)
        cots = rng.standard_normal((B, S, D)).astype(np.float32)
        jplain = lambda *a: jnorms._native_ln_mul_add(*a, 1e-6, jnp.float32, fold, rms)
        tplain = lambda *a: tnorms._native_ln_mul_add(*a, 1e-6, torch.float32, fold, rms)
    return inputs, cots, jplain, tplain


@pytest.mark.parametrize("which", ["ln", "ln-fold", "rms", "rgm"])
def test_norm_gradients_match_jax(which):
    """K5/K6 backward: the VJP of the plain composition (JAX
    ``_fused_ln_mul_add_bwd`` / ``_rgm_fused_bwd``), both as autograd through
    the CPU wrapper and as ``_recompute_vjp`` (the CUDA Functions' backward),
    against jax.vjp of the JAX plain composition: fp32, 1e-6 relative to each
    gradient's max."""
    inputs, cots, jplain, tplain = _norm_case(which)
    _, vjp = jax.vjp(jplain, *map(jnp.asarray, inputs))
    theirs = [np.asarray(g) for g in vjp(jax.tree.map(jnp.asarray, cots))]

    t_in = [torch.from_numpy(a) for a in inputs]
    t_cot = tuple(map(torch.from_numpy, cots)) if isinstance(cots, tuple) else torch.from_numpy(cots)
    recomputed = tnorms._recompute_vjp(tplain, t_in, (True,) * len(t_in), t_cot)
    leaves = [t.clone().requires_grad_() for t in t_in]
    if which == "rgm":
        outs = tnorms.residual_gate_modulate_rows(*leaves, 1e-6, torch.float32)
        autograd = torch.autograd.grad(outs, leaves, t_cot)
    else:
        fold, rms = {"ln": (False, False), "ln-fold": (True, False), "rms": (False, True)}[which]
        out = tnorms.ln_mul_add(*leaves, 1e-6, torch.float32, fold=fold, rms=rms)
        autograd = torch.autograd.grad(out, leaves, t_cot)
    for ours in (recomputed, autograd):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * max(1.0, np.abs(b).max()), rtol=0)
