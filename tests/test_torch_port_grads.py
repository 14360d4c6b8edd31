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
from torch_port_threads import one_torch_thread  # noqa: F401

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


_LN_FLAGS = {"ln": (False, False), "ln-fold": (True, False), "rms": (False, True)}


def _plain_backward(which, t_in, t_cot, needs=None):
    """The closed-form plain backward of a ``_norm_case``, every gradient
    asked for unless ``needs`` says otherwise."""
    needs = needs or (True,) * len(t_in)
    if which == "rgm":
        x, br, gate, mul, add = t_in
        return tnorms.residual_gate_modulate_backward(x, br, gate, mul, *t_cot, 1e-6, needs)
    x, mul, add = t_in
    return tnorms.ln_mul_add_backward(x, mul, t_cot, 1e-6, _LN_FLAGS[which][1], needs)


def _wrapper(which, leaves, out_dtype=torch.float32):
    if which == "rgm":
        return tnorms.residual_gate_modulate_rows(*leaves, 1e-6, out_dtype)
    fold, rms = _LN_FLAGS[which]
    return tnorms.ln_mul_add(*leaves, 1e-6, out_dtype, fold=fold, rms=rms)


@pytest.mark.parametrize("which", ["ln", "ln-fold", "rms", "rgm"])
def test_norm_gradients_match_jax(which):
    """K5/K6 backward: the closed-form plain backward (what the CUDA kernels
    are held to, JAX ``_fused_ln_mul_add_bwd`` / ``_rgm_fused_bwd``) and
    autograd through the CPU wrapper (the same Function, plain halves),
    against jax.vjp of the JAX plain composition: fp32, 1e-6 relative to
    each gradient's max."""
    inputs, cots, jplain, tplain = _norm_case(which)
    _, vjp = jax.vjp(jplain, *map(jnp.asarray, inputs))
    theirs = [np.asarray(g) for g in vjp(jax.tree.map(jnp.asarray, cots))]

    t_in = [torch.from_numpy(a) for a in inputs]
    t_cot = tuple(map(torch.from_numpy, cots)) if isinstance(cots, tuple) else torch.from_numpy(cots)
    closed_form = _plain_backward(which, t_in, t_cot)
    leaves = [t.clone().requires_grad_() for t in t_in]
    autograd = torch.autograd.grad(_wrapper(which, leaves), leaves, t_cot)
    for ours in (closed_form, autograd):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * max(1.0, np.abs(b).max()), rtol=0)


@pytest.mark.parametrize("which", ["ln", "rms"])
def test_norm_gradients_match_jax_with_a_per_token_modulation(which):
    """A (B, S, D) modulation: dmul and dadd are the un-summed products, one
    row each; fp32, 1e-6 relative to each gradient's max."""
    rng = np.random.default_rng(5)
    B, S, D = 2, 17, 80
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    mul = (1.0 + 0.1 * rng.standard_normal((B, S, D))).astype(np.float32)
    add = (0.1 * rng.standard_normal((B, S, D))).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    rms = which == "rms"
    _, vjp = jax.vjp(lambda *a: jnorms._native_ln_mul_add(*a, 1e-6, jnp.float32, False, rms),
                     *map(jnp.asarray, (x, mul, add)))
    theirs = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ours = tnorms.ln_mul_add_backward(*map(torch.from_numpy, (x, mul)), torch.from_numpy(g), 1e-6, rms,
                                      (True,) * 3)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * np.abs(b).max(), rtol=0)


def test_norm_gradients_match_jax_for_the_wan_head():
    """The Wan head: x bf16, output and cotangent fp32. dx is computed in fp32
    and rounded once to bf16 in both packages, so it differs only where the
    fp32 stats' summation order moves a value across a rounding boundary: the
    bar is 1 bf16 ulp of max|dx|. dmul/dadd stay fp32: 1e-6 relative."""
    rng = np.random.default_rng(6)
    B, S, D = 2, 33, 96
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    mul = (1.0 + 0.1 * rng.standard_normal((B, 1, D))).astype(np.float32)
    add = (0.1 * rng.standard_normal((B, 1, D))).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _, vjp = jax.vjp(lambda *a: jnorms._native_ln_mul_add(*a, 1e-6, jnp.float32, False),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(mul), jnp.asarray(add))
    theirs = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g))]
    closed_form = tnorms.ln_mul_add_backward(xb, torch.from_numpy(mul), torch.from_numpy(g), 1e-6, False,
                                             (True,) * 3)
    leaves = [xb.clone().requires_grad_(), torch.from_numpy(mul).requires_grad_(),
              torch.from_numpy(add).requires_grad_()]
    autograd = torch.autograd.grad(tnorms.ln_mul_add(*leaves, 1e-6, torch.float32, fold=False), leaves,
                                   torch.from_numpy(g))
    for ours in (closed_form, autograd):
        assert ours[0].dtype == torch.bfloat16 and ours[1].dtype == ours[2].dtype == torch.float32
        np.testing.assert_allclose(ours[0].float().numpy(), theirs[0], rtol=0,
                                   atol=_bf16_ulp(np.abs(theirs[0]).max()))
        for a, b in zip(ours[1:], theirs[1:]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize("which", ["ln", "rms", "rgm"])
def test_norm_backward_returns_none_where_no_gradient_is_needed(which):
    """Each subset of ``needs``: None exactly where unset, and every gradient
    that is set equal to the one computed with all set."""
    inputs, cots, _, _ = _norm_case(which, seed=3)
    t_in = [torch.from_numpy(a) for a in inputs]
    t_cot = tuple(map(torch.from_numpy, cots)) if isinstance(cots, tuple) else torch.from_numpy(cots)
    full = _plain_backward(which, t_in, t_cot)
    for mask in range(2 ** len(t_in)):
        needs = tuple(bool(mask >> i & 1) for i in range(len(t_in)))
        got = _plain_backward(which, t_in, t_cot, needs)
        assert len(got) == len(t_in)
        for need, a, b in zip(needs, got, full):
            assert (a is None) == (not need)
            if need:
                assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["ln", "rgm"])
def test_norm_gradients_match_jax_on_a_constant_row(which):
    """A constant row (x - mean exactly 0, fast variance exactly 0 in either
    package): r = rsqrt(eps) and dx = r * (g_hat - mean(g_hat)) where x's
    gradient is asked; the clamp's tie (PyTorch passes the gradient at 0,
    JAX halves it) meets a zero x_hat, so both packages agree: fp32, 1e-6
    relative."""
    inputs, cots, jplain, _ = _norm_case(which, seed=4)
    inputs = list(inputs)
    inputs[0] = inputs[0].copy()
    inputs[0][0, 5] = 0.75
    inputs[0][1, 0] = -2.5
    if which == "rgm":  # branch 0 on those rows: x_new is x there
        inputs[1] = inputs[1].copy()
        inputs[1][0, 5] = inputs[1][1, 0] = 0.0
    _, vjp = jax.vjp(jplain, *map(jnp.asarray, inputs))
    theirs = [np.asarray(g) for g in vjp(jax.tree.map(jnp.asarray, cots))]
    t_cot = tuple(map(torch.from_numpy, cots)) if isinstance(cots, tuple) else torch.from_numpy(cots)
    ours = _plain_backward(which, [torch.from_numpy(a) for a in inputs], t_cot)
    for a, b in zip(ours, theirs):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * max(1.0, np.abs(b).max()), rtol=0)


def _clamped_rows():
    """fp32 rows of 64 near-constant values around 3.0 whose fast variance
    E[x^2] - E[x]^2, as torch computes it on the CPU, rounds to exactly 0 and
    to below 0 although the values differ: the clamp decides there, and
    x_hat = (x - mean) * rsqrt(eps) is far from 0."""
    rng = np.random.default_rng(7)
    rows = {}
    while len(rows) < 2:
        row = (3.0 + 2e-4 * rng.standard_normal(64)).astype(np.float32)
        t = torch.from_numpy(row)
        raw = (torch.mean(t * t) - torch.mean(t) * torch.mean(t)).item()
        if raw == 0.0:
            rows.setdefault("zero", row)
        elif raw < 0.0:
            rows.setdefault("negative", row)
    return rows


def test_norm_plain_backward_follows_the_clamp_on_rows_whose_variance_rounds_away():
    """Where the fast variance rounds to 0 (the clamp passes the gradient, as
    torch.clamp does at equality) or below 0 (it stops it), the closed-form
    plain backward equals autograd through the plain forward: the same torch
    ops give both the same stats, and the x_hat term (x_hat ~ 1e-1 here)
    moves dx far beyond the bar where it would be taken wrongly: fp32, 1e-5
    relative to max|dx| (the two round differently inside the terms)."""
    rows = _clamped_rows()
    rng = np.random.default_rng(8)
    x = torch.from_numpy(np.stack([rows["zero"], rows["negative"]])[:, None, :])  # (2, 1, 64)
    mul = torch.from_numpy((1.0 + 0.1 * rng.standard_normal((2, 1, 64))).astype(np.float32))
    add = torch.zeros(2, 1, 64)
    g = torch.from_numpy(rng.standard_normal((2, 1, 64)).astype(np.float32))
    leaves = [x.clone().requires_grad_(), mul.clone().requires_grad_(), add.clone().requires_grad_()]
    want = torch.autograd.grad(tnorms._native_ln_mul_add(*leaves, 1e-6, torch.float32, False), leaves, g)
    got = tnorms.ln_mul_add_backward(x, mul, g, 1e-6, False, (True,) * 3)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    # the x_hat term is what the clamp decides on: dropping it on the row at 0,
    # or keeping it on the row below 0, misses the bar
    r, xhat, raw = tnorms._ln_stats(x, 1e-6, False)
    wrong = tnorms._ln_dx(g, mul, r, xhat, torch.where(raw >= 0, -1.0, 1.0))
    assert xhat.abs().max().item() > 1e-2
    for row in range(2):
        assert (wrong[row] - want[0][row]).abs().max().item() > 1e-3 * want[0][row].abs().max().item()


@pytest.mark.parametrize("which", ["adaln", "fold", "rgm"])
def test_cpu_wrappers_and_backward_functions_give_gradients_in_the_shapes_autograd_expects(which):
    """The public CPU wrappers run the K5/K6 Functions (a ``_LnMulAddBackward``
    or ``_ResidualGateModulateBackward`` node) and their gradients come back in
    each input's shape and dtype (bf16 activations, fp32 modulation, a (D,)
    affine weight, (B, D) AdaLN chunks); the backward functions themselves
    return (B, 1, D) modulation gradients."""
    rng = np.random.default_rng(9)
    B, S, D = 2, 9, 48
    t = lambda *shape, dtype=torch.float32: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype).requires_grad_()
    x = t(B, S, D, dtype=torch.bfloat16)
    if which == "rgm":
        leaves = [x, t(B, S, D, dtype=torch.bfloat16), t(B, D), t(B, D), t(B, D)]
        outs = tnorms.residual_gate_modulate(*leaves)
        assert type(outs[0].grad_fn).__name__ == "_ResidualGateModulateBackward"
        loss = sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs))
    else:
        leaves = [x, t(D), t(D)] if which == "fold" else [x, t(B, D, dtype=torch.bfloat16), t(B, D)]
        fn = tnorms.fused_layernorm if which == "fold" else tnorms.adaln_modulate
        out = fn(*leaves, out_dtype=torch.float32)
        assert type(out.grad_fn).__name__ == "_LnMulAddBackward"
        loss = (out * torch.linspace(-1, 1, D)).sum()
    grads = torch.autograd.grad(loss, leaves)
    for leaf, grad in zip(leaves, grads):
        assert grad.shape == leaf.shape and grad.dtype == leaf.dtype and torch.isfinite(grad.float()).all()
    xs = x.detach()
    mul = torch.ones(B, 1, D)
    if which == "rgm":
        got = tnorms.residual_gate_modulate_backward(xs, xs, torch.ones(B, D), mul, xs, xs.float(), 1e-6,
                                                     (True,) * 5)
        want = [(B, S, D), (B, S, D), (B, D), (B, 1, D), (B, 1, D)]
    else:
        got = tnorms.ln_mul_add_backward(xs, mul, xs.float(), 1e-6, False, (True,) * 3)
        want = [(B, S, D), (B, 1, D), (B, 1, D)]
    assert [tuple(g.shape) for g in got] == want
