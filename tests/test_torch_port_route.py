"""PyTorch port, on the CPU: the attention dispatcher's routing
(``attention_route``) held to the JAX ``dot_product_attention`` rule
(``flow_factory_tpu/ops/attention.py:955-975``) for every backend, with a
dense mask or none, on the CPU and on an accelerator. The JAX side is
observed, not restated: its ``dot_product_attention`` runs on the same
seeded numpy inputs, off the TPU as it is and with ``_on_tpu`` patched true
for the accelerator column (its Pallas kernel then runs in interpret mode),
and its outcome is read as the error it raises, or ``native`` where the
result is bit-equal to its ``native_attention``, else ``flash``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_factory_tpu.ops import attention as J
from flow_factory_tpu_torch.ops import attention as T

BACKENDS = ("auto", "flash", "splash", "native", "hybrid", "ring", "bogus")


def _inputs(head_dim: int = 64):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 16, head_dim)).astype(np.float32) for _ in range(3))
    mask = rng.random((1, 1, 16, 16)) > 0.3
    mask[..., 0] = True  # every row keeps a key
    return q, k, v, mask


def _outcome(call):
    try:
        return call()
    except NotImplementedError:
        return "NotImplementedError"
    except ValueError:
        return "ValueError"


def _jax_route(backend: str, masked: bool, accelerator: bool, monkeypatch, head_dim: int = 64) -> str:
    if accelerator:
        monkeypatch.setattr(J, "_on_tpu", lambda: True)
    q, k, v, mask = (jnp.asarray(a) for a in _inputs(head_dim))
    m = mask if masked else None
    out = _outcome(lambda: J.dot_product_attention(q, k, v, mask=m, backend=backend))
    if isinstance(out, str):
        return out
    return "native" if np.array_equal(np.asarray(out), np.asarray(J.native_attention(q, k, v, mask=m))) else "flash"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_attention_route_follows_the_jax_rule(backend, masked, device, monkeypatch):
    """auto with a mask is native on every device; flash/splash/hybrid/ring
    with a mask raise on every device; auto without one takes K3 on CUDA and
    native on the CPU. hybrid without a mask is its own route on every
    device (the plain forward, K3 and K2 in the backward): its forward is
    bit-equal to the port's ``native_attention``, while JAX's, XLA's fused
    attention, is read as ``flash`` by this probe; its gate and gradients
    are held to JAX's in tests/test_torch_port_hybrid.py. ring without a
    mask is its own route, whose dispatch without a ring runs what flash
    runs on every device (JAX's ``_ring_dispatch`` falls back to native off
    the TPU and to its flash kernel on it)."""
    port = _outcome(lambda: T.attention_route(backend, masked, device, 64))
    want = _jax_route(backend, masked, device == "cuda", monkeypatch)
    if backend == "hybrid" and not masked:
        assert want in ("native", "flash") and port == "hybrid"
        q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
        assert torch.equal(T.dot_product_attention(q, k, v, backend="hybrid"), T.native_attention(q, k, v))
    elif backend == "ring" and not masked:
        assert want == ("flash" if device == "cuda" else "native") and port == "ring"
        q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
        assert torch.equal(T.dot_product_attention(q, k, v, backend="ring"),
                           T.dot_product_attention(q, k, v, backend="flash"))
    else:
        assert port == want, (backend, masked, device, port, want)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head_dim", [256, 257, 320])
def test_auto_route_follows_the_jax_rule_at_large_head_dims(head_dim, masked, device, monkeypatch):
    """``auto`` takes the head dim into account as JAX does: on the
    accelerator without a mask it is ``flash`` up to head dim 256 and
    ``native`` above it (K3 would raise there); with a mask, or on the CPU,
    it is ``native`` at every head dim. ``dot_product_attention`` passes
    ``q``'s last dim to the route: above 256 on the CPU it is bit-equal to
    ``native_attention``."""
    port = T.attention_route("auto", masked, device, head_dim)
    assert port == _jax_route("auto", masked, device == "cuda", monkeypatch, head_dim), (head_dim, masked, device)
    assert port == ("flash" if device == "cuda" and not masked and head_dim <= 256 else "native")
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(head_dim))
    assert torch.equal(T.dot_product_attention(q, k, v, backend="auto"), T.native_attention(q, k, v))


@pytest.mark.parametrize("backend", ["auto", "flash", "splash", "native", "hybrid"])
@pytest.mark.parametrize("head_dim", [64, 256, 257, 320])
def test_qknorm_route_follows_the_jax_rule_at_large_head_dims(head_dim, backend, monkeypatch):
    """The qk-norm attention takes K1 where JAX takes its fused kernel on the
    accelerator (``fused_qknorm_eligible`` with ``_on_tpu`` patched true: a
    flash-class backend at head dim 256 or less) and nowhere else; above 256
    ``auto`` composes the RMS scale with native attention, as JAX does, and
    never reaches K1's wrapper (on the card K1 would raise there). On the
    CPU the result is bit-equal to the port's composition and within 4e-6
    of the JAX package's ``qknorm_dot_product_attention`` (its native path
    off the TPU: XLA's and PyTorch's CPU matmul, rsqrt and exp differ in the
    last bits over 257-320 terms; 1.1e-6 seen)."""
    monkeypatch.setattr(J, "_on_tpu", lambda: True)
    assert T.qknorm_fused(backend, head_dim) == J.fused_qknorm_eligible(backend, head_dim)
    if backend not in ("auto", "native") or head_dim <= 256:
        return
    monkeypatch.setattr(J, "_on_tpu", lambda: False)
    q, k, v, _ = _inputs(head_dim)
    g = np.random.default_rng(1).uniform(0.5, 1.5, (2, 16, head_dim)).astype(np.float32)
    tq, tk, tv, tgq, tgk = (torch.from_numpy(a) for a in (q, k, v, g[0], g[1]))

    def no_k1(*args, **kwargs):
        raise AssertionError("K1's wrapper reached above head dim 256")

    monkeypatch.setattr(T, "qknorm_flash_attention", no_k1)
    out = T.qknorm_dot_product_attention(tq, tk, tv, tgq, tgk, backend=backend)
    qn, kn = (T._rms_scale(t, gt, 1e-6) for t, gt in ((tq, tgq), (tk, tgk)))
    assert torch.equal(out, T.native_attention(qn, kn, tv))
    ref = J.qknorm_dot_product_attention(*(jnp.asarray(a) for a in (q, k, v, g[0], g[1])), backend=backend)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=4e-6, rtol=0)


def test_masked_auto_is_native_attention_on_the_cpu():
    """``auto`` with a mask runs ``native_attention`` with the mask: bit-equal
    to the port's own, and to the JAX native path within 1e-6 on seeded
    fp32 inputs (XLA's and PyTorch's CPU matmul and exp differ in the last
    bits, 4.8e-7 here); ``flash`` with the mask raises."""
    q, k, v, mask = _inputs()
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    out = T.dot_product_attention(tq, tk, tv, mask=tm, backend="auto")
    assert torch.equal(out, T.native_attention(tq, tk, tv, mask=tm))
    ref = np.asarray(J.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
                                             backend="auto"))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    for backend in ("flash", "splash"):
        with pytest.raises(NotImplementedError):
            T.dot_product_attention(tq, tk, tv, mask=tm, backend=backend)


def test_masked_auto_matches_the_jax_native_path_bit_for_bit_where_the_arithmetic_is_exact():
    """The mask's semantics bit for bit: with q = 0 every kept key scores 0
    and every masked one -1e30, each row keeps 1, 2, 4 or 8 keys (seeded), and
    v holds small integers, so softmax weights of 2^-j and their sums are
    exact in both frameworks: the port's masked ``auto`` equals the JAX
    masked ``auto`` exactly."""
    rng = np.random.default_rng(1)
    B, H, S, D = 1, 2, 16, 64
    q = np.zeros((B, H, S, D), np.float32)
    k = rng.standard_normal((B, H, S, D)).astype(np.float32)
    v = rng.integers(-8, 9, (B, H, S, D)).astype(np.float32)
    mask = np.zeros((B, 1, S, S), bool)
    for i in range(S):
        mask[0, 0, i, rng.permutation(S)[:2 ** (i % 4)]] = True
    out = T.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(mask),
                                  backend="auto")
    ref = np.asarray(J.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
                                             backend="auto"))
    assert np.array_equal(out.numpy(), ref)
    assert not np.array_equal(ref, np.asarray(J.native_attention(*(jnp.asarray(a) for a in (q, k, v)))))


def test_cpu_routes_reach_their_functions():
    """The CPU path of each route: native (auto, native) is
    ``native_attention``, flash (flash, splash) is K3's plain version."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
    for backend in ("auto", "native"):
        assert torch.equal(T.dot_product_attention(q, k, v, backend=backend), T.native_attention(q, k, v))
    for backend in ("flash", "splash"):
        assert torch.equal(T.dot_product_attention(q, k, v, backend=backend), T.flash_attention_plain(q, k, v))
