"""PyTorch port, the ``hybrid`` attention backend against the JAX package on
the CPU, fp32: the plain forward against JAX ``native_attention`` and the
gradients (K3's recompute, then K2a and K2b: their plain versions here)
against JAX ``flash_attention``'s with its Pallas kernels in interpret mode,
at the bars of the JAX package's own test (tests/test_ops.py:77-107); the
qk-norm composition; the 8 GiB gate; and the tiny SD3.5 adapter under
``attn_backend: hybrid`` in both packages: the rollout, the replay ratio and
the GRPO loss and LoRA gradients."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu.ops import attention as J
from flow_factory_tpu_torch.ops import attention as T
from test_torch_port_train import CONFIG, _depth, _leaf_close, _port_grads_as_flax

PROMPTS = ["a photo of a red fox in the snow", "a bowl of ramen with chopsticks"]
SEED = 7


def _jax_inputs(S=300, D=32, n=4, seed=7):
    """q, k, v and a cotangent as the JAX test draws them (B1 H2, fp32)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), n)
    return [jax.random.normal(kk, (1, 2, S, D), jnp.float32) for kk in ks]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]


def test_hybrid_forward_matches_jax_native_and_grads_match_jax_flash():
    """The forward within 2e-5 of JAX ``native_attention`` (and of JAX
    ``hybrid_attention``); dq, dk, dv within 2e-5 of the gradients of JAX
    ``flash_attention`` (Pallas in interpret mode); ``dot_product_attention``
    with ``backend="hybrid"`` is ``hybrid_attention``, bit for bit."""
    q, k, v, cot = _jax_inputs()
    tq, tk, tv, tc = _torch(q, k, v, cot)
    out = T.hybrid_attention(tq, tk, tv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(J.native_attention(q, k, v)), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(J.hybrid_attention(q, k, v)), atol=2e-5, rtol=0)
    assert torch.equal(T.dot_product_attention(tq, tk, tv, backend="hybrid"), out)
    assert torch.equal(out, T.native_attention(tq, tk, tv))  # the forward is the plain product

    grads = torch.autograd.grad((out * tc).sum(), (tq, tk, tv))
    want = jax.grad(lambda q, k, v: jnp.sum(J.flash_attention(q, k, v) * cot), argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=f"d{name}")


def test_hybrid_backward_is_flash_recompute_then_flash_backward():
    """The backward recomputes (O, lse) with K3's plain version and runs the
    plain K2a/K2b on Δ of that O: bit-equal to ``flash_backward_plain`` fed
    ``flash_attention_plain``'s (O, lse), and to the gradients of ``flash``."""
    q, k, v, cot = _jax_inputs(S=77, D=64, seed=3)
    tq, tk, tv, tc = _torch(q, k, v, cot)
    grads = torch.autograd.grad((T.hybrid_attention(tq, tk, tv) * tc).sum(), (tq, tk, tv))
    with torch.no_grad():
        o, lse = T.flash_attention_plain(tq, tk, tv, 64 ** -0.5, return_lse=True)
        want = T.flash_backward_plain(tq, tk, tv, o, lse, tc, 64 ** -0.5)
    flash = torch.autograd.grad((T.dot_product_attention(tq, tk, tv, backend="flash") * tc).sum(), (tq, tk, tv))
    for a, b, c in zip(grads, want, flash):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5, rtol=0)


def test_qknorm_hybrid_composes_the_rms_scale_with_hybrid():
    """``qknorm_dot_product_attention`` under ``hybrid``: the fp32 RMS scale,
    cast to the input dtype, then the hybrid backend (JAX :592ff, not K1):
    the output and the q, k, v and scale-map gradients against JAX's
    composition under ``hybrid`` within 2e-5; an lse is not ported."""
    rng = np.random.default_rng(11)
    q, k, v, cot = _jax_inputs(S=130, D=32, seed=5)
    gq = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    gk = (1.0 - 0.1 * rng.standard_normal(32)).astype(np.float32)

    def jfn(q, k, v, gq, gk):
        return jnp.sum(J.qknorm_dot_product_attention(q, k, v, gq, gk, backend="hybrid") * cot)

    j_out = J.qknorm_dot_product_attention(q, k, v, jnp.asarray(gq), jnp.asarray(gk), backend="hybrid")
    j_grads = jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(q, k, v, jnp.asarray(gq), jnp.asarray(gk))
    tq, tk, tv, tc, tgq, tgk = _torch(q, k, v, cot, gq, gk)
    out = T.qknorm_dot_product_attention(tq, tk, tv, tgq, tgk, backend="hybrid")
    qn, kn = (T._rms_scale(t, g.expand(130, 32), 1e-6).to(t.dtype) for t, g in ((tq, tgq), (tk, tgk)))
    assert torch.equal(out, T.hybrid_attention(qn, kn, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-5, rtol=0)
    grads = torch.autograd.grad((out * tc).sum(), (tq, tk, tv, tgq, tgk))
    for a, b, name in zip(grads, j_grads, ("q", "k", "v", "gq", "gk")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5, err_msg=f"d{name}")
    with pytest.raises(NotImplementedError, match="lse"):
        T.qknorm_dot_product_attention(tq, tk, tv, tgq, tgk, backend="hybrid", return_lse=True)


def test_hybrid_gate_takes_flash_past_the_score_limit(monkeypatch):
    """The gate (JAX :880-883): B·H·Sq·Sk x itemsize above the limit runs
    ``flash`` on every device. The constant is JAX's; with both limits
    lowered below these inputs' scores, JAX's ``hybrid_attention`` gives its
    ``flash_attention``'s output and the port routes to ``flash`` and gives
    K3's plain version, bit for bit; at the limit itself both stay hybrid."""
    assert T.NATIVE_SCORE_BYTES_LIMIT == J.XLA_SCORE_BYTES_LIMIT == 8 * 1024 ** 3
    q, k, v, _ = _jax_inputs(S=64, D=32)
    tq, tk, tv = (torch.from_numpy(np.array(a)) for a in (q, k, v))
    scores = T.score_bytes(tq, tk)
    assert scores == 1 * 2 * 64 * 64 * 4
    for device in ("cpu", "cuda"):
        assert T.attention_route("hybrid", False, device, 32, scores) == "hybrid"
        assert T.attention_route("hybrid", False, device, 32, T.NATIVE_SCORE_BYTES_LIMIT) == "hybrid"
        assert T.attention_route("hybrid", False, device, 32, T.NATIVE_SCORE_BYTES_LIMIT + 1) == "flash"
        with pytest.raises(NotImplementedError, match="mask"):
            T.attention_route("hybrid", True, device, 32, scores)
    monkeypatch.setattr(J, "XLA_SCORE_BYTES_LIMIT", scores - 1)
    monkeypatch.setattr(T, "NATIVE_SCORE_BYTES_LIMIT", scores - 1)
    assert np.array_equal(np.asarray(J.hybrid_attention(q, k, v)), np.asarray(J.flash_attention(q, k, v)))
    assert T.attention_route("hybrid", False, "cpu", 32, scores) == "flash"
    out = T.dot_product_attention(tq, tk, tv, backend="hybrid")
    assert torch.equal(out, T.flash_attention_plain(tq, tk, tv))
    assert torch.equal(T.hybrid_attention(tq, tk, tv), out)


# ---------------------------------------------------------------------------
# The tiny SD3.5 under attn_backend: hybrid in both packages
# ---------------------------------------------------------------------------

def _hybrid_config():
    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["attn_backend"] = "hybrid"
    return cfg


def _jax_noise(B, shape, T_):
    """The x0 and per-step noise the JAX adapter draws for ``seed=SEED``."""
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    k, noise = jax.random.fold_in(keys[0], 7), []
    for _ in range(T_):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (B, *shape), jnp.float32)))
    return x0, noise


@pytest.fixture(scope="module")
def pair():
    """Both tiny SD3.5 adapters under ``hybrid`` on the JAX adapter's weights
    and a LoRA with a non-zero ``b``; one CFG rollout each from the same x0
    and noise."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_hybrid_config()))
    finally:
        set_world_size_override(None)
    flax_params = jax.tree.map(np.asarray, jax.device_get(ja.params))
    rng = np.random.default_rng(5)
    lora = {path: {"a": np.asarray(ab["a"]), "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for path, ab in jax.device_get(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
    pa = load_adapter(Arguments.from_dict(_hybrid_config()), device="cpu")
    assert pa.component_configs["transformer"].attn_backend == "hybrid"
    pa.load_state_dicts(weights.sd35_state_dicts(flax_params, pa.component_configs))
    module_map = weights.sd3_transformer_map(*_depth(pa))[0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))

    ja.rollout()
    j_samples = ja.inference(prompt=PROMPTS, seed=SEED)
    ja.train()
    x0, noise = _jax_noise(len(PROMPTS), pa.latent_shape(32, 32), 4)
    pa.rollout()
    p_samples = pa.inference(prompt=PROMPTS, x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise])
    pa.train()
    return ja, pa, j_samples, p_samples, module_map


def test_tiny_sd35_hybrid_rollout_matches_jax_and_replays_at_ratio_one(pair):
    """Every stored latent and every per-step log-prob of the 4-step CFG
    Flow-SDE rollout within the 1e-4 trajectory bar of the JAX rollout under
    ``hybrid``; the port's no-grad replay of each stored step gives the
    rollout's log-probs bit for bit (ratio exactly 1.0)."""
    _, pa, j_samples, p_samples, _ = pair
    for js, ps in zip(j_samples, p_samples):
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.log_probs, js.log_probs, atol=1e-4, rtol=0)
    replay = pa.replay_log_probs(p_samples)
    assert replay
    lp = np.stack([s.log_probs for s in p_samples])
    for step, new in replay.items():
        slot = p_samples[0].log_prob_index_map[step]
        assert np.array_equal(np.exp(new.numpy() - lp[:, slot]), np.ones(len(p_samples))), step


def test_tiny_sd35_hybrid_grpo_loss_and_lora_grads_match_jax(pair):
    """One GRPO micro-batch of the rollout's first stored step, with old
    log-probs off the new ones so the clip binds on one row, through the JAX
    trainer's ``_grad_fn`` and the port's ``loss_and_grads``, both under
    ``hybrid`` (JAX: the XLA forward, the Pallas backward in interpret
    mode): loss and aux 1e-5, every LoRA gradient within 1e-4 of its leaf's
    largest magnitude (tests/test_torch_port_train.py)."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.samples import stack_samples
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    ja, pa, _, p_samples, module_map = pair
    b = stack_samples(p_samples)
    s0 = p_samples[0]
    step = int(np.asarray(pa.scheduler.train_timesteps)[0])
    li, lni, lpi = s0.latent_index_map[step], s0.latent_index_map[step + 1], s0.log_prob_index_map[step]
    sig, nl = s0.extra_kwargs["sigmas"], s0.extra_kwargs["noise_levels"]
    full = lambda x: np.full((len(p_samples),), x, np.float32)
    batch = dict(latents=b["all_latents"][:, li], next_latents=b["all_latents"][:, lni],
                 timestep=full(s0.timesteps[step]), sigma=full(sig[step]), sigma_next=full(sig[step + 1]),
                 noise_level=full(nl[step]), sigma_max=full(sig[1]), advantage=np.asarray([1.2, -0.7], np.float32),
                 old_log_prob=(b["log_probs"][:, lpi] + np.asarray([-0.05, -0.5], np.float32)).astype(np.float32),
                 **{k: b[k].astype(np.float32) for k in ("prompt_embeds", "pooled_prompt_embeds",
                                                         "negative_prompt_embeds", "negative_pooled_prompt_embeds")})
    jt = object.__new__(JGRPO)
    jt.training_args, jt.use_guard, jt.adapter = copy.copy(ja.training_args), False, ja
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(),
                                           {**{k: jnp.asarray(v) for k, v in batch.items()},
                                            "guidance_scale": jnp.float32(2.0)}, None)
    pt = object.__new__(GRPOTrainer)
    pt.training_args, pt.use_guard, pt.adapter = copy.copy(pa.training_args), False, pa
    (loss, aux), grads = pt.loss_and_grads({**{k: torch.from_numpy(v) for k, v in batch.items()},
                                            "guidance_scale": 2.0}, None)
    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert 0.0 < float(aux["train/clip_frac"]) < 1.0
    _leaf_close(_port_grads_as_flax(pa, grads, module_map), jax.tree.map(np.asarray, j_grads)["transformer"],
                1e-4, "hybrid grpo")
