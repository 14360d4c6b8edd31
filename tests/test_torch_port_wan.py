"""PyTorch port, the Wan2.1 T2V slice against the JAX package, fp32 on the
CPU: the UniPC eval step, RoPE and the across-heads qk-norm, the plain flash
forward (K3's plain version) against the JAX kernel in Pallas interpret
mode, the Wan DiT, UMT5 and the causal video VAE through the weight bridge
on the flax modules' own random init, and the tiny adapter in both packages
(rollout, replay, decode, UniPC eval rollout) on the same weights, LoRA,
prompts, x0 and per-step noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights

PROMPTS = ["a paper boat drifting down a rainy gutter stream"] * 2 + ["a border collie catching a frisbee"] * 2
SEED = 11


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _port(factory, flax_params, module_map):
    module = build_module(factory, torch.device("cpu"), torch.float32, None)
    weights.load_component(module, weights.convert(flax_params, *module_map))
    return module


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


# ---------------------------------------------------------------------------
# UniPC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver_order", [1, 2, 3])
def test_unipc_orders_and_eval_steps_match_jax(solver_order):
    """The host order schedule is equal, and six ``unipc_eval_step`` calls on
    the same (sample, velocity) sequence stay within 1e-6 of the JAX carry
    (x, last_sample, history), relative to each tensor's largest magnitude
    where that is above 1: fp32 scalar coefficients on both sides, and XLA
    contracts the updates into fmas where eager PyTorch rounds twice (F3;
    5 fp32 ulp at |x| ~ 3 seen)."""
    from flow_factory_tpu.scheduler import unipc as J
    from flow_factory_tpu.scheduler.flow_match_euler import build_flow_match_sigmas
    from flow_factory_tpu_torch.scheduler import unipc as T

    for n in (1, 2, 5, 6, 28):
        for lof in (True, False):
            for a, b in zip(T.compute_unipc_orders(n, solver_order, lof),
                            J.compute_unipc_orders(n, solver_order, lof)):
                np.testing.assert_array_equal(a, b)
    steps = 6
    sigmas = build_flow_match_sigmas(steps, shift=3.0)
    pred, corr = T.compute_unipc_orders(steps, solver_order)
    rng = np.random.default_rng(solver_order)
    x0 = rng.standard_normal((2, 3, 4, 4, 5)).astype(np.float32)
    vs = [rng.standard_normal(x0.shape).astype(np.float32) for _ in range(steps)]
    jc, tc = J.init_unipc_carry(jnp.asarray(x0)), T.init_unipc_carry(torch.from_numpy(x0))
    for i in range(steps):
        jc, _ = J.unipc_eval_step(jc, jnp.asarray(vs[i]), sigmas[i], sigmas[i + 1],
                                  jnp.int32(pred[i]), jnp.int32(corr[i]))
        tc, x_next = T.unipc_eval_step(tc, torch.from_numpy(vs[i]), float(sigmas[i]), float(sigmas[i + 1]),
                                       int(pred[i]), int(corr[i]))
        assert torch.equal(x_next, tc.x)
        for name in ("x", "last_sample", "ms", "lams"):
            ref = np.asarray(getattr(jc, name))
            np.testing.assert_allclose(getattr(tc, name).numpy(), ref, atol=1e-6 * max(1.0, np.abs(ref).max()),
                                       rtol=0, err_msg=f"step {i} {name}")


def test_scheduler_registry_and_adapter_defaults():
    """``scheduler_type`` picks the class by name or diffusers alias; an
    adapter without one gets its ``default_scheduler`` (Wan: UniPC, SD3.5:
    FlowMatch-Euler), with the UniPC eval knobs attached."""
    from flow_factory_tpu.scheduler.registry import get_scheduler_class as jget
    from flow_factory_tpu_torch.models.sd3.adapter import SD35Adapter
    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter
    from flow_factory_tpu_torch.scheduler import FlowMatchEulerSDE, UniPCSDEScheduler, get_scheduler_class

    for name in ("unipc", "UniPCMultistepScheduler", "flow_match_euler", "FlowMatchEulerDiscreteScheduler"):
        assert get_scheduler_class(name).__name__ == jget(name).__name__
    with pytest.raises(KeyError):
        get_scheduler_class("ddim")
    assert WanT2VAdapter.default_scheduler == "unipc" and SD35Adapter.default_scheduler == "flow_match_euler"
    adapter = _tiny_wan_port(scheduler={"solver_order": 3, "lower_order_final": False})
    assert isinstance(adapter.scheduler, UniPCSDEScheduler)
    assert (adapter.scheduler.solver_order, adapter.scheduler.lower_order_final) == (3, False)
    assert adapter.scheduler.shift == 3.0
    forced = _tiny_wan_port(scheduler={"scheduler_type": "flow_match_euler"})
    assert type(forced.scheduler) is FlowMatchEulerSDE


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rope_and_across_heads_rms_match_jax():
    """``rope_frequencies`` over (t, h, w) ids, ``apply_rope`` (interleaved
    pairs, fp32 tables, back in x's dtype) and ``_across_heads_rms`` (one
    mean square over all heads, γ (D,)): 1e-6 in fp32."""
    from flow_factory_tpu.models import layers as J
    from flow_factory_tpu_torch.models import layers as T

    g = np.stack(np.meshgrid(np.arange(3), np.arange(4), np.arange(5), indexing="ij"), -1).reshape(-1, 3)
    jc, js = J.rope_frequencies(jnp.asarray(g), (8, 12, 12))
    tc, ts = T.rope_frequencies(torch.from_numpy(g), (8, 12, 12))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 60, 32)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    np.testing.assert_allclose(T.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
                               np.asarray(J.apply_rope(jnp.asarray(x), jc, js)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(T._across_heads_rms(torch.from_numpy(x), torch.from_numpy(gamma)).numpy(),
                               np.asarray(J._across_heads_rms(jnp.asarray(x), jnp.asarray(gamma))),
                               atol=1e-6, rtol=0)
    xb = torch.from_numpy(x).bfloat16()
    assert T.apply_rope(xb, tc, ts).dtype == torch.bfloat16 and T._across_heads_rms(xb, torch.from_numpy(gamma)).dtype == torch.bfloat16


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax_interpret(D, dtype):
    """K3's plain version against the JAX ``_flash_forward`` (the Pallas
    kernel in interpret mode, as it runs off the TPU) at a ragged shape
    (Sq 300, Sk 77: padded q rows and a masked key tail): O and lse. fp32:
    1e-6 (summation order only). bf16: both pre-scale q in bf16 and round p
    to bf16 before PV, so O moves only where a p near a rounding boundary
    rounds the other way or at O's own rounding: 1 bf16 ulp of max|O|;
    lse 1e-5."""
    from flow_factory_tpu.ops import attention as J
    from flow_factory_tpu_torch.ops import attention as T

    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((1, 2, S, D)).astype(np.float32) for S in (300, 77, 77))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    scale = D ** -0.5
    j_out, j_lse = J._flash_forward(as_j(tq), as_j(tk), as_j(tv), scale, J.DEFAULT_BLOCK_Q, J.DEFAULT_BLOCK_K)
    out, lse = T.flash_attention_plain(tq, tk, tv, scale, return_lse=True)
    ref = np.asarray(j_out.astype(jnp.float32))
    assert out.dtype == tdt and out.shape == ref.shape and lse.shape == (1, 2, 300)
    tol = 1e-6 if dtype == "float32" else _bf16_ulp(np.abs(ref).max())
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-6 if dtype == "float32" else 1e-5, rtol=0)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(T.flash_attention(tq, tk, tv, scale), out)


def test_dot_product_attention_dispatch_on_cpu():
    """On a CPU tensor ``auto`` and ``native`` are ``native_attention`` and
    ``flash``/``splash`` K3's plain version, as the JAX package runs
    ``native`` and its Pallas kernel (in interpret mode) off the TPU;
    ``ring`` without a ring runs what ``flash`` runs, and with a mask raises."""
    from flow_factory_tpu_torch.ops import attention as T

    q = torch.randn(1, 2, 20, 128)
    ref = T.native_attention(q, q, q)
    for backend in ("auto", "native"):
        assert torch.equal(T.dot_product_attention(q, q, q, backend=backend), ref)
    for backend in ("flash", "splash"):
        assert torch.equal(T.dot_product_attention(q, q, q, backend=backend), T.flash_attention_plain(q, q, q))
    assert torch.equal(T.dot_product_attention(q, q, q, backend="ring"), T.flash_attention_plain(q, q, q))
    with pytest.raises(NotImplementedError):
        T.dot_product_attention(q, q, q, backend="ring", mask=torch.ones(1, 1, 20, 20, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Models through the bridge
# ---------------------------------------------------------------------------

def test_wan_transformer_single_forward_matches_jax_through_bridge():
    """The tiny Wan DiT (2 blocks, 3-D RoPE, across-heads qk-norm, fp32
    modulation table) on 2 latent frames of 8x8 with 12 context tokens.
    Bar: 2e-5, the single-forward bar of tests/test_torch_reference.py."""
    from flow_factory_tpu.models.wan.transformer import WanConfig as JCfg, WanTransformer as JT
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

    kw = dict(dtype="float32", attn_backend="native")
    jm = JT(JCfg.tiny(**kw))
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 2, 8, 8, 16)).astype(np.float32)
    t = np.asarray([437.0, 801.0], np.float32)
    ctx = rng.standard_normal((2, 12, 48)).astype(np.float32)
    params = _host(jm.init(jax.random.PRNGKey(0), lat, t, ctx)["params"])
    params = jax.tree.map(lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype), params)
    theirs = np.asarray(jm.apply({"params": params}, lat, t, ctx))
    tm = _port(lambda: WanTransformer(WanConfig.tiny(dtype="float32", attn_backend="auto")), params,
               weights.wan_transformer_map(2))
    with torch.no_grad():
        ours = tm(*map(torch.from_numpy, (lat, t, ctx))).numpy()
    assert ours.shape == theirs.shape == lat.shape
    assert np.max(np.abs(ours - theirs)) < 2e-5


def test_umt5_encoder_matches_jax_through_bridge():
    """UMT5: a relative-position bias table on every block. Bar: 1e-5, the
    T5 bar (fp32, 3 layers, 40 tokens)."""
    from flow_factory_tpu.models.text_encoders.t5 import T5Config as JCfg, T5Encoder as JE
    from flow_factory_tpu_torch.models.text_encoders import T5Config, T5Encoder

    kw = dict(hidden_dim=48, num_heads=2, head_dim=8, num_layers=3, dtype="float32", rel_pos_max_distance=32,
              per_layer_rel_bias=True)
    jm = JE(JCfg.tiny(**kw))
    ids = np.random.default_rng(2).integers(0, 1000, size=(2, 40)).astype(np.int32)
    params = _host(jm.init(jax.random.PRNGKey(2), ids)["params"])
    assert all(f"block_{i}" in params and "rel_bias" in params[f"block_{i}"]["attn"] for i in range(3))
    theirs = np.asarray(jm.apply({"params": params}, ids))
    tm = _port(lambda: T5Encoder(T5Config.tiny(**kw)), params, weights.t5_encoder_map(3, per_layer_rel_bias=True))
    with torch.no_grad():
        ours = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    assert T5Config.umt5_xxl().vocab_size == 256384 and T5Config.umt5_xxl().per_layer_rel_bias


@pytest.mark.parametrize("mults,temporal_down,attn_scales", [
    ((1, 2, 2), 2, ()),       # downsample2d then downsample3d (and the reverse upsamples)
    ((1, 2, 2), 4, (0.5,)),   # both resamples temporal, attention blocks in a stage
])
def test_video_vae_encode_and_decode_match_jax_through_bridge(mults, temporal_down, attn_scales):
    """The causal video VAE: left-only time padding, the (0, 1) downsample
    pad, the time-first upsample3d that drops the first twin frame, 2x
    nearest upsampling, the mid attention, per-channel latent statistics.
    Encode of 5 frames (padded to T ≡ 1 mod down) and decode of the
    latents: 2e-5 (fp32 convolutions, summation order only)."""
    from flow_factory_tpu.models.wan.video_vae import VideoVAE as JV, VideoVAEConfig as JCfg
    from flow_factory_tpu_torch.models.wan.video_vae import VideoVAE, VideoVAEConfig

    stats = dict(latents_mean=tuple(np.linspace(-0.5, 0.5, 4)), latents_std=tuple(np.linspace(0.8, 1.6, 4)))
    kw = dict(channel_mults=mults, temporal_down=temporal_down, attn_scales=attn_scales, latent_channels=4,
              **stats)
    jcfg = JCfg.tiny(**kw)
    jm = JV(jcfg)
    rng = np.random.default_rng(3)
    frames = 5 if temporal_down == 4 else 4  # 4 frames pads one in front when down = 2
    vid = rng.uniform(-1, 1, (2, 3, frames, 16, 16)).astype(np.float32)
    params = _host(jm.init(jax.random.PRNGKey(3), vid)["params"])
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype), params)
    j_lat = np.array(jm.apply({"params": params}, vid, method=JV.encode))
    j_dec = np.asarray(jm.apply({"params": params}, j_lat, 5, method=JV.decode))
    tm = _port(lambda: VideoVAE(VideoVAEConfig.tiny(**kw)), params, weights.wan_vae_map(jcfg))
    with torch.no_grad():
        lat = tm.encode(torch.from_numpy(vid)).numpy()
        dec = tm.decode(torch.from_numpy(j_lat), 5).numpy()
    assert lat.shape == j_lat.shape and dec.shape == j_dec.shape == (2, 3, 5, 16, 16)
    np.testing.assert_allclose(lat, j_lat, atol=2e-5, rtol=0)
    np.testing.assert_allclose(dec, j_dec, atol=2e-5, rtol=0)


def test_not_ported_wan_options_raise():
    """Every Wan option builds: the Wan2.1-I2V CLIP image stream, in the DiT
    (``attn2.add_k_proj``/``add_v_proj``/``norm_added_k`` and the image
    embedder) and as the I2V adapter's ``use_image_encoder`` (the tiny CLIP
    tower, 5 image tokens among the embed keys;
    ``tests/test_torch_port_wan_i2v_clip.py`` holds it to JAX), the Wan2.2
    presets, its VAE, per-frame timesteps and the MoE build
    (``tests/test_torch_port_wan22.py`` holds them to JAX)."""
    from flow_factory_tpu_torch.models.wan.t2v import _preset
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer
    from flow_factory_tpu_torch.models.wan.video_vae import VideoVAE, VideoVAEConfig

    dit = WanTransformer(WanConfig.tiny(image_context_tokens=4, image_context_dim=32))
    assert dit.blocks[0].attn2.add_k_proj.weight.shape == (64, 64)
    assert dit.condition_embedder.image_embedder.norm1.weight.shape == (32,)
    i2v = _tiny_wan_port(model={"model_type": "wan2-i2v", "use_image_encoder": True})
    assert "image_encoder" in i2v.modules and i2v.embed_keys[-1] == "image_embeds"
    assert i2v.component_configs["transformer"].image_context_tokens == 5
    assert _preset("wan2.2-a14b", "auto", "bfloat16")["boundary_ratio"] == 0.875
    VideoVAE(VideoVAEConfig.tiny(spatial_patch=2))
    tm = build_module(lambda: WanTransformer(WanConfig.tiny(dtype="float32")), torch.device("cpu"),
                      torch.float32, torch.Generator().manual_seed(0))
    assert tm(torch.zeros(1, 2, 4, 4, 16), torch.zeros(1, 2), torch.zeros(1, 3, 48)).shape == (1, 2, 4, 4, 16)
    assert _tiny_wan_port(model={"boundary_ratio": 0.875}).trainable_components == ("transformer", "transformer_2")


# ---------------------------------------------------------------------------
# The tiny adapter in both packages
# ---------------------------------------------------------------------------

def _config_dict(**sections):
    cfg = {
        "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
        "model": {"model_type": "wan2-t2v", "model_name_or_path": "tiny", "finetune_type": "lora",
                  "lora_rank": 4, "lora_alpha": 8, "attn_backend": "auto",
                  "master_dtype": "float32", "inference_dtype": "float32"},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2,
                      "sde_steps": [0, 1, 2]},
        "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4,
                  "guidance_scale": 5.0, "per_device_batch_size": 2, "group_size": 2,
                  "unique_sample_num_per_epoch": 2, "latent_storage_dtype": "fp32", "num_frames": 5},
        "eval": {}, "log": {}, "rewards": [],
    }
    for section, values in sections.items():
        cfg[section] = {**cfg[section], **values}
    return cfg


def _tiny_wan_port(**sections):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    return load_adapter(Arguments.from_dict(_config_dict(**sections)), device="cpu")


def _jax_noise(B, shape, T):
    """The x0 and per-step noise the JAX adapter draws for ``seed=SEED``
    (``wan/t2v.py:397-403`` and the scan body, ``abc.py:976``)."""
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    k = jax.random.fold_in(keys[0], 7)
    noise = []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (B, *shape), jnp.float32)))
    return x0, noise


@pytest.fixture(scope="module")
def both():
    """Both tiny adapters on the JAX adapter's weights and a LoRA with
    non-zero B on every WAN target, one Flow-SDE rollout each and one UniPC
    eval rollout each (order 2, 6 steps)."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_config_dict(model={"attn_backend": "native"})))
        rng = np.random.default_rng(5)
        lora = _host(ja.trainable["transformer"])
        lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for p, ab in lora.items()}
        trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
        ja.rollout()
        j_samples = ja.inference(prompt=PROMPTS, seed=SEED, trainable=trainable)
        ja.eval()
        j_eval = ja.inference(prompt=PROMPTS[:2], seed=SEED, num_inference_steps=6, trainable=trainable)
        flax_params = _host(ja.params)
    finally:
        set_world_size_override(None)

    pa = _tiny_wan_port()
    pa.load_state_dicts(weights.wan_t2v_state_dicts(flax_params, pa.component_configs))
    module_map = weights.wan_transformer_map(pa.component_configs["transformer"].num_layers)[0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    shape = pa.latent_shape(32, 32, 5)
    x0, noise = _jax_noise(len(PROMPTS), shape, 4)
    pa.rollout()
    p_samples = pa.inference(prompt=PROMPTS, x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise])
    pa.eval()
    e_x0, _ = _jax_noise(2, shape, 0)
    p_eval = pa.inference(prompt=PROMPTS[:2], x0=torch.tensor(e_x0), num_inference_steps=6)
    pa.rollout()
    return pa, j_samples, p_samples, j_eval, p_eval


def test_wan_lora_targets_and_bridge_match_jax(both):
    """WAN_LORA_TARGETS picks the same 20 weights (2 blocks x 4 self + 4
    cross projections + 2 FFN linears) in both packages: the JAX LoRA tree
    bridges onto the port's live tree path for path."""
    pa = both[0]
    paths = sorted(pa.trainable["transformer"])
    assert len(paths) == 20 and all(("attn1" in p or "attn2" in p or "ffn" in p) for p in paths)


def test_wan_prompt_embeddings_and_schedule_match_jax(both):
    _, j_samples, p_samples, _, _ = both
    for js, ps in zip(j_samples, p_samples):
        assert ps.prompt_embeds.shape == (16, 32)
        np.testing.assert_allclose(ps.prompt_embeds, js.prompt_embeds, atol=1e-5)
        np.testing.assert_allclose(ps.negative_prompt_embeds, js.negative_prompt_embeds, atol=1e-5)
    np.testing.assert_allclose(p_samples[0].extra_kwargs["sigmas"], j_samples[0].extra_kwargs["sigmas"],
                               atol=1e-6)
    np.testing.assert_array_equal(p_samples[0].extra_kwargs["noise_levels"],
                                  j_samples[0].extra_kwargs["noise_levels"])


def test_wan_rollout_trajectory_log_probs_and_video_match_jax(both):
    """Every stored latent of the 4-step CFG Flow-SDE rollout and the
    log-probs of its SDE steps: 1e-4 (the trajectory bar of
    tests/test_torch_reference.py); the decoded videos (T, C, H, W) in
    [0, 1]: 1e-4. The zero-noise steps' log-probs are the 1e-12 scale
    clamp's constant on both sides, meaningless by design, held to the
    SD3.5 slice's 1e-3."""
    _, j_samples, p_samples, _, _ = both
    sde = np.nonzero(p_samples[0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2  # num_sde_steps of [0, 1, 2]
    for js, ps in zip(j_samples, p_samples):
        assert ps.all_latents.shape == js.all_latents.shape == (5, 3, 16, 16, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4)
        np.testing.assert_allclose(ps.log_probs, js.log_probs, atol=1e-3)
        assert ps.video.shape == js.video.shape == (5, 3, 32, 32)
        np.testing.assert_allclose(ps.video, js.video, atol=1e-4)


def test_wan_replay_ratio_is_exactly_one_and_rewards_attach(both):
    """The no-grad replay over the adapter's embed keys (no pooled embeds)
    gives exp(new − old) == 1.0 exactly on every stored step; the
    brightness reward scores the videos as their frame mean."""
    from flow_factory_tpu_torch.advantage import AdvantageProcessor
    from flow_factory_tpu_torch.rewards import MyReward, RewardProcessor
    from flow_factory_tpu_torch.hparams.reward_args import RewardArguments

    pa, _, p_samples, _, _ = both
    new = pa.replay_log_probs(p_samples)
    old = np.stack([s.log_probs for s in p_samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i
    RewardProcessor([MyReward(RewardArguments(name="b", reward_model="MyReward"))]).score_and_attach(p_samples)
    metrics = AdvantageProcessor(group_size=2).compute_advantages(p_samples)
    for s in p_samples:
        assert abs(s.extra_kwargs["rewards"]["b"] - float(np.mean(s.video))) < 1e-9
    assert np.isfinite(metrics["advantage/std"])


def test_wan_unipc_eval_rollout_matches_jax(both):
    """The eval rollout (scheduler.eval(): UniPC order 2 with the corrector,
    6 steps, CFG): every stored latent within 1e-4 of the JAX
    ``_unipc_eval_impl``, log-probs zero, videos within 1e-4."""
    _, _, _, j_eval, p_eval = both
    for js, ps in zip(j_eval, p_eval):
        assert ps.all_latents.shape == (7, 3, 16, 16, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4)
        assert not np.any(ps.log_probs)
        np.testing.assert_allclose(ps.video, js.video, atol=1e-4)


def test_wan_encode_video_round_trip_shapes(both):
    pa = both[0]
    videos = np.stack([s.video for s in both[2][:2]])
    z = pa.encode_video(videos)
    assert z.shape == (2, 3, 16, 16, 16) and np.isfinite(z).all()
