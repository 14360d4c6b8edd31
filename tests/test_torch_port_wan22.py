"""PyTorch port, the rest of Wan against the JAX package, fp32 on the CPU:
the Wan 2.2 VAE (2x2 patch, residual resample stages) encode, decode and
chunked decode; the DiT with per-frame timesteps; the presets; and the tiny
adapters in both packages on the same weights, LoRA, prompts, x0 and
per-step noise: the Wan2.2 MoE (both experts, ``guidance_scale_2``), the
channel-concat I2V (with and without a last frame), the TI2V
``expand_timesteps`` I2V and the V2V: their conditions, rollouts (each
step's expert, the trajectory, the decoded video) and replay ratio; the
dataset's ``video`` field; the registry."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights

PROMPTS = ["a paper boat drifting down a rainy gutter stream", "a border collie catching a frisbee"]
SEED = 11
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0). One intra-op torch thread: the tiny models
    run as fast on it, and the parallel test workers then do not
    oversubscribe the CPUs they share (with every worker's torch on all
    cores, the tiny GRPO epochs here ran 50-90x slower)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    set_world_size_override(None)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _port(factory, flax_params, module_map):
    module = build_module(factory, torch.device("cpu"), torch.float32, None)
    weights.load_component(module, weights.convert(flax_params, *module_map))
    return module


# ---------------------------------------------------------------------------
# The Wan 2.2 VAE and the DiT's per-frame timesteps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wan22_vae():
    """The config of JAX ``test_wan22_residual_vae_variant`` (2x2 patch,
    residual stages, mults (1, 2), temporal 2) with its init perturbed, in
    both packages; 7 frames of 16 x 16 encode to 4 latent frames of 4 x 4."""
    from flow_factory_tpu.models.wan.video_vae import VideoVAE as JV, VideoVAEConfig as JCfg
    from flow_factory_tpu_torch.models.wan.video_vae import VideoVAE, VideoVAEConfig

    kw = dict(spatial_patch=2, resample_residual=True, channel_mults=(1, 2), temporal_down=2)
    jm = JV(JCfg.tiny(**kw))
    rng = np.random.default_rng(3)
    vid = rng.uniform(-1, 1, (2, 3, 7, 16, 16)).astype(np.float32)
    params = _host(jax.jit(jm.init)(jax.random.PRNGKey(0), vid)["params"])
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype), params)
    tcfg = VideoVAEConfig.tiny(**kw)
    return jm, params, vid, _port(lambda: VideoVAE(tcfg), params, weights.wan_vae_map(tcfg))


def test_wan22_vae_encode_and_decode_match_jax(wan22_vae):
    """Encode (front padding, the patch over (H, W), the average shortcuts)
    and decode (the repeat shortcuts, the patch-widened output conv): 2e-5,
    the bar of the Wan 2.1 VAE test."""
    from flow_factory_tpu.models.wan.video_vae import VideoVAE as JV

    jm, params, vid, tm = wan22_vae
    j_lat = np.array(jax.jit(lambda p, v: jm.apply({"params": p}, v, method=JV.encode))(params, vid))
    j_dec = np.asarray(jax.jit(lambda p, z: jm.apply({"params": p}, z, method=JV.decode))(params, j_lat))
    with torch.no_grad():
        lat = tm.encode(torch.from_numpy(vid)).numpy()
        dec = tm.decode(torch.from_numpy(j_lat)).numpy()
    assert lat.shape == j_lat.shape == (2, 4, 4, 4, 16) and dec.shape == j_dec.shape == (2, 3, 7, 16, 16)
    np.testing.assert_allclose(lat, j_lat, atol=2e-5, rtol=0)
    np.testing.assert_allclose(dec, j_dec, atol=2e-5, rtol=0)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_wan22_vae_decode_chunked_matches_jax_and_the_full_decode(wan22_vae, chunk):
    """``decode_chunked`` with 8 frames of left context: within 2e-5 of the
    JAX one and within 1e-5 of the port's own full decode (the JAX test's
    exactness bar); with no context (overlap 0) it must differ."""
    from flow_factory_tpu.models.wan.video_vae import VideoVAE as JV

    jm, params, vid, tm = wan22_vae
    z = np.array(jax.jit(lambda p, v: jm.apply({"params": p}, v, method=JV.encode))(params, vid))
    theirs = np.asarray(jax.jit(lambda p, z: jm.apply({"params": p}, z, chunk, 8, method=JV.decode_chunked))(params, z))
    with torch.no_grad():
        full = tm.decode(torch.from_numpy(z)).numpy()
        ours = tm.decode_chunked(torch.from_numpy(z), chunk, 8).numpy()
        cut = tm.decode_chunked(torch.from_numpy(z), 1, 0).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours, full, atol=1e-5, rtol=0)
    assert not np.allclose(cut, full, atol=1e-5)


def test_wan21_vae_decode_chunked_is_exact():
    """JAX ``test_video_vae_chunked_decode_exact`` on the port: the tiny Wan
    2.1 VAE, 13 frames to 7 latents, chunks of 1, 2 and 4 with 8 frames of
    context give the full decode within 1e-5, and ``num_frames`` keeps the
    last frames of both."""
    from flow_factory_tpu_torch.models.wan.video_vae import VideoVAE, VideoVAEConfig

    tm = build_module(lambda: VideoVAE(VideoVAEConfig.tiny()), torch.device("cpu"), torch.float32,
                      torch.Generator().manual_seed(5))
    v = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3, 13, 16, 16)).astype(np.float32))
    with torch.no_grad():
        z = tm.encode(v)
        full = tm.decode(z)
        assert z.shape[1] == 7 and full.shape[2] == 13
        for chunk in (1, 2, 4):
            torch.testing.assert_close(tm.decode_chunked(z, chunk, 8), full, atol=1e-5, rtol=0)
        torch.testing.assert_close(tm.decode_chunked(z, 2, 8, num_frames=9), full[:, :, -9:], atol=1e-5, rtol=0)


def test_wan_transformer_per_frame_timesteps_match_jax():
    """The DiT with (B, gt) timesteps, frame 0 at t = 0 as TI2V pins it: the
    per-token AdaLN modulations of every block and the head through K5's
    plain per-token path, 2e-5 against JAX; uniform per-frame t gives the
    scalar-t output within 1e-5, the JAX test's bar (the time MLP runs on B·gt
    rows instead of B: another blocking of its products)."""
    from flow_factory_tpu.models.wan.transformer import WanConfig as JCfg, WanTransformer as JT
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

    jm = JT(JCfg.tiny(dtype="float32", attn_backend="native"))
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 3, 8, 8, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 48)).astype(np.float32)
    t = np.asarray([[0.0, 700.0, 700.0], [0.0, 310.0, 310.0]], np.float32)
    params = _host(jax.jit(jm.init)(jax.random.PRNGKey(2), lat, t[:, 0], ctx)["params"])
    params = jax.tree.map(lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype), params)
    theirs = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, lat, t, ctx))
    tm = _port(lambda: WanTransformer(WanConfig.tiny(dtype="float32")), params, weights.wan_transformer_map(2))
    with torch.no_grad():
        ours = tm(*map(torch.from_numpy, (lat, t, ctx))).numpy()
        uniform = tm(torch.from_numpy(lat), torch.full((2, 3), 700.0), torch.from_numpy(ctx))
        scalar = tm(torch.from_numpy(lat), torch.full((2,), 700.0), torch.from_numpy(ctx))
    assert np.max(np.abs(ours - theirs)) < 2e-5
    torch.testing.assert_close(uniform, scalar, atol=1e-5, rtol=0)


def test_wan22_presets_build_at_their_widths():
    """``wan2.2-ti2v-5b`` (30 layers, width 3072, 48 channels, the Wan 2.2
    VAE at 16x spatial) and ``wan2.2-a14b`` (width 5120, 40 heads, boundary
    0.875) as the JAX presets give them, built on the meta device: their
    parameter counts."""
    from flow_factory_tpu.models.wan.t2v import _preset as jax_preset
    from flow_factory_tpu_torch.models.wan.t2v import _preset
    from flow_factory_tpu_torch.models.wan.transformer import WanTransformer
    from flow_factory_tpu_torch.models.wan.video_vae import VideoVAE

    for name in ("wan2.2-ti2v-5b", "wan2.2-a14b"):
        ours, theirs = _preset(name, "auto", "bfloat16"), jax_preset(name, "auto", "bfloat16")
        assert ours["boundary_ratio"] == theirs["boundary_ratio"]
        for field in ("in_channels", "hidden_dim", "ffn_dim", "num_heads", "num_layers", "axes_dim"):
            assert getattr(ours["transformer"], field) == getattr(theirs["transformer"], field), (name, field)
        assert ours["vae"].spatial_down == theirs["vae"].spatial_down
        assert ours["vae"].latent_channels == theirs["vae"].latent_channels
    with torch.device("meta"):
        count = lambda m: sum(p.numel() for p in m.parameters())
        ti2v, a14b = _preset("wan2.2-ti2v-5b", "auto", "bfloat16"), _preset("wan2.2-a14b", "auto", "bfloat16")
        assert 4.9e9 < count(WanTransformer(ti2v["transformer"])) < 5.1e9
        assert 13.5e9 < count(WanTransformer(a14b["transformer"])) < 14.5e9
        assert ti2v["vae"].spatial_down == 16 and count(VideoVAE(ti2v["vae"])) > 0


# ---------------------------------------------------------------------------
# The tiny adapters in both packages
# ---------------------------------------------------------------------------

def _config_dict(model_type, model=None, train=None):
    cfg = {
        "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
        "model": {"model_type": model_type, "model_name_or_path": "tiny", "finetune_type": "lora",
                  "lora_rank": 4, "lora_alpha": 8, "attn_backend": "auto",
                  "master_dtype": "float32", "inference_dtype": "float32", **(model or {})},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2, "sde_steps": [0, 1, 2]},
        "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": STEPS, "guidance_scale": 5.0,
                  "per_device_batch_size": 2, "group_size": 2, "unique_sample_num_per_epoch": 2,
                  "latent_storage_dtype": "fp32", "num_frames": 5, "clip_range": 0.2, "adv_clip_range": 1.5,
                  **(train or {})},
        "eval": {}, "log": {}, "rewards": [],
    }
    return cfg


#: the four tiny adapters: (model_type, model options, train options)
KINDS = {
    "moe": ("wan22", {"boundary_ratio": 0.8}, {"guidance_scale_2": 3.0}),
    "i2v": ("wan2-i2v", {}, {}),
    "ti2v": ("wan2-i2v", {"expand_timesteps": True}, {}),
    "v2v": ("wan2-v2v", {}, {}),
}


def _jax_noise(B, shape):
    """The x0 and per-step noise the JAX adapter draws for ``seed=SEED``."""
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    k = jax.random.fold_in(keys[0], 7)
    noise = []
    for _ in range(STEPS):
        k, sub = jax.random.split(k)
        noise.append(torch.from_numpy(np.asarray(jax.random.normal(sub, (B, *shape), jnp.float32))))
    return torch.from_numpy(x0), noise


def _media(kind):
    """The condition media, [0, 1], 32 px: two first frames and two last
    frames, or two 5-frame clips."""
    rng = np.random.default_rng(4)
    if kind == "v2v":
        return {"condition_video": [rng.uniform(0, 1, (5, 3, 32, 32)).astype(np.float32) for _ in PROMPTS]}
    return {"images": [rng.uniform(0, 1, (3, 32, 32)).astype(np.float32) for _ in PROMPTS],
            "last_images": [rng.uniform(0, 1, (3, 32, 32)).astype(np.float32) for _ in PROMPTS]}


def _route_spy(adapter, routes):
    """Record each call's expert (True for the high-noise one) in ``routes``."""
    real = adapter.step_params

    def spy(params, t_host):
        out = real(params, t_host)
        routes.append(getattr(out, "high", None))
        return out

    adapter.step_params = spy


class _Pair:
    """A JAX adapter and the port's on its weights and LoRA (non-zero B on
    every target of every trained expert), both rolled out on the same
    prompts, media, x0 and noise."""

    def __init__(self, kind):
        from flow_factory_tpu.hparams.args import Arguments as JArgs
        from flow_factory_tpu.models import load_adapter as jax_load
        from flow_factory_tpu.parallel.dist import set_world_size_override
        from flow_factory_tpu_torch.hparams import Arguments
        from flow_factory_tpu_torch.models import load_adapter

        model_type, model, train = KINDS[kind]
        cfg = _config_dict(model_type, model, train)
        media = _media(kind)
        rng = np.random.default_rng(5)
        set_world_size_override(1)
        try:
            ja = jax_load(JArgs.from_dict(copy.deepcopy(cfg)))
            lora = {comp: {p: {"a": np.asarray(ab["a"]),
                               "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                           for p, ab in _host(tree).items()} for comp, tree in ja.trainable.items()}
            self.trainable = {c: jax.tree.map(jnp.asarray, t) for c, t in lora.items()}
            ja.rollout()
            self.j_samples = ja.inference(prompt=PROMPTS, seed=SEED, trainable=self.trainable, **media)
            flax_params = _host(ja.params)
        finally:
            set_world_size_override(None)
        pa = load_adapter(Arguments.from_dict(copy.deepcopy(cfg)), device="cpu")
        pa.load_state_dicts({c: weights.convert(tree, *pa.weight_maps()[c]) for c, tree in flax_params.items()})
        for comp, tree in lora.items():
            pa.load_lora(comp, weights.lora_from_flax(tree, pa.weight_maps()[comp][0]))
        x0, noise = _jax_noise(len(PROMPTS), pa.latent_shape(32, 32, 5))
        self.routes = []
        _route_spy(pa, self.routes)
        pa.rollout()
        self.p_samples = pa.inference(prompt=PROMPTS, x0=x0, noise=noise, **media)
        del pa.step_params
        self.ja, self.pa, self.lora, self.media = ja, pa, lora, media


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _Pair(kind)
        return cache[kind]

    return get


def _assert_rollouts_match(j_samples, p_samples):
    """Every stored latent and the SDE steps' log-probs within 1e-4 (the
    trajectory bar), the decoded videos within 1e-4."""
    sde = np.nonzero(p_samples[0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2
    for js, ps in zip(j_samples, p_samples):
        assert ps.all_latents.shape == js.all_latents.shape
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4)
        assert ps.video.shape == js.video.shape == (5, 3, 32, 32)
        np.testing.assert_allclose(ps.video, js.video, atol=1e-4)


def _assert_replay_ratio_is_one(pa, samples):
    new = pa.replay_log_probs(samples)
    old = np.stack([s.log_probs for s in samples], axis=1)
    assert sorted(new) == list(range(STEPS))
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i


def test_moe_routes_each_step_as_jax_and_trains_both_experts(pairs):
    """The tiny MoE (``boundary_ratio`` 0.8, so that each expert takes two
    of the four steps [1000, 900, 750, 500]):
    ``transformer_2`` beside ``transformer`` with its own LoRA, both
    trainable; each step's expert on the host equals JAX's fp32 rule
    ``t ≥ boundary · 1000`` on the rollout's own schedule, and both run."""
    p = pairs("moe")
    pa, ts = p.pa, p.p_samples[0].timesteps
    assert pa.trainable_components == ("transformer", "transformer_2")
    assert sorted(pa.trainable) == sorted(p.ja.trainable) == ["transformer", "transformer_2"]
    want = [bool(jnp.float32(t) >= jnp.float32(0.8 * 1000.0)) for t in ts]
    assert p.routes == want == [True, True, False, False]
    np.testing.assert_array_equal(ts, p.j_samples[0].timesteps)


def test_moe_rollout_and_replay_match_jax(pairs):
    """The MoE rollout with ``guidance_scale_2`` on the low-noise steps: the
    trajectory, log-probs and videos against JAX's ``lax.cond``; the no-grad
    replay routes the same way and gives ratio exactly 1.0."""
    p = pairs("moe")
    _assert_rollouts_match(p.j_samples, p.p_samples)
    _assert_replay_ratio_is_one(p.pa, p.p_samples)


@pytest.mark.parametrize("last", [False, True])
def test_i2v_condition_matches_jax(pairs, last):
    """The channel-concat condition (B, 3, 16, 16, 17): the encoded first
    frame and the mask channel on latent frame 0, with ``last_images`` the
    last frame too; 2e-5 against JAX's ``build_condition``."""
    p = pairs("i2v")
    kw = {"last_images": p.media["last_images"]} if last else {}
    theirs = p.ja.build_condition(p.media["images"], 5, 32, 32, **kw)
    ours = p.pa.build_condition(p.media["images"], 5, 32, 32, **kw)
    assert ours.shape == theirs.shape == (2, 3, 16, 16, 17)
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)
    assert np.all(ours[:, 0, ..., 16] == 1.0) and np.all(ours[:, -1, ..., 16] == float(last))
    assert p.pa.component_configs["transformer"].in_channels == 33


def test_i2v_rollout_and_replay_match_jax(pairs):
    """The concat I2V rollout (first and last frame pinned): trajectory,
    log-probs and videos against JAX; each sample keeps its
    ``cond_latents`` and image; the replay reads ``cond_latents`` among
    the embeds and gives ratio exactly 1.0."""
    p = pairs("i2v")
    _assert_rollouts_match(p.j_samples, p.p_samples)
    for js, ps in zip(p.j_samples, p.p_samples):
        np.testing.assert_allclose(ps.extra_kwargs["cond_latents"], js.extra_kwargs["cond_latents"], atol=2e-5)
        np.testing.assert_array_equal(ps.images[0], js.images[0])
    _assert_replay_ratio_is_one(p.pa, p.p_samples)


def test_ti2v_expand_timesteps_rollout_decode_and_replay_match_jax(pairs):
    """TI2V (``expand_timesteps``): the condition is the clean latent on
    frame 0 (no mask channel, no widening); the rollout steps the raw
    latents with the transformer on the composite at per-frame t; the decode
    composites the clean frame back: trajectory and videos against JAX, and
    the decode of the final latents with frame 0 replaced; ratio 1.0."""
    p = pairs("ti2v")
    pa = p.pa
    cond = pa.build_condition(p.media["images"], 5, 32, 32)
    np.testing.assert_allclose(cond, p.ja.build_condition(p.media["images"], 5, 32, 32), atol=2e-5, rtol=0)
    assert cond.shape == (2, 3, 16, 16, 16) and not cond[:, 1:].any()
    assert pa.component_configs["transformer"].in_channels == 16
    _assert_rollouts_match(p.j_samples, p.p_samples)
    final = np.stack([s.all_latents[-1] for s in p.p_samples])
    composite = final.copy()
    composite[:, 0] = cond[:, 0]
    want = pa.decode_latents(torch.from_numpy(composite), num_frames=5)
    np.testing.assert_array_equal(np.stack([s.video for s in p.p_samples]), want)
    assert not np.allclose(pa.decode_latents(torch.from_numpy(final), num_frames=5), want)
    _assert_replay_ratio_is_one(pa, p.p_samples)


def test_v2v_condition_rollout_and_replay_match_jax(pairs):
    """V2V: the 5-frame clips encode over all 3 latent frames with the mask
    channel (2e-5 against JAX); the rollout against JAX; each sample keeps
    its clip; ratio exactly 1.0."""
    p = pairs("v2v")
    clips = p.media["condition_video"]
    ours = p.pa.build_condition(clips, 5, 32, 32)
    np.testing.assert_allclose(ours, p.ja.build_condition(clips, 5, 32, 32), atol=2e-5, rtol=0)
    assert ours.shape == (2, 3, 16, 16, 17) and np.all(ours[..., 16] == 1.0)
    _assert_rollouts_match(p.j_samples, p.p_samples)
    for ps, clip in zip(p.p_samples, clips):
        np.testing.assert_array_equal(ps.condition_video, clip)
    _assert_replay_ratio_is_one(p.pa, p.p_samples)


# ---------------------------------------------------------------------------
# GRPO gradients of both experts and of TI2V against the JAX _grad_fn
# ---------------------------------------------------------------------------

def _jax_trainer(p, cls, training_args, **attrs):
    """A bare JAX trainer of ``cls`` on the pair ``p``'s adapter, shared
    across cases: the one an earlier case made with the same class,
    arguments and attributes, which keeps its jitted ``_grad_fn`` compiled
    for the pair's shapes."""
    cache = p.__dict__.setdefault("jax_trainers", {})
    key = (cls, repr(sorted(vars(training_args).items())), repr(sorted(attrs.items())))
    if key not in cache:
        jt = object.__new__(cls)
        jt.training_args, jt.adapter = training_args, p.ja
        for name, value in attrs.items():
            setattr(jt, name, value)
        cache[key] = jt
    return cache[key]


def _grad_batch(p, step):
    """One GRPO micro-batch of the port's rollout at ``step``, η 0.7 (a
    stored step with no noise has its mean as next latents, which keeps the
    log-prob moderate), old log-probs off the JAX ones so that the clip
    binds on the second row."""
    s, B = p.p_samples, len(p.p_samples)
    lat = np.stack([x.all_latents for x in s])
    sig = s[0].extra_kwargs["sigmas"]
    full = lambda v: np.full((B,), v, np.float32)
    batch = dict(latents=lat[:, step], next_latents=lat[:, step + 1], timestep=full(s[0].timesteps[step]),
                 sigma=full(sig[step]), sigma_next=full(sig[step + 1]), noise_level=full(0.7), sigma_max=full(sig[1]),
                 advantage=np.asarray([1.5, -0.8], np.float32),
                 **{k: np.stack([getattr(x, k) for x in s]) for k in p.pa.embed_keys})
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "guidance_scale": jnp.float32(5.0)}
    new_lp = np.asarray(p.ja.training_forward(p.trainable, jbatch).log_prob)
    batch["old_log_prob"] = (new_lp + np.asarray([-0.05, 0.5], np.float32)).astype(np.float32)
    jbatch["old_log_prob"] = jnp.asarray(batch["old_log_prob"])
    tbatch = {**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, "guidance_scale": 5.0,
              "timestep_host": float(s[0].timesteps[step])}
    return jbatch, tbatch


def _grpo_grads(p, step):
    """The JAX trainer's ``_grad_fn`` and the port's ``loss_and_grads`` on the
    same micro-batch: (loss, aux, {component: flax LoRA grads}) each."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer

    jbatch, tbatch = _grad_batch(p, step)
    jt = _jax_trainer(p, JGRPO, copy.copy(p.ja.training_args), use_guard=False)
    (j_loss, j_aux), j_grads = jt._grad_fn(p.trainable, p.ja.frozen_velocity_params(), jbatch, None)
    pt = object.__new__(GRPOTrainer)
    pt.training_args, pt.use_guard, pt.adapter = copy.copy(p.pa.training_args), False, p.pa
    (loss, aux), grads = pt.loss_and_grads(tbatch)
    return (float(j_loss), j_aux, _host(j_grads)), (float(loss), aux, _port_grads(p.pa, grads))


def _port_grads(pa, grads):
    """The port's flat gradient list as {component: flax LoRA grads}."""
    it, ours = iter(grads), {}
    for comp in sorted(pa.trainable):
        tree = {path: {k: next(it) for k in sorted(ab)} for path, ab in sorted(pa.trainable[comp].items())}
        ours[comp] = weights.lora_to_flax(tree, pa.weight_maps()[comp][0])
    return ours


def _assert_grads_close(ours, theirs, rel=1e-4):
    """Every LoRA leaf within ``rel`` of that leaf's largest magnitude (so a
    leaf JAX gives zeros must be exactly zero)."""
    assert sorted(ours) == sorted(theirs)
    for comp in theirs:
        assert sorted(ours[comp]) == sorted(theirs[comp])
        for path, ab in theirs[comp].items():
            for k, ref in ab.items():
                err = np.abs(ours[comp][path][k] - ref).max()
                assert err <= rel * np.abs(ref).max(), f"{comp} {path}/{k}: {err} vs max {np.abs(ref).max()}"


@pytest.mark.parametrize("step,expert", [(1, "transformer_2"), (2, "transformer")])
def test_moe_grpo_grads_reach_the_routed_expert_only_as_in_jax(pairs, step, expert):
    """A grad step at a high-noise step (t 900) and at a low-noise one (t
    750, CFG at ``guidance_scale_2``): loss and aux within 1e-5, every LoRA
    leaf of both experts within 1e-4 of JAX's ``lax.cond`` gradients, the
    routed expert's non-zero and the other's exactly zero in both."""
    (j_loss, j_aux, j_grads), (loss, aux, grads) = _grpo_grads(pairs("moe"), step)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    _assert_grads_close(grads, j_grads)
    for comp, tree in grads.items():
        live = max(np.abs(v).max() for ab in tree.values() for v in ab.values())
        assert (live > 0) == (comp == expert), (comp, live)


def test_ti2v_grpo_grads_match_jax(pairs):
    """TI2V's grad step: per-frame t through every block's per-token AdaLN
    (K5's plain per-token backward) and the composite; loss within 1e-5,
    LoRA grads within 1e-4 of JAX."""
    (j_loss, _, j_grads), (loss, _, grads) = _grpo_grads(pairs("ti2v"), 1)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=1e-7)
    _assert_grads_close(grads, j_grads)


# ---------------------------------------------------------------------------
# The decoupled trainers' reference policy on the MoE against the JAX _grad_fn
# ---------------------------------------------------------------------------

def _decoupled_batch(p, trainer, t):
    """One micro-batch of 2 for ``trainer`` at the per-row timesteps ``t``:
    clean (DPO: chosen and rejected) latents, one noise draw, the rollout's
    prompt embeds, CFG 5.0; NFT's old velocity is JAX's for the LoRA with
    ``b`` x 0.8."""
    from flow_factory_tpu.trainers.decoupled import DecoupledTrainer as JDecoupled

    rng = np.random.default_rng(12)
    lat = lambda: {"latents": rng.standard_normal((2, *p.pa.latent_shape(32, 32, 5))).astype(np.float32)}
    batch = dict(noise=lat(), timestep=np.asarray(t, np.float32),
                 **{k: np.stack([getattr(x, k) for x in p.p_samples]) for k in p.pa.embed_keys})
    if trainer == "dpo":
        batch.update(chosen=lat(), rejected=lat())
    else:
        batch.update(clean=lat(), advantage=np.asarray([1.2, -0.7], np.float32))
    jb = {**jax.tree.map(jnp.asarray, batch), "guidance_scale": jnp.float32(5.0)}
    if trainer == "nft":
        old = {c: {path: {"a": ab["a"], "b": 0.8 * ab["b"]} for path, ab in tree.items()}
               for c, tree in p.trainable.items()}
        x_t = JDecoupled.tree_noised(jb["clean"], jb["noise"], jb["timestep"])
        batch["old_v"] = {"latents": np.asarray(p.ja.training_velocity(old, {**jb, **x_t}))}
        jb["old_v"] = jax.tree.map(jnp.asarray, batch["old_v"])
    tb = {**jax.tree.map(torch.from_numpy, batch), "guidance_scale": 5.0}
    return jb, tb


@pytest.mark.parametrize("t", [(900.0, 300.0), (600.0, 950.0)], ids=["row0_high", "row0_low"])
@pytest.mark.parametrize("trainer", ["dpo", "nft_kl"])
def test_moe_decoupled_reference_routes_as_jax(pairs, trainer, t):
    """DPO (β 10) and NFT with its KL term (β 0.7, ``kl_beta`` 0.5) on the
    tiny MoE, whose reference policy is the zero LoRA: JAX merges it into
    both experts and routes by ``lax.cond`` on row 0's t; the port runs the
    frozen experts and routes on the same t. Row 0 above the boundary (the
    high-noise expert at CFG 5.0) and below it (the low-noise expert at
    ``guidance_scale_2`` 3.0): loss and aux within 1e-5 (DPO's margin and
    loss, differences of the errors times β/2, within β/2 x 4 fp32 ulps of
    the largest error, as tests/test_torch_port_dpo.py holds them), every
    LoRA leaf of both experts within 1e-4 of JAX's, the untaken expert's
    exactly zero."""
    import importlib

    kind = trainer.split("_")[0]
    p = pairs("moe")
    jcls = getattr(importlib.import_module(f"flow_factory_tpu.trainers.{kind}"), f"{kind.upper()}Trainer")
    tcls = getattr(importlib.import_module(f"flow_factory_tpu_torch.trainers.{kind}"), f"{kind.upper()}Trainer")
    ta = copy.copy(p.pa.training_args)
    ta.beta, ta.nft_beta, ta.kl_beta, ta.adv_clip_range = 10.0, 0.7, 0.5, (-1.5, 1.5)
    jt, pt = _jax_trainer(p, jcls, ta), object.__new__(tcls)
    pt.training_args, pt.adapter = ta, p.pa
    jb, tb = _decoupled_batch(p, kind, t)
    (j_loss, j_aux), j_grads = jt._grad_fn(p.trainable, p.ja.frozen_velocity_params(), jb, p.ja.ref_trainable())
    (loss, aux), grads = pt.loss_and_grads(tb, pt.reference_trainable())
    if kind == "nft":
        assert float(j_aux["train/kl"]) > 0
    assert sorted(aux) == sorted(j_aux)
    bars = {}
    if kind == "dpo":
        err = max(float(j_aux["train/theta_w_err"]), float(j_aux["train/theta_l_err"]))
        bars["train/loss"] = bars["train/implicit_margin"] = 0.5 * ta.beta * 4 * float(np.spacing(np.float32(err)))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0 if bars else 1e-5, atol=bars.get("train/loss", 1e-7))
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=0 if k in bars else 1e-5,
                                   atol=bars.get(k, 1e-7), err_msg=k)
    ours = _port_grads(p.pa, grads)
    _assert_grads_close(ours, _host(j_grads))
    routed = "transformer_2" if t[0] >= 800.0 else "transformer"
    for comp, tree in ours.items():
        live = max(np.abs(v).max() for ab in tree.values() for v in ab.values())
        assert (live > 0) == (comp == routed), (comp, live)


def test_moe_lora_checkpoint_round_trips_both_experts_in_the_jax_layout(pairs, tmp_path):
    """The JAX adapter's LoRA save (``lora_transformer`` and
    ``lora_transformer_2`` files under flax names) loads into the port
    through the bridge equal to the live LoRA; the port's own save of both
    experts loads back bit for bit."""
    p = pairs("moe")
    p.ja.trainable = p.trainable
    p.ja.save_checkpoint(str(tmp_path / "jax"), save_ema=False)
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    cfg = Arguments.from_dict(_config_dict(*KINDS["moe"][:1], KINDS["moe"][1], KINDS["moe"][2]))
    pb = load_adapter(cfg, device="cpu")
    pb.load_checkpoint(str(tmp_path / "jax"))
    for comp in ("transformer", "transformer_2"):
        for path, ab in p.pa.trainable[comp].items():
            for k, v in ab.items():
                assert torch.equal(pb.trainable[comp][path][k], v), (comp, path, k)
    p.pa.save_checkpoint(str(tmp_path / "port"), save_ema=False)
    pb.trainable = {c: {path: {k: torch.zeros_like(v) for k, v in ab.items()} for path, ab in t.items()}
                    for c, t in pb.trainable.items()}
    pb.load_checkpoint(str(tmp_path / "port"))
    assert all(torch.equal(a, b) for a, b in zip(pb.trainable_leaves(), p.pa.trainable_leaves()))


# ---------------------------------------------------------------------------
# Data and registry
# ---------------------------------------------------------------------------

def test_dataset_video_field_loads_the_same_condition_video(tmp_path):
    """A record's ``video`` path (a 5-frame clip written with imageio) loads
    to the same ``condition_video`` (T, C, H, W) in [0, 1] in both
    packages; a path that cannot be read is warned about and left out."""
    import imageio.v3 as iio

    from flow_factory_tpu.data.dataset import _load_media_fields as jax_load_media
    from flow_factory_tpu_torch.data.dataset import _load_media_fields

    frames = np.random.default_rng(6).integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    iio.imwrite(tmp_path / "clip.gif", frames)
    rec = {"prompt": "a clip", "video": "clip.gif"}
    ours, theirs = _load_media_fields(rec, str(tmp_path)), jax_load_media(rec, str(tmp_path))
    assert ours["condition_video"].shape == (5, 3, 16, 16)
    np.testing.assert_array_equal(ours["condition_video"], theirs["condition_video"])
    missing = _load_media_fields({"prompt": "x", "video": "nope.gif"}, str(tmp_path))
    assert "condition_video" not in missing


def test_registry_resolves_the_wan_adapters():
    from flow_factory_tpu_torch.models.registry import resolve_adapter_class
    from flow_factory_tpu_torch.models.wan import WanI2VAdapter, WanT2VAdapter, WanV2VAdapter

    assert resolve_adapter_class("wan22") is WanT2VAdapter
    assert resolve_adapter_class("wan2-i2v") is WanI2VAdapter
    assert resolve_adapter_class("wan2-v2v") is WanV2VAdapter
