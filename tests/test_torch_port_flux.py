"""PyTorch port, the FLUX.1 slice against the JAX package, fp32 on the CPU:
the per-head qk-norm, RoPE at FLUX's axes, latent packing and image ids,
the timestep features, the tiny FLUX transformer through the weight bridge
(with the native attention and with K3's plain version against the JAX
Pallas kernel in interpret mode), the LoRA targets and the fused-linear
LoRA bridge, per-block remat, and the tiny adapter in both packages
(rollout from the same x0 and per-step noise, the dynamic-shift schedule,
decode) on the same weights, LoRA and prompts.

The timestep features: XLA's fp32 ``exp`` on the CPU is one ulp off the
correctly rounded value on about 12% of the frequencies where PyTorch's is
on 98-100% (``test_timestep_features_differ_from_jax_by_exps_last_ulp``);
at FLUX's guidance x1000 (3500 for 3.5) an ulp of a frequency moves an
angle by up to 2.4e-4 rad, which the tiny model carries to 1.3e-5 at its
output before any block. The forward and rollout comparisons therefore
feed both packages JAX's features (``shared_time_features``), as they feed
both the same noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights

PROMPTS = ["a red fox in fresh snow"] * 2 + ["a lighthouse at dusk"] * 2
SEED = 13


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_features(t, dim, *args, **kwargs):
    """The JAX sinusoidal timestep features of a torch tensor's fp32 values."""
    from flow_factory_tpu.models import layers as J

    out = J.sinusoidal_timestep_embedding(jnp.asarray(t.detach().float().numpy()), dim, *args, **kwargs)
    return torch.from_numpy(np.array(out))


@pytest.fixture
def shared_time_features(monkeypatch):
    """The port's timestep features taken from the JAX function on the same
    fp32 inputs (see the module docstring)."""
    from flow_factory_tpu_torch.models import layers as T

    monkeypatch.setattr(T, "sinusoidal_timestep_embedding", _jax_features)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qknorm_matches_jax(dtype):
    """``QKNorm`` (per-head RMS of q and k, fp32 statistics, the result cast
    back to the input dtype) against the JAX ``QKNorm`` on the same γ:
    fp32 1e-6; bf16 equal bits (both round the same fp32 value once)."""
    from flow_factory_tpu.models.layers import QKNorm as JQKNorm
    from flow_factory_tpu_torch.models.layers import QKNorm

    rng = np.random.default_rng(1)
    q, k = (rng.standard_normal((2, 3, 10, 32)).astype(np.float32) * s for s in (1.0, 4.0))
    jm = JQKNorm(32)
    params = _host(jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(k))["params"])
    params = jax.tree.map(lambda a: (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32), params)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk = jm.apply({"params": params}, jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt))
    tm = QKNorm(32)
    tm.norm_q.weight.data = torch.from_numpy(params["q_norm"]["scale"])
    tm.norm_k.weight.data = torch.from_numpy(params["k_norm"]["scale"])
    tq, tk = tm(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt))
    for ours, theirs in ((tq, jq), (tk, jk)):
        assert ours.dtype == tdt
        ref = np.asarray(theirs.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(ours.detach().float().numpy(), ref)


def test_rope_tables_and_rotation_at_flux_axes_match_jax():
    """``rope_frequencies`` over FLUX's ids (512 text tokens at (0, 0, 0),
    then the 32 x 32 image grid of 512 px) at axes (16, 56, 56), theta 1e4,
    and ``apply_rope`` on head dim 128: 1e-6 on the tables, 1e-5 on the
    rotation (|x| up to 4.5 times angles up to 31 rad)."""
    from flow_factory_tpu.models import layers as J
    from flow_factory_tpu.models.flux.adapter import Flux1Adapter as JAd
    from flow_factory_tpu_torch.models import layers as T

    ids = np.concatenate([np.zeros((512, 3), np.float32), JAd.latent_image_ids(64, 64)])
    jc, js = J.rope_frequencies(jnp.asarray(ids), (16, 56, 56), 10000.0)
    tc, ts = T.rope_frequencies(torch.from_numpy(ids), (16, 56, 56), 10000.0)
    assert tc.shape == (1536, 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    x = np.random.default_rng(2).standard_normal((1, 2, 1536, 128)).astype(np.float32)
    np.testing.assert_allclose(T.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
                               np.asarray(J.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5, rtol=0)


def test_pack_unpack_and_image_ids_equal_jax():
    """``pack_latents``/``unpack_latents`` (2x2 patches of c channels → 4c)
    and ``latent_image_ids`` are the JAX functions' values exactly, and
    unpack inverts pack."""
    from flow_factory_tpu.models.flux.adapter import Flux1Adapter as JAd
    from flow_factory_tpu_torch.models.flux.adapter import Flux1Adapter as TAd

    x = np.random.default_rng(3).standard_normal((2, 8, 12, 4)).astype(np.float32)
    packed = TAd.pack_latents(torch.from_numpy(x))
    assert packed.shape == (2, 24, 16)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JAd.pack_latents(jnp.asarray(x))))
    np.testing.assert_array_equal(TAd.unpack_latents(packed, 8, 12).numpy(), x)
    np.testing.assert_array_equal(np.asarray(JAd.unpack_latents(jnp.asarray(packed.numpy()), 8, 12)), x)
    np.testing.assert_array_equal(TAd.latent_image_ids(8, 12), JAd.latent_image_ids(8, 12))


def test_timestep_features_differ_from_jax_by_exps_last_ulp():
    """The sinusoidal features of t = 750 and of the guidance 3.5 x 1000
    agree with JAX's only as far as XLA's fp32 ``exp`` allows: the
    frequencies differ by at most one ulp, on a minority of them, PyTorch's
    being the correctly rounded value where they differ; the features then
    differ by at most the angle that ulp moves (t x ulp), plus an ulp of
    the angle (the product's own rounding), plus 1e-6."""
    import math

    from flow_factory_tpu.models import layers as J
    from flow_factory_tpu_torch.models import layers as T

    half = 128
    exponent = (-math.log(10000) * np.arange(half, dtype=np.float32)) / np.float32(half)
    j_freq = np.asarray(jnp.exp(jnp.asarray(exponent)))
    t_freq = torch.exp(torch.from_numpy(exponent)).numpy()
    exact = np.exp(exponent.astype(np.float64)).astype(np.float32)
    ulp = np.spacing(exact)
    assert np.all(np.abs(j_freq - t_freq) <= ulp) and (j_freq != t_freq).mean() < 0.2
    assert (t_freq == exact).mean() > (j_freq == exact).mean()
    t = np.asarray([750.0, 3500.0], np.float32)
    ours = T.sinusoidal_timestep_embedding(torch.from_numpy(t), 256).numpy()
    theirs = np.asarray(J.sinusoidal_timestep_embedding(jnp.asarray(t), 256))
    angle = t[:, None] * exact[None, :]
    bound = t[:, None] * ulp[None, :] + np.spacing(angle) + 1e-6
    bound = np.concatenate([bound, bound], axis=1)
    assert np.all(np.abs(ours - theirs) <= bound)


@pytest.mark.parametrize("which", ["timestep", "pooled"])
def test_time_and_pooled_embedders_match_jax(which, shared_time_features):
    """``TimestepEmbedding`` (FLUX's time and guidance embedders: the
    sinusoidal features of t and of guidance x 1000, then a SiLU MLP) and
    ``PooledTextEmbedding`` (the CLIP-L pooled vector's MLP) against the JAX
    ``TimestepEmbedder``/``PooledTextEmbedder`` on the same Dense kernels,
    fp32: 1e-5 relative to the output's max."""
    from flow_factory_tpu.models import layers as J
    from flow_factory_tpu_torch.models import layers as T

    rng = np.random.default_rng(12)
    if which == "timestep":
        x = np.asarray([750.0, 3500.0, 12.5], np.float32)
        jm, tm = J.TimestepEmbedder(64), T.TimestepEmbedding(64)
    else:
        x = rng.standard_normal((3, 16)).astype(np.float32)
        jm, tm = J.PooledTextEmbedder(64), T.PooledTextEmbedding(16, 64)
    params = _host(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    weights.load_component(tm, weights.convert(params, {"linear_1": "linear_1", "linear_2": "linear_2"}))
    theirs = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == (3, 64)
    np.testing.assert_allclose(ours, theirs, atol=1e-5 * np.abs(theirs).max(), rtol=0)


# ---------------------------------------------------------------------------
# The transformer through the bridge
# ---------------------------------------------------------------------------

def _flux_inputs(rng, B=2, L=16, Lt=5):
    from flow_factory_tpu.models.flux.adapter import Flux1Adapter as JAd

    return dict(
        latents=rng.standard_normal((B, L, 16)).astype(np.float32),
        timestep=np.asarray([750.0, 300.0][:B], np.float32),
        ctx=rng.standard_normal((B, Lt, 48)).astype(np.float32),
        pooled=rng.standard_normal((B, 16)).astype(np.float32),
        img_ids=JAd.latent_image_ids(8, 8),
        txt_ids=np.zeros((Lt, 3), np.float32),
        guidance=np.full((B,), 3.5, np.float32),
    )


def _port_transformer(flax_params, **kw):
    from flow_factory_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer

    cfg = FluxConfig.tiny(dtype="float32", **kw)
    module = build_module(lambda: FluxTransformer(cfg), torch.device("cpu"), torch.float32, None)
    weights.load_component(module, weights.convert(flax_params, *weights.flux1_transformer_map(
        cfg.num_double_blocks, cfg.num_single_blocks)))
    return module


@pytest.mark.parametrize("backend", ["native", "flash"])
def test_flux_transformer_matches_jax_through_bridge(backend, shared_time_features):
    """The tiny FLUX.1 (2 double + 2 single blocks, packed 8x8 latents, 5
    text tokens, guidance 3.5) on the flax module's random init perturbed by
    0.02 noise, through the bridge: 2e-5, the single-forward bar of
    tests/test_torch_reference.py. ``flash``: K3's plain version in the port
    against the JAX Pallas kernel in interpret mode."""
    from flow_factory_tpu.models.flux.transformer import FluxConfig as JCfg, FluxTransformer as JT

    rng = np.random.default_rng(0)
    x = _flux_inputs(rng)
    args = [x[k] for k in ("latents", "timestep", "ctx", "pooled", "img_ids", "txt_ids", "guidance")]
    jm = JT(JCfg.tiny(dtype="float32", attn_backend=backend))
    params = _host(jm.init(jax.random.PRNGKey(0), *args)["params"])
    params = jax.tree.map(lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype), params)
    theirs = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = _port_transformer(params, attn_backend=backend)
    with torch.no_grad():
        ours = tm(*map(torch.from_numpy, args)).numpy()
    assert ours.shape == theirs.shape == x["latents"].shape
    assert np.max(np.abs(ours - theirs)) < 2e-5


def test_flux_remat_gives_the_same_bits_and_gradients():
    """Per-block remat (``torch.utils.checkpoint`` through
    ``layers.checkpointed``) recomputes every double and single block in the
    backward and changes no bit of the output or of any LoRA gradient, the
    fused ``linear1``/``linear2`` ones included."""
    import dataclasses

    from flow_factory_tpu_torch.models import layers
    from flow_factory_tpu_torch.models.flux.adapter import FLUX_LORA_TARGETS
    from flow_factory_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer
    from flow_factory_tpu_torch.models.lora import init_lora, merge_lora
    from torch.func import functional_call

    gen = torch.Generator().manual_seed(4)
    model = build_module(lambda: FluxTransformer(FluxConfig.tiny(dtype="float32")), torch.device("cpu"),
                         torch.float32, gen)
    lora = init_lora(model, 4, gen, FLUX_LORA_TARGETS)
    for ab in lora.values():
        ab["lora_B"].data.normal_(0.0, 0.05, generator=gen)
    leaves = [ab[k] for p, ab in sorted(lora.items()) for k in ("lora_A", "lora_B")]
    args = [torch.from_numpy(v) for v in _flux_inputs(np.random.default_rng(5)).values()]
    runs = []
    calls = []
    real = layers.checkpointed

    def counting(block, *inputs):
        calls.append(type(block).__name__)
        return real(block, *inputs)

    for remat in (False, True):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        import flow_factory_tpu_torch.models.flux.transformer as FT

        FT.checkpointed = counting
        try:
            out = functional_call(model, merge_lora(model, lora, 2.0), tuple(args))
            grads = torch.autograd.grad((out * out).sum(), leaves)
        finally:
            FT.checkpointed = real
        runs.append((out.detach(), grads))
    assert calls == ["FluxDoubleBlock"] * 2 + ["FluxSingleBlock"] * 2
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(g.abs().max() > 0 for g in runs[0][1][1::2])


# ---------------------------------------------------------------------------
# The tiny adapter in both packages
# ---------------------------------------------------------------------------

def _config_dict(**sections):
    cfg = {
        "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
        "model": {"model_type": "flux1", "model_name_or_path": "tiny", "finetune_type": "lora",
                  "lora_rank": 4, "lora_alpha": 8, "attn_backend": "auto",
                  "master_dtype": "float32", "inference_dtype": "float32"},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2,
                      "sde_steps": [0, 1, 2]},
        "train": {"trainer_type": "dpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 3.5,
                  "per_device_batch_size": 2, "group_size": 2, "unique_sample_num_per_epoch": 2,
                  "latent_storage_dtype": "fp32"},
        "eval": {}, "log": {}, "rewards": [],
    }
    for section, values in sections.items():
        cfg[section] = {**cfg[section], **values}
    return cfg


def _jax_noise(B, shape, packed, T):
    """The x0 (unpacked, per row) and the per-step packed noise the JAX
    adapter draws for ``seed=SEED`` (``flux/adapter.py:359-365`` and the
    scan body, ``models/abc.py:976``)."""
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    k = jax.random.fold_in(keys[0], 7)
    noise = []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (B, *packed), jnp.float32)))
    return x0, noise


@pytest.fixture(scope="module")
def both():
    """Both tiny FLUX adapters on the JAX adapter's weights and a LoRA with
    non-zero B on every FLUX target, one Flow-SDE rollout each from the same
    x0 and noise, with the same timestep features."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import layers as TL
    from flow_factory_tpu_torch.models import load_adapter

    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_config_dict(model={"attn_backend": "native"})))
        rng = np.random.default_rng(6)
        lora = _host(ja.trainable["transformer"])
        lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for p, ab in lora.items()}
        ja.rollout()
        j_samples = ja.inference(prompt=PROMPTS, seed=SEED,
                                 trainable={"transformer": jax.tree.map(jnp.asarray, lora)})
        flax_params = _host(ja.params)
    finally:
        set_world_size_override(None)

    pa = load_adapter(Arguments.from_dict(_config_dict()), device="cpu")
    pa.load_state_dicts(weights.flux1_state_dicts(flax_params, pa.component_configs))
    module_map = weights.flux1_component_maps(pa.component_configs)["transformer"][0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    h, w, c = pa.latent_shape(32, 32)
    x0, noise = _jax_noise(len(PROMPTS), (h, w, c), ((h // 2) * (w // 2), 4 * c), 4)
    real = TL.sinusoidal_timestep_embedding
    TL.sinusoidal_timestep_embedding = _jax_features
    try:
        pa.rollout()
        p_samples = pa.inference(prompt=PROMPTS, x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise])
    finally:
        TL.sinusoidal_timestep_embedding = real
    return ja, pa, lora, module_map, j_samples, p_samples


def test_flux_lora_targets_and_fused_lora_bridge_match_jax(both):
    """FLUX_LORA_TARGETS picks the same 28 weights in both packages (2
    double blocks x 8 attention projections and 4 FFN linears, 2 single
    blocks x the fused ``linear1``/``linear2``): the JAX LoRA tree bridges
    onto the port's live tree path for path and back exactly, and the port's
    merge of the fused weights equals the JAX merge through the bridge
    (fp32, 1e-6)."""
    from flow_factory_tpu.models.lora import merge_lora as jmerge

    ja, pa, lora, module_map = both[:4]
    paths = sorted(pa.trainable["transformer"])
    assert len(paths) == 28 == len(lora)
    assert sum(p.endswith(("linear1", "linear2")) for p in paths) == 4
    back = weights.lora_to_flax(pa.trainable["transformer"], module_map)
    assert set(back) == set(lora)
    for path, ab in lora.items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(back[path][k], ab[k])
    assert pa.trainable["transformer"]["single_transformer_blocks.0.linear1"]["lora_A"].shape == (4, 64)
    assert pa.trainable["transformer"]["single_transformer_blocks.0.linear1"]["lora_B"].shape == (3 * 64 + 256, 4)
    merged = pa.merged_params("transformer")
    theirs = weights.convert(_host(jmerge(ja.params["transformer"], jax.tree.map(jnp.asarray, lora), ja.lora_scale)),
                             *weights.flux1_transformer_map(2, 2))
    assert len(merged) == 28
    for name, w in merged.items():
        np.testing.assert_allclose(w.detach().numpy(), theirs[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_flux_rollout_trajectory_schedule_and_images_match_jax(both):
    """The 4-step Flow-SDE rollout with embedded guidance 3.5 and no CFG
    doubling: the prompt embeddings (T5 context, CLIP-L pooled) 1e-5, the
    dynamic-shift sigmas (mu from 16 image tokens) equal, every stored
    packed latent and the SDE steps' log-probs 1e-4 (the trajectory bar of
    tests/test_torch_reference.py), the ids equal, and the decoded images in
    [0, 1] 1e-4."""
    _, _, _, _, j_samples, p_samples = both
    np.testing.assert_array_equal(p_samples[0].extra_kwargs["sigmas"], j_samples[0].extra_kwargs["sigmas"])
    sde = np.nonzero(p_samples[0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2
    for js, ps in zip(j_samples, p_samples):
        np.testing.assert_allclose(ps.prompt_embeds, js.prompt_embeds, atol=1e-5, rtol=0)
        np.testing.assert_allclose(ps.extra_kwargs["pooled_prompt_embeds"], js.extra_kwargs["pooled_prompt_embeds"],
                                   atol=1e-5, rtol=0)
        for key in ("img_ids", "txt_ids"):
            np.testing.assert_array_equal(ps.extra_kwargs[key], js.extra_kwargs[key])
        assert ps.all_latents.shape == js.all_latents.shape == (5, 64, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4, rtol=0)
        assert ps.image.shape == js.image.shape == (3, 32, 32)
        assert ps.image.min() >= 0.0 and ps.image.max() <= 1.0
        np.testing.assert_allclose(ps.image, js.image, atol=1e-4, rtol=0)


def test_flux_replay_ratio_is_exactly_one(both, shared_time_features):
    """The no-grad replay over FLUX's embed keys (the pooled embeds and ids
    from ``extra_kwargs``) gives exp(new − old) == 1.0 exactly on every
    stored step (with the features the rollout ran on)."""
    pa, p_samples = both[1], both[5]
    new = pa.replay_log_probs(p_samples)
    old = np.stack([s.log_probs for s in p_samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i


def test_unported_flux_family_members_raise():
    """Every FLUX family member resolves to the port's adapter now that
    FLUX.2 and Klein are ported: ``flux1``, ``flux1-kontext``, ``flux2`` and
    ``flux2-klein``; none raises."""
    from flow_factory_tpu_torch.models.flux.adapter import Flux1Adapter
    from flow_factory_tpu_torch.models.flux.flux2 import Flux2Adapter, Flux2KleinAdapter
    from flow_factory_tpu_torch.models.flux.kontext import Flux1KontextAdapter
    from flow_factory_tpu_torch.models.registry import resolve_adapter_class

    assert resolve_adapter_class("flux1") is Flux1Adapter
    assert resolve_adapter_class("flux1-kontext") is Flux1KontextAdapter
    assert resolve_adapter_class("flux2") is Flux2Adapter
    assert resolve_adapter_class("flux2-klein") is Flux2KleinAdapter


def test_every_jax_model_type_resolves_or_names_its_item():
    """Every key of the JAX package's adapter registry resolves in the port
    to the adapter class of the same name: none raises
    ``NotImplementedError`` or ``KeyError``, and ``ported`` lists them all."""
    from flow_factory_tpu.models.registry import _MODEL_ADAPTER_REGISTRY as JAX_KEYS
    from flow_factory_tpu_torch.models.registry import resolve_adapter_class

    ported = []
    for key, target in JAX_KEYS.items():
        cls = resolve_adapter_class(key)
        assert cls.__name__ == target.split(":")[1], key
        ported.append(key)
    assert sorted(ported) == sorted(JAX_KEYS) == ["flux1", "flux1-kontext", "flux2", "flux2-klein", "ltx2-i2av",
                                                  "ltx2-t2av", "qwen-image", "qwen-image-edit-plus", "sd3-5", "sd3.5",
                                                  "wan2-i2v", "wan2-t2v", "wan2-v2v", "wan21", "wan22", "z-image"]
