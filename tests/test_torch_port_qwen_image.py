"""PyTorch port, the Qwen-Image and Qwen-Image-Edit-Plus slice against the
JAX package, fp32 on the CPU at tiny size: the LM with q/k/v biases, M-RoPE
and the vision scatter; the vision tower's host preprocessing (bit-equal)
and its windowed and full blocks; the FLUX transformer with ``txt_norm``
and no single blocks; the weight bridge; a CFG rollout of each adapter from
the same x0 and noise with its decode and its replay (ratio exactly 1.0);
the GRPO loss and LoRA gradients against the JAX ``_grad_fn``; the pin of
F15 (Edit-Plus takes the condition ids of the batch's first row for every
row, in both packages); the depth cut read from a ``config.json``; one GRPO
epoch through ``load_trainer``.

One tiny JAX adapter of each kind is built once for the module; the port's
twins run on its weights through the bridge and a LoRA with a non-zero
``b``; the velocities take the JAX timestep features
(``shared_time_features``, tests/test_torch_port_flux.py). Bars: ROADMAP's
"Match", a single forward 2e-5, a trajectory 1e-4."""
import copy
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _config_dict, _host, _jax_features, shared_time_features  # noqa: F401

REPO = os.path.dirname(os.path.abspath(__file__)).rsplit(os.sep, 1)[0]
DATASET = os.path.join(REPO, "dataset", "multi_ref_image")
CUT = os.path.join(REPO, "tests", "fixtures", "qwen_image_cut")
SMOKE = os.path.join(REPO, "tests", "fixtures", "smoke_grpo_qwen_image.yaml")
SEED = 15
G = 4.0
#: the Edit-Plus rollout's rows: the two-reference record twice, then the one-reference record twice
ROWS = [0, 0, 1, 1]


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _cfg(model_type, **data):
    return _config_dict(data={"dataset_dir": DATASET, **data}, model={"model_type": model_type},
                        train={"trainer_type": "grpo", "clip_range": 0.2, "adv_clip_range": 1.5,
                               "guidance_scale": G})


def _records():
    from flow_factory_tpu_torch.data.dataset import _load_media_fields, load_raw_records

    recs = [_load_media_fields(r, DATASET) for r in load_raw_records(os.path.join(DATASET, "train.jsonl"))]
    return {"prompt": [r["prompt"] for r in recs], "images": [r["images"] for r in recs]}


def _jax_noise(B, shape, packed, T):
    """The x0 (unpacked, per row) and the per-step packed noise the JAX FLUX
    rollout draws for ``seed=SEED`` (``flux/adapter.py:359-365``)."""
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    k = jax.random.fold_in(keys[0], 7)
    noise = []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (B, *packed), jnp.float32)))
    return x0, noise


def _twin(model_type, ja, rng):
    """The port adapter on the JAX adapter's weights and a LoRA with a
    non-zero ``b`` (set on both); returns (port adapter, flax LoRA, transformer map)."""
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for p, ab in _host(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
    pa = load_adapter(Arguments.from_dict(_cfg(model_type)), device="cpu")
    pa.load_state_dicts(weights.qwen_image_state_dicts(_host(ja.params), pa.component_configs))
    module_map = weights.qwen_image_component_maps(pa.component_configs)["transformer"][0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    return pa, lora, module_map


def _port_rollout(pa, B, **kwargs):
    from flow_factory_tpu_torch.models import layers as TL

    h, w, c = pa.latent_shape(32, 32)
    x0, noise = _jax_noise(B, (h, w, c), ((h // 2) * (w // 2), 4 * c), 4)
    real = TL.sinusoidal_timestep_embedding
    TL.sinusoidal_timestep_embedding = _jax_features
    try:
        pa.rollout()
        return pa.inference(x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise], **kwargs)
    finally:
        TL.sinusoidal_timestep_embedding = real
        pa.train()


@pytest.fixture(scope="module")
def qwen():
    """The tiny Qwen-Image pair and one 4-step CFG rollout each of two
    prompts (the JAX package's embeddings, x0 and noise)."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override

    prompts = ["a sunflower field under a stormy sky", "a vintage car parked by the ocean"]
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_cfg("qwen-image", dataset_dir="tests/fixtures/tiny_prompts")))
        pa, lora, module_map = _twin("qwen-image", ja, np.random.default_rng(6))
        j_pre = ja.preprocess_func({"prompt": prompts})
        ja.rollout()
        j_samples = ja.inference(prompt=prompts, seed=SEED, prompt_embeds=j_pre["prompt_embeds"],
                                 negative_prompt_embeds=j_pre["negative_prompt_embeds"])
        ja.train()
    finally:
        set_world_size_override(None)
    p_pre = pa.preprocess_func({"prompt": prompts})
    p_samples = _port_rollout(pa, 2, prompt=prompts, prompt_embeds=j_pre["prompt_embeds"],
                              negative_prompt_embeds=j_pre["negative_prompt_embeds"])
    return dict(ja=ja, pa=pa, j_pre=j_pre, p_pre=p_pre, module_map=module_map, j_samples=j_samples,
                p_samples=p_samples)


@pytest.fixture(scope="module")
def edit():
    """The tiny Edit-Plus pair, each package's preprocessing of the two
    records of dataset/multi_ref_image, and one 4-step CFG rollout each of
    the rows ``ROWS`` on the JAX package's embeddings and condition tokens."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override

    recs = _records()
    prompts = [recs["prompt"][r] for r in ROWS]
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_cfg("qwen-image-edit-plus")))
        pa, lora, module_map = _twin("qwen-image-edit-plus", ja, np.random.default_rng(8))
        j_pre = ja.preprocess_func(copy.deepcopy(recs))
        ja.rollout()
        j_samples = ja.inference(prompt=prompts, seed=SEED, **{k: v[ROWS] for k, v in j_pre.items()})
        ja.train()
    finally:
        set_world_size_override(None)
    p_pre = pa.preprocess_func(copy.deepcopy(recs))
    p_samples = _port_rollout(pa, len(ROWS), prompt=prompts, **{k: v[ROWS] for k, v in j_pre.items()})
    return dict(ja=ja, pa=pa, recs=recs, j_pre=j_pre, p_pre=p_pre, module_map=module_map, j_samples=j_samples,
                p_samples=p_samples)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_lm_biases_mrope_and_vision_scatter_match_jax():
    """The Qwen2.5-VL LM layout (q/k/v biases, M-RoPE sections (2, 1, 1) at
    head dim 8) through the bridge: plain, with per-row (t, h, w) ids and
    vision embeddings scattered into the image-pad rows, fp32 within 2e-5 of
    the JAX ``LMEncoder`` (which takes one row's ids a call); ids equal on
    the three axes give the 1-D RoPE's states; the scatter changes exactly
    the rows from the first pad on."""
    from flow_factory_tpu.models.text_encoders.lm import LMConfig as JCfg, LMEncoder as JLM
    from flow_factory_tpu_torch.models.text_encoders.lm import LMConfig, LMEncoder
    from flow_factory_tpu_torch.utils import weights

    kw = dict(vocab_size=1000, hidden_dim=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8, mlp_dim=64,
              rope_theta=10000.0, attn_bias=True, mrope_sections=(2, 1, 1), dtype="float32")
    rng = np.random.default_rng(3)
    B, L, Lv = 2, 12, 5
    ids = rng.integers(3, 1000, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    vis_mask = np.zeros((B, L), bool)
    vis_mask[0, :5] = True
    vis_mask[1, :3] = True
    vis = rng.standard_normal((B, Lv, 32)).astype(np.float32)
    pos = np.stack([np.stack([np.r_[np.zeros(5), 2 + np.arange(L - 5)], np.r_[[0, 0, 1, 1, 2], 2 + np.arange(L - 5)],
                              np.r_[[0, 1, 0, 1, 0], 2 + np.arange(L - 5)]]) for _ in range(B)]).astype(np.float32)
    jm = JLM(JCfg(**kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids[:1]))["params"]
    apply = jax.jit(lambda p, *a, **k: jm.apply({"params": p}, *a, **k))
    params = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    pm = LMEncoder(LMConfig(**kw))
    pm.load_state_dict(weights.convert(_host(params), *weights.lm_decoder_map(2)), strict=True)
    T = lambda a: torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        plain = pm(T(ids).long(), T(mask)).numpy()
        ours = pm(T(ids).long(), T(mask), vision_embeds=T(vis), vision_mask=T(vis_mask), position_ids=T(pos)).numpy()
        flat = pm(T(ids).long(), T(mask), position_ids=T(np.broadcast_to(np.arange(L, dtype=np.float32),
                                                                          (B, 3, L)).copy())).numpy()
    np.testing.assert_allclose(plain, np.asarray(apply(params, ids, mask)), atol=2e-5, rtol=0)
    np.testing.assert_allclose(flat, plain, atol=1e-6, rtol=0)
    for b in range(B):
        theirs = np.asarray(apply(params, ids[b:b + 1], mask[b:b + 1], vision_embeds=vis[b:b + 1],
                                  vision_mask=vis_mask[b:b + 1], position_ids=pos[b]))[0]
        np.testing.assert_allclose(ours[b], theirs, atol=2e-5, rtol=0)
    assert np.abs(ours - plain).max() > 1e-2


@pytest.mark.parametrize("hw", [(64, 64), (90, 47), (20, 200)])
def test_vision_host_preprocessing_is_bit_equal_to_jax(hw):
    """``smart_resize``, the bilinear resize, ``preprocess_vision_image`` at
    the 384² area and a small one, ``window_layout`` and ``rot_pos_ids`` of
    the full and the tiny tower give the JAX functions' arrays bit for bit."""
    from flow_factory_tpu.models.text_encoders import vl_vision as J
    from flow_factory_tpu_torch.models.text_encoders import vl_vision as T

    img = np.random.default_rng(sum(hw)).random((3, *hw)).astype(np.float32)
    for area in (384 * 384, 56 * 56):
        for make in ("qwen25_vl", "tiny"):
            jc, tc = getattr(J.VLVisionConfig, make)(), getattr(T.VLVisionConfig, make)()
            assert T.smart_resize(*hw, 28) == J.smart_resize(*hw, 28)
            np.testing.assert_array_equal(T._bilinear_resize_chw(img, 33, 17), J._bilinear_resize_chw(img, 33, 17))
            flat, grid = T.preprocess_vision_image(img, tc, area)
            jflat, jgrid = J.preprocess_vision_image(img, jc, area)
            assert grid == jgrid and flat.dtype == np.float32
            np.testing.assert_array_equal(flat, jflat)
            for a, b in zip(T.window_layout(grid, tc), J.window_layout(jgrid, jc)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(T.rot_pos_ids(grid, 2), J.rot_pos_ids(jgrid, 2))


def test_vision_tower_windowed_and_full_blocks_match_jax():
    """The tiny tower (block 0 windowed, block 1 full) on a 16 x 24-patch
    grid (2 x 3 windows of 4 x 4 merged positions) through the bridge: the
    merged embeddings (96, 32) in merged row-major order, fp32 within 2e-5
    of the JAX ``VLVisionTower``; with every block windowed it differs."""
    import dataclasses

    from flow_factory_tpu.models.text_encoders import vl_vision as J
    from flow_factory_tpu_torch.models.text_encoders import vl_vision as T
    from flow_factory_tpu_torch.utils import weights

    jc, tc = J.VLVisionConfig.tiny(dtype="float32"), T.VLVisionConfig.tiny(dtype="float32")
    grid = (1, 16, 24)
    rng = np.random.default_rng(4)
    patches = rng.standard_normal((16 * 24, tc.patch_dim)).astype(np.float32)
    perm, inv, mask = T.window_layout(grid, tc)
    pos = T.rot_pos_ids(grid, 2)
    assert mask.sum() == 6 * 64 ** 2
    jm = J.VLVisionTower(jc)
    args = tuple(jnp.asarray(a) for a in (patches, pos, perm, mask, inv))
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), *args)["params"]
    theirs = np.asarray(jax.jit(jm.apply)({"params": params}, *args))
    pm = T.VLVisionTower(tc)
    pm.load_state_dict(weights.convert(_host(params), *weights.vl_vision_map(tc.depth)), strict=True)
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in (patches, pos, perm, mask, inv))
    with torch.no_grad():
        ours = pm(*targs).numpy()
        pm.cfg = dataclasses.replace(tc, fullatt_block_indexes=())
        windowed = pm(*targs).numpy()
    assert ours.shape == theirs.shape == (96, 32) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)
    assert np.abs(windowed - theirs).max() > 1e-3


def test_flux_transformer_with_txt_norm_and_no_single_blocks_matches_jax(shared_time_features):
    """Qwen-Image's transformer form (``txt_norm``, no pooled vector, no
    guidance embedding, two double blocks and no single block) through the
    bridge: (2, 16, 16) fp32 within 2e-5 of the JAX ``FluxTransformer``, with
    remat too (bit-identical to without), and ``txt_norm`` moves it."""
    import dataclasses

    from flow_factory_tpu.models.flux.transformer import FluxConfig as JCfg, FluxTransformer as JFlux
    from flow_factory_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer
    from flow_factory_tpu_torch.utils import weights

    kw = dict(pooled_dim=0, guidance_embeds=False, num_single_blocks=0, num_double_blocks=2, context_dim=32,
              txt_norm=True, dtype="float32", attn_backend="native")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    ctx = (3.0 * rng.standard_normal((2, 6, 32))).astype(np.float32)
    t = np.asarray([800.0, 120.0], np.float32)
    img_ids = np.stack([np.zeros(16), np.repeat(np.arange(4), 4), np.tile(np.arange(4), 4)], 1).astype(np.float32)
    txt_ids = np.zeros((6, 3), np.float32)
    jm = JFlux(JCfg.tiny(**kw))
    init = jax.jit(lambda k, *a: jm.init(k, a[0], a[1], a[2], None, a[3], a[4]))
    params = init(jax.random.PRNGKey(0), x, t, ctx, img_ids, txt_ids)["params"]
    params = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(jax.random.PRNGKey(3), a.shape), params)
    theirs = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, a[0], a[1], a[2], None, a[3], a[4]))(
        params, x, t, ctx, img_ids, txt_ids))
    m, raw = weights.qwen_image_transformer_map(2)
    sd = weights.convert(_host(params), m, raw)
    outs = {}
    for remat in (False, True):
        pm = FluxTransformer(FluxConfig.tiny(**kw, remat=remat))
        pm.load_state_dict(sd, strict=True)
        args = (torch.from_numpy(x).requires_grad_(), torch.from_numpy(t), torch.from_numpy(ctx), None,
                torch.from_numpy(img_ids), torch.from_numpy(txt_ids))
        out = pm(*args)
        out.square().sum().backward()
        outs[remat] = (out.detach().numpy(), args[0].grad.numpy())
    np.testing.assert_allclose(outs[False][0], theirs, atol=2e-5, rtol=0)
    assert all(np.array_equal(a, b) for a, b in zip(outs[False], outs[True]))
    pm = FluxTransformer(FluxConfig.tiny(**{**kw, "txt_norm": False}))
    pm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("txt_norm")}, strict=True)
    with torch.no_grad():
        plain = pm(*(torch.from_numpy(a) for a in (x, t, ctx)), None, torch.from_numpy(img_ids),
                   torch.from_numpy(txt_ids)).numpy()
    assert np.abs(plain - theirs).max() > 1e-3
    assert dataclasses.replace(FluxConfig.tiny(), txt_norm=True).txt_norm


def test_bridge_maps_every_leaf_and_lora_round_trips(edit):
    """``qwen_image_state_dicts`` maps every flax leaf of the tiny Edit-Plus
    (transformer, LM, VAE, vision tower) onto every port parameter, values
    equal (kernels transposed); the LoRA comes back from the port equal;
    an unknown leaf raises."""
    from flow_factory_tpu_torch.utils import weights

    ja, pa = edit["ja"], edit["pa"]
    flax = _host(ja.params)
    assert set(flax) == set(pa.modules) == {"transformer", "text_encoder", "vae", "vision_tower"}
    sds = weights.qwen_image_state_dicts(flax, pa.component_configs)
    for comp, sd in sds.items():
        live = pa.modules[comp].state_dict()
        assert set(sd) == set(live), comp
        assert all(torch.equal(sd[k], live[k]) for k in sd), comp
    np.testing.assert_array_equal(sds["transformer"]["txt_norm.weight"].numpy(), flax["transformer"]["txt_norm"]["scale"])
    back = weights.lora_to_flax(pa.trainable["transformer"], edit["module_map"])
    for path, ab in _host(ja.trainable["transformer"]).items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(back[path][k], ab[k])
    with pytest.raises(KeyError):
        weights.convert({"unknown": {"kernel": np.zeros((2, 2))}}, *weights.qwen_image_transformer_map(1))


def test_depth_cut_from_config_json_in_both_packages(tmp_path):
    """tests/fixtures/qwen_image_cut: ``transformer/config.json`` sets the
    depth of the full-width preset, read alike by both packages'
    ``apply_config_json_overrides``; a directory without it, a partial LM
    config and a VAE config override what they name."""
    from flow_factory_tpu.models.flux.transformer import FluxConfig as JCfg
    from flow_factory_tpu.models.text_encoders.lm import LMConfig as JLM
    from flow_factory_tpu.models.vae import VAEConfig as JVAE
    from flow_factory_tpu.utils import checkpoint as J
    from flow_factory_tpu_torch.models.flux.transformer import FluxConfig
    from flow_factory_tpu_torch.models.text_encoders.lm import LMConfig
    from flow_factory_tpu_torch.models.vae import VAEConfig
    from flow_factory_tpu_torch.utils import model_config as T

    with open(os.path.join(CUT, "transformer", "config.json")) as f:
        depth = json.load(f)["num_layers"]
    ours = T.apply_config_json_overrides(FluxConfig(num_single_blocks=0), CUT, "transformer",
                                         T.flux_transformer_overrides_from_config)
    theirs = J.apply_config_json_overrides(JCfg(num_single_blocks=0), CUT, "transformer",
                                           J.flux_transformer_overrides_from_config)
    assert ours.num_double_blocks == theirs.num_double_blocks == depth >= 16 and ours.hidden_dim == 3072
    (tmp_path / "text_encoder").mkdir()
    (tmp_path / "vae").mkdir()
    (tmp_path / "text_encoder" / "config.json").write_text(json.dumps(
        {"model_type": "qwen2", "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4}))
    (tmp_path / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": [32, 64], "latent_channels": 4, "scaling_factor": 0.5}))
    for fn, ccls, jcls, sub in (("lm_overrides_from_config", LMConfig, JLM, "text_encoder"),
                                ("image_vae_overrides_from_config", VAEConfig, JVAE, "vae")):
        a = T.apply_config_json_overrides(ccls(), str(tmp_path), sub, getattr(T, fn))
        b = J.apply_config_json_overrides(jcls(), str(tmp_path), sub, getattr(J, fn))
        for field in a.__dataclass_fields__:
            if hasattr(b, field):
                assert getattr(a, field) == getattr(b, field), (sub, field)
    assert T.apply_config_json_overrides(FluxConfig(), str(tmp_path), "transformer",
                                         T.flux_transformer_overrides_from_config) == FluxConfig()


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------

def test_qwen_image_encode_and_cfg_rollout_match_jax(qwen):
    """Qwen-Image: the prompts and the " " negatives through the LM with
    biases, 1e-5 of JAX's; the 4-step true-CFG Flow-SDE rollout: every stored
    latent and the SDE steps' log-probs within the trajectory bar 1e-4, the
    decoded images 1e-4; each sample keeps its negative embeddings."""
    for key in ("prompt_embeds", "negative_prompt_embeds"):
        np.testing.assert_allclose(qwen["p_pre"][key], qwen["j_pre"][key], atol=1e-5, rtol=0)
    _same_rollout(qwen["j_samples"], qwen["p_samples"], qwen["j_pre"], range(2))


def _same_rollout(j_samples, p_samples, pre, rows):
    sde = np.nonzero(p_samples[0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2
    for row, js, ps in zip(rows, j_samples, p_samples):
        assert ps.all_latents.shape == js.all_latents.shape == (5, 64, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.image, js.image, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(ps.negative_prompt_embeds, pre["negative_prompt_embeds"][row])
        assert "negative_prompt_embeds" not in ps.extra_kwargs


def test_edit_plus_preprocess_matches_jax(edit):
    """Edit-Plus preprocessing of dataset/multi_ref_image: the vision tower
    on each reference (64 px → the 392² grid, 196 merged tokens), scattered
    into the leading image pads with M-RoPE ids, at the fixed length 16 +
    197 x 3 = 607: prompt and " " negative states (2, 607, 32) within 2e-5
    of JAX's; the condition tokens 2e-5, their ids exactly."""
    j_pre, p_pre, pa = edit["j_pre"], edit["p_pre"], edit["pa"]
    assert pa.vl_total_length == 607
    assert set(p_pre) == set(j_pre) == {"prompt_embeds", "negative_prompt_embeds", "cond_latents", "cond_ids"}
    for key in ("prompt_embeds", "negative_prompt_embeds"):
        assert p_pre[key].shape == (2, 607, 32)
        np.testing.assert_allclose(p_pre[key], j_pre[key], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(p_pre["cond_ids"], j_pre["cond_ids"])
    np.testing.assert_allclose(p_pre["cond_latents"], j_pre["cond_latents"], atol=2e-5, rtol=0)
    host, vis = pa.vision_rows(edit["recs"]["prompt"], edit["recs"]["images"])
    assert host["vis_mask"].sum(1).tolist() == [392, 196] and vis.shape == (2, 392, 32)
    assert host["pos_ids"][0, 0, 196] == 14 and host["pos_ids"][0, 1, 391] == 14 + 13


def test_edit_plus_cfg_rollout_matches_jax(edit):
    """The 4-step true-CFG rollout with the condition tokens on every step
    (64 target + 512 condition + 607 text tokens): the trajectory bar 1e-4,
    images 1e-4; each sample keeps its row of the condition tokens and ids
    and of the negatives, and its reference images."""
    pre = edit["j_pre"]
    _same_rollout(edit["j_samples"], edit["p_samples"], {k: v[ROWS] for k, v in pre.items()}, range(len(ROWS)))
    for row, ps in zip(ROWS, edit["p_samples"]):
        for key in ("cond_latents", "cond_ids"):
            np.testing.assert_array_equal(ps.extra_kwargs[key], pre[key][row])


@pytest.mark.parametrize("which", ["qwen", "edit"])
def test_replay_ratio_is_exactly_one(which, request, shared_time_features):
    """The no-grad replay of every stored step, the negatives and (Edit-Plus)
    the condition tokens from each sample, gives exp(new − old) == 1.0
    exactly on every row."""
    data = request.getfixturevalue(which)
    pa, samples = data["pa"], data["p_samples"]
    new = pa.replay_log_probs(samples)
    old = np.stack([s.log_probs for s in samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i


def _step_batch(samples, step, lib, keys, old_shift=None, advantage=None):
    from flow_factory_tpu_torch.samples import stack_samples

    bn = stack_samples(samples)
    s0 = samples[0]
    lat_map = s0.latent_index_map
    sig, nl = s0.extra_kwargs["sigmas"], s0.extra_kwargs["noise_levels"]
    full = lambda v: np.full((len(samples),), v, np.float32)
    old = bn["log_probs"][:, s0.log_prob_index_map[step]].astype(np.float32)
    batch = dict(latents=bn["all_latents"][:, lat_map[step]], next_latents=bn["all_latents"][:, lat_map[step + 1]],
                 timestep=full(s0.timesteps[step]), sigma=full(sig[step]), sigma_next=full(sig[step + 1]),
                 noise_level=full(nl[step]), sigma_max=full(sig[1]),
                 old_log_prob=old if old_shift is None else (old + old_shift).astype(np.float32),
                 advantage=np.zeros(len(samples), np.float32) if advantage is None else advantage,
                 **{k: np.stack([getattr(s, k) for s in samples]).astype(np.float32) for k in keys})
    return {**{k: lib(np.ascontiguousarray(v)) for k, v in batch.items()}, "guidance_scale": G}


@pytest.mark.parametrize("which", ["qwen", "edit"])
def test_grpo_loss_and_lora_grads_match_jax(which, request, shared_time_features):
    """A rollout micro-batch at its first SDE step through the JAX GRPO
    ``_grad_fn`` and the port's ``loss_and_grads`` (true CFG, B doubled),
    the old log-probs moved so that the clip (0.2) binds on some rows: loss
    and every aux metric 1e-5 (relative, absolute below 1e-7), every LoRA
    gradient leaf 1e-4 of its max."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer
    from test_torch_port_train import _leaf_close, _port_grads_as_flax

    data = request.getfixturevalue(which)
    ja, pa, samples = data["ja"], data["pa"], data["p_samples"]
    keys = [k for k in pa.embed_keys]
    n = len(samples)
    step = int(np.nonzero(samples[0].extra_kwargs["noise_levels"])[0][0])
    shift = np.asarray([-0.05, 0.5, -0.4, -0.1][:n], np.float32)
    adv = np.asarray([1.2, -0.7, 1.4, -1.0][:n], np.float32)
    jt, pt = object.__new__(JGRPO), object.__new__(GRPOTrainer)
    for trainer, adapter in ((jt, ja), (pt, pa)):
        trainer.training_args, trainer.use_guard, trainer.adapter = adapter.training_args, False, adapter
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(),
                                           _step_batch(samples, step, jnp.asarray, keys, shift, adv), None)
    (loss, aux), grads = pt.loss_and_grads(_step_batch(samples, step, torch.from_numpy, keys, shift, adv))
    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert 0.0 < float(aux["train/clip_frac"]) < 1.0
    _leaf_close(_port_grads_as_flax(pa, grads, data["module_map"]),
                jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4, f"{which} grpo")


def test_f15_edit_plus_replays_every_row_under_row_0s_condition_ids(edit, shared_time_features):
    """F15: as Kontext (F13), Edit-Plus's velocity takes the condition ids of
    the batch's first row for every row (JAX ``edit_plus.py:295``). The
    rollout ran rows 2-3 (one reference) under row 0's ids (two references).
    In the pair (row 2, row 1), row 1 (two references) runs under row 2's
    ids, whose second reference is −1 padding: its velocity is its velocity
    alone with row 2's ids, not with its own (by more than 1e-3), in both
    packages, which agree within 2e-5; so the pair's replay ratio
    exp(new − old) is not 1.0 on either row, and the packages' log-ratios
    agree within 1e-5. Fixing F15 takes per-row condition ids, so per-row
    RoPE, in both."""
    ja, pa = edit["ja"], edit["pa"]
    step = int(np.nonzero(pa.scheduler.get_noise_levels())[0][0])
    keys = list(pa.embed_keys)
    velocities, ratios = [], []
    for adapter, samples, lib in ((ja, edit["j_samples"], jnp.asarray), (pa, edit["p_samples"], torch.from_numpy)):
        pair = _step_batch([samples[2], samples[1]], step, lib, keys)
        alone = _step_batch([samples[1]], step, lib, keys)
        swapped = {**alone, "cond_ids": pair["cond_ids"][:1]}
        with torch.no_grad():
            v = [np.asarray(adapter.training_velocity(adapter.trainable, b)) for b in (pair, alone, swapped)]
            out = adapter.training_forward(adapter.trainable, pair)
        np.testing.assert_allclose(v[0][1], v[2][0], atol=1e-5, rtol=0)
        assert np.abs(v[0][1] - v[1][0]).max() > 1e-3
        velocities.append(v[0])
        ratios.append(np.asarray(out.log_prob, np.float64) - np.asarray(pair["old_log_prob"], np.float64))
    np.testing.assert_allclose(velocities[1], velocities[0], atol=2e-5, rtol=0)
    for log_ratio in ratios:
        assert np.all(np.exp(log_ratio) != 1.0), log_ratio
    np.testing.assert_allclose(ratios[1], ratios[0], atol=1e-5, rtol=0)


def test_registry_resolves_the_three_families_and_flux2_still_raises():
    """The three families resolve to their adapters, and FLUX.2 and Klein,
    once the last two model types the port raised for, now resolve to the
    port's FLUX.2 adapters."""
    from flow_factory_tpu_torch.models.flux.flux2 import Flux2Adapter, Flux2KleinAdapter
    from flow_factory_tpu_torch.models.qwen_image import QwenImageAdapter, QwenImageEditPlusAdapter
    from flow_factory_tpu_torch.models.registry import resolve_adapter_class
    from flow_factory_tpu_torch.models.z_image import ZImageAdapter

    assert resolve_adapter_class("qwen-image") is QwenImageAdapter
    assert resolve_adapter_class("qwen-image-edit-plus") is QwenImageEditPlusAdapter
    assert resolve_adapter_class("z-image") is ZImageAdapter
    assert resolve_adapter_class("flux2") is Flux2Adapter
    assert resolve_adapter_class("flux2-klein") is Flux2KleinAdapter


def test_qwen_image_grpo_epoch_through_load_trainer(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on
    tests/fixtures/smoke_grpo_qwen_image.yaml: one epoch of true-CFG rollouts
    whose samples keep their " " negatives, finite metrics, the replay ratio
    exactly 1.0 on every grad step, one optimizer step, a moved LoRA, and no
    kernel launch on the CPU."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models.qwen_image import QwenImageAdapter
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = Arguments.load_from_yaml(SMOKE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    assert type(trainer.adapter) is QwenImageAdapter
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / "smoke_grpo_qwen_image" / "metrics.jsonl")]
    train = [r for r in rows if "train/loss" in r]
    assert len(train) == 1 and trainer.global_step == 1
    assert all(np.isfinite(v) for k, v in train[0].items() if k.startswith(("train/", "reward/")))
    stat = lambda key, how: train[0].get(f"{key}_{how}", train[0].get(key))
    assert stat("train/ratio_min", "min") == stat("train/ratio_max", "max") == 1.0
    assert all(s.negative_prompt_embeds.shape == (16, 32) for s in trainer.reward_buffer.samples)
    assert max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
               for p, b in b0.items()) > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
