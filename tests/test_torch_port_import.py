"""PyTorch port, the pretrained-checkpoint import (ROADMAP Queue 1 item 19,
fault F16), the image families: SD3.5, FLUX.1, FLUX.1-Kontext, Qwen-Image,
Qwen-Image-Edit-Plus, Z-Image, FLUX.2 and Klein each loaded from one
directory in both packages (``tests/torch_port_import_cases.py``), FLUX.2's
``mlp_style`` check before the import, the tiny SD3.5's rollout
from its directory against JAX's, the importer's strictness, scope, skip
rule and place before the trainable copies, and the copies of the JAX
preprocesses and config.json translators against the JAX functions."""
import jax
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from torch_port_import_cases import _jax, _port, cases, check_config_json_like_jax, check_import_equals_jax  # noqa: F401

IMAGE_FAMILIES = ("sd3-5", "flux1", "flux1-kontext", "qwen-image", "qwen-image-edit-plus", "z-image", "flux2",
                  "flux2-klein")


@pytest.mark.parametrize("model_type", IMAGE_FAMILIES)
def test_import_equals_jax_through_the_bridge(cases, model_type):
    """The port's strict import of the directory: every component's
    ``state_dict()`` equals the JAX import through the bridge exactly, every
    imported tensor differs from the port's init, and the port's renames
    read what the JAX maps read."""
    check_import_equals_jax(cases, model_type)


@pytest.mark.parametrize("model_type", ("sd3-5", "flux1", "flux2"))
def test_config_json_self_configures_like_jax(cases, model_type):
    """The transformer's, the encoders' and the VAE's config.json give the
    port's dataclasses the JAX adapter's values on every field they share,
    and each moved off the tiny preset."""
    check_config_json_like_jax(cases, model_type)


def test_flux2_mlp_style_mismatch_raises_in_both_packages(cases):
    """FLUX.2's gated checkpoint (``linear_in``'s output twice
    ``linear_out``'s input) loaded with ``mlp_style: gelu_tanh`` raises the
    same ``ValueError`` in both packages, naming the fix; in the port
    Klein's ungated one loaded with ``swiglu`` raises too, and FLUX.2's
    renames read the time embedders under ``time_guidance_embed``, the FFNs
    as ``linear_in``/``linear_out`` and the single blocks' fused
    ``attn.to_qkv_mlp_proj``/``attn.to_out.0``."""
    from flow_factory_tpu_torch.utils.checkpoint import FLUX2_TRANSFORMER_RENAMES, upstream_key

    errors = []
    for build in (_jax, _port):
        with pytest.raises(ValueError, match="model.mlp_style: 'swiglu'") as e:
            build("flux2", cases("flux2").ckpt, mlp_style="gelu_tanh")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="model.mlp_style: 'gelu_tanh'"):
        _port("flux2-klein", cases("flux2-klein").ckpt, mlp_style="swiglu")
    assert [upstream_key(k, FLUX2_TRANSFORMER_RENAMES) for k in (
        "time_text_embed.guidance_embedder.linear_1.weight", "transformer_blocks.3.ff_context.net.0.proj.bias",
        "transformer_blocks.3.ff.linear_out.weight", "single_transformer_blocks.2.linear1.weight",
        "single_transformer_blocks.2.linear2.bias")] == [
        "time_guidance_embed.guidance_embedder.linear_1.weight", "transformer_blocks.3.ff_context.linear_in.bias",
        "transformer_blocks.3.ff.linear_out.weight", "single_transformer_blocks.2.attn.to_qkv_mlp_proj.weight",
        "single_transformer_blocks.2.attn.to_out.0.bias"]


def test_sd35_rollout_from_a_directory_matches_jax(cases):
    """The tiny SD3.5 loaded from the directory in both packages (the
    config.json shapes and the imported weights), the x0 and per-step noise
    the JAX rollout drew: every stored latent within the 1e-4 trajectory bar
    and the log-probs within 1e-3, the bars of
    ``tests/test_torch_port_slice.py``."""
    import jax.numpy as jnp
    from flow_factory_tpu.utils.base import derive_key

    from flow_factory_tpu.parallel.dist import set_world_size_override

    case = cases("sd3-5")
    prompts, seed = ["a red fox", "a bowl of ramen"], 5
    set_world_size_override(1)
    try:
        j_samples = case.ja.inference(prompt=prompts, seed=seed, compute_log_prob=True)
    finally:
        set_world_size_override(None)
    pa = _port("sd3-5", case.ckpt, strict_import=True)
    h, w, c = pa.latent_shape(32, 32)
    keys = jax.random.split(derive_key("rollout", seed), len(prompts))
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (h, w, c), jnp.float32))(keys))
    k, noise = jax.random.fold_in(keys[0], 7), []
    for _ in range(4):
        k, sub = jax.random.split(k)
        noise.append(torch.tensor(np.asarray(jax.random.normal(sub, (len(prompts), h, w, c), jnp.float32))))
    p_samples = pa.inference(prompt=prompts, x0=torch.tensor(x0), noise=noise, compute_log_prob=True)
    for js, ps in zip(j_samples, p_samples):
        np.testing.assert_allclose(ps.prompt_embeds, js.prompt_embeds, atol=1e-5)
        np.testing.assert_allclose(ps.extra_kwargs["pooled_prompt_embeds"], js.extra_kwargs["pooled_prompt_embeds"],
                                   atol=1e-5)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4)
        np.testing.assert_allclose(ps.log_probs, js.log_probs, atol=1e-3)


def test_strict_import_names_a_misspelled_key(tmp_path):
    """A misspelled checkpoint key aborts a strict load naming the key and
    the tensor left at init; without strict the load warns and goes on."""
    from flow_factory_tpu_torch.utils.safetensors_io import save_file

    ref = _port("sd3-5", "tiny")
    sd = {k: v.clone() for k, v in ref.modules["transformer"].state_dict().items()}
    sd["context_embedderX.weight"] = sd.pop("context_embedder.weight")
    (tmp_path / "transformer").mkdir()
    save_file(sd, str(tmp_path / "transformer" / "diffusion_pytorch_model.safetensors"))
    with pytest.raises(ValueError) as ei:
        _port("sd3-5", str(tmp_path), strict_import=True)
    assert "context_embedderX.weight" in str(ei.value) and "'context_embedder.weight'" in str(ei.value)
    assert _port("sd3-5", str(tmp_path)) is not None


def test_scope_ignores_a_sibling_components_keys():
    """Keys outside ``unmatched_scope`` belong to a sibling component of the
    same subfolder and do not fail a strict import; without the scope they do."""
    from flow_factory_tpu_torch.utils.checkpoint import import_state_dict

    lin = torch.nn.Linear(4, 8)
    sd = {"lin.weight": torch.ones(8, 4), "lin.bias": torch.zeros(8), "visual.tower.weight": torch.ones(3, 3)}
    module = torch.nn.Module()
    module.lin = lin
    report = import_state_dict(module, sd, strict=True, unmatched_scope=r"^lin\.")
    assert report.matched == 2 and torch.equal(lin.weight, torch.ones(8, 4))
    with pytest.raises(ValueError, match="visual.tower.weight"):
        import_state_dict(module, sd, strict=True)


def test_shapes_and_dtypes_of_an_import():
    """A tensor of another shape raises, naming it; one of the same size and
    another rank is reshaped (the Wan VAE's (C, 1, 1, 1) gains onto (C,));
    values are cast to the module's dtype; sharded input is read a dict at
    a time."""
    from flow_factory_tpu_torch.utils.checkpoint import import_state_dict

    module = torch.nn.Module()
    module.lin = torch.nn.Linear(4, 8).to(torch.bfloat16)
    module.gamma = torch.nn.Parameter(torch.zeros(8))
    w, g = torch.randn(8, 4), torch.randn(8, 1, 1, 1)
    report = import_state_dict(module, iter([{"lin.weight": w}, {"lin.bias": torch.ones(8), "gamma": g}]),
                               strict=True)
    assert report.matched == 3 and module.lin.weight.dtype == torch.bfloat16
    assert torch.equal(module.lin.weight, w.to(torch.bfloat16)) and torch.equal(module.gamma.detach(), g.reshape(8))
    with pytest.raises(ValueError, match=r"lin.weight.*\(4, 8\)"):
        import_state_dict(module, {"lin.weight": torch.randn(4, 8)})


def test_a_missing_subfolder_keeps_the_init(tmp_path):
    """Only ``transformer/`` in the directory: the transformer imports and
    every other component keeps its random init, under strict too."""
    from flow_factory_tpu_torch.utils.safetensors_io import save_file

    ref = _port("sd3-5", "tiny")
    rng = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=rng) for k, v in ref.modules["transformer"].state_dict().items()}
    (tmp_path / "transformer").mkdir()
    (tmp_path / "vae").mkdir()  # a subfolder with no safetensors is skipped too
    save_file(sd, str(tmp_path / "transformer" / "model.safetensors"))
    pa = _port("sd3-5", str(tmp_path), strict_import=True)
    for k, v in pa.modules["transformer"].state_dict().items():
        assert torch.equal(v, sd[k]), k
    for comp in ("text_encoder", "text_encoder_2", "text_encoder_3", "vae"):
        for k, v in pa.modules[comp].state_dict().items():
            assert torch.equal(v, ref.modules[comp].state_dict()[k]), (comp, k)


def test_load_components_imports_only_the_built_modules(cases):
    case = cases("sd3-5")
    pa = _port("sd3-5", case.ckpt, strict_import=True, load_components=["transformer"])
    assert list(pa.modules) == ["transformer"]
    full = _port("sd3-5", case.ckpt, strict_import=True)
    for k, v in pa.modules["transformer"].state_dict().items():
        assert torch.equal(v, full.modules["transformer"].state_dict()[k]), k


def test_import_lands_before_the_trainable_copies_and_resume(cases, tmp_path):
    """The import runs before ``_setup_trainable`` and a resume: a LoRA's
    base weights, the full-finetune tree, its DPO reference, EMA and named
    snapshot are the imported values, not the init; a full checkpoint given
    as ``resume_path`` wins over the import."""
    case = cases("sd3-5")
    init = _port("sd3-5", case.configs).modules["transformer"].state_dict()
    lora = _port("sd3-5", case.ckpt)
    merged = lora.merge_component("transformer")
    imported = lora.modules["transformer"].state_dict()
    assert lora.trainable["transformer"] and merged
    for name, w in merged.items():
        assert torch.equal(w, imported[name]) and not torch.equal(w, init[name]), name

    full = _port("sd3-5", case.ckpt, finetune_type="full")
    full.training_args.ema_decay = 0.9
    full.init_ema()
    full.init_ref_parameters()
    full.add_named_parameters("ema_ref")
    trees = {"trainable": full.trainable, "reference": full.ref_trainable(), "ema": full.ema_trainable,
             "ema_ref": full.get_named_parameters("ema_ref")}
    for what, tree in trees.items():
        for name, t in tree["transformer"].items():
            assert torch.equal(t.detach(), imported[name]), (what, name)
            assert not torch.equal(t.detach(), init[name]), (what, name)

    with torch.no_grad():
        for t in full.trainable["transformer"].values():
            t.add_(1.0)
    full.save_checkpoint(str(tmp_path / "ckpt"), save_ema=False)
    resumed = _port("sd3-5", case.ckpt, finetune_type="full", resume_path=str(tmp_path / "ckpt"))
    for name, t in resumed.trainable["transformer"].items():
        assert torch.equal(t, full.trainable["transformer"][name].detach()), name


def test_sd3_full_import_trains_the_position_grid(cases):
    """F9: SD3's position grid is a parameter, as in JAX. A full finetune
    reads the checkpoint's grid into its trainable tree (fp32, with a
    gradient, the imported values and not the init) and keeps no module
    copy of it; LoRA mode leaves it frozen in the module, outside the LoRA
    tree."""
    case = cases("sd3-5")
    init = _port("sd3-5", case.configs).modules["transformer"].state_dict()["pos_embed.pos_embed"]
    lora = _port("sd3-5", case.ckpt)
    grid = lora.modules["transformer"].get_parameter("pos_embed.pos_embed")
    assert not grid.requires_grad and not torch.equal(grid, init)
    assert not any("pos_embed" in path for path in lora.trainable["transformer"])
    full = _port("sd3-5", case.ckpt, finetune_type="full")
    theirs = full.trainable["transformer"]["pos_embed.pos_embed"]
    assert theirs.requires_grad and theirs.dtype == torch.float32 and torch.equal(theirs.detach(), grid)
    assert full.modules["transformer"].get_parameter("pos_embed.pos_embed").is_meta


# ---------------------------------------------------------------------------
# The copies of the JAX functions, against the JAX functions
# ---------------------------------------------------------------------------

def test_preprocesses_match_jax():
    """The weight-norm fuse, the FLUX.1 single-block fuse, the LTX VAE's
    statistics and the Qwen2.5-VL normalisation: the JAX functions' values,
    exactly."""
    import flow_factory_tpu.utils.checkpoint as J

    import flow_factory_tpu_torch.utils.checkpoint as P

    rng = np.random.default_rng(0)
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    wn = {"conv.weight_g": rng.standard_normal((4, 1, 1), dtype=np.float32),
          "conv.weight_v": rng.standard_normal((4, 3, 5), dtype=np.float32),
          "conv.bias": rng.standard_normal(4, dtype=np.float32)}
    got, want = P.fuse_weight_norm(t(wn)), J.fuse_weight_norm(wn)
    assert set(got) == set(want) == {"conv.weight", "conv.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    b = "single_transformer_blocks.0"
    flux = {f"{b}.{n}.{s}": rng.standard_normal((6, 2) if s == "weight" else 6, dtype=np.float32)
            for n in ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp") for s in ("weight", "bias")}
    got, want = P.fuse_flux_single_block_qkv_mlp(t(flux), 1), J.fuse_flux_single_block_qkv_mlp(flux, 1)
    assert set(got) == set(want) == {f"{b}.attn.to_q.weight", f"{b}.attn.to_q.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    stats = {"latents_mean": rng.standard_normal(4, dtype=np.float32),
             "latents_std": rng.standard_normal(4, dtype=np.float32), "x.weight": np.ones(2, np.float32)}
    (g_sd, g_mean, g_std), (w_sd, w_mean, w_std) = P.pop_ltx_vae_latent_stats(t(stats)), \
        J.pop_ltx_vae_latent_stats(dict(stats))
    assert (g_mean, g_std) == (w_mean, w_std) and set(g_sd) == set(w_sd) == {"x.weight"}
    vl = {"model.visual.patch_embed.proj.weight": rng.standard_normal((8, 3, 2, 2, 2), dtype=np.float32),
          "model.visual.blocks.0.norm1.weight": np.ones(8, np.float32), "model.layers.0.x.weight": np.ones(2)}
    got, want = P.qwen_vl_vision_preprocess(t(vl)), J.qwen_vl_vision_preprocess(vl)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


#: config.json dicts for each translator, upstream spellings
_TRANSLATOR_INPUTS = {
    "sd3_transformer_overrides_from_config": {"num_layers": 24, "num_attention_heads": 24, "attention_head_dim": 64,
                                              "in_channels": 16, "patch_size": 2, "joint_attention_dim": 4096,
                                              "pooled_projection_dim": 2048, "pos_embed_max_size": 384,
                                              "dual_attention_layers": list(range(13)), "qk_norm": "rms_norm"},
    "wan_transformer_overrides_from_config": {"dim": 1536, "ffn_dim": 8960, "num_heads": 12, "num_layers": 30,
                                              "in_channels": 36, "out_channels": 16, "text_dim": 4096,
                                              "freq_dim": 256, "patch_size": [1, 2, 2], "qk_norm": "rms_norm_across_heads"},
    "ltx2_transformer_overrides_from_config": {"num_layers": 48, "num_attention_heads": 32, "attention_head_dim": 128,
                                               "in_channels": 128, "audio_in_channels": 128, "ffn_dim": 16384,
                                               "rope_theta": 10000.0},
    "ltx2_audio_vae_overrides_from_config": {"latent_channels": 8, "mel_bins": 64, "sampling_rate": 16000,
                                             "hop_length": 160, "n_fft": 1024, "base_channels": 128},
    "clip_text_overrides_from_config": {"vocab_size": 49408, "hidden_size": 1280, "num_hidden_layers": 32,
                                        "num_attention_heads": 20, "max_position_embeddings": 77,
                                        "projection_dim": 1280, "eos_token_id": 49407, "hidden_act": "gelu",
                                        "layer_norm_eps": 1e-5},
    "t5_overrides_from_config": {"model_type": "umt5", "vocab_size": 256384, "d_model": 4096, "d_ff": 10240,
                                 "num_layers": 24, "num_heads": 64, "d_kv": 64,
                                 "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128},
    "wan_vae_overrides_from_config": {"base_dim": 160, "z_dim": 48, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 2,
                                      "attn_scales": [], "temperal_downsample": [False, True, True],
                                      "patch_size": 2, "is_residual": True, "latents_mean": [0.5] * 48,
                                      "latents_std": [1.5] * 48},
    "ltx_video_vae_overrides_from_config": {"in_channels": 3, "out_channels": 3, "latent_channels": 128,
                                            "patch_size": 4, "patch_size_t": 1,
                                            "block_out_channels": [256, 512, 1024, 2048],
                                            "decoder_block_out_channels": [256, 512, 1024],
                                            "layers_per_block": [4, 6, 6, 2, 2],
                                            "decoder_layers_per_block": [5, 5, 5, 5],
                                            "spatio_temporal_scaling": [True, True, True, True],
                                            "decoder_spatio_temporal_scaling": [True, True, True],
                                            "decoder_inject_noise": [False, False, False, False],
                                            "upsample_residual": [True, True, True], "upsample_factor": [2, 2, 2],
                                            "timestep_conditioning": False, "encoder_causal": True,
                                            "decoder_causal": False, "resnet_norm_eps": 1e-6,
                                            "scaling_factor": 1.0, "latents_mean": [0.0] * 4,
                                            "latents_std": [1.0] * 4},
    "lm_overrides_from_config": {"model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 3840,
                                 "num_hidden_layers": 48, "num_attention_heads": 16, "num_key_value_heads": 8,
                                 "head_dim": 256, "intermediate_size": 15360, "rope_theta": 1000000.0,
                                 "rms_norm_eps": 1e-6, "query_pre_attn_scalar": 256, "sliding_window": 1024,
                                 "rope_local_base_freq": 10000.0, "rope_scaling": {"factor": 8.0},
                                 "layer_types": ["sliding_attention"] * 5 + ["full_attention"]},
}
#: the keys the JAX translators emit that no port dataclass has
_NO_PORT_FIELD = {"ltx2_transformer_overrides_from_config": {"rms_eps"},
                  "wan_transformer_overrides_from_config": {"image_context_dim"}}


@pytest.mark.parametrize("name", list(_TRANSLATOR_INPUTS))
def test_config_translators_match_jax(name):
    """Each config.json translator gives the JAX translator's overrides, but
    for the keys that name a field the port's dataclass lacks (JAX's
    ``LTX2Config`` lacks ``rms_eps`` too)."""
    import flow_factory_tpu.utils.checkpoint as J

    import flow_factory_tpu_torch.utils.model_config as P

    cfg = dict(_TRANSLATOR_INPUTS[name])
    if name.startswith("ltx2_transformer"):
        cfg["rms_norm_eps"] = 1e-6
    if name.startswith("wan_transformer"):
        cfg["image_dim"] = 1280
    want = {k: v for k, v in getattr(J, name)(cfg).items() if k not in _NO_PORT_FIELD.get(name, ())}
    assert getattr(P, name)(cfg) == want
    assert set(getattr(J, name)(cfg)) - set(want) == _NO_PORT_FIELD.get(name, set())
