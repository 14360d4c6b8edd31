"""The pretrained-checkpoint import in both packages, shared by
``tests/test_torch_port_import.py`` (the image families) and
``tests/test_torch_port_import_video.py`` (the video families).

For each family a directory is written with the JAX key maps
(``tests/test_utils_aux.py:_synth_torch_state_dict``) in the upstream form
each importer preprocesses: FLUX.1's unfused single blocks, the LTX VAE's
latent-stat buffers, a weight-norm HiFi-GAN generator under ``generator.``
with (in, out, k) transposed convolutions, Qwen2.5-VL's ``visual.*`` keys and
conv3d patch kernel beside the LM's, SD3's (1, G·G, D) position grid and the
Wan VAE's (C, 1, 1, 1) norm gains (FLUX.2's single blocks ship fused, as
the map reads them). SD3, FLUX.1, FLUX.2, Wan, Wan I2V and LTX-2 also get
config.json files that reshape their tiny presets. The JAX adapter is
built from the config.json files, the safetensors are written from its
parameters, its ``import_pretrained_weights`` runs, and the port loads the
same directory through ``load_adapter``: its ``state_dict()`` must equal the
JAX params through the weight bridge exactly (fp32), and its renames must be
the JAX key maps composed with the bridge letter for letter."""
import dataclasses
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from test_utils_aux import _synth_torch_state_dict

#: family → model-section extras at tiny size
FAMILIES = {
    "sd3-5": {},
    "flux1": {},
    "flux1-kontext": {},
    "wan2-t2v": {},
    "wan2-i2v": {},
    "wan2-i2v-clip": {"use_image_encoder": True},  # Wan2.1 I2V with the CLIP image stream
    "wan22": {"boundary_ratio": 0.8},  # the A14B MoE: two experts
    "ltx2-t2av": {},
    "qwen-image": {},
    "qwen-image-edit-plus": {},
    "z-image": {},
    "flux2": {"mlp_style": "swiglu"},  # upstream FLUX.2's gated double-block FFN
    "flux2-klein": {},
}

#: a case's model type where its name is not one
MODEL_TYPE = {"wan2-i2v-clip": "wan2-i2v"}

#: config.json files (upstream field names) that reshape the tiny presets
CONFIG_JSON = {
    "sd3-5": {
        "transformer": {"_class_name": "SD3Transformer2DModel", "num_layers": 3, "num_attention_heads": 4,
                        "attention_head_dim": 16, "in_channels": 16, "patch_size": 2, "joint_attention_dim": 48,
                        "pooled_projection_dim": 40, "pos_embed_max_size": 32, "dual_attention_layers": [0, 1],
                        "qk_norm": "rms_norm"},
        "text_encoder": {"model_type": "clip_text_model", "vocab_size": 1000, "hidden_size": 16,
                         "num_hidden_layers": 3, "num_attention_heads": 2, "projection_dim": 16,
                         "eos_token_id": 2, "hidden_act": "gelu"},
        "text_encoder_2": {"model_type": "clip_text_model", "num_hidden_layers": 1},
        "text_encoder_3": {"model_type": "t5", "vocab_size": 1000, "d_model": 48, "d_ff": 64, "num_layers": 3,
                           "num_heads": 2, "d_kv": 8},
        "vae": {"_class_name": "AutoencoderKL", "in_channels": 3, "latent_channels": 16,
                "block_out_channels": [8, 16], "layers_per_block": 2, "scaling_factor": 0.5,
                "shift_factor": 0.25, "mid_block_add_attention": True},
    },
    "flux1": {
        "transformer": {"_class_name": "FluxTransformer2DModel", "num_layers": 1, "num_single_layers": 3,
                        "num_attention_heads": 4, "attention_head_dim": 16, "in_channels": 16,
                        "joint_attention_dim": 48, "pooled_projection_dim": 16, "guidance_embeds": True,
                        "axes_dims_rope": [4, 6, 6]},
        "text_encoder": {"model_type": "clip_text_model", "num_hidden_layers": 3},
        "text_encoder_2": {"model_type": "t5", "num_layers": 1},
        "vae": {"_class_name": "AutoencoderKL", "layers_per_block": 2},
    },
    "wan2-t2v": {
        "transformer": {"_class_name": "WanTransformer3DModel", "num_layers": 3, "dim": 64, "num_heads": 4,
                        "ffn_dim": 96},
        "text_encoder": {"model_type": "umt5", "num_layers": 3},
        "vae": {"_class_name": "AutoencoderKLWan", "num_res_blocks": 2, "latents_mean": [0.1] * 16,
                "latents_std": [2.0] * 16},
    },
    "wan2-i2v": {
        # the widened input width declared by the checkpoint: no widening on top
        "transformer": {"_class_name": "WanTransformer3DModel", "num_layers": 3, "in_channels": 33},
        "vae": {"_class_name": "AutoencoderKLWan", "num_res_blocks": 2},
    },
    "wan2-i2v-clip": {
        "transformer": {"_class_name": "WanTransformer3DModel", "num_layers": 3, "in_channels": 33},
    },
    "flux2": {
        "transformer": {"_class_name": "Flux2Transformer2DModel", "num_layers": 1, "num_single_layers": 3},
        "text_encoder": {"model_type": "mistral", "num_hidden_layers": 3},
    },
    "ltx2-t2av": {
        "transformer": {"num_layers": 3, "num_attention_heads": 4, "attention_head_dim": 16},
        "text_encoder": {"model_type": "gemma3_text", "vocab_size": 1000, "hidden_size": 32,
                         "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2,
                         "head_dim": 8, "intermediate_size": 64, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
                         "query_pre_attn_scalar": 8, "sliding_window": 4,
                         "layer_types": ["sliding_attention", "full_attention", "sliding_attention"],
                         "rope_local_base_freq": 10000.0, "rope_scaling": {"factor": 2.0}},
        # a VAE that declares its latent width: the transformer's video tokens follow it
        "vae": {"latent_channels": 8, "decoder_inject_noise": [True, False]},
        "audio_vae": {"mel_bins": 16, "base_channels": 16},
    },
}

#: a field each config.json above must have moved off the tiny preset
CONFIGURED = {
    "sd3-5": {"transformer": ("depth", 3), "text_encoder": ("hidden_act", "gelu"),
              "text_encoder_2": ("num_layers", 1), "text_encoder_3": ("num_layers", 3),
              "vae": ("layers_per_block", 2)},
    "flux1": {"transformer": ("num_single_blocks", 3), "text_encoder": ("num_layers", 3),
              "text_encoder_2": ("num_layers", 1), "vae": ("layers_per_block", 2)},
    "wan2-t2v": {"transformer": ("ffn_dim", 96), "text_encoder": ("per_layer_rel_bias", True),
                 "vae": ("latents_std", (2.0,) * 16)},
    "wan2-i2v": {"transformer": ("in_channels", 33), "vae": ("layers_per_block", 2)},
    "flux2": {"transformer": ("num_single_blocks", 3), "text_encoder": ("num_layers", 3)},
    "ltx2-t2av": {"transformer": ("video_channels", 8), "text_encoder": ("arch", "gemma3"),
                  "vae": ("decoder_inject_noise", (False, True)), "audio_vae": ("base_channels", 16)},
}


def _cfg_dict(model_type: str, path: str, **model) -> dict:
    return {
        "data": {},
        "model": {"model_type": MODEL_TYPE.get(model_type, model_type), "model_name_or_path": path, "variant": "tiny",
                  "finetune_type": "lora", "lora_rank": 4, "lora_alpha": 8, "attn_backend": "native",
                  "master_dtype": "float32", "inference_dtype": "float32", **FAMILIES.get(model_type, {}), **model},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2, "sde_steps": [0, 1, 2]},
        "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4, "guidance_scale": 2.0,
                  "per_device_batch_size": 2, "group_size": 2, "unique_sample_num_per_epoch": 2,
                  "latent_storage_dtype": "fp32", "seed": 7},
        "eval": {}, "log": {}, "rewards": [],
    }


def _port(model_type: str, path: str, **model):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    return load_adapter(Arguments.from_dict(_cfg_dict(model_type, path, **model)), device="cpu")


def _jax(model_type: str, path: str, **model):
    from flow_factory_tpu.hparams.args import Arguments
    from flow_factory_tpu.models import load_adapter
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(1)
    try:
        return load_adapter(Arguments.from_dict(_cfg_dict(model_type, path, **model)))
    finally:
        set_world_size_override(None)


def _jax_params(ja, comp: str):
    return jax.tree.map(np.asarray, jax.device_get(ja.params[comp]))


# ---------------------------------------------------------------------------
# The upstream form of each family's checkpoint
# ---------------------------------------------------------------------------

def _upstream_form(model_type: str, comp: str, sd: dict, ja) -> dict:
    """The synthesized state dict in the form a published checkpoint ships,
    which the importers' preprocesses turn back into what their maps read."""
    cfg = ja.component_configs.get(comp)
    if comp == "transformer" and model_type == "sd3-5":  # the grid as diffusers' (1, G·G, D) buffer
        grid = sd["pos_embed.pos_embed"]
        sd["pos_embed.pos_embed"] = grid.reshape(1, -1, grid.shape[-1])
    if comp == "transformer" and model_type.startswith("flux1"):  # q, k, v and the MLP input apart
        D = cfg.hidden_dim
        for i in range(cfg.num_single_blocks):
            b = f"single_transformer_blocks.{i}"
            sd.pop(f"{b}.proj_mlp.weight"), sd.pop(f"{b}.proj_mlp.bias")
            for suffix in ("weight", "bias"):
                q, k, v, mlp = np.split(sd.pop(f"{b}.attn.to_q.{suffix}"), [D, 2 * D, 3 * D], axis=0)
                sd.update({f"{b}.attn.to_q.{suffix}": q, f"{b}.attn.to_k.{suffix}": k,
                           f"{b}.attn.to_v.{suffix}": v, f"{b}.proj_mlp.{suffix}": mlp})
    if comp == "vae" and model_type.startswith("wan"):  # the norms' gains as (C, 1, 1, 1)
        sd = {k: (v.reshape(-1, 1, 1, 1) if k.endswith(".gamma") else v) for k, v in sd.items()}
    if comp == "vae" and model_type == "ltx2-t2av":  # the latent statistics ride the state dict
        rng = np.random.default_rng(3)
        sd["latents_mean"] = rng.standard_normal(cfg.latent_channels, dtype=np.float32)
        sd["latents_std"] = rng.uniform(0.5, 2.0, cfg.latent_channels).astype(np.float32)
    if comp == "audio_vae":  # a weight-norm HiFi-GAN generator, transposed convs (in, out, k)
        out = {}
        for k, v in sd.items():
            if re.match(r"^ups\.\d+\.weight$", k):
                v = np.swapaxes(v, 0, 1)
            if k.endswith(".weight"):
                g = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape(-1, 1, 1) * 1.5
                out[f"generator.{k}_g"], out[f"generator.{k}_v"] = g.astype(np.float32), v
            else:
                out[f"generator.{k}"] = v
        sd = out
    if comp == "vision_tower":  # the conv3d patch kernel
        w = sd["visual.patch_embed.proj.weight"]
        sd["visual.patch_embed.proj.weight"] = w.reshape(w.shape[0], cfg.in_channels, cfg.temporal_patch_size,
                                                         cfg.patch_size, cfg.patch_size)
    return sd


#: the synthesized weights' scale, a trained model's: at N(0, 1) the tiny
#: SD3.5's activations reach ~1e2, where fp32 rounding alone moves the
#: rollout past its 1e-4 bar in either package
WEIGHT_STD = 0.05


def _write_dir(model_type: str, ja, path: str, seed: int = 20) -> None:
    """Every component of ``ja``'s import maps as safetensors under ``path``
    (a subfolder two components share gets one file each)."""
    from safetensors.numpy import save_file

    for i, (comp, spec) in enumerate(ja.pretrained_component_maps().items()):
        subfolder, key_map, raw_map = spec[:3]
        if comp not in ja.params:
            continue
        conv = None
        if comp.startswith("transformer") and model_type.startswith("wan"):
            c = ja.component_configs["transformer"]
            conv = {"patch_embedding": (c.hidden_dim, c.in_channels, *c.patch_size)}
        sd = _synth_torch_state_dict(_jax_params(ja, comp), key_map, raw_map=raw_map, conv_specs=conv,
                                     seed=seed + i)
        sd = _upstream_form(model_type, comp, {k: v * WEIGHT_STD for k, v in sd.items()}, ja)
        os.makedirs(os.path.join(path, subfolder), exist_ok=True)
        save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                  os.path.join(path, subfolder, f"model-{comp}.safetensors"))


class Case:
    """One family: the directory of config.json files alone (``configs``),
    the checkpoint directory (``ckpt``), and the JAX adapter built from the
    configs with the checkpoint imported (``strict_error``: what its strict
    import raised, if it did)."""

    def __init__(self, model_type: str, root: str):
        self.model_type = model_type
        self.configs, self.ckpt = os.path.join(root, "configs"), os.path.join(root, "ckpt")
        for sub, cj in CONFIG_JSON.get(model_type, {}).items():
            os.makedirs(os.path.join(self.configs, sub), exist_ok=True)
            with open(os.path.join(self.configs, sub, "config.json"), "w") as f:
                json.dump(cj, f)
        os.makedirs(self.configs, exist_ok=True)
        shutil.copytree(self.configs, self.ckpt)
        self.ja = _jax(model_type, self.configs)
        self.jax_configs = dict(self.ja.component_configs)  # before the import moves LTX-2's VAE statistics
        _write_dir(model_type, self.ja, self.ckpt)
        self.ja.model_args.model_name_or_path = self.ckpt
        self.ja.model_args.strict_import = True
        self.strict_error = None
        try:
            self.ja.import_pretrained_weights()
        except ValueError as e:
            self.strict_error = str(e)
            self.ja.model_args.strict_import = False
            self.ja.import_pretrained_weights()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The module's :class:`Case` of a family, built at first use."""
    built = {}

    def get(model_type: str) -> Case:
        if model_type not in built:
            built[model_type] = Case(model_type, str(tmp_path_factory.mktemp(model_type)))
        return built[model_type]

    yield get
    jax.clear_caches()


def _bridge_keys(flax_tree, module_map, raw_map) -> dict:
    """JAX leaf path → the port key the weight bridge gives it."""
    from flow_factory_tpu_torch.utils.weights import _convert_leaf, flatten_flax

    out = {}
    for path, arr in flatten_flax(flax_tree).items():
        if path in raw_map:
            out[path] = raw_map[path][0]
        else:
            mod, leaf = path.rsplit("/", 1)
            out[path] = f"{module_map[mod]}.{_convert_leaf(leaf, arr)[0]}"
    return out


def _jax_read_keys(flax_tree, key_map, raw_map, bridge) -> dict:
    """Upstream key → port key: what the JAX key map reads, carried to the
    port's names by the bridge (FLUX.1's ``proj_mlp`` alias left out: the
    fuse folds it into ``attn.to_q`` before the map reads)."""
    leaves = _bridge_keys(flax_tree, *bridge)
    by_module = {}
    for path, port in leaves.items():
        if "/" in path:
            mod, leaf = path.rsplit("/", 1)
            by_module.setdefault(mod, []).append((leaf, port))
    out = {}
    for up_mod, jmod in key_map.items():
        if up_mod.endswith(".proj_mlp"):
            continue
        for leaf, port in by_module.get(jmod, ()):
            out[f"{up_mod}.{'bias' if leaf == 'bias' else 'weight'}"] = port
    for up, jpath in (raw_map or {}).items():
        if jpath in leaves:
            out[up] = leaves[jpath]
    return out


def check_import_equals_jax(cases, model_type: str) -> None:
    """The port's strict import of the directory: every component's
    ``state_dict()`` equals the JAX import through the bridge exactly, every
    imported tensor differs from the port's init, and the port's renames
    read what the JAX maps read. LTX-2's strict import fails in both
    packages, on the text connectors (the JAX map has none); without strict
    both leave exactly those, and the mel VAE's halves, at their inits."""
    from flow_factory_tpu_torch.utils.checkpoint import upstream_key
    from flow_factory_tpu_torch.utils.weights import convert

    case = cases(model_type)
    ja = case.ja
    if model_type == "ltx2-t2av":
        assert "video_connector" in case.strict_error
        with pytest.raises(ValueError, match="video_connector.weight"):
            _port(model_type, case.ckpt, strict_import=True)
        pa = _port(model_type, case.ckpt)
    else:
        assert case.strict_error is None
        pa = _port(model_type, case.ckpt, strict_import=True)
    init = _port(model_type, case.configs)
    bridge = pa.weight_maps()
    jax_maps = ja.pretrained_component_maps()
    imported = 0
    for comp, spec in pa.pretrained_component_maps().items():
        if comp not in pa.modules:
            continue
        flax_tree = _jax_params(ja, comp)
        got, fresh = pa.modules[comp].state_dict(), init.modules[comp].state_dict()
        want = convert(flax_tree, *bridge[comp])
        assert set(got) == set(want), comp
        for k, v in got.items():
            if upstream_key(k, spec.renames) is None:  # no upstream key: the init stays
                assert torch.equal(v, fresh[k]), (comp, k)
                continue
            assert torch.equal(v, want[k]), (comp, k)
            assert not torch.equal(v, fresh[k]), (comp, k)
            imported += 1
        subfolder, key_map, raw_map = jax_maps[comp][:3]
        assert spec.subfolder == subfolder
        ours = {upstream_key(k, spec.renames): k for k in got if upstream_key(k, spec.renames) is not None}
        assert ours == _jax_read_keys(flax_tree, key_map, raw_map, bridge[comp]), comp
    assert imported > 0
    if model_type == "ltx2-t2av":  # the statistics went into the VAE's config in both
        assert pa.component_configs["vae"].latents_mean == ja.component_configs["vae"].latents_mean is not None
        assert pa.modules["vae"].cfg.latents_std == ja.component_configs["vae"].latents_std


def check_config_json_like_jax(cases, model_type: str) -> None:
    """The transformer's, the encoders' and the VAEs' config.json give the
    port's dataclasses the JAX adapter's values on every field they share,
    and each moved off the tiny preset."""
    case = cases(model_type)
    pa = _port(model_type, case.configs)
    for comp, (field, value) in CONFIGURED[model_type].items():
        p, j = pa.component_configs[comp], case.jax_configs[comp]
        shared = {f.name for f in dataclasses.fields(p)} & {f.name for f in dataclasses.fields(j)}
        assert {n: getattr(p, n) for n in shared} == {n: getattr(j, n) for n in shared}, comp
        assert getattr(p, field) == value, (comp, field)
