"""Weight bridge: the JAX package's flax parameters → the port's state dicts.

Input is a nested dict of numpy arrays under flax paths (what
``jax.device_get(adapter.params[component])`` gives); output is a
``state_dict`` for the port's module of that component, whose parameter
names are diffusers' / transformers' names. Layouts:

* Dense kernels (in, out) → Linear weights (out, in); the attention head
  projections (``HeadProj`` (D_in, H*E), ``MergeProj`` (H*E, D_out)) are Dense
  kernels of the same layout;
* Conv kernels (k, I, O) → (O, I, k), HWIO → OIHW, and 3-D (kt, kh, kw, I,
  O) → (O, I, kt, kh, kw);
* norm ``scale`` → ``weight``; the Wan VAE's ``gamma`` keeps its name and
  (C,) shape; embeddings keep their (rows, dim) layout;
* the SD3 position grid (1, G, G, D) → diffusers' (1, G*G, D) layout (a parameter
  here, as in the JAX package: a full finetune trains it);
* the Wan patch embedding, a Dense over (pt, ph, pw, C) voxels in flax →
  diffusers' Conv3d weight (D, C, pt, ph, pw).

The bridge is strict: a flax leaf that no rule consumes raises here, and
:func:`load_component` loads with ``strict=True``, so a port parameter left
unfilled raises too.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

ModuleMap = Dict[str, str]  # flax module path → port module path
RawMap = Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]]  # flax leaf → (port key, fn)


def flatten_flax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params → {'a/b/leaf': array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_flax(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _convert_leaf(leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:  # 1-D conv (k, I, O) → (O, I, k); ConvTranspose alike (no flip)
            return "weight", np.transpose(arr, (2, 1, 0))
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 5:
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    if leaf in ("scale", "embedding"):
        return "weight", arr
    if leaf in ("bias", "weight", "gamma"):
        return leaf, arr
    raise KeyError(leaf)


def convert(flax_params: Mapping[str, Any], module_map: ModuleMap,
            raw_map: RawMap = None) -> Dict[str, torch.Tensor]:
    """Apply a module map to one component's flax tree (strict)."""
    raw_map = raw_map or {}
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, arr in flatten_flax(flax_params).items():
        if path in raw_map:
            key, fn = raw_map[path]
            value = fn(arr)
        else:
            mod, leaf = path.rsplit("/", 1) if "/" in path else ("", path)
            port_mod = module_map.get(mod)
            if port_mod is None:
                unmatched.append(path)
                continue
            name, value = _convert_leaf(leaf, arr)
            key = f"{port_mod}.{name}"
        out[key] = torch.from_numpy(np.array(value))  # a writable contiguous copy
    if unmatched:
        raise KeyError(f"weight bridge: {len(unmatched)} flax leaves have no rule: {unmatched[:10]}")
    return out


def load_component(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a bridged state dict; raises if a port parameter is left unfilled."""
    module.load_state_dict(state_dict, strict=True)


# ---------------------------------------------------------------------------
# Module maps (inverses of flow_factory_tpu/utils/checkpoint.py's key maps)
# ---------------------------------------------------------------------------

def sd3_transformer_map(depth: int, dual_attention_layers=()) -> Tuple[ModuleMap, RawMap]:
    m: ModuleMap = {
        "pos_embed/proj": "pos_embed.proj",
        "context_embedder": "context_embedder",
        "time_embed/linear_1": "time_text_embed.timestep_embedder.linear_1",
        "time_embed/linear_2": "time_text_embed.timestep_embedder.linear_2",
        "text_embed/linear_1": "time_text_embed.text_embedder.linear_1",
        "text_embed/linear_2": "time_text_embed.text_embedder.linear_2",
        "norm_out/linear": "norm_out.linear",
        "proj_out": "proj_out",
    }
    for i in range(depth):
        o, b = f"block_{i}", f"transformer_blocks.{i}"
        m[f"{o}/norm1/linear"] = f"{b}.norm1.linear"
        m[f"{o}/norm1_context/linear"] = f"{b}.norm1_context.linear"
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            m[f"{o}/attn/{name}"] = f"{b}.attn.{name}"
        m[f"{o}/attn/to_out"] = f"{b}.attn.to_out.0"
        m[f"{o}/attn/qk_norm/q_norm"] = f"{b}.attn.norm_q"
        m[f"{o}/attn/qk_norm/k_norm"] = f"{b}.attn.norm_k"
        m[f"{o}/attn/added_qk_norm/q_norm"] = f"{b}.attn.norm_added_q"
        m[f"{o}/attn/added_qk_norm/k_norm"] = f"{b}.attn.norm_added_k"
        for ff in ("ff", "ff_context"):
            m[f"{o}/{ff}/fc1"] = f"{b}.{ff}.net.0.proj"
            m[f"{o}/{ff}/fc2"] = f"{b}.{ff}.net.2"
        if i in dual_attention_layers:
            for name in ("to_q", "to_k", "to_v"):
                m[f"{o}/attn2/{name}"] = f"{b}.attn2.{name}"
            m[f"{o}/attn2/to_out"] = f"{b}.attn2.to_out.0"
            m[f"{o}/attn2/qk_norm/q_norm"] = f"{b}.attn2.norm_q"
            m[f"{o}/attn2/qk_norm/k_norm"] = f"{b}.attn2.norm_k"
    raw: RawMap = {"pos_embed/pos_embed": ("pos_embed.pos_embed",
                                           lambda a: a.reshape(1, -1, a.shape[-1]))}
    return m, raw


def clip_text_map(num_layers: int) -> Tuple[ModuleMap, RawMap]:
    m: ModuleMap = {
        "token_embedding": "text_model.embeddings.token_embedding",
        "final_ln": "text_model.final_layer_norm",
        "text_projection": "text_projection",
    }
    for i in range(num_layers):
        o, b = f"layer_{i}", f"text_model.encoder.layers.{i}"
        m[f"{o}/ln1"] = f"{b}.layer_norm1"
        m[f"{o}/ln2"] = f"{b}.layer_norm2"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[f"{o}/{name}"] = f"{b}.self_attn.{name}"
        m[f"{o}/fc1"] = f"{b}.mlp.fc1"
        m[f"{o}/fc2"] = f"{b}.mlp.fc2"
    raw: RawMap = {"position_embedding": ("text_model.embeddings.position_embedding.weight",
                                          lambda a: a)}
    return m, raw


def clip_vision_map(num_layers: int) -> Tuple[ModuleMap, RawMap]:
    """The CLIP vision tower (inverse of the JAX ``clip_vision_encoder_key_map``,
    ``utils/checkpoint.py:1465``): transformers' ``vision_model.*`` names; the
    (1, L, D) position table → the (L, D) embedding."""
    v = "vision_model"
    m: ModuleMap = {"patch_embedding": f"{v}.embeddings.patch_embedding", "pre_ln": f"{v}.pre_layrnorm",
                    "post_ln": f"{v}.post_layernorm"}
    for i in range(num_layers):
        o, b = f"layer_{i}", f"{v}.encoder.layers.{i}"
        m[f"{o}/ln1"] = f"{b}.layer_norm1"
        m[f"{o}/ln2"] = f"{b}.layer_norm2"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[f"{o}/{name}"] = f"{b}.self_attn.{name}"
        m[f"{o}/fc1"] = f"{b}.mlp.fc1"
        m[f"{o}/fc2"] = f"{b}.mlp.fc2"
    raw: RawMap = {"class_embedding": (f"{v}.embeddings.class_embedding", lambda a: a),
                   "position_embedding": (f"{v}.embeddings.position_embedding.weight", lambda a: a[0])}
    return m, raw


def t5_encoder_map(num_layers: int, per_layer_rel_bias: bool = False) -> Tuple[ModuleMap, RawMap]:
    """T5 (bias table on block 0) or UMT5 (``per_layer_rel_bias``: on every block)."""
    m: ModuleMap = {"token_embedding": "shared", "final_ln": "encoder.final_layer_norm"}
    raw: RawMap = {f"block_{i}/attn/rel_bias": (
        f"encoder.block.{i}.layer.0.SelfAttention.relative_attention_bias.weight", lambda a: a)
        for i in (range(num_layers) if per_layer_rel_bias else (0,))}
    for i in range(num_layers):
        o, b = f"block_{i}", f"encoder.block.{i}"
        m[f"{o}/ln1"] = f"{b}.layer.0.layer_norm"
        m[f"{o}/ln2"] = f"{b}.layer.1.layer_norm"
        for name in ("q", "k", "v", "o"):
            m[f"{o}/attn/{name}"] = f"{b}.layer.0.SelfAttention.{name}"
        for name in ("wi_0", "wi_1", "wo"):
            m[f"{o}/{name}"] = f"{b}.layer.1.DenseReluDense.{name}"
    return m, raw


def vae_map(channel_mults, layers_per_block: int, mid_attention: bool = True) -> Tuple[ModuleMap, RawMap]:
    m: ModuleMap = {}
    parts = ("norm1", "conv1", "norm2", "conv2", "conv_shortcut")

    def resnet(src: str, dst: str) -> None:
        for part in parts:
            m[f"{src}/{part}"] = f"{dst}.{part}"

    n = len(channel_mults)
    for side in ("encoder", "decoder"):
        m[f"{side}/conv_in"] = f"{side}.conv_in"
        m[f"{side}/norm_out"] = f"{side}.conv_norm_out"
        m[f"{side}/conv_out"] = f"{side}.conv_out"
        resnet(f"{side}/mid_res_1", f"{side}.mid_block.resnets.0")
        resnet(f"{side}/mid_res_2", f"{side}.mid_block.resnets.1")
        if mid_attention:
            m[f"{side}/mid_attn/norm"] = f"{side}.mid_block.attentions.0.group_norm"
            for name in ("to_q", "to_k", "to_v"):
                m[f"{side}/mid_attn/{name}"] = f"{side}.mid_block.attentions.0.{name}"
            m[f"{side}/mid_attn/to_out"] = f"{side}.mid_block.attentions.0.to_out.0"
    for i in range(n):
        for j in range(layers_per_block):
            resnet(f"encoder/down_{i}_res_{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        for j in range(layers_per_block + 1):
            resnet(f"decoder/up_{i}_res_{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        if i < n - 1:
            m[f"encoder/down_{i}_conv"] = f"encoder.down_blocks.{i}.downsamplers.0.conv"
            m[f"decoder/up_{i}_conv"] = f"decoder.up_blocks.{i}.upsamplers.0.conv"
    return m, {}


def sd35_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every SD3.5 adapter component, keyed like ``adapter.params``."""
    t, v = configs["transformer"], configs["vae"]
    return {
        "transformer": sd3_transformer_map(t.depth, t.dual_attention_layers),
        "text_encoder": clip_text_map(configs["text_encoder"].num_layers),
        "text_encoder_2": clip_text_map(configs["text_encoder_2"].num_layers),
        "text_encoder_3": t5_encoder_map(configs["text_encoder_3"].num_layers),
        "vae": vae_map(v.channel_mults, v.layers_per_block, v.use_mid_attention),
    }


def sd35_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All SD3.5 components' flax trees → the port's state dicts."""
    maps = sd35_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def wan_transformer_map(num_layers: int, patch_size=(1, 2, 2), image_stream: bool = False
                        ) -> Tuple[ModuleMap, RawMap]:
    """The Wan DiT (inverse of the JAX ``wan_transformer_key_map``,
    ``utils/checkpoint.py:382``; with ``image_stream`` its ``i2v`` keys, the
    Wan2.1 I2V image cross-attention and the CLIP-token embedder)."""
    pt, ph, pw = patch_size

    def patch_kernel(a: np.ndarray) -> np.ndarray:  # (pt*ph*pw*C, D) → (D, C, pt, ph, pw)
        return np.transpose(a.reshape(pt, ph, pw, -1, a.shape[-1]), (4, 3, 0, 1, 2))

    m: ModuleMap = {
        "patch_embedding": "patch_embedding",
        "time_embed/linear_1": "condition_embedder.time_embedder.linear_1",
        "time_embed/linear_2": "condition_embedder.time_embedder.linear_2",
        "time_proj": "condition_embedder.time_proj",
        "ctx_proj0": "condition_embedder.text_embedder.linear_1",
        "ctx_proj1": "condition_embedder.text_embedder.linear_2",
        "head_out": "proj_out",
    }
    raw: RawMap = {"head_table": ("scale_shift_table", lambda a: a),
                   "patch_embedding/kernel": ("patch_embedding.weight", patch_kernel)}
    for i in range(num_layers):
        o, b = f"block_{i}", f"blocks.{i}"
        raw[f"{o}/scale_shift_table"] = (f"{b}.scale_shift_table", lambda a: a)
        for src, attn in (("sa", "attn1"), ("ca", "attn2")):
            for name in ("q", "k", "v"):
                m[f"{o}/{src}_{name}"] = f"{b}.{attn}.to_{name}"
            m[f"{o}/{src}_out"] = f"{b}.{attn}.to_out.0"
            m[f"{o}/{src}_qk_norm/q_norm"] = f"{b}.{attn}.norm_q"
            m[f"{o}/{src}_qk_norm/k_norm"] = f"{b}.{attn}.norm_k"
        m[f"{o}/norm2"] = f"{b}.norm2"
        m[f"{o}/ffn1"] = f"{b}.ffn.net.0.proj"
        m[f"{o}/ffn2"] = f"{b}.ffn.net.2"
        if image_stream:
            m[f"{o}/ca_k_img"] = f"{b}.attn2.add_k_proj"
            m[f"{o}/ca_v_img"] = f"{b}.attn2.add_v_proj"
            m[f"{o}/ca_k_img_norm"] = f"{b}.attn2.norm_added_k"
    if image_stream:
        e = "condition_embedder.image_embedder"
        m.update({"img_emb_norm1": f"{e}.norm1", "img_emb_fc1": f"{e}.ff.net.0.proj",
                  "img_emb_fc2": f"{e}.ff.net.2", "img_emb_norm2": f"{e}.norm2"})
    return m, raw


def wan_vae_map(cfg) -> Tuple[ModuleMap, RawMap]:
    """The Wan 2.1 and 2.2 video VAE (inverse of the JAX ``wan_vae_key_map``,
    ``utils/checkpoint.py:1176``): flax ``.../conv`` scopes of the causal
    convs are the port's Conv3d modules themselves."""
    m: ModuleMap = {}

    def resblock(src: str, dst: str, shortcut: bool) -> None:
        m[f"{src}/norm1"] = f"{dst}.norm1"
        m[f"{src}/norm2"] = f"{dst}.norm2"
        m[f"{src}/conv1/conv"] = f"{dst}.conv1"
        m[f"{src}/conv2/conv"] = f"{dst}.conv2"
        if shortcut:
            m[f"{src}/conv_shortcut/conv"] = f"{dst}.conv_shortcut"

    def attnblock(src: str, dst: str) -> None:
        m[f"{src}/norm"] = f"{dst}.norm"
        m[f"{src}/to_qkv"] = f"{dst}.to_qkv"
        m[f"{src}/proj"] = f"{dst}.proj"

    def resample(src: str, dst: str, temporal: bool) -> None:
        m[f"{src}/resample_1"] = f"{dst}.resample.1"
        if temporal:
            m[f"{src}/time_conv/conv"] = f"{dst}.time_conv"

    for side in ("encoder", "decoder"):
        m[f"{side}/conv_in/conv"] = f"{side}.conv_in"
        m[f"{side}/conv_out/conv"] = f"{side}.conv_out"
        m[f"{side}/norm_out"] = f"{side}.norm_out"
        for j in range(2):
            resblock(f"{side}/mid_block/resnets_{j}", f"{side}.mid_block.resnets.{j}", False)
        attnblock(f"{side}/mid_block/attentions_0", f"{side}.mid_block.attentions.0")
    m["quant_conv/conv"] = "quant_conv"
    m["post_quant_conv/conv"] = "post_quant_conv"

    n_spatial = len(cfg.channel_mults) - 1
    t_flags = cfg.temporal_down_flags()
    if cfg.resample_residual:  # Wan 2.2: one residual stage a multiplier, the shortcuts parameter-free
        for side, mults, flags, extra, prev in (
                ("encoder", tuple(cfg.channel_mults), t_flags, 0, cfg.base_channels),
                ("decoder", tuple(reversed(cfg.channel_mults)), tuple(reversed(t_flags)), 1,
                 cfg.base_channels * cfg.channel_mults[-1])):
            blocks, resampler = ("down_blocks", "downsampler") if side == "encoder" else ("up_blocks", "upsampler")
            for i, mult in enumerate(mults):
                ch = cfg.base_channels * mult
                src, dst = f"{side}/{blocks}_{i}", f"{side}.{blocks}.{i}"
                for j in range(cfg.layers_per_block + extra):
                    resblock(f"{src}/resnets_{j}", f"{dst}.resnets.{j}", j == 0 and prev != ch)
                prev = ch
                if i < n_spatial:
                    resample(f"{src}/{resampler}", f"{dst}.{resampler}", flags[i])
                    if side == "decoder":
                        prev = ch // 2
        return m, {}
    for side, mults, flags, extra, scale, prev in (
            ("encoder", tuple(cfg.channel_mults), t_flags, 0, 1.0, cfg.base_channels),
            ("decoder", tuple(reversed(cfg.channel_mults)), tuple(reversed(t_flags)), 1,
             1.0 / 2 ** n_spatial, cfg.base_channels * cfg.channel_mults[-1])):
        blocks = "down_blocks" if side == "encoder" else "up_blocks"
        idx = 0
        for i, mult in enumerate(mults):
            ch = cfg.base_channels * mult
            for _ in range(cfg.layers_per_block + extra):
                resblock(f"{side}/{blocks}_{idx}", f"{side}.{blocks}.{idx}", prev != ch)
                prev, idx = ch, idx + 1
                if scale in cfg.attn_scales:
                    attnblock(f"{side}/{blocks}_{idx}", f"{side}.{blocks}.{idx}")
                    idx += 1
            if i < n_spatial:
                resample(f"{side}/{blocks}_{idx}", f"{side}.{blocks}.{idx}", flags[i])
                idx += 1
                if side == "encoder":
                    scale /= 2.0
                else:
                    scale *= 2.0
                    prev = ch // 2
    return m, {}


def wan_t2v_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every Wan adapter component, keyed like ``adapter.params``:
    the Wan2.2 MoE's ``transformer_2`` takes the same map as ``transformer``,
    a widened patch embedding (I2V/V2V's 33 input channels, TI2V's 48)
    goes through the same reshape, and Wan2.1 I2V adds its image stream
    and ``image_encoder``."""
    t = configs["transformer"]
    dit = wan_transformer_map(t.num_layers, t.patch_size, bool(t.image_context_tokens))
    maps = {
        "transformer": dit,
        "transformer_2": dit,
        "text_encoder": t5_encoder_map(configs["text_encoder"].num_layers,
                                       configs["text_encoder"].per_layer_rel_bias),
        "vae": wan_vae_map(configs["vae"]),
    }
    if "image_encoder" in configs:  # Wan2.1 I2V's CLIP tower
        maps["image_encoder"] = clip_vision_map(configs["image_encoder"].num_layers)
    return maps


def wan_t2v_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All Wan T2V components' flax trees → the port's state dicts."""
    maps = wan_t2v_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def flux1_transformer_map(num_double: int, num_single: int) -> Tuple[ModuleMap, RawMap]:
    """The FLUX.1 transformer (inverse of the JAX ``flux_transformer_key_map``,
    ``utils/checkpoint.py:315``), diffusers names but for the single blocks'
    fused ``linear1``/``linear2``, which stay single weights in both packages."""
    m: ModuleMap = {
        "x_embedder": "x_embedder",
        "context_embedder": "context_embedder",
        "time_embed/linear_1": "time_text_embed.timestep_embedder.linear_1",
        "time_embed/linear_2": "time_text_embed.timestep_embedder.linear_2",
        "guidance_embed/linear_1": "time_text_embed.guidance_embedder.linear_1",
        "guidance_embed/linear_2": "time_text_embed.guidance_embedder.linear_2",
        "text_embed/linear_1": "time_text_embed.text_embedder.linear_1",
        "text_embed/linear_2": "time_text_embed.text_embedder.linear_2",
        "norm_out/linear": "norm_out.linear",
        "proj_out": "proj_out",
    }
    for i in range(num_double):
        o, b = f"double_{i}", f"transformer_blocks.{i}"
        m[f"{o}/img_mod"] = f"{b}.norm1.linear"
        m[f"{o}/txt_mod"] = f"{b}.norm1_context.linear"
        for src, dst in (("img_q", "to_q"), ("img_k", "to_k"), ("img_v", "to_v"), ("img_attn_out", "to_out.0"),
                         ("txt_q", "add_q_proj"), ("txt_k", "add_k_proj"), ("txt_v", "add_v_proj"),
                         ("txt_attn_out", "to_add_out"), ("img_qk_norm/q_norm", "norm_q"),
                         ("img_qk_norm/k_norm", "norm_k"), ("txt_qk_norm/q_norm", "norm_added_q"),
                         ("txt_qk_norm/k_norm", "norm_added_k")):
            m[f"{o}/{src}"] = f"{b}.attn.{dst}"
        for src, dst in (("img_ff", "ff"), ("txt_ff", "ff_context")):
            m[f"{o}/{src}/fc1"] = f"{b}.{dst}.net.0.proj"
            m[f"{o}/{src}/fc2"] = f"{b}.{dst}.net.2"
    for i in range(num_single):
        o, b = f"single_{i}", f"single_transformer_blocks.{i}"
        m[f"{o}/mod"] = f"{b}.norm.linear"
        m[f"{o}/linear1"] = f"{b}.linear1"
        m[f"{o}/linear2"] = f"{b}.linear2"
        m[f"{o}/qk_norm/q_norm"] = f"{b}.attn.norm_q"
        m[f"{o}/qk_norm/k_norm"] = f"{b}.attn.norm_k"
    return m, {}


def flux1_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every FLUX.1 adapter component, keyed like ``adapter.params``."""
    t, v = configs["transformer"], configs["vae"]
    return {
        "transformer": flux1_transformer_map(t.num_double_blocks, t.num_single_blocks),
        "text_encoder": clip_text_map(configs["text_encoder"].num_layers),
        "text_encoder_2": t5_encoder_map(configs["text_encoder_2"].num_layers),
        "vae": vae_map(v.channel_mults, v.layers_per_block, v.use_mid_attention),
    }


def flux1_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All FLUX.1 components' flax trees → the port's state dicts."""
    maps = flux1_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def flux2_transformer_map(num_double: int, num_single: int, mlp_style: str = "gelu_tanh"
                          ) -> Tuple[ModuleMap, RawMap]:
    """The FLUX.2 / Klein transformer: FLUX.1's names, with the double blocks'
    gated FFNs (``mlp_style`` ``swiglu``) as ``linear_in``/``linear_out``."""
    m, raw = flux1_transformer_map(num_double, num_single)
    if mlp_style == "swiglu":
        for i in range(num_double):
            o, b = f"double_{i}", f"transformer_blocks.{i}"
            for src, dst in (("img_ff", "ff"), ("txt_ff", "ff_context")):
                m[f"{o}/{src}/fc1"] = f"{b}.{dst}.linear_in"
                m[f"{o}/{src}/fc2"] = f"{b}.{dst}.linear_out"
    return m, raw


def flux2_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every FLUX.2 / Klein adapter component, keyed like ``adapter.params``."""
    t, v = configs["transformer"], configs["vae"]
    return {
        "transformer": flux2_transformer_map(t.num_double_blocks, t.num_single_blocks, t.mlp_style),
        "text_encoder": lm_decoder_map(configs["text_encoder"].num_layers),
        "vae": vae_map(v.channel_mults, v.layers_per_block, v.use_mid_attention),
    }


def flux2_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All FLUX.2 / Klein components' flax trees → the port's state dicts."""
    maps = flux2_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def ltx2_transformer_map(num_layers: int) -> Tuple[ModuleMap, RawMap]:
    """The LTX-2 AV DiT (inverse of the JAX ``ltx2_transformer_key_map``,
    ``utils/checkpoint.py:504``, plus the two connector projections)."""
    m: ModuleMap = {
        "video_embedder": "proj_in",
        "audio_embedder": "audio_proj_in",
        "time_embed/linear_1": "time_embed.emb.timestep_embedder.linear_1",
        "time_embed/linear_2": "time_embed.emb.timestep_embedder.linear_2",
        "time_proj": "time_embed.linear",
        "audio_time_embed/linear_1": "audio_time_embed.emb.timestep_embedder.linear_1",
        "audio_time_embed/linear_2": "audio_time_embed.emb.timestep_embedder.linear_2",
        "audio_time_proj": "audio_time_embed.linear",
        "video_connector": "video_connector",
        "audio_connector": "audio_connector",
        "video_head": "proj_out",
        "audio_head": "audio_proj_out",
    }
    raw: RawMap = {"head_table": ("scale_shift_table", lambda a: a),
                   "audio_head_table": ("audio_scale_shift_table", lambda a: a)}
    for i in range(num_layers):
        o, b = f"block_{i}", f"transformer_blocks.{i}"
        raw[f"{o}/scale_shift_table"] = (f"{b}.scale_shift_table", lambda a: a)
        raw[f"{o}/audio_scale_shift_table"] = (f"{b}.audio_scale_shift_table", lambda a: a)
        for src, attn in (("sa", "attn1"), ("a_sa", "audio_attn1")):
            for name in ("q", "k", "v"):
                m[f"{o}/{src}_{name}"] = f"{b}.{attn}.to_{name}"
            m[f"{o}/{src}_out"] = f"{b}.{attn}.to_out.0"
            m[f"{o}/{src}_qk_norm/q_norm"] = f"{b}.{attn}.norm_q"
            m[f"{o}/{src}_qk_norm/k_norm"] = f"{b}.{attn}.norm_k"
        for src, attn in (("ca", "attn2"), ("a_ca", "audio_attn2"), ("a2v", "audio_to_video_attn"),
                          ("v2a", "video_to_audio_attn")):
            for name in ("q", "k", "v"):
                m[f"{o}/{src}/{name}"] = f"{b}.{attn}.to_{name}"
            m[f"{o}/{src}/out"] = f"{b}.{attn}.to_out.0"
            m[f"{o}/{src}/qk_norm/q_norm"] = f"{b}.{attn}.norm_q"
            m[f"{o}/{src}/qk_norm/k_norm"] = f"{b}.{attn}.norm_k"
        for src, ff in (("", "ff"), ("a_", "audio_ff")):
            m[f"{o}/{src}ffn1"] = f"{b}.{ff}.net.0.proj"
            m[f"{o}/{src}ffn2"] = f"{b}.{ff}.net.2"
    return m, raw


def lm_decoder_map(num_layers: int, gemma: bool = False) -> Tuple[ModuleMap, RawMap]:
    """A decoder-only LM, both ``arch``es (inverse of the JAX
    ``lm_decoder_key_map``, ``utils/checkpoint.py:1371``): Gemma3's
    ``post_attn_ln`` is ``post_attention_layernorm`` and its ``ln2`` the
    ``pre_feedforward_layernorm``; llama's ``ln2`` is
    ``post_attention_layernorm``."""
    m: ModuleMap = {"token_embedding": "model.embed_tokens", "final_ln": "model.norm"}
    for i in range(num_layers):
        o, b = f"layer_{i}", f"model.layers.{i}"
        m[f"{o}/ln1"] = f"{b}.input_layernorm"
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "o_proj")):
            m[f"{o}/{src}"] = f"{b}.self_attn.{dst}"
        for name in ("gate", "up", "down"):
            m[f"{o}/{name}"] = f"{b}.mlp.{name}_proj"
        if gemma:
            m[f"{o}/post_attn_ln"] = f"{b}.post_attention_layernorm"
            m[f"{o}/ln2"] = f"{b}.pre_feedforward_layernorm"
            m[f"{o}/post_ff_ln"] = f"{b}.post_feedforward_layernorm"
            m[f"{o}/q_norm"] = f"{b}.self_attn.q_norm"
            m[f"{o}/k_norm"] = f"{b}.self_attn.k_norm"
        else:
            m[f"{o}/ln2"] = f"{b}.post_attention_layernorm"
    return m, {}


def ltx_video_vae_map(cfg) -> Tuple[ModuleMap, RawMap]:
    """The LTX video VAE (inverse of the JAX ``ltx_video_vae_key_map``,
    ``utils/checkpoint.py:979``): flax ``.../conv`` scopes are the causal
    convs' ``conv`` Conv3d modules; tables and the multiplier copy raw."""
    m: ModuleMap = {}
    raw: RawMap = {}
    same = lambda a: a

    def causal(src: str, dst: str) -> None:
        m[f"{src}/conv"] = f"{dst}.conv"

    def resnet(src: str, dst: str, shortcut: bool, cond: bool = False, noise: bool = False) -> None:
        causal(f"{src}/conv1", f"{dst}.conv1")
        causal(f"{src}/conv2", f"{dst}.conv2")
        if shortcut:
            causal(f"{src}/conv_shortcut", f"{dst}.conv_shortcut")
        if cond:
            raw[f"{src}/scale_shift_table"] = (f"{dst}.scale_shift_table", same)
        if noise:
            for k in ("per_channel_scale1", "per_channel_scale2"):
                raw[f"{src}/{k}"] = (f"{dst}.{k}", same)

    def time_embedder(src: str, dst: str) -> None:
        m[f"{src}/linear_1"] = f"{dst}.linear_1"
        m[f"{src}/linear_2"] = f"{dst}.linear_2"

    blocks = cfg.block_out_channels
    causal("encoder/conv_in", "encoder.conv_in")
    causal("encoder/conv_out", "encoder.conv_out")
    for i in range(len(blocks)):
        out_ch = blocks[i + 1] if i + 1 < len(blocks) else blocks[i]
        src, dst = f"encoder/down_blocks_{i}", f"encoder.down_blocks.{i}"
        for j in range(cfg.layers_per_block[i]):
            resnet(f"{src}/resnets_{j}", f"{dst}.resnets.{j}", False)
        if cfg.spatio_temporal_scaling[i]:
            causal(f"{src}/downsampler", f"{dst}.downsamplers.0")
        if out_ch != blocks[i]:
            resnet(f"{src}/conv_out", f"{dst}.conv_out", True)
    for j in range(cfg.layers_per_block[-1]):
        resnet(f"encoder/mid_block/resnets_{j}", f"encoder.mid_block.resnets.{j}", False)

    dblocks, cond = cfg.decoder_block_out_channels, cfg.timestep_conditioning
    causal("decoder/conv_in", "decoder.conv_in")
    causal("decoder/conv_out", "decoder.conv_out")
    for j in range(cfg.decoder_layers_per_block[0]):
        resnet(f"decoder/mid_block/resnets_{j}", f"decoder.mid_block.resnets.{j}", False, cond)
    if cond:
        time_embedder("decoder/mid_block/time_embedder", "decoder.mid_block.time_embedder")
        time_embedder("decoder/time_embedder", "decoder.time_embedder")
        raw["decoder/scale_shift_table"] = ("decoder.scale_shift_table", same)
        raw["decoder/timestep_scale_multiplier"] = ("decoder.timestep_scale_multiplier", same)
    width = dblocks[0]
    for i in range(len(dblocks)):
        out_ch = dblocks[i + 1] if i + 1 < len(dblocks) else dblocks[i]
        src, dst = f"decoder/up_blocks_{i}", f"decoder.up_blocks.{i}"
        scale = cfg.decoder_spatio_temporal_scaling[i]
        if width != (out_ch * cfg.upsample_factor[i] if scale else out_ch):
            resnet(f"{src}/conv_in", f"{dst}.conv_in", True)
        if scale:
            causal(f"{src}/upsampler/conv", f"{dst}.upsamplers.0.conv")
        if cond:
            time_embedder(f"{src}/time_embedder", f"{dst}.time_embedder")
        n = (cfg.decoder_layers_per_block[i + 1] if i + 1 < len(cfg.decoder_layers_per_block)
             else cfg.decoder_layers_per_block[-1])
        for j in range(n):
            resnet(f"{src}/resnets_{j}", f"{dst}.resnets.{j}", False, cond, cfg.decoder_inject_noise[i])
        width = out_ch
    return m, raw


def ltx2_audio_vae_map(cfg) -> Tuple[ModuleMap, RawMap]:
    """The LTX-2 audio VAE and HiFi-GAN vocoder (the JAX ``AudioVAE`` tree;
    the vocoder's names are the public generator's, ``resblocks.{stage·K +
    kernel}``)."""
    from ..models.ltx2.audio import vocoder_upsample_rates

    n = {1: 0, 2: 1, 4: 2}[cfg.temporal_down]
    m: ModuleMap = {f"{side}/{c}": f"{side}.{c}" for side in ("encoder", "decoder") for c in ("conv_in", "conv_out")}
    for i in range(n):
        m[f"encoder/down_{i}"] = f"encoder.down.{i}"
        m[f"decoder/up_{i}"] = f"decoder.up.{i}"
    m["vocoder/conv_pre"] = "vocoder.conv_pre"
    m["vocoder/conv_post"] = "vocoder.conv_post"
    nk = len(cfg.resblock_kernels)
    for i in range(len(vocoder_upsample_rates(cfg.hop))):
        m[f"vocoder/ups_{i}"] = f"vocoder.ups.{i}"
        for r in range(nk):
            for j in range(len(cfg.resblock_dilations)):
                for c in ("convs1", "convs2"):
                    m[f"vocoder/resblocks_{i}_{r}/{c}_{j}"] = f"vocoder.resblocks.{i * nk + r}.{c}.{j}"
    return m, {}


def ltx2_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every LTX-2 adapter component, keyed like ``adapter.params``."""
    lm = configs["text_encoder"]
    return {
        "transformer": ltx2_transformer_map(configs["transformer"].num_layers),
        "text_encoder": lm_decoder_map(lm.num_layers, gemma=lm.arch == "gemma3"),
        "vae": ltx_video_vae_map(configs["vae"]),
        "audio_vae": ltx2_audio_vae_map(configs["audio_vae"]),
    }


def ltx2_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All LTX-2 components' flax trees → the port's state dicts."""
    maps = ltx2_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def qwen_image_transformer_map(num_double: int) -> Tuple[ModuleMap, RawMap]:
    """Qwen-Image's transformer: FLUX.1's double blocks (no single blocks,
    no pooled or guidance embedder) and ``txt_norm``, the port's FLUX names."""
    m, raw = flux1_transformer_map(num_double, 0)
    return {**m, "txt_norm": "txt_norm"}, raw


def vl_vision_map(depth: int) -> Tuple[ModuleMap, RawMap]:
    """The Qwen2.5-VL vision tower (inverse of the JAX ``qwen_vl_vision_key_map``,
    ``utils/checkpoint.py:1494``, without the ``visual.`` prefix)."""
    m: ModuleMap = {"patch_embed": "patch_embed.proj", "ln_q": "merger.ln_q", "merger_fc1": "merger.mlp.0",
                    "merger_fc2": "merger.mlp.2"}
    for i in range(depth):
        o, b = f"block_{i}", f"blocks.{i}"
        m[f"{o}/norm1"] = f"{b}.norm1"
        m[f"{o}/norm2"] = f"{b}.norm2"
        m[f"{o}/qkv"] = f"{b}.attn.qkv"
        m[f"{o}/proj"] = f"{b}.attn.proj"
        for name in ("gate", "up", "down"):
            m[f"{o}/{name}"] = f"{b}.mlp.{name}_proj"
    return m, {}


def qwen_image_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every Qwen-Image (and Edit-Plus) adapter component,
    keyed like ``adapter.params``."""
    v = configs["vae"]
    maps = {
        "transformer": qwen_image_transformer_map(configs["transformer"].num_double_blocks),
        "text_encoder": lm_decoder_map(configs["text_encoder"].num_layers),
        "vae": vae_map(v.channel_mults, v.layers_per_block, v.use_mid_attention),
    }
    if "vision_tower" in configs:
        maps["vision_tower"] = vl_vision_map(configs["vision_tower"].depth)
    return maps


def qwen_image_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All Qwen-Image (and Edit-Plus) components' flax trees → the port's state dicts."""
    maps = qwen_image_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def z_image_transformer_map(num_layers: int) -> Tuple[ModuleMap, RawMap]:
    """The Z-Image S3-DiT (inverse of the JAX ``z_image_transformer_key_map``,
    ``utils/checkpoint.py:1138``)."""
    m: ModuleMap = {
        "x_embedder": "x_embedder",
        "cap_norm": "cap_embedder.0",
        "cap_embedder": "cap_embedder.1",
        "t_embedder/linear_1": "t_embedder.mlp.0",
        "t_embedder/linear_2": "t_embedder.mlp.2",
        "final_adaLN": "final_layer.adaLN_modulation.1",
        "final_linear": "final_layer.linear",
    }
    for i in range(num_layers):
        o, b = f"layer_{i}", f"layers.{i}"
        for name in ("to_q", "to_k", "to_v"):
            m[f"{o}/{name}"] = f"{b}.attention.{name}"
        m[f"{o}/to_out"] = f"{b}.attention.to_out.0"
        m[f"{o}/qk_norm/q_norm"] = f"{b}.attention.norm_q"
        m[f"{o}/qk_norm/k_norm"] = f"{b}.attention.norm_k"
        for name in ("w1", "w2", "w3"):
            m[f"{o}/{name}"] = f"{b}.feed_forward.{name}"
        for name in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            m[f"{o}/{name}"] = f"{b}.{name}"
        m[f"{o}/adaLN_modulation"] = f"{b}.adaLN_modulation.1"
    return m, {}


def z_image_component_maps(configs: Mapping[str, Any]) -> Dict[str, Tuple[ModuleMap, RawMap]]:
    """Module maps for every Z-Image adapter component, keyed like ``adapter.params``."""
    v = configs["vae"]
    return {
        "transformer": z_image_transformer_map(configs["transformer"].num_layers),
        "text_encoder": lm_decoder_map(configs["text_encoder"].num_layers),
        "vae": vae_map(v.channel_mults, v.layers_per_block, v.use_mid_attention),
    }


def z_image_state_dicts(flax_params: Mapping[str, Any], configs: Mapping[str, Any]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """All Z-Image components' flax trees → the port's state dicts."""
    maps = z_image_component_maps(configs)
    return {comp: convert(tree, *maps[comp]) for comp, tree in flax_params.items()}


def full_from_flax(tree: Mapping[str, Any], maps: Tuple[ModuleMap, RawMap]) -> Dict[str, torch.Tensor]:
    """A JAX full-finetune trainable tree of one component (numpy leaves)
    → the port's ``{parameter name: fp32 tensor}`` tree through the
    component's ``maps`` (strict both ways: a flax leaf no rule maps raises,
    and so does a tree whose leaf count differs from the result's, e.g.
    two leaves on one name). SD3's position grid is among the leaves."""
    out = {name: t.float() for name, t in convert(tree, *maps).items()}
    if len(out) != len(flatten_flax(tree)):
        raise KeyError(f"full bridge: {len(flatten_flax(tree))} flax leaves gave {len(out)} port tensors")
    return out


# ---------------------------------------------------------------------------
# LoRA trees: flax {path/kernel: {a (in, r), b (r, out)}} ↔ the port's PEFT
# layout {module path: {lora_A (r, in), lora_B (out, r)}}
# ---------------------------------------------------------------------------

def lora_from_flax(lora: Mapping[str, Mapping[str, Any]], module_map: ModuleMap
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree (numpy leaves) → the port's names and layout (strict:
    a path no rule maps raises)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    unmatched = []
    for path, ab in lora.items():
        port = module_map.get(path[: -len("/kernel")]) if path.endswith("/kernel") else None
        if port is None or set(ab) != {"a", "b"}:
            unmatched.append(path)
            continue
        out[port] = {"lora_A": torch.from_numpy(np.array(np.asarray(ab["a"]).T)),
                     "lora_B": torch.from_numpy(np.array(np.asarray(ab["b"]).T))}
    if unmatched:
        raise KeyError(f"LoRA bridge: {len(unmatched)} flax paths have no rule: {unmatched[:10]}")
    return out


def lora_to_flax(tree: Mapping[str, Mapping[str, torch.Tensor]], module_map: ModuleMap
                 ) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's LoRA tree (or its gradients) → flax paths and layout, numpy
    (strict: a port path with no flax module raises)."""
    inverse = {port: flax for flax, port in module_map.items()}
    missing = [path for path in tree if path not in inverse]
    if missing:
        raise KeyError(f"LoRA bridge: {len(missing)} port paths have no flax module: {missing[:10]}")
    return {f"{inverse[path]}/kernel": {"a": ab["lora_A"].detach().cpu().numpy().T.copy(),
                                        "b": ab["lora_B"].detach().cpu().numpy().T.copy()}
            for path, ab in tree.items()}
