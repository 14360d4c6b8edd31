"""Weight bridge: the JAX package's flax parameters → the port's state dicts.

Input is a nested dict of numpy arrays under flax paths (what
``jax.device_get(adapter.params[component])`` gives); output is a
``state_dict`` for the port's module of that component, whose parameter
names are diffusers' / transformers' names. Layouts:

* Dense kernels (in, out) → Linear weights (out, in); the attention head
  projections (``HeadProj`` (D_in, H*E), ``MergeProj`` (H*E, D_out)) are Dense
  kernels of the same layout;
* Conv kernels HWIO → OIHW;
* norm ``scale`` → ``weight``; embeddings keep their (rows, dim) layout;
* the SD3 position grid (1, G, G, D) → diffusers' (1, G*G, D) buffer.

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
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    if leaf in ("scale", "embedding"):
        return "weight", arr
    if leaf in ("bias", "weight"):
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


def t5_encoder_map(num_layers: int) -> Tuple[ModuleMap, RawMap]:
    m: ModuleMap = {"token_embedding": "shared", "final_ln": "encoder.final_layer_norm"}
    raw: RawMap = {"block_0/attn/rel_bias": (
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", lambda a: a)}
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
