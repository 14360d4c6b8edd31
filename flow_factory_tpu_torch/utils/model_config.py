"""A component's config from a checkpoint directory's ``config.json``.

Port of the JAX package's ``utils/checkpoint.py`` overrides
(``apply_config_json_overrides`` and the ``*_overrides_from_config``
translators of the families ported here): ``<path>/<subfolder>/config.json``
in the diffusers or transformers layout, where present, replaces the
preset's fields it names; a partial file overrides only its keys. A
directory that holds only ``transformer/config.json`` with
``{"num_layers": N}`` is how a full-width model runs at depth N.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)


def load_component_config(path: str, subfolder: str) -> Optional[Dict[str, Any]]:
    """``<path>/<subfolder>/config.json`` as a dict, None when absent or malformed."""
    f = os.path.join(path, subfolder, "config.json")
    if not os.path.isfile(f):
        return None
    try:
        with open(f) as fh:
            return json.load(fh)
    except ValueError as e:  # malformed: the preset stands
        logger.warning("Could not parse %s: %s", f, e)
        return None


def apply_config_json_overrides(preset_cfg: Any, path: Optional[str], subfolder: str,
                                overrides_fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> Any:
    """The preset dataclass with ``overrides_fn(config.json)`` applied, when
    ``path`` is a directory holding the component's config."""
    if path and os.path.isdir(path):
        cj = load_component_config(path, subfolder)
        if cj:
            return dataclasses.replace(preset_cfg, **overrides_fn(cj))
    return preset_cfg


def flux_transformer_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """diffusers ``FluxTransformer2DModel`` keys (Qwen-Image keeps them) → ``FluxConfig``."""
    out: Dict[str, Any] = {}
    if "num_layers" in cfg:
        out["num_double_blocks"] = int(cfg["num_layers"])
    if "num_single_layers" in cfg:
        out["num_single_blocks"] = int(cfg["num_single_layers"])
    if "num_attention_heads" in cfg:
        out["num_heads"] = int(cfg["num_attention_heads"])
        if "attention_head_dim" in cfg:
            out["hidden_dim"] = int(cfg["num_attention_heads"]) * int(cfg["attention_head_dim"])
    if cfg.get("in_channels") is not None:
        out["in_channels"] = int(cfg["in_channels"])
    if cfg.get("joint_attention_dim") is not None:
        out["context_dim"] = int(cfg["joint_attention_dim"])
    if cfg.get("pooled_projection_dim") is not None:
        out["pooled_dim"] = int(cfg["pooled_projection_dim"])
    if "guidance_embeds" in cfg:
        out["guidance_embeds"] = bool(cfg["guidance_embeds"])
    if "axes_dims_rope" in cfg:
        out["axes_dim"] = tuple(int(d) for d in cfg["axes_dims_rope"])
    return out


def z_image_transformer_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Z-Image (S3-DiT) keys, diffusers or Lumina spellings → ``ZImageConfig``;
    ``in_channels`` is the unpacked count upstream, times patch_size² here."""
    out: Dict[str, Any] = {}
    layers = cfg.get("num_layers", cfg.get("n_layers"))
    if layers is not None:
        out["num_layers"] = int(layers)
    heads = cfg.get("num_attention_heads", cfg.get("n_heads"))
    if heads is not None:
        out["num_heads"] = int(heads)
    hidden = cfg.get("hidden_size", cfg.get("dim"))
    if hidden is not None:
        out["hidden_dim"] = int(hidden)
    elif heads is not None and cfg.get("attention_head_dim") is not None:
        out["hidden_dim"] = int(heads) * int(cfg["attention_head_dim"])
    ctx = cfg.get("cap_feat_dim", cfg.get("joint_attention_dim"))
    if ctx is not None:
        out["context_dim"] = int(ctx)
    if cfg.get("in_channels") is not None:
        p = int(cfg.get("patch_size") or 1)
        out["in_channels"] = int(cfg["in_channels"]) * p * p
    axes = cfg.get("axes_dim_rope", cfg.get("axes_dims_rope"))
    if axes is not None:
        out["axes_dim"] = tuple(int(d) for d in axes)
    if cfg.get("ffn_dim") is not None:
        out["ffn_dim"] = int(cfg["ffn_dim"])
    if cfg.get("rope_theta") is not None:
        out["rope_theta"] = float(cfg["rope_theta"])
    return out


def lm_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """transformers causal-LM keys (Llama/Mistral/Qwen2 layout) → ``LMConfig``;
    Qwen2.x (by ``model_type``) has q/k/v biases."""
    out: Dict[str, Any] = {}
    for src, dst in (("vocab_size", "vocab_size"), ("hidden_size", "hidden_dim"),
                     ("num_hidden_layers", "num_layers"), ("num_attention_heads", "num_heads"),
                     ("num_key_value_heads", "num_kv_heads"), ("head_dim", "head_dim"),
                     ("intermediate_size", "mlp_dim")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    if cfg.get("rope_theta") is not None:
        out["rope_theta"] = float(cfg["rope_theta"])
    if cfg.get("rms_norm_eps") is not None:
        out["rms_eps"] = float(cfg["rms_norm_eps"])
    if "head_dim" not in out and {"hidden_size", "num_attention_heads"} <= cfg.keys():
        out["head_dim"] = int(cfg["hidden_size"]) // int(cfg["num_attention_heads"])
    mt = str(cfg.get("model_type", ""))
    if mt.startswith("qwen2"):
        out["attn_bias"] = True
    elif mt:
        out["attn_bias"] = bool(cfg.get("attention_bias", False))
    if mt.startswith("gemma3"):
        raise NotImplementedError("a Gemma3 config.json: the LTX-2 adapters take their LM from the preset")
    return out


def image_vae_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """diffusers ``AutoencoderKL`` keys → ``VAEConfig``."""
    out: Dict[str, Any] = {}
    if cfg.get("block_out_channels"):
        blocks = [int(b) for b in cfg["block_out_channels"]]
        out["base_channels"] = blocks[0]
        out["channel_mults"] = tuple(b // blocks[0] for b in blocks)
    for src, dst in (("in_channels", "in_channels"), ("latent_channels", "latent_channels"),
                     ("layers_per_block", "layers_per_block")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    for src, dst in (("scaling_factor", "scaling_factor"), ("shift_factor", "shift_factor")):
        if cfg.get(src) is not None:
            out[dst] = float(cfg[src])
    if "mid_block_add_attention" in cfg:
        out["use_mid_attention"] = bool(cfg["mid_block_add_attention"])
    return out
