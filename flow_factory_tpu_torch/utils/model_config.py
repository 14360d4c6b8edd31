"""A component's config from a checkpoint directory's ``config.json``.

Port of the JAX package's ``utils/checkpoint.py`` overrides
(``apply_config_json_overrides`` and the ``*_overrides_from_config``
translators, :606-976): ``<path>/<subfolder>/config.json`` in the diffusers
or transformers layout, where present, replaces the preset's fields it
names; a partial file overrides only its keys. A directory that holds only
``transformer/config.json`` with ``{"num_layers": N}`` is how a full-width
model runs at depth N.
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
    """transformers causal-LM keys (Llama/Mistral/Qwen2/Gemma3 layout) →
    ``LMConfig``; Qwen2.x (by ``model_type``) has q/k/v biases, Gemma3 its
    own architecture and attention pattern."""
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
        out["arch"] = "gemma3"
        if cfg.get("query_pre_attn_scalar") is not None:
            out["query_pre_attn_scalar"] = float(cfg["query_pre_attn_scalar"])
        if cfg.get("sliding_window") is not None:
            out["sliding_window"] = int(cfg["sliding_window"])
        if cfg.get("sliding_window_pattern") is not None:
            out["sliding_window_pattern"] = int(cfg["sliding_window_pattern"])
        if cfg.get("rope_local_base_freq") is not None:
            out["rope_local_theta"] = float(cfg["rope_local_base_freq"])
        rs = cfg.get("rope_scaling") or {}
        if rs.get("factor") is not None:
            out["rope_scaling_factor"] = float(rs["factor"])
        lt = cfg.get("layer_types")
        if lt:
            # transformers' layer_types is authoritative; LMConfig expresses the
            # regular interleave (sliding unless (i + 1) % pattern == 0)
            fulls = [i for i, t in enumerate(lt) if t == "full_attention"]
            if not fulls:
                out["sliding_window_pattern"] = len(lt) + 1  # all sliding
            elif fulls == [i for i in range(len(lt)) if (i + 1) % (fulls[0] + 1) == 0]:
                out["sliding_window_pattern"] = fulls[0] + 1
            else:
                logger.warning("gemma3 layer_types is not a regular interleave; keeping the (i+1) %% %d default — "
                               "attention masks may diverge from the checkpoint",
                               out.get("sliding_window_pattern", 6))
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


def sd3_transformer_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """diffusers ``SD3Transformer2DModel`` keys → ``MMDiTConfig``."""
    out: Dict[str, Any] = {}
    if "num_layers" in cfg:
        out["depth"] = int(cfg["num_layers"])
    if "num_attention_heads" in cfg:
        out["num_heads"] = int(cfg["num_attention_heads"])
        if "attention_head_dim" in cfg:
            out["hidden_dim"] = int(cfg["num_attention_heads"]) * int(cfg["attention_head_dim"])
    for src, dst in (("in_channels", "in_channels"), ("out_channels", "out_channels"), ("patch_size", "patch_size"),
                     ("joint_attention_dim", "context_dim"), ("pooled_projection_dim", "pooled_dim"),
                     ("pos_embed_max_size", "pos_embed_max_size")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    if "dual_attention_layers" in cfg:
        out["dual_attention_layers"] = tuple(int(i) for i in cfg["dual_attention_layers"])
    if "qk_norm" in cfg:
        out["qk_norm"] = bool(cfg["qk_norm"])
    if "out_channels" not in out and "in_channels" in out:
        out["out_channels"] = out["in_channels"]
    return out


def wan_transformer_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """diffusers ``WanTransformer3DModel`` keys → ``WanConfig``. ``image_dim``
    (the CLIP image stream's width, ``image_context_dim``) is not read here:
    the I2V adapter takes it from its vision tower
    (``models/wan/i2v.py``, as JAX ``wan/i2v.py`` does)."""
    out: Dict[str, Any] = {}
    for src, dst in (("dim", "hidden_dim"), ("ffn_dim", "ffn_dim"), ("num_heads", "num_heads"),
                     ("num_layers", "num_layers"), ("in_channels", "in_channels"), ("out_channels", "out_channels"),
                     ("text_dim", "context_dim"), ("freq_dim", "freq_dim")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    if "patch_size" in cfg:
        out["patch_size"] = tuple(int(p) for p in cfg["patch_size"])
    if "qk_norm" in cfg:
        out["qk_norm"] = bool(cfg["qk_norm"])
    return out


def ltx2_transformer_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """LTX-Video/LTX-2 transformer keys → ``LTX2Config``. No
    ``cross_attention_dim``: the context width is the LM's, which the adapter
    sets. ``rms_norm_eps`` has no field here (nor in JAX's ``LTX2Config``,
    whose translator emits one that its dataclass rejects)."""
    out: Dict[str, Any] = {}
    if "num_layers" in cfg:
        out["num_layers"] = int(cfg["num_layers"])
    if "num_attention_heads" in cfg:
        out["num_heads"] = int(cfg["num_attention_heads"])
        if "attention_head_dim" in cfg:
            out["hidden_dim"] = int(cfg["num_attention_heads"]) * int(cfg["attention_head_dim"])
    if cfg.get("in_channels") is not None:
        out["video_channels"] = int(cfg["in_channels"])
    for src in ("audio_in_channels", "audio_channels"):
        if cfg.get(src) is not None:
            out["audio_channels"] = int(cfg[src])
            break
    if cfg.get("ffn_dim") is not None:
        out["ffn_dim"] = int(cfg["ffn_dim"])
    if cfg.get("rope_theta") is not None:
        out["rope_theta"] = float(cfg["rope_theta"])
    return out


def ltx2_audio_vae_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """LTX-2 audio VAE keys → ``AudioVAEConfig``."""
    out: Dict[str, Any] = {}
    for src, dst in (("latent_channels", "latent_channels"), ("mel_bins", "n_mels"), ("n_mels", "n_mels"),
                     ("sampling_rate", "sample_rate"), ("sample_rate", "sample_rate"), ("hop_length", "hop"),
                     ("n_fft", "n_fft"), ("base_channels", "base_channels")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    return out


def clip_text_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """transformers ``CLIPTextConfig`` keys → ``CLIPTextConfig``."""
    out: Dict[str, Any] = {}
    for src, dst in (("vocab_size", "vocab_size"), ("hidden_size", "hidden_dim"),
                     ("num_hidden_layers", "num_layers"), ("num_attention_heads", "num_heads"),
                     ("max_position_embeddings", "max_positions"), ("projection_dim", "projection_dim"),
                     ("eos_token_id", "eos_token_id")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    if cfg.get("hidden_act"):
        out["hidden_act"] = str(cfg["hidden_act"])
    if cfg.get("layer_norm_eps") is not None:
        out["layer_norm_eps"] = float(cfg["layer_norm_eps"])
    return out


def t5_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """transformers ``T5Config``/``UMT5Config`` keys → ``T5Config``."""
    out: Dict[str, Any] = {}
    for src, dst in (("vocab_size", "vocab_size"), ("d_model", "hidden_dim"), ("d_ff", "ff_dim"),
                     ("num_layers", "num_layers"), ("num_heads", "num_heads"), ("d_kv", "head_dim"),
                     ("relative_attention_num_buckets", "rel_pos_buckets"),
                     ("relative_attention_max_distance", "rel_pos_max_distance")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    if str(cfg.get("model_type", "")) == "umt5":
        out["per_layer_rel_bias"] = True
    return out


def wan_vae_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """diffusers ``AutoencoderKLWan`` keys (upstream's ``temperal_downsample``
    spelling) → ``VideoVAEConfig``, the per-channel latent normalisation
    included."""
    out: Dict[str, Any] = {}
    if "base_dim" in cfg:
        out["base_channels"] = int(cfg["base_dim"])
    if "z_dim" in cfg:
        out["latent_channels"] = int(cfg["z_dim"])
    if "dim_mult" in cfg:
        out["channel_mults"] = tuple(int(m) for m in cfg["dim_mult"])
    if "num_res_blocks" in cfg:
        out["layers_per_block"] = int(cfg["num_res_blocks"])
    if "attn_scales" in cfg:
        out["attn_scales"] = tuple(float(s) for s in cfg["attn_scales"])
    if "temperal_downsample" in cfg:
        out["temporal_down"] = 2 ** sum(bool(b) for b in cfg["temperal_downsample"])
    if cfg.get("patch_size"):
        out["spatial_patch"] = int(cfg["patch_size"])
    if "is_residual" in cfg:
        out["resample_residual"] = bool(cfg["is_residual"])
    if cfg.get("latents_mean") is not None:
        out["latents_mean"] = tuple(float(v) for v in cfg["latents_mean"])
    if cfg.get("latents_std") is not None:
        out["latents_std"] = tuple(float(v) for v in cfg["latents_std"])
    return out


def ltx_video_vae_overrides_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """diffusers ``AutoencoderKLLTXVideo`` keys → ``LTXVideoVAEConfig``. The
    decoder's lists are in encoder order upstream and in the decoder's
    forward order here, so they reverse."""
    out: Dict[str, Any] = {}
    for src, dst in (("in_channels", "in_channels"), ("out_channels", "out_channels"),
                     ("latent_channels", "latent_channels"), ("patch_size", "patch_size"),
                     ("patch_size_t", "patch_size_t")):
        if cfg.get(src) is not None:
            out[dst] = int(cfg[src])
    if cfg.get("block_out_channels"):
        out["block_out_channels"] = tuple(int(c) for c in cfg["block_out_channels"])
    if cfg.get("decoder_block_out_channels"):
        out["decoder_block_out_channels"] = tuple(int(c) for c in reversed(cfg["decoder_block_out_channels"]))
    if cfg.get("layers_per_block"):
        out["layers_per_block"] = tuple(int(n) for n in cfg["layers_per_block"])
    if cfg.get("decoder_layers_per_block"):
        out["decoder_layers_per_block"] = tuple(int(n) for n in cfg["decoder_layers_per_block"])
    if cfg.get("spatio_temporal_scaling"):
        out["spatio_temporal_scaling"] = tuple(bool(b) for b in cfg["spatio_temporal_scaling"])
    for key, kind in (("decoder_spatio_temporal_scaling", bool), ("decoder_inject_noise", bool),
                      ("upsample_residual", bool), ("upsample_factor", int)):
        if cfg.get(key):
            out[key] = tuple(kind(v) for v in reversed(cfg[key]))
    for key in ("timestep_conditioning", "encoder_causal", "decoder_causal"):
        if key in cfg:
            out[key] = bool(cfg[key])
    if cfg.get("resnet_norm_eps") is not None:
        out["resnet_norm_eps"] = float(cfg["resnet_norm_eps"])
    if cfg.get("scaling_factor") is not None:
        out["scaling_factor"] = float(cfg["scaling_factor"])
    if cfg.get("latents_mean") is not None:
        out["latents_mean"] = tuple(float(v) for v in cfg["latents_mean"])
    if cfg.get("latents_std") is not None:
        out["latents_std"] = tuple(float(v) for v in cfg["latents_std"])
    return out
