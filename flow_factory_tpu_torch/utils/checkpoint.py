"""Importing a local diffusers-layout checkpoint into the port's modules.

Port of the import half of the JAX package's ``utils/checkpoint.py``
(``load_safetensors_dir`` :1124, ``ImportReport`` :164,
``import_diffusers_params`` :197 and the state-dict preprocesses). A
directory ``<model_name_or_path>/<subfolder>/*.safetensors`` holds each
component in torch layout under upstream names (diffusers', transformers',
HiFi-GAN's).

The JAX package renames every upstream key onto its flax tree through a key
map (upstream module path → flax path). The port's parameter names are
diffusers' and transformers' already (``utils/weights.py``), so most
upstream keys ARE the port's keys. A component's :data:`Renames` say where
they are not: each rule maps a port key to the upstream key that the JAX
key map reads for the same parameter, or to None where the JAX map reads
none (the JAX import leaves that parameter at its init, and a strict import
fails on it in both packages). The tables below are the JAX key maps
composed with the weight bridge's maps, and
``tests/test_torch_port_import.py`` holds each to that composition letter
for letter.
"""
from __future__ import annotations

import glob
import logging
import os
import re
from typing import Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .safetensors_io import load_file

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]
#: (regex over a port key, its upstream spelling or None), the first rule
#: whose regex matches a prefix of the key applies: the upstream key is the
#: match expanded by the replacement, then the rest of the key
Renames = Sequence[Tuple[str, Optional[str]]]


class ComponentImport(NamedTuple):
    """Where and how one component imports (JAX ``pretrained_component_maps``'s
    spec): ``subfolder`` of the checkpoint directory, the component's
    :data:`Renames`, a ``preprocess`` of the merged upstream state dict, and
    ``scope``, the regex of the upstream keys this component claims when a
    sibling shares its subfolder (Qwen2.5-VL's LM and vision tower)."""

    subfolder: str
    renames: Renames = ()
    preprocess: Optional[Callable[[StateDict], StateDict]] = None
    scope: Optional[str] = None


class ImportReport:
    """What an :func:`import_state_dict` call did: ``matched`` port tensors
    filled from the checkpoint, ``missing`` port tensors left at their init,
    ``unmatched`` checkpoint keys that no port tensor reads."""

    def __init__(self):
        self.matched: int = 0
        self.missing: List[str] = []
        self.unmatched: List[str] = []

    def summary(self, component: str = "") -> str:
        head = f"[{component}] " if component else ""
        return (
            f"{head}{self.matched} leaves imported, "
            f"{len(self.missing)} template leaves left at init"
            + (f" (first: {self.missing[:8]})" if self.missing else "")
            + f", {len(self.unmatched)} checkpoint keys unmatched"
            + (f" (first: {self.unmatched[:8]})" if self.unmatched else "")
        )


#: torch state-dict keys that are never parameters on either side
_IGNORABLE_KEYS = re.compile(r"(^|\.)(position_ids|num_batches_tracked|rotary_emb\.inv_freq)$")


def safetensors_files(path: str) -> List[str]:
    """Every ``*.safetensors`` of a directory, sorted (a sharded component's
    index json is not read: the shards name themselves)."""
    return sorted(glob.glob(os.path.join(path, "*.safetensors")))


def load_safetensors_dir(path: str) -> StateDict:
    """Every ``*.safetensors`` of a directory merged into one host state dict."""
    out: StateDict = {}
    for f in safetensors_files(path):
        out.update(load_file(f))
    return out


def upstream_key(key: str, renames: Renames = ()) -> Optional[str]:
    """The upstream spelling the JAX key map reads for the port's ``key``
    (None: it reads none)."""
    for pattern, repl in renames:
        m = re.match(pattern, key)
        if m:
            return None if repl is None else m.expand(repl) + key[m.end():]
    return key


def import_state_dict(module: torch.nn.Module, sd: Union[StateDict, Iterable[StateDict]], renames: Renames = (),
                      strict: bool = False, component: str = "", unmatched_scope: Optional[str] = None
                      ) -> ImportReport:
    """Copy an upstream state dict into ``module``'s parameters and persistent
    buffers in place, cast to their dtypes (JAX ``import_diffusers_params``).

    ``sd`` is a state dict or an iterable of them (a sharded checkpoint one
    file at a time, so that no shard set is held twice). A tensor of another
    shape raises, but one of the same size and another rank is reshaped (a
    Wan VAE norm's (C, 1, 1, 1) ``gamma`` onto (C,), as JAX reshapes).
    ``strict`` raises a ``ValueError`` naming every port tensor left at init
    and every checkpoint key left unread; ``unmatched_scope`` is the regex of
    the upstream keys this component claims, the others belonging to a
    sibling component of the same subfolder."""
    targets = module.state_dict(keep_vars=True)
    by_upstream = {}
    for key in targets:
        up = upstream_key(key, renames)
        if up is not None:
            by_upstream[up] = key
    report = ImportReport()
    filled, mismatched = set(), []
    with torch.no_grad():
        for chunk in ([sd] if isinstance(sd, Mapping) else sd):
            for up, value in chunk.items():
                key = by_upstream.get(up)
                if key is None:
                    if not _IGNORABLE_KEYS.search(up) and (unmatched_scope is None or re.match(unmatched_scope, up)):
                        report.unmatched.append(up)
                    continue
                target = targets[key]
                if value.shape != target.shape:
                    if value.numel() != target.numel() or value.dim() == target.dim():
                        mismatched.append((key, tuple(value.shape), tuple(target.shape)))
                        continue
                    value = value.reshape(target.shape)
                target.copy_(value)
                filled.add(key)
    report.matched = len(filled)
    report.missing = [key for key in targets if key not in filled]
    if mismatched:
        raise ValueError(f"Shape mismatches during import: {mismatched[:5]}")
    if strict and (report.missing or report.unmatched):
        raise ValueError("Strict pretrained import failed — the key map does not cover this checkpoint. "
                         + report.summary(component)
                         + f"; all missing: {report.missing}; all unmatched: {report.unmatched}")
    if report.missing:
        logger.warning("Import left %d params at init (first: %s)", len(report.missing), report.missing[:5])
    if report.unmatched:
        logger.warning("Import ignored %d checkpoint keys (first: %s)", len(report.unmatched), report.unmatched[:5])
    return report


# ---------------------------------------------------------------------------
# Renames: where the upstream spelling the JAX key map reads differs from the
# port's name (every other component reads its keys as they are)
# ---------------------------------------------------------------------------

# CLIP's text and vision towers (JAX ``clip_text_encoder_key_map`` :1309 and
# ``clip_vision_encoder_key_map`` :1465, transformers' ``pre_layrnorm``
# spelling included) and the Wan2.1 I2V image stream (the ``i2v`` keys of
# ``wan_transformer_key_map`` :420) read the upstream keys as the port names
# them: no renames (``tests/test_torch_port_clip_vision.py``,
# ``tests/test_torch_port_wan_i2v_clip.py``).

#: FLUX.1 (JAX ``flux_transformer_key_map`` :315): the single blocks' fused
#: projections, after :func:`fuse_flux_single_block_qkv_mlp`
FLUX1_TRANSFORMER_RENAMES: Renames = (
    (r"(single_transformer_blocks\.\d+)\.linear1\.", r"\1.attn.to_q."),
    (r"(single_transformer_blocks\.\d+)\.linear2\.", r"\1.proj_out."),
)

#: FLUX.2 and Klein (JAX ``flux2_transformer_key_map`` :432): the time and
#: guidance embedders under ``time_guidance_embed``, the double blocks' FFNs
#: as ``linear_in``/``linear_out`` in either ``mlp_style`` (the gated form
#: holds those names itself), and the single blocks' natively fused
#: projections
FLUX2_TRANSFORMER_RENAMES: Renames = (
    (r"time_text_embed\.", "time_guidance_embed."),
    (r"(transformer_blocks\.\d+\.ff(_context)?)\.net\.0\.proj\.", r"\1.linear_in."),
    (r"(transformer_blocks\.\d+\.ff(_context)?)\.net\.2\.", r"\1.linear_out."),
    (r"(single_transformer_blocks\.\d+)\.linear1\.", r"\1.attn.to_qkv_mlp_proj."),
    (r"(single_transformer_blocks\.\d+)\.linear2\.", r"\1.attn.to_out.0."),
)

#: Qwen-Image (JAX ``qwen_image_transformer_key_map`` :564): the port runs it
#: as the FLUX transformer, under FLUX's names
QWEN_IMAGE_TRANSFORMER_RENAMES: Renames = (
    (r"x_embedder\.", "img_in."),
    (r"context_embedder\.", "txt_in."),
    (r"(transformer_blocks\.\d+)\.norm1\.linear\.", r"\1.img_mod.1."),
    (r"(transformer_blocks\.\d+)\.norm1_context\.linear\.", r"\1.txt_mod.1."),
    (r"(transformer_blocks\.\d+)\.ff\.", r"\1.img_mlp."),
    (r"(transformer_blocks\.\d+)\.ff_context\.", r"\1.txt_mlp."),
)

#: LTX-2 (JAX ``ltx2_transformer_key_map`` :504): the text connectors ship
#: outside the transformer's safetensors, and no map reads them
LTX2_TRANSFORMER_RENAMES: Renames = ((r"(video|audio)_connector\.", None),)

#: the LTX video VAE (JAX ``ltx_video_vae_key_map`` :979): the JAX map reads
#: each causal conv's inner ``conv`` bare (the upsampler's two levels of it
#: too) and the time embedders under PixArt's combined embedder
LTX_VIDEO_VAE_RENAMES: Renames = (
    (r"(.*\.upsamplers\.0)\.conv\.conv\.", r"\1."),
    (r"(.*\.time_embedder)\.", r"\1.emb.timestep_embedder."),
    (r"(.*)\.conv\.(weight|bias)$", r"\1.\2"),
)

#: the LTX-2 audio VAE from the ``vocoder/`` subfolder (JAX
#: ``hifigan_vocoder_key_map`` :1099): the generator's own names; the mel
#: VAE's halves have no upstream map (``tests/test_keymap_completeness.py``)
LTX2_AUDIO_VAE_RENAMES: Renames = ((r"(encoder|decoder)\.", None), (r"vocoder\.", ""))

#: the Qwen2.5-VL vision tower (JAX ``qwen_vl_vision_key_map`` :1494) in the
#: ``text_encoder/`` subfolder, after :func:`qwen_vl_vision_preprocess`
VL_VISION_RENAMES: Renames = (("", "visual."),)


# ---------------------------------------------------------------------------
# State-dict preprocesses (upstream form → what the renames read)
# ---------------------------------------------------------------------------

def fuse_flux_single_block_qkv_mlp(sd: StateDict, num_single: int) -> StateDict:
    """FLUX.1's single blocks keep q/k/v and the MLP input as four
    projections upstream; both packages hold them as one ``linear1``:
    concatenate along the output dim into ``attn.to_q`` (JAX :360)."""
    out = dict(sd)
    for i in range(num_single):
        b = f"single_transformer_blocks.{i}"
        for suffix in ("weight", "bias"):
            parts = [out.pop(f"{b}.{name}.{suffix}", None)
                     for name in ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")]
            if all(p is not None for p in parts):
                out[f"{b}.attn.to_q.{suffix}"] = torch.cat(parts, dim=0)
    return out


def check_flux2_mlp_style(sd: StateDict, mlp_style: str) -> StateDict:
    """Raise, with the fix, when a FLUX.2 checkpoint's double-block FFN is
    gated (``linear_in``'s output twice ``linear_out``'s input: SwiGLU) and
    ``mlp_style`` says otherwise, or the other way round (JAX :486)."""
    win = sd.get("transformer_blocks.0.ff.linear_in.weight")
    wout = sd.get("transformer_blocks.0.ff.linear_out.weight")
    if win is not None and wout is not None:
        gated = win.shape[0] == 2 * wout.shape[1]
        want = "swiglu" if gated else "gelu_tanh"
        if want != mlp_style:
            raise ValueError(
                f"FLUX.2 checkpoint FFN is {'gated (SwiGLU)' if gated else 'ungated'} "
                f"but the model was built with mlp_style={mlp_style!r}; set "
                f"model.mlp_style: {want!r} in the config.")
    return sd


def pop_ltx_vae_latent_stats(sd: StateDict) -> Tuple[StateDict, Optional[Tuple[float, ...]],
                                                      Optional[Tuple[float, ...]]]:
    """Pop the ``latents_mean``/``latents_std`` buffers of an LTX VAE state
    dict: config in both packages, not parameters (JAX :1068)."""
    to_t = lambda v: tuple(float(x) for x in v.reshape(-1).tolist()) if v is not None else None
    mean, std = sd.pop("latents_mean", None), sd.pop("latents_std", None)
    return sd, to_t(mean), to_t(std)


def fuse_weight_norm(sd: StateDict) -> StateDict:
    """Fuse torch ``weight_norm`` pairs, ``w = g · v / ||v||`` with the norm
    over every dim but the output channels, in fp32 (JAX :1079, in the same
    numpy arithmetic)."""
    out: StateDict = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            base = k[: -len(".weight_g")]
            wv = sd[base + ".weight_v"].float().numpy()
            g = v.float().numpy()
            norm = np.sqrt(np.sum(np.square(wv), axis=tuple(range(1, wv.ndim)), keepdims=True))
            out[base + ".weight"] = torch.from_numpy(g * wv / np.maximum(norm, 1e-12))
        elif not k.endswith(".weight_v"):
            out[k] = v
    return out


def hifigan_vocoder_preprocess(sd: StateDict) -> StateDict:
    """A HiFi-GAN generator checkpoint in the vocoder map's form (JAX
    ``ltx2/t2av.py:118-130``): weight-norm pairs fused, a leading
    ``generator.`` stripped, and the transposed convolutions' (in, out, k)
    weights swapped to the (out, in, k) that both packages hold."""
    sd = fuse_weight_norm(sd)
    sd = {(k[len("generator."):] if k.startswith("generator.") else k): v for k, v in sd.items()}
    return {k: (v.transpose(0, 1).contiguous() if re.match(r"^ups\.\d+\.weight$", k) else v) for k, v in sd.items()}


def qwen_vl_vision_preprocess(sd: StateDict) -> StateDict:
    """A Qwen2.5-VL state dict for the vision map (JAX :1521): an optional
    ``model.`` prefix stripped off ``visual.*`` keys, and the conv3d patch
    kernel (out, C, T, ph, pw) flattened to the patch projection's
    (out, C·T·ph·pw), the order the host patchifier flattens in."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.visual."):
            k = k[len("model."):]
        if k == "visual.patch_embed.proj.weight":
            v = v.reshape(v.shape[0], -1)
        out[k] = v
    return out
