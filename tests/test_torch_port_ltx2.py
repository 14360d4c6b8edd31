"""PyTorch port, the LTX-2 modules against the JAX package, fp32 on the CPU:
the decoder-only LM at ``gemma3_tiny`` (window 4, pattern 2, length 16:
local and global layers and the band mask) and at ``tiny`` (llama), pad
rows included; the dual-stream transformer at ``tiny`` plain, with STG's
skipped blocks, with the cross-modal attentions off, with a binary video
conditioning mask and with a per-token (B, Lv) timestep; the LTX video VAE's
encode and timestep-conditioned decode; the audio VAE's mel encoder,
decoder and HiFi-GAN vocoder; the x0 conversions; and the weight bridge of
all four trees.

Each JAX module is initialised from a key and every leaf is then moved by
seeded noise (so Gemma's zero-init (1 + w) norms, the zero biases and the
tables all matter), and the same numpy arrays reach the port through the
bridge. The transformer's timestep features are the JAX function's on both
sides (``shared_time_features``, tests/test_torch_port_flux.py). The bar is
ROADMAP's single-forward "Match": 2e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _jax_features

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights

SEED = 5


def _moved(params, scale=0.05, seed=SEED):
    """Every leaf of a flax tree (numpy) plus seeded noise of ``scale``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
                        jax.device_get(params))


def _port(factory, flax_params, module_map):
    module = build_module(factory, torch.device("cpu"), torch.float32, None)
    weights.load_component(module, weights.convert(flax_params, *module_map))
    return module


def _close(ours, theirs, atol=2e-5):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The LM text encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["gemma3_tiny", "tiny"])
def test_lm_encoder_matches_jax_with_pad_rows(preset):
    """LMEncoder through the bridge: the final states of every position of
    16-token rows, the pad rows' too (the transformer attends them);
    gemma3_tiny runs layers 0 and 2 sliding (the
    band of 4 keys, local RoPE) and layer 1 global (positions / 8); vision
    embeddings without an image-pad mask leave the states as they are (the
    scatter itself: tests/test_torch_port_qwen_image.py)."""
    from flow_factory_tpu.models.text_encoders import lm as J
    from flow_factory_tpu_torch.models.text_encoders import lm as T

    cfg_j = getattr(J.LMConfig, preset)(dtype="float32")
    cfg_t = getattr(T.LMConfig, preset)(dtype="float32")
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg_j.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    ids[1, 9:] = 0
    module = J.LMEncoder(cfg_j)
    params = _moved(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(ids[:, :4]))["params"])
    h_j = jax.jit(module.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    port = _port(lambda: T.LMEncoder(cfg_t), params,
                 weights.lm_decoder_map(cfg_t.num_layers, gemma=cfg_t.arch == "gemma3"))
    if preset == "gemma3_tiny":
        assert [port.layer_is_sliding(i) for i in range(3)] == [True, False, True]
    with torch.no_grad():
        h_t = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert h_t.shape == (2, 16, 32)
    _close(h_t, h_j)
    with torch.no_grad():  # vision embeddings without an image-pad mask change nothing, as in JAX
        assert torch.equal(port(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                vision_embeds=torch.ones(2, 1, 32)), h_t)


# ---------------------------------------------------------------------------
# The dual-stream transformer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def transformer_pair():
    from flow_factory_tpu.models.ltx2.transformer import LTX2Config as JC, LTX2Transformer as JT
    from flow_factory_tpu_torch.models.ltx2.t2av import LTX2T2AVAdapter
    from flow_factory_tpu_torch.models.ltx2.transformer import LTX2Config, LTX2Transformer

    cfg_j = JC.tiny(dtype="float32", attn_backend="native")
    module = JT(cfg_j)
    params = _moved(jax.jit(module.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 16)), jnp.zeros((1, 4, 8)),
                                         jnp.zeros((1,)), jnp.zeros((1, 4, 32)), jnp.zeros((8, 3)),
                                         jnp.zeros((4, 3)))["params"])
    port = _port(lambda: LTX2Transformer(LTX2Config.tiny(dtype="float32")), params,
                 weights.ltx2_transformer_map(cfg_j.num_layers))
    rng = np.random.default_rng(2)
    vid_ids = LTX2T2AVAdapter._video_ids(2, 2, 3)
    inputs = dict(video_latents=rng.standard_normal((2, 12, 16)).astype(np.float32),
                  audio_latents=rng.standard_normal((2, 5, 8)).astype(np.float32),
                  timestep=np.asarray([700.0, 250.0], np.float32),
                  encoder_hidden_states=rng.standard_normal((2, 6, 32)).astype(np.float32),
                  video_ids=vid_ids, audio_ids=LTX2T2AVAdapter._audio_ids(5, 2))
    return module, params, port, inputs


_VARIANTS = {
    "plain": {},
    "skip_blocks": {"skip_blocks": (1,)},
    "isolate_modalities": {"isolate_modalities": True},
    "video_cond_mask": {"video_cond_mask": "mask"},
    "per_token_timestep": {"timestep": "per_token"},
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_ltx2_transformer_matches_jax(variant, transformer_pair, monkeypatch):
    """The tiny LTX2Transformer (2 blocks, width 64, 4 heads) on the bridged
    weights: both velocities fp32 within 2e-5 of the JAX module's, for the
    plain forward, STG's skipped block 1, the cross-modal attentions off, a
    binary conditioning mask over the first frame's 6 tokens (the t/0
    interpolation in every block and the video head) and a per-token (B, 12)
    timestep (a (B, Lv, 6, D) modulation)."""
    from flow_factory_tpu_torch.models import layers as TL

    monkeypatch.setattr(TL, "sinusoidal_timestep_embedding", _jax_features)
    module, params, port, inputs = transformer_pair
    kw = dict(inputs)
    extra = dict(_VARIANTS[variant])
    if extra.get("video_cond_mask") == "mask":
        m = np.zeros((2, 12, 1), np.float32)
        m[:, :6] = 1.0
        extra["video_cond_mask"] = m
    if extra.get("timestep") == "per_token":
        extra["timestep"] = np.linspace(100.0, 900.0, 24, dtype=np.float32).reshape(2, 12)
    kw.update(extra)
    order = ("video_latents", "audio_latents", "timestep", "encoder_hidden_states", "video_ids", "audio_ids")
    j_args = [jnp.asarray(kw.pop(k)) for k in order]
    skip = kw.pop("skip_blocks", ())
    j_kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    v_j, a_j = jax.jit(lambda p, *a, **k: module.apply(p, *a, skip, **k),
                       static_argnames=("isolate_modalities",))({"params": params}, *j_args, **j_kw)
    t_args = [torch.from_numpy(np.array(a)) for a in j_args]
    t_kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    with torch.no_grad():
        v_t, a_t = port(*t_args, skip_blocks=skip, **t_kw)
    assert v_t.dtype == a_t.dtype == torch.float32 and v_t.shape == (2, 12, 16) and a_t.shape == (2, 5, 8)
    _close(v_t, v_j)
    _close(a_t, a_j)


# ---------------------------------------------------------------------------
# The VAEs and the vocoder
# ---------------------------------------------------------------------------

def test_ltx_video_vae_encode_and_conditioned_decode_match_jax():
    """The tiny LTX video VAE through the bridge: encode of a (1, 3, 5, 16,
    16) clip to (1, 3, 4, 4, 16) latents, and the timestep-conditioned
    decode at decode timestep 0 and 0.05 without noise (noise scale 0) back
    to (1, 3, 5, 16, 16), within 2e-5 of JAX. The decoder's injected noise
    draws from a torch generator: its bits differ from the JAX key's, so
    it is not compared."""
    from flow_factory_tpu.models.ltx2.video_vae import LTXVideoVAE as JV, LTXVideoVAEConfig as JC
    from flow_factory_tpu_torch.models.ltx2.video_vae import LTXVideoVAE, LTXVideoVAEConfig

    cfg_j = JC.tiny(latents_mean=tuple(np.linspace(-0.2, 0.2, 16)), latents_std=tuple(np.linspace(0.8, 1.2, 16)))
    module = JV(cfg_j)
    params = _moved(jax.jit(module.init)(jax.random.PRNGKey(2), jnp.zeros((1, 3, 3, 8, 8)))["params"], scale=0.02)
    cfg_t = LTXVideoVAEConfig.tiny(latents_mean=cfg_j.latents_mean, latents_std=cfg_j.latents_std)
    port = _port(lambda: LTXVideoVAE(cfg_t), params, weights.ltx_video_vae_map(cfg_t))
    video = np.random.default_rng(3).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
    z_j = jax.jit(functools.partial(module.apply, method=JV.encode))({"params": params}, jnp.asarray(video))
    decode = jax.jit(functools.partial(module.apply, method=JV.decode), static_argnums=(2,))
    with torch.no_grad():
        z_t = port.encode(torch.from_numpy(video))
    assert z_t.shape == (1, 3, 4, 4, 16)
    _close(z_t, z_j)
    for t in (0.0, 0.05):
        out_j = decode({"params": params}, z_j, 5, jnp.asarray([t]))
        with torch.no_grad():
            out_t = port.decode(torch.from_numpy(np.asarray(z_j)), 5, torch.tensor([t]))
        assert out_t.shape == (1, 3, 5, 16, 16)
        _close(out_t, out_j)


def test_audio_vae_mel_decode_and_vocoder_match_jax():
    """The tiny audio VAE through the bridge: the framed-DFT log-mel and the
    encoder's posterior mean of a 0.2 s waveform, and the decode of (2, 6, 8)
    latents through the mel decoder (a SAME transposed convolution) and the
    HiFi-GAN vocoder (stride-8 transposed convolutions, dilated ResBlock1s)
    to (2, 1, 768) waveforms, within 2e-5 of JAX."""
    from flow_factory_tpu.models.ltx2 import audio as J
    from flow_factory_tpu_torch.models.ltx2 import audio as T

    cfg = J.AudioVAEConfig.tiny()
    module = J.AudioVAE(cfg)
    params = _moved(jax.jit(module.init)(jax.random.PRNGKey(3), jnp.zeros((1, 1, cfg.n_fft + cfg.hop * 15)))["params"],
                    scale=0.02)
    port = _port(lambda: T.AudioVAE(T.AudioVAEConfig.tiny()), params, weights.ltx2_audio_vae_map(cfg))
    rng = np.random.default_rng(4)
    wave = np.clip(0.3 * rng.standard_normal((2, 1, 4800)), -1, 1).astype(np.float32)
    _close(T.waveform_to_mel(torch.from_numpy(wave[:, 0]), T.AudioVAEConfig.tiny()),
           J.waveform_to_mel(jnp.asarray(wave[:, 0]), cfg), atol=1e-4)
    z_j = jax.jit(functools.partial(module.apply, method=J.AudioVAE.encode))({"params": params}, jnp.asarray(wave))
    z = rng.standard_normal((2, 6, 8)).astype(np.float32)
    out_j = jax.jit(functools.partial(module.apply, method=J.AudioVAE.decode))({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        _close(port.encode(torch.from_numpy(wave)), z_j, atol=1e-4)
        out_t = port.decode(torch.from_numpy(z))
    assert out_t.shape == (2, 1, 768) == tuple(out_j.shape)
    _close(out_t, out_j)


# ---------------------------------------------------------------------------
# The x0 conversions and the bridge
# ---------------------------------------------------------------------------

def test_x0_conversions_match_jax_and_invert():
    """convert_velocity_to_x0 and convert_x0_to_velocity equal the JAX
    functions (per-row σ as (B, 1, 1), and a σ of 0 clamped at 1e-6), and
    one undoes the other to fp32 rounding."""
    from flow_factory_tpu.scheduler import flow_match_euler as J
    from flow_factory_tpu_torch.scheduler import flow_match_euler as T

    rng = np.random.default_rng(6)
    v, x = (rng.standard_normal((3, 7, 4)).astype(np.float32) for _ in range(2))
    sigma = np.asarray([0.9, 0.3, 0.0], np.float32).reshape(3, 1, 1)
    x0_t = T.convert_velocity_to_x0(torch.from_numpy(v), torch.from_numpy(x), torch.from_numpy(sigma))
    _close(x0_t, J.convert_velocity_to_x0(jnp.asarray(v), jnp.asarray(x), jnp.asarray(sigma)), atol=1e-6)
    back = T.convert_x0_to_velocity(x0_t, torch.from_numpy(x), torch.from_numpy(sigma))
    _close(back, J.convert_x0_to_velocity(jnp.asarray(x0_t.numpy()), jnp.asarray(x), jnp.asarray(sigma)), atol=1e-5)
    _close(back[:2], v[:2], atol=1e-5)
    assert torch.all(back[2] == 0.0)  # σ 0: x0 = x, so v = 0 / 1e-6


def test_ltx2_bridge_covers_all_four_trees_and_the_lora():
    """The tiny LTX-2 adapter's four JAX trees (transformer, Gemma3-layout
    and llama-layout LM, video VAE, audio VAE) bridge onto the port's
    modules strictly, every flax leaf consumed and every port parameter
    filled, shapes equal; the 56 LoRA targets (28 a block) bridge to the
    port's tree and back exactly."""
    from flow_factory_tpu.models.ltx2.t2av import _preset as j_preset
    from flow_factory_tpu.models.text_encoders.lm import LMEncoder as JLM
    from flow_factory_tpu_torch.models.ltx2.t2av import LTX2_LORA_TARGETS, _preset
    from flow_factory_tpu_torch.models.lora import init_lora
    from flow_factory_tpu_torch.models.text_encoders.lm import LMEncoder
    from flow_factory_tpu_torch.models.ltx2 import AudioVAE, LTX2Transformer, LTXVideoVAE
    from flow_factory_tpu.models.ltx2 import AudioVAE as JA, LTX2Transformer as JT
    from flow_factory_tpu.models.ltx2.video_vae import LTXVideoVAE as JV

    jp, tp = j_preset("tiny", "native", "float32"), _preset("tiny", "native", "float32")
    k = jax.random.PRNGKey(0)
    tc, vc, ac = jp["transformer"], jp["video_vae"], jp["audio_vae"]
    trees = {
        "transformer": (jax.jit(JT(tc).init)(k, jnp.zeros((1, 8, 16)), jnp.zeros((1, 4, 8)), jnp.zeros((1,)),
                                    jnp.zeros((1, 4, tc.context_dim)), jnp.zeros((8, 3)), jnp.zeros((4, 3))),
                        lambda: LTX2Transformer(tp["transformer"]), weights.ltx2_transformer_map(tc.num_layers)),
        "vae": (jax.jit(JV(vc).init)(k, jnp.zeros((1, 3, 3, 8, 8))), lambda: LTXVideoVAE(tp["video_vae"]),
                weights.ltx_video_vae_map(tp["video_vae"])),
        "audio_vae": (jax.jit(JA(ac).init)(k, jnp.zeros((1, 1, ac.n_fft + ac.hop * 15))), lambda: AudioVAE(tp["audio_vae"]),
                      weights.ltx2_audio_vae_map(tp["audio_vae"])),
    }
    from flow_factory_tpu.models.text_encoders.lm import LMConfig as JLC
    from flow_factory_tpu_torch.models.text_encoders.lm import LMConfig

    for name in ("tiny", "gemma3_tiny"):
        trees[f"text_encoder/{name}"] = (
            jax.jit(JLM(getattr(JLC, name)()).init)(k, jnp.zeros((1, 4), jnp.int32)),
            lambda name=name: LMEncoder(getattr(LMConfig, name)()),
            weights.lm_decoder_map(getattr(LMConfig, name)().num_layers, gemma=name == "gemma3_tiny"))
    for comp, (variables, factory, module_map) in trees.items():
        sd = weights.convert(variables["params"], *module_map)
        module = build_module(factory, torch.device("cpu"), torch.float32, None)
        own = dict(module.state_dict())
        assert set(sd) == set(own), comp
        assert all(tuple(sd[n].shape) == tuple(own[n].shape) for n in sd), comp
        weights.load_component(module, sd)

    module = build_module(trees["transformer"][1], torch.device("cpu"), torch.float32, None)
    lora = init_lora(module, 4, torch.Generator().manual_seed(0), LTX2_LORA_TARGETS)
    assert len(lora) == 56
    module_map = trees["transformer"][2][0]
    back = weights.lora_from_flax(weights.lora_to_flax(lora, module_map), module_map)
    assert set(back) == set(lora)
    for path, ab in lora.items():
        for key in ("lora_A", "lora_B"):
            assert torch.equal(back[path][key], ab[key].detach())
