"""PyTorch port, models: MMDiT-X, CLIP, T5 and the VAE against the JAX
package's flax modules, starting from the flax modules' own random init and
carried across by the weight bridge (``utils/weights.py``). fp32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _port(factory, flax_params, module_map):
    module = build_module(factory, torch.device("cpu"), torch.float32, None)
    weights.load_component(module, weights.convert(flax_params, *module_map))
    return module


def test_mmdit_single_forward_matches_jax_through_bridge():
    """MMDiT-X with a dual-attention block, a plain block and the
    context_pre_only last block. Bar: 2e-5, the bar of
    tests/test_torch_reference.py for a single fp32 forward."""
    from flow_factory_tpu.models.sd3.transformer import MMDiTConfig as JCfg, SD3Transformer as JT
    from flow_factory_tpu_torch.models.sd3.transformer import MMDiTConfig, SD3Transformer

    kw = dict(depth=3, dual_attention_layers=(0, 1), context_dim=48, pooled_dim=40, dtype="float32",
              attn_backend="native")
    jm = JT(JCfg.tiny(**kw))
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    t = np.asarray([437.0, 801.0], np.float32)
    ctx = rng.standard_normal((2, 6, 48)).astype(np.float32)
    pooled = rng.standard_normal((2, 40)).astype(np.float32)
    params = _host(jm.init(jax.random.PRNGKey(0), lat, t, ctx, pooled)["params"])
    theirs = np.asarray(jm.apply({"params": params}, lat, t, ctx, pooled))

    cfg = MMDiTConfig.tiny(**{**kw, "attn_backend": "auto"})
    tm = _port(lambda: SD3Transformer(cfg), params, weights.sd3_transformer_map(3, (0, 1)))
    with torch.no_grad():
        ours = tm(*map(torch.from_numpy, (lat, t, ctx, pooled))).numpy()
    assert np.max(np.abs(ours - theirs)) < 2e-5


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_text_encoder_matches_jax_through_bridge(act):
    """CLIP-L (quick-GELU) and CLIP-G (exact GELU) forms; fast-variance
    LayerNorm. Bar: 1e-5 on every output (fp32, 2 layers)."""
    from flow_factory_tpu.models.text_encoders.clip import CLIPTextConfig as JCfg, CLIPTextEncoder as JE
    from flow_factory_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder

    kw = dict(hidden_dim=24, num_heads=2, projection_dim=24, hidden_act=act, dtype="float32")
    jm = JE(JCfg.tiny(**kw))
    ids = np.asarray([[1, 57, 300, 2, 0, 0, 0, 0], [1, 9, 11, 13, 17, 2, 0, 0]], np.int32)
    params = _host(jm.init(jax.random.PRNGKey(1), ids)["params"])
    theirs = jm.apply({"params": params}, ids)
    tm = _port(lambda: CLIPTextEncoder(CLIPTextConfig.tiny(**kw)), params, weights.clip_text_map(2))
    with torch.no_grad():
        ours = tm(torch.from_numpy(ids).long())
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_t5_encoder_matches_jax_through_bridge():
    """RMS T5LayerNorm, relative-position buckets shared from block 0, gated
    GELU. Bar: 1e-5 (fp32, 2 layers, 40 tokens so the log-spaced buckets
    are exercised)."""
    from flow_factory_tpu.models.text_encoders.t5 import T5Config as JCfg, T5Encoder as JE
    from flow_factory_tpu_torch.models.text_encoders import T5Config, T5Encoder

    kw = dict(hidden_dim=48, num_heads=2, head_dim=8, dtype="float32", rel_pos_max_distance=32)
    jm = JE(JCfg.tiny(**kw))
    ids = np.random.default_rng(2).integers(0, 1000, size=(2, 40)).astype(np.int32)
    params = _host(jm.init(jax.random.PRNGKey(2), ids)["params"])
    theirs = np.asarray(jm.apply({"params": params}, ids))
    tm = _port(lambda: T5Encoder(T5Config.tiny(**kw)), params, weights.t5_encoder_map(2))
    with torch.no_grad():
        ours = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_t5_relative_position_buckets_match_jax():
    from flow_factory_tpu.models.text_encoders.t5 import relative_position_bucket as jb
    from flow_factory_tpu_torch.models.text_encoders.t5 import relative_position_bucket as tb

    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(tb(torch.from_numpy(rel)).numpy(), np.asarray(jb(jnp.asarray(rel))))


def test_vae_decode_and_encode_match_jax_through_bridge():
    """AutoencoderKL decode (the rollout's path) and encoder moments: NHWC
    HWIO flax convs vs NCHW OIHW torch convs, fp32 GroupNorm. Bar: 1e-4
    (fp32 convolutions over 3x3x32 windows, summation order differs; TF32
    plays no part on the CPU)."""
    from flow_factory_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JCfg
    from flow_factory_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    cfg = JCfg.tiny(dtype="float32")
    jm = JV(cfg)
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    z = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    params = _host(jm.init(jax.random.PRNGKey(3), img)["params"])
    j_dec = np.asarray(jm.apply({"params": params}, z, method=JV.decode))
    j_mean, j_logvar = jm.apply({"params": params}, img, method=JV.encode_moments)
    tm = _port(lambda: AutoencoderKL(VAEConfig.tiny(dtype="float32")), params,
               weights.vae_map(cfg.channel_mults, cfg.layers_per_block))
    with torch.no_grad():
        dec = tm.decode(torch.from_numpy(z)).numpy()
        mean, logvar = tm.encode_moments(torch.from_numpy(img))
    np.testing.assert_allclose(dec, j_dec, atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(j_logvar), atol=1e-4)


def test_weight_bridge_is_strict():
    """A flax leaf no rule consumes raises; a port parameter left unfilled
    raises on load."""
    from flow_factory_tpu.models.text_encoders.t5 import T5Config as JCfg, T5Encoder as JE
    from flow_factory_tpu_torch.models.text_encoders import T5Config, T5Encoder

    jm = JE(JCfg.tiny(dtype="float32"))
    params = _host(jm.init(jax.random.PRNGKey(4), np.zeros((1, 4), np.int32))["params"])
    module_map = weights.t5_encoder_map(2)
    with pytest.raises(KeyError):
        weights.convert({**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}, *module_map)
    sd = weights.convert(params, *module_map)
    sd.pop("encoder.block.1.layer.1.DenseReluDense.wo.weight")
    module = build_module(lambda: T5Encoder(T5Config.tiny(dtype="float32")), torch.device("cpu"),
                          torch.float32, None)
    with pytest.raises(RuntimeError):
        weights.load_component(module, sd)


def test_weight_bridge_layouts():
    """Dense (in, out) → (out, in); conv HWIO → OIHW; the SD3 position grid
    (1, G, G, D) → (1, G*G, D); norm scale → weight."""
    k = np.arange(6, dtype=np.float32).reshape(2, 3)
    conv = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    sd = weights.convert(
        {"proj_out": {"kernel": k, "bias": np.ones(3, np.float32)},
         "pos_embed": {"proj": {"kernel": conv, "bias": np.zeros(4, np.float32)},
                       "pos_embed": np.ones((1, 2, 2, 4), np.float32)},
         "norm_out": {"linear": {"kernel": k, "bias": np.zeros(3, np.float32)}}},
        *weights.sd3_transformer_map(0))
    assert torch.equal(sd["proj_out.weight"], torch.from_numpy(k.T))
    assert torch.equal(sd["pos_embed.proj.weight"], torch.from_numpy(conv.transpose(3, 2, 0, 1)))
    assert tuple(sd["pos_embed.pos_embed"].shape) == (1, 4, 4)
