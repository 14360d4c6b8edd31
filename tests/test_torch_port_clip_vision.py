"""PyTorch port, the CLIP ViT-H/14 vision tower against the JAX package,
fp32 on the CPU: the bilinear resize with JAX's antialias against
``jax.image.resize`` (shrinking and growing), the tower with and without
its post-LN at the tiny preset and at 224 px / patch 14 (257 tokens)
through the weight bridge, and the checkpoint names: the port's tensor
names are the upstream keys that the JAX key maps of both CLIP towers read
(``pre_layrnorm`` included), carried to the port by the bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_import_cases import _jax_read_keys
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it
    before and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.mark.parametrize("size", [(256, 256), (480, 832), (16, 16), (24, 24)])
def test_resize_matches_jax_image_resize(size):
    """``utils.media.resize_bilinear`` to 224 px within 1e-5 of
    ``jax.image.resize(..., "bilinear")`` (antialias on)."""
    from flow_factory_tpu_torch.utils.media import resize_bilinear

    x = np.random.default_rng(0).random((2, 3, *size), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 224, 224), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), 224, 224).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_tower(cfg):
    from flow_factory_tpu.models.text_encoders.clip import CLIPVisionEncoder

    return CLIPVisionEncoder(cfg)


@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("geometry", ["tiny", "224px"])
def test_vision_tower_matches_jax(geometry, post_ln):
    """Pixel normalisation, the bias-free patch conv, the class token and
    position table, the fp32 pre-LN, the blocks (exact GELU, no mask) and
    the optional post-LN: (B, L, D) fp32 states within 2e-5 of JAX's on the
    same weights (moved off their init by N(0, 0.05))."""
    from flow_factory_tpu.models.text_encoders.clip import CLIPVisionConfig as JC

    from flow_factory_tpu_torch.models.text_encoders.clip import CLIPVisionConfig, CLIPVisionEncoder

    kw = dict(dtype="float32", use_post_ln=post_ln)
    jcfg = JC.tiny(**kw) if geometry == "tiny" else JC(image_size=224, patch_size=14, hidden_dim=64,
                                                       num_layers=2, num_heads=4, **kw)
    rng = np.random.default_rng(1)
    px = rng.random((2, 3, jcfg.image_size, jcfg.image_size), dtype=np.float32)
    jm = _jax_tower(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), px)["params"])
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, px))
    cfg = CLIPVisionConfig(**dataclasses.asdict(jcfg))
    tm = build_module(lambda: CLIPVisionEncoder(cfg), torch.device("cpu"), torch.float32, None)
    weights.load_component(tm, weights.convert(params, *weights.clip_vision_map(cfg.num_layers)))
    with torch.no_grad():
        got = tm(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, cfg.num_tokens, cfg.hidden_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_port_names_are_the_upstream_keys_the_jax_maps_read(tower):
    """Every tensor of the port's tower (the vision one with its post-LN) is
    named by the upstream key that the JAX key map reads for it: the JAX
    ``clip_vision_encoder_key_map`` / ``clip_text_encoder_key_map`` composed
    with the bridge is the identity on the port's names, so a transformers
    checkpoint imports with no renames."""
    from flow_factory_tpu.models.text_encoders.clip import CLIPTextConfig as JT
    from flow_factory_tpu.models.text_encoders.clip import CLIPTextEncoder as JTE
    from flow_factory_tpu.models.text_encoders.clip import CLIPVisionConfig as JV
    from flow_factory_tpu.utils.checkpoint import clip_text_encoder_key_map, clip_vision_encoder_key_map

    from flow_factory_tpu_torch.models.text_encoders.clip import (
        CLIPTextConfig,
        CLIPTextEncoder,
        CLIPVisionConfig,
        CLIPVisionEncoder,
    )

    if tower == "vision":
        jcfg = JV.tiny(use_post_ln=True, dtype="float32")
        tree = jax.eval_shape(lambda: _jax_tower(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16))))
        maps = clip_vision_encoder_key_map(2), weights.clip_vision_map(2)
        factory = lambda: CLIPVisionEncoder(CLIPVisionConfig.tiny(use_post_ln=True, dtype="float32"))
    else:
        tree = jax.eval_shape(lambda: JTE(JT.tiny(dtype="float32")).init(jax.random.PRNGKey(0),
                                                                          jnp.zeros((1, 4), jnp.int32)))
        maps = clip_text_encoder_key_map(2), weights.clip_text_map(2)
        factory = lambda: CLIPTextEncoder(CLIPTextConfig.tiny(dtype="float32"))
    shapes = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree["params"])
    (key_map, raw_map), bridge = maps
    read = _jax_read_keys(shapes, key_map, raw_map, bridge)
    with torch.device("meta"):
        names = set(factory().state_dict())
    assert read == {k: k for k in names}
    if tower == "vision":
        assert "vision_model.pre_layrnorm.weight" in names
