"""PyTorch port, the Wan2.1-I2V CLIP image stream against the JAX package,
fp32 on the CPU: the tiny DiT's velocity with the image cross-attention
and the CLIP-token embedder through the weight bridge; the tiny I2V adapter
with ``use_image_encoder`` in both packages on the same weights, LoRA,
prompts, images, x0 and per-step noise (``preprocess_func``'s condition
latents and image tokens, the rollout, replay ratio 1.0, the GRPO loss and
LoRA gradients against the JAX ``_grad_fn``); the LoRA targets, which leave
the image projections alone in both; a diffusers-layout I2V checkpoint
directory with the image stream imported in both packages."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_wan22 import (
    PROMPTS,
    SEED,
    _assert_grads_close,
    _assert_replay_ratio_is_one,
    _assert_rollouts_match,
    _config_dict,
    _grpo_grads,
    _host,
    _jax_noise,
    _media,
)
from torch_port_import_cases import cases, check_import_equals_jax  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights

CLIP = {"use_image_encoder": True}


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it
    before and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


def test_tiny_dit_velocity_with_the_image_stream_matches_jax():
    """The tiny DiT with 5 image tokens of width 32 (the tiny CLIP tower's):
    the CLIP-token embedder (LayerNorm at flax's eps, exact GELU), each
    block's second cross-attention with the text stream's normed query and
    the k-only across-heads norm, summed before ``to_out``: within 2e-5 of
    the JAX DiT through the bridge, and away from the port's own velocity
    without the image tokens."""
    from flow_factory_tpu.models.wan.transformer import WanConfig as JC
    from flow_factory_tpu.models.wan.transformer import WanTransformer as JT
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

    kw = dict(dtype="float32", attn_backend="native", image_context_tokens=5, image_context_dim=32)
    jm = JT(JC.tiny(**kw))
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 2, 8, 8, 16)).astype(np.float32)
    t = np.asarray([900.0, 250.0], np.float32)
    ctx = rng.standard_normal((2, 6, 48)).astype(np.float32)
    img = rng.standard_normal((2, 5, 32)).astype(np.float32)
    params = _host(jax.jit(jm.init)(jax.random.PRNGKey(3), lat, t, ctx, img)["params"])
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype), params)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, lat, t, ctx, img))
    cfg = WanConfig.tiny(**kw)
    tm = build_module(lambda: WanTransformer(cfg), torch.device("cpu"), torch.float32, None)
    weights.load_component(tm, weights.convert(params, *weights.wan_transformer_map(2, image_stream=True)))
    args = [torch.from_numpy(a) for a in (lat, t, ctx)]
    with torch.no_grad():
        got = tm(*args, torch.from_numpy(img)).numpy()
        plain = tm(*args).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.abs(got - plain).max() > 1e-3  # the image stream moves the velocity
    assert tm.blocks[0].attn2.norm_added_k.weight.shape == (64,)
    assert tm.condition_embedder.image_embedder.ff.net[0].proj.weight.shape == (64, 32)


def test_lora_targets_leave_the_image_projections_in_both():
    """The default LoRA targets of both packages take the same weights of
    the I2V DiT with the image stream: every attention projection and FFN
    linear but ``add_k_proj`` / ``add_v_proj`` (JAX's ``ca_k_img`` /
    ``ca_v_img``) and the CLIP-token embedder."""
    import re

    from flow_factory_tpu.models.wan.t2v import WAN_LORA_TARGETS as JAX_TARGETS
    from flow_factory_tpu.models.wan.transformer import WanConfig as JC
    from flow_factory_tpu.models.wan.transformer import WanTransformer as JT
    from flow_factory_tpu_torch.models.wan.t2v import WAN_LORA_TARGETS
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

    kw = dict(dtype="float32", image_context_tokens=5, image_context_dim=32)
    shapes = jax.eval_shape(lambda: JT(JC.tiny(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 4, 16)), jnp.zeros((1,)), jnp.zeros((1, 3, 48)),
        encoder_hidden_states_image=jnp.zeros((1, 5, 32))))["params"]
    paths = ["/".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    jax_hits = {p for p in paths if any(re.match(r, p) for r in JAX_TARGETS)}
    module_map, _ = weights.wan_transformer_map(2, image_stream=True)
    want = {f"{module_map[p.rsplit('/', 1)[0]]}.weight" for p in jax_hits}
    with torch.device("meta"):
        names = [n for n, _ in WanTransformer(WanConfig.tiny(**kw)).named_parameters()]
    ours = {n for n in names if any(re.match(r, n) for r in WAN_LORA_TARGETS)}
    assert ours == want and len(ours) == 2 * 10
    assert not any("add_" in n or "image_embedder" in n for n in ours)
    assert any("add_k_proj" in n for n in names)


class _ClipPair:
    """The tiny I2V adapter with the image stream in both packages: the port
    on the JAX adapter's weights (the tiny CLIP tower included) and LoRA
    (non-zero B on every target), both rolled out on the same prompts,
    first and last frames, x0 and noise."""

    def __init__(self):
        from flow_factory_tpu.hparams.args import Arguments as JArgs
        from flow_factory_tpu.models import load_adapter as jax_load
        from flow_factory_tpu.parallel.dist import set_world_size_override
        from flow_factory_tpu_torch.hparams import Arguments
        from flow_factory_tpu_torch.models import load_adapter

        cfg = _config_dict("wan2-i2v", CLIP)
        self.media = media = _media("i2v")
        rng = np.random.default_rng(5)
        set_world_size_override(1)
        try:
            ja = jax_load(JArgs.from_dict(copy.deepcopy(cfg)))
            lora = {comp: {p: {"a": np.asarray(ab["a"]),
                               "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                           for p, ab in _host(tree).items()} for comp, tree in ja.trainable.items()}
            self.trainable = {c: jax.tree.map(jnp.asarray, t) for c, t in lora.items()}
            ja.rollout()
            self.j_samples = ja.inference(prompt=PROMPTS, seed=SEED, trainable=self.trainable, **media)
            flax_params = _host(ja.params)
        finally:
            set_world_size_override(None)
        pa = load_adapter(Arguments.from_dict(copy.deepcopy(cfg)), device="cpu")
        pa.load_state_dicts({c: weights.convert(tree, *pa.weight_maps()[c]) for c, tree in flax_params.items()})
        for comp, tree in lora.items():
            pa.load_lora(comp, weights.lora_from_flax(tree, pa.weight_maps()[comp][0]))
        x0, noise = _jax_noise(len(PROMPTS), pa.latent_shape(32, 32, 5))
        pa.rollout()
        self.p_samples = pa.inference(prompt=PROMPTS, x0=x0, noise=noise, **media)
        self.ja, self.pa, self.lora = ja, pa, lora


@pytest.fixture(scope="module")
def pair():
    return _ClipPair()


def test_preprocess_gives_jax_condition_latents_and_image_tokens(pair):
    """``preprocess_func`` on records with images: the condition latents and
    the CLIP tower's 5 token states (the 32 px images resized to 16 px with
    JAX's antialias) within 2e-5 of JAX's, fp32 on the host."""
    ja, pa = pair.ja, pair.pa
    batch = {"prompt": PROMPTS, "images": pair.media["images"]}
    want = ja.preprocess_func(copy.deepcopy(batch))
    got = pa.preprocess_func(copy.deepcopy(batch))
    assert sorted(got) == sorted(want) == ["cond_latents", "image_embeds", "negative_prompt_embeds", "prompt_embeds"]
    assert got["image_embeds"].shape == (2, 5, 32) and got["image_embeds"].dtype == np.float32
    for k in ("cond_latents", "image_embeds"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=2e-5, rtol=0, err_msg=k)
    assert "image_embeds" in pa.embed_keys and pa.component_configs["transformer"].image_context_tokens == 5


def test_rollout_and_replay_with_the_image_stream_match_jax(pair):
    """The I2V rollout with the image stream (first and last frame pinned,
    CFG with the image tokens in both halves): trajectory, log-probs and
    videos against JAX; each sample keeps its ``image_embeds``; the replay
    reads them among the embeds and gives ratio exactly 1.0."""
    _assert_rollouts_match(pair.j_samples, pair.p_samples)
    for js, ps in zip(pair.j_samples, pair.p_samples):
        assert ps.extra_kwargs["image_embeds"].shape == (5, 32)
        np.testing.assert_allclose(ps.extra_kwargs["image_embeds"], js.extra_kwargs["image_embeds"], atol=2e-5)
    _assert_replay_ratio_is_one(pair.pa, pair.p_samples)


def test_grpo_loss_and_lora_grads_match_jax(pair):
    """A GRPO grad step with the image stream: loss within 1e-5, every LoRA
    leaf within 1e-4 of the JAX ``_grad_fn``'s gradients."""
    (j_loss, _, j_grads), (loss, _, grads) = _grpo_grads(pair, 1)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=1e-7)
    _assert_grads_close(grads, j_grads)


def test_diffusers_directory_with_the_image_stream_imports_as_in_jax(cases):
    """A diffusers-layout Wan2.1 I2V directory whose transformer carries the
    image stream (``attn2.add_k_proj`` / ``add_v_proj`` / ``norm_added_k``,
    ``condition_embedder.image_embedder.*``): the port's strict import equals
    the JAX import through the bridge exactly; neither imports the CLIP
    tower, which keeps its init."""
    check_import_equals_jax(cases, "wan2-i2v-clip")
